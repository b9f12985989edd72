"""``dp.allreduce_share``: the device time of the NCCL kernels (the step's
gradient all-reduce and the mesh's global sums) over rank 0's traced
window, in percent."""


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    seconds = ctx.trace.kernel_seconds(("nccl",))
    if seconds <= 0:
        return None
    return 100.0 * seconds / ctx.trace.window_s
