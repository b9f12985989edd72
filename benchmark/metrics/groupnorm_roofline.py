"""``groupnorm_roofline``: the least time of every block's GroupNorm(1),
forward and backward, over the device time of the kernels that do that
work, in percent.

Least time a step: a block's norm reads its input once and writes its
output once (2 × N elements) forward, and reads the output's gradient and
its input once and writes the input's gradient once (3 × N) backward, at
the step's activation dtype (bf16 under mixed precision, though the library
computes GroupNorm in fp32 there), plus the scale and shift and their
gradients in fp32, over the card's HBM bandwidth.  The kernels: PyTorch's
GroupNorm kernels, which the step runs today, and the program's own
(``csrc/gn.cu``), so that wiring these in reads the same work.

The time is the GroupNorm kernels' own.  The bf16 ↔ fp32 casts and copies
that the library's fp32 GroupNorm needs under mixed precision run as
separate elementwise and copy kernels, which this metric leaves out: their
cost shows in ``step.mfu``, ``step_images_per_sec`` and the breakdown's
device operations, not here.  So this share reads higher than the whole
cost of GroupNorm on today's path, and wiring a kernel that needs no casts
shows in those metrics, not in this one.
"""

KERNELS = ("GroupNorm", "RowwiseMoments", "ComputeFusedParams",
           "ComputeInternalGradients", "ComputeBackwardFusedParams",
           "GammaBetaBackward",
           "gn_stats_kernel", "gn_apply_kernel", "gn_bwd_sums_kernel",
           "gn_bwd_dx_kernel", "gn_fwd_cluster_kernel",
           "gn_bwd_cluster_kernel")


def block_outputs(sizes: dict) -> list:
    """``(channels, side)`` of every block's norm, encoder then decoder."""
    chs = [sizes["base"] * 2**i for i in range(sizes["blocks"])]
    out, s = [], sizes["image_size"]
    for c in chs:
        s = (s + 1) // 2
        out.append((c, s))
    dec = list(reversed(chs))
    for i in range(sizes["blocks"]):
        s *= 2
        out.append((dec[i + 1] if i + 1 < len(dec) else dec[-1], s))
    return out


def step_bytes(batch: int, sizes: dict, dtype_bytes: int) -> int:
    total = 0
    for c, s in block_outputs(sizes):
        total += 5 * batch * c * s * s * dtype_bytes + 4 * 4 * c
    return total


def read(ctx):
    if ctx.peaks is None:
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    d = 2 if ctx.cfg["training"].get("mixed_precision") else 4
    least = step_bytes(ctx.batch, ctx.sizes, d) * ctx.steps / ctx.peaks["hbm_bytes"]
    return 100.0 * least / seconds
