"""``upsample_roofline``: the least time of the decoder's bilinear ×2
upsamples, forward and backward, over the device time of the kernels that
do that work, in percent.

Least time a step: every decoder block's upsample reads its input once and
writes its output (4 × the input) once; its backward reads the output's
gradient once and writes the input's once: 10 × the input's bytes a block,
at the step's activation dtype (bf16 under mixed precision), over the
card's HBM bandwidth (the operations are far below the compute bound).
The kernels: the program's (``csrc/upsample.cu``) and PyTorch's, should a
later program call it.
"""

KERNELS = ("upsample2x_fwd_vector_kernel", "upsample2x_bwd_vector_kernel",
           "upsample2x_fwd_generic_kernel", "upsample2x_bwd_generic_kernel",
           "upsample_bilinear2d")


def step_bytes(batch: int, sizes: dict, dtype_bytes: int) -> int:
    chs = [sizes["base"] * 2**i for i in range(sizes["blocks"])]
    s = sizes["image_size"]
    for _ in range(sizes["blocks"]):
        s = (s + 1) // 2
    total = 0
    for cin in reversed(chs):
        total += 10 * batch * cin * s * s * dtype_bytes
        s *= 2
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
