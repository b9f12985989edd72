"""``gn_silu_roofline``: the least time of every GroupNorm of the
autoencoder and the swish after it, forward and backward, over the device
time of the kernels that do that work, in percent.

Least time a step: a norm with its swish reads its input once and writes
its output once (2 × N elements) forward, and reads the output's gradient
and its input once and writes the input's gradient once (3 × N) backward,
at the step's activation dtype (bf16 under mixed precision, though the
library computes GroupNorm in fp32 there), plus the scale and shift and
their gradients in fp32, over the card's HBM bandwidth; the shapes are
``flops_klf8.norm_shapes``'s (the attention's norms, which no swish
follows, among them).  The kernels: PyTorch's GroupNorm kernels and its
``silu`` elementwise kernels by name, and a port kernel's (``gn_silu``).
The bf16 ↔ fp32 casts around the library's GroupNorm are left out, as
``groupnorm_roofline`` leaves them out.
"""

from benchmark.flops_klf8 import norm_shapes

KERNELS = ("GroupNorm", "RowwiseMoments", "ComputeFusedParams",
           "ComputeInternalGradients", "ComputeBackwardFusedParams",
           "GammaBetaBackward", "silu", "gn_silu")


def step_bytes(batch: int, cfg: dict, dtype_bytes: int) -> int:
    return sum(5 * batch * c * s * s * dtype_bytes + 4 * 4 * c
               for c, s in norm_shapes(cfg))


def read(ctx):
    if ctx.peaks is None:
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    d = 2 if ctx.cfg["training"].get("mixed_precision") else 4
    least = step_bytes(ctx.batch, ctx.cfg, d) * ctx.steps / ctx.peaks["hbm_bytes"]
    return 100.0 * least / seconds
