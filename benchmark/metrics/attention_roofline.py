"""``attention_roofline``: the least time of the attention's matmuls,
forward and backward, over the device time of the kernels that do that
work, in percent.

Least time: a call of one head of width C over N = side² positions
multiplies qᵀk and the product with v forward (2 · 2N²C operations) and
four such products backward (the gradients of q, k, v and the scores: 4 ·
2N²C), 6 · N² · C · 2 operations a call an image, nothing recomputed, over
the card's dense bf16 peak.  The calls a step are the program's
``attn.<backend>_launches`` counters over its graph replays (the runner's
``launches`` and ``replays``), each of the shape
``flops_klf8.attention_calls`` gives.  The kernels: PyTorch's fused
attention kernels by name (the memory-efficient, flash and cuDNN
backends), and a port kernel's, should one run there.  None where the
program counts no attention call.
"""

from benchmark.flops_klf8 import attention_calls

KERNELS = ("fmha_cutlass", "flash_fwd", "flash_bwd", "cudnn_generated_fort_native_sdpa",
           "attention_fwd", "attention_bwd")


def read(ctx):
    launches = ctx.counters.get("launches") or {}
    replays = ctx.counters.get("replays", 0)
    calls = sum(n for k, n in launches.items() if k.startswith("attn."))
    shapes = attention_calls(ctx.cfg)
    if ctx.peaks is None or not calls or not replays or not shapes:
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    per_call = sum(12 * (s * s) ** 2 * c for s, c in shapes) / len(shapes)
    ops = calls / replays * per_call * ctx.batch * ctx.steps
    return 100.0 * ops / ctx.peaks["bf16_flops"] / seconds
