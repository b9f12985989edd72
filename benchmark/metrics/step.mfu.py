"""``step.mfu``: the untraced window's training operations over the card's
dense bf16 peak, in percent.

Operations: ``benchmark/flops.py``'s count of a step (3 × the forward's
convolutions, dense and SE layers; nothing recomputed) × the window's
steps.  Time: the window's wall seconds on the benchmark's clock, the same
window that ``step_images_per_sec`` reads, whatever ran in it.  Not the
traced window: while the profiler is open the program launches its graphs
from the host, and a step there takes longer than in the window.
"""

from benchmark.flops import train_step_flops


def read(ctx):
    window = ctx.counters.get("window") or {}
    steps, seconds = window.get("steps", 0), window.get("seconds", 0.0)
    if ctx.peaks is None or steps <= 0 or seconds <= 0:
        return None
    ops = train_step_flops(ctx.batch, **ctx.sizes) * steps
    return 100.0 * ops / (seconds * ctx.peaks["bf16_flops"])
