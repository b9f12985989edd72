"""``klf8.step.mfu``: the untraced window's training operations of the
autoencoder over the card's dense bf16 peak, in percent.

Operations: ``benchmark/flops_klf8.py``'s count of a step (3 × the
forward's convolutions and attention matmuls; nothing recomputed) × the
window's steps.  Time: the window's wall seconds on the benchmark's clock,
the window ``step_images_per_sec`` reads (as ``step.mfu`` reads the
β-VAE's).
"""

from benchmark.flops_klf8 import train_step_flops


def read(ctx):
    window = ctx.counters.get("window") or {}
    steps, seconds = window.get("steps", 0), window.get("seconds", 0.0)
    if ctx.peaks is None or steps <= 0 or seconds <= 0:
        return None
    ops = train_step_flops(ctx.batch, ctx.cfg) * steps
    return 100.0 * ops / (seconds * ctx.peaks["bf16_flops"])
