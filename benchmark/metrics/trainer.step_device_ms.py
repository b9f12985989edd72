"""``trainer.step_device_ms``: the device time of a train step inside
``train()``, in ms: the device seconds of the chunks' ``dispatch.chunk``
spans (a pair of CUDA events on the chunk's stream, from its dispatch's
start to its rows' copy) within each epoch cycle, over the steps the card
ran in the cycle (each chunk's steps in proportion to its device interval
inside it), × 1000, over the ``spans`` lines of the epochs
``trainer.tail_s`` reads (W + 3 … E of the traced run, each untraced and
free of host launches of a graph).  To be set beside the steady cell's
1000 · batch / ``step_images_per_sec``.  None on the CPU, and where the
program keeps no such lines.
"""


def read(ctx, spans=None):
    last = ctx.counters.get("epochs")
    n = (ctx.counters.get("trainer") or {}).get("epochs")
    if not last or not n:
        return None
    if spans is None:
        try:
            from betavae_tpu_torch.utils.profiling import SPANS as spans
        except ImportError:
            return None
        spans.settle()
    lines = spans.epoch_lines(last - n + 1, last)
    if not lines:
        return None
    steps = sum(x["steps"] for x in lines)
    if steps <= 0:
        return None
    return 1e3 * sum(x["device_seconds"].get("dispatch.chunk", 0.0)
                     for x in lines) / steps
