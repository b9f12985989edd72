"""``trainer.device_idle_share``: the share of the trainer's epoch cycles in
which no span of the program had work on the card, in percent: Σ
``device_idle_seconds`` over Σ ``cycle_seconds`` of the program's ``spans``
lines (``betavae_tpu_torch/utils/profiling.py``: each cycle from one
``epoch_end`` stamp to the next, its busy time the union of every span's
device interval, each read from a pair of CUDA events with no profiler).
The epochs are those ``trainer.tail_s`` reads, W + 3 … E of the traced
run; each line must be untraced and free of host launches of a graph.
None on the CPU, and where the program keeps no such lines.
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
    return 100.0 * (sum(x["device_idle_seconds"] for x in lines)
                    / sum(x["cycle_seconds"] for x in lines))
