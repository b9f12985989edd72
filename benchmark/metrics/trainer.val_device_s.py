"""``trainer.val_device_s``: the mean device seconds of the trainer's
validation pass (the program's ``eval.pass`` span: the test split's
staging, the launches of the captured batch and the copy of the metrics
and μ to the host, between a pair of CUDA events on its stream) in the
``spans`` lines of the epochs ``trainer.tail_s`` reads (W + 3 … E of the
traced run, each untraced and free of host launches of a graph).  None on
the CPU, and where the program keeps no such lines.
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
    if not lines or any("eval.pass" not in x["device_seconds"]
                        for x in lines):
        return None
    return sum(x["device_seconds"]["eval.pass"] for x in lines) / len(lines)
