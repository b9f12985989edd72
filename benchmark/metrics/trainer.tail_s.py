"""``trainer.tail_s``: the mean of the trainer's ``tail_seconds`` (its
``epoch_end`` lines: validation, probes, checkpoint hand-off, panel and the
rotated dispatch) over the run's epochs after the traced one."""


def read(ctx):
    return ctx.counters.get("trainer", {}).get("tail_s")
