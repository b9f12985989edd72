"""``trainer.train_images_per_sec``: the trainer's ``train_images_per_sec``
(its ``val`` lines: an epoch's steps over their own seconds, the tail left
out), images-weighted over the run's epochs after the traced one."""


def read(ctx):
    return ctx.counters.get("trainer", {}).get("train_images_per_sec")
