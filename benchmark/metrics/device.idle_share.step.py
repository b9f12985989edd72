"""``device.idle_share.step``: the share of the traced window of steady
steps in which no operation ran on the card (the union of kernel, copy and
memset intervals), in percent."""


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_share
