"""``dispatch.device_idle_share``: the share of the untraced window's
chunks' time on the card in which none of them was in flight, in percent.

Read from the program's spans (``betavae_tpu_torch/utils/profiling.py``):
each chunk's ``dispatch.chunk`` span records a CUDA event on its stream
where its dispatch starts and where its rows' copy to the host is queued.
The window's chunks are the last untraced ones whose steps sum to the
window's (``counters.window.steps``): the window ``step.mfu`` and
``step_images_per_sec`` read, its graphs launched from the device, no
profiler open.  The share is of the time from the first chunk's start to
the last one's end on the card.  None on the CPU, and where the program
keeps no such spans.
"""


def read(ctx, spans=None):
    steps = (ctx.counters.get("window") or {}).get("steps", 0)
    if spans is None:
        try:
            from betavae_tpu_torch.utils.profiling import SPANS as spans
        except ImportError:
            return None
        spans.settle()
    window = spans.chunk_window(steps) if steps > 0 else None
    if not window:
        return None
    start, end = min(r.d0 for r in window), max(r.d1 for r in window)
    busy, at = 0.0, start
    for r in sorted(window, key=lambda r: r.d0):
        a, b = max(r.d0, at), max(r.d1, at)
        busy += b - a
        at = b
    if end <= start:
        return None
    return 100.0 * (1.0 - busy / (end - start))
