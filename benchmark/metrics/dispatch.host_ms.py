"""``dispatch.host_ms``: the mean host time of the untraced window's
chunks' dispatch, in ms: the program's ``dispatch.chunk`` span, from the
staging of a chunk's steps through the upload of its slots, the draws and
its launches to the copy of its rows to the host being queued
(``betavae_tpu_torch/train/chunks.py::TrainChunks.dispatch``).  The
window's chunks are those ``dispatch.device_idle_share`` reads: the last
untraced ones whose steps sum to ``counters.window.steps``.  None on the
CPU, and where the program keeps no such spans.
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
    return 1e3 * sum(r.t1 - r.t0 for r in window) / len(window)
