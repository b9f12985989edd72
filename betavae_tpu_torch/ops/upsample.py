"""Bilinear ×2 upsampling with half-pixel centres (``align_corners=False``):
the CUDA kernels and their plain PyTorch versions.

Counterpart of ``betavae_tpu/ops/upsample.py::bilinear_upsample_x2``, whose
separable dilated depthwise convolutions are a TPU lowering of exactly this
function, edges included (the edge taps clamp to the border pixel).  Per
axis, ``out[2i] = 0.25·x[i−1] + 0.75·x[i]`` and ``out[2i+1] = 0.75·x[i] +
0.25·x[i+1]``, indices clamped.

Two kernels (``csrc/upsample.cu``, whose header gives their bound on an
H100): :func:`upsample2x_forward`, and :func:`upsample2x_backward` in
gather form, where each ``dx`` element is one thread's fixed-order sum of
the ``dy`` taps that touch it, with no atomics, so a run replays bitwise
(``F.interpolate``'s backward scatters with atomics).  The forward computes
in fp32 the H axis first, the backward the W axis first, with every product
and sum rounded on its own, and round once to the input's dtype; the plain
versions (:func:`upsample2x_reference`, :func:`upsample2x_backward_reference`)
do the same in torch ops, so kernel and plain version agree bitwise.

Each direction has two paths, by :func:`upsample_path` (shape, dtype and
the pointers' alignment): ``"vector"``, a thread per band of rows and 16
bytes of columns with 16-byte loads and stores (every shape of the
flagship and the scaled config; :func:`vector_tiling` mirrors its index
map), and ``"generic"``, a thread per input pixel or dx element, for
everything else.  Each wrapper launches its kernel for a CUDA tensor and
takes the plain version only for a CPU tensor; ``.launches`` counts kernel
launches and ``.launches_by_path`` counts them by path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..device import raw_stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"generic": 0, "vector": 1}
# as in csrc/upsample.cu: threads a CTA; rows a vector-path thread walks,
# forward and backward
_THREADS, _FWD_BAND, _BWD_BAND = 256, 2, 4


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int):
    """``even`` and ``odd`` alternating along ``dim`` (``even`` first)."""
    return torch.stack((even, odd), dim=dim + 1).flatten(dim, dim + 1)


def _up_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of the forward on an edge-padded fp32 ``x`` (``n + 2``
    along ``dim``): ``2n`` values."""
    n = x.shape[dim] - 2
    lo, mid, hi = (x.narrow(dim, k, n) for k in range(3))
    return _interleave(0.25 * lo + 0.75 * mid, 0.75 * mid + 0.25 * hi, dim)


def upsample2x_reference(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W) in ``x``'s dtype: an edge-replicate
    pad, then the taps over H and then over W, in fp32."""
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="replicate")
    return _up_axis(_up_axis(xp, 2), 3).to(x.dtype)


def _down_axis(g: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of the gather backward on fp32 ``g`` (``2n`` along
    ``dim``): ``dx[i] = 0.25·g[2i−1] + w1·g[2i] + w2·g[2i+1] + 0.25·g[2i+2]``,
    ``g`` 0 outside, ``w1`` 1.0 at ``i = 0`` and ``w2`` 1.0 at ``i = n−1``
    (the clamped taps fold into the edge), else 0.75."""
    n = g.shape[dim] // 2
    pad = [0, 0] * (g.dim() - 1 - dim) + [1, 1]
    gp = F.pad(g, pad)
    even = torch.arange(0, 2 * n, 2, device=g.device)
    taps = [gp.index_select(dim, even + k) for k in range(4)]
    shape = [1] * g.dim()
    shape[dim] = n
    w1 = torch.full((n,), 0.75, dtype=g.dtype, device=g.device)
    w2 = w1.clone()
    w1[0] = 1.0
    w2[-1] = 1.0
    w1, w2 = w1.reshape(shape), w2.reshape(shape)
    return 0.25 * taps[0] + w1 * taps[1] + w2 * taps[2] + 0.25 * taps[3]


def upsample2x_backward_reference(dy: torch.Tensor) -> torch.Tensor:
    """(B, C, 2H, 2W) → (B, C, H, W) in ``dy``'s dtype: the gather sum of
    the backward, over W and then over H, in fp32."""
    return _down_axis(_down_axis(dy.float(), 3), 2).to(dy.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    lib = _build.load("upsample")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    for fn in (lib.betavae_upsample2x_fwd, lib.betavae_upsample2x_bwd):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.betavae_upsample_path.argtypes = [ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int64]
    lib.betavae_upsample_path.restype = ctypes.c_int
    return lib


def _vector_width(dtype: torch.dtype) -> int:
    """Values in 16 bytes: a vector-path thread's columns."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"upsample kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    return 16 // (2 if dtype == torch.bfloat16 else 4)


def upsample_path(shape, dtype: torch.dtype, ptr_alignment: int) -> str:
    """The path the kernels take for ``x`` (forward) or ``dx`` (backward)
    of ``shape`` ``[B, C, H, W]`` and ``dtype``, where both pointers are
    aligned to ``ptr_alignment`` bytes: ``"vector"`` where a row is 1, 2,
    4, 8, 16 or 32 units of 16 bytes (8 bf16 or 4 fp32 values: every row
    then starts on a 16-byte boundary and a warp holds whole rows), both
    pointers are 16-byte aligned and ``B·C·H·(W / 16 bytes)``, which bounds
    the thread count, is under 2³¹; else ``"generic"``.
    ``betavae_upsample_path`` in ``csrc/upsample.cu`` states the same
    rule."""
    b, c, h, w = shape
    v = _vector_width(dtype)
    groups = w // v
    if (ptr_alignment % 16 == 0 and min(b * c, h, w) > 0 and w % v == 0
            and groups <= 32 and groups & (groups - 1) == 0
            and b * c * h * groups < 2**31):
        return "vector"
    return "generic"


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two, up to 16, dividing every data pointer."""
    return min(16, *(t.data_ptr() & -t.data_ptr() for t in tensors))


def _fast_div(d: int) -> tuple[int, int]:
    """``(m, s)`` of ``fast_div`` in ``csrc/upsample.cu``: ``n // d ==
    ((n·m >> 32) + n) >> s`` for ``0 ≤ n < 2³¹``."""
    s = (d - 1).bit_length()
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def _div_by(n: np.ndarray, d: int) -> np.ndarray:
    m, s = _fast_div(d)
    return ((n * m >> 32) + n) >> s


def vector_tiling(shape, dtype: torch.dtype, backward: bool = False,
                  items: slice | None = None) -> dict:
    """A numpy mirror of the vector kernels' index map (``locate``, the
    kernels and the forward's staged runs in ``csrc/upsample.cu``, the
    magic-number divisions included) for the forward of ``x`` or the
    backward to ``dx`` of ``shape`` ``[B, C, H, W]``, over the items
    ``items`` (default all; a slice of whole warps).  Item ``n`` is thread
    ``n % 256`` of CTA ``n // 256``.  Returns, one row an item: ``cta``,
    ``thread``, ``plane``; ``computed``, the output's 16-byte chunks
    (flat indices, −1 padding) whose values the thread computes (the
    forward stages them in shared memory, the backward stores them);
    ``stored``, the chunks it stores to device memory (the forward: chunks
    ``l, l + 32, …`` of its warp's run, lane ``l``); and the rows
    ``[in_row0, in_row1]`` and columns ``[in_col0, in_col1]`` of its plane
    of the input that it loads (the values left and right of its columns
    come from its neighbouring lanes' loads).  ``items_total`` is the
    grid's item count, ``ctas`` its CTAs."""
    b, c, h, w = shape
    v = _vector_width(dtype)
    band = _BWD_BAND if backward else _FWD_BAND
    groups, bands = w // v, -(-h // band)
    total = b * c * bands * groups
    ctas = -(-total // _THREADS)
    sl = items or slice(0, ctas * _THREADS)
    t = np.arange(sl.start, sl.stop, dtype=np.int64)
    active = t < total
    n = np.minimum(t, total - 1)
    rest = _div_by(n, groups)
    g = n - rest * groups
    plane = _div_by(rest, bands)
    row0 = (rest - plane * bands) * band
    col0 = g * v
    # output rows 2i, 2i+1 (forward) or dx row i (backward) of each of the
    # band's rows inside the plane, each as its 16-byte chunks
    r = np.arange(band)
    rows = row0[:, None] + r
    live = active[:, None] & (rows < h)
    if backward:
        out_w = w // v
        chunk = (plane[:, None] * h + rows) * out_w + g[:, None]
        computed = np.where(live, chunk, -1)
        stored = computed
        in_rows = (np.clip(2 * row0 - 1, 0, 2 * h - 1),
                   np.clip(2 * row0 + 2 * band, 0, 2 * h - 1))
        in_cols = (2 * col0, 2 * col0 + 2 * v - 1)
    else:
        out_w = 2 * w // v
        even = (plane[:, None] * 2 * h + 2 * rows) * out_w + 2 * g[:, None]
        chunk = np.stack([even, even + 1, even + out_w, even + out_w + 1],
                         axis=2).reshape(len(t), 4 * band)
        computed = np.where(np.repeat(live, 4, axis=1), chunk, -1)
        # a warp's run: from lane 0's first chunk to the end of its last
        # computed one; lane l stores chunks l, l + 32, ... of it
        warp = computed.reshape(-1, 32, 4 * band)
        base = np.repeat(warp[:, 0, 0], 32)[:, None]
        end = np.repeat(warp.max(axis=(1, 2)) + 1, 32)[:, None]
        mine = base + (t % 32)[:, None] + 32 * np.arange(band * 4)
        stored = np.where((base >= 0) & (mine < end), mine, -1)
        in_rows = (np.clip(row0 - 1, 0, h - 1),
                   np.clip(row0 + band, 0, h - 1))
        in_cols = (col0, col0 + v - 1)
    return {"cta": t // _THREADS, "thread": t % _THREADS, "plane": plane,
            "computed": computed, "stored": stored,
            "in_row0": in_rows[0], "in_row1": in_rows[1],
            "in_col0": in_cols[0], "in_col1": in_cols[1],
            "items_total": total, "ctas": ctas}


def _launch(src: torch.Tensor, backward: bool,
            path: str | None = None) -> torch.Tensor:
    """One kernel launch for contiguous CUDA ``src`` (``x``, or ``dy`` with
    ``backward``) into a new output, on the path :func:`upsample_path`
    gives, or on ``path`` where a caller forces one (the vector path only
    where the rule allows it: the kernel refuses it otherwise).  Counts the
    launch on its wrapper, by path."""
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"upsample kernel takes float32 or bfloat16, got "
                        f"{src.dtype}")
    if src.device.index != torch.cuda.current_device():
        with torch.cuda.device(src.device):
            return _launch(src, backward, path)
    b, c, h, w = src.shape
    if backward:
        h, w = h // 2, w // 2
        out = src.new_empty((b, c, h, w))
    else:
        out = src.new_empty((b, c, 2 * h, 2 * w))
    if path is None:
        path = upsample_path((b, c, h, w), src.dtype, _alignment(src, out))
    entry = "betavae_upsample2x_bwd" if backward else "betavae_upsample2x_fwd"
    rc = getattr(_library(), entry)(
        src.data_ptr(), out.data_ptr(), b * c, h, w, _DTYPE_CODES[src.dtype],
        _PATH_CODES[path], raw_stream(src.device))
    if rc != 0:
        raise RuntimeError(f"upsample kernel {entry} ({path} path) failed "
                           f"with CUDA error {rc}")
    wrapper = _WRAPPERS[backward]
    wrapper.launches += 1
    wrapper.launches_by_path[path] += 1
    return out


def _device(t: torch.Tensor) -> str:
    if t.dim() != 4:
        raise ValueError(f"upsample takes (B, C, H, W), got {tuple(t.shape)}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def upsample2x_forward(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), without autograd: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if _device(x) == "cpu":
        return upsample2x_reference(x)
    return _launch(x.contiguous(), backward=False)


upsample2x_forward.launches = 0
upsample2x_forward.launches_by_path = {"vector": 0, "generic": 0}


def upsample2x_backward(dy: torch.Tensor) -> torch.Tensor:
    """(B, C, 2H, 2W) → (B, C, H, W), the gather backward: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if _device(dy) == "cpu":
        return upsample2x_backward_reference(dy)
    if dy.shape[2] % 2 or dy.shape[3] % 2:
        raise ValueError(f"upsample backward takes even H and W, got "
                         f"{tuple(dy.shape)}")
    return _launch(dy.contiguous(), backward=True)


upsample2x_backward.launches = 0
upsample2x_backward.launches_by_path = {"vector": 0, "generic": 0}
# the counted wrappers by direction, as defined here (a caller may patch
# the module's names)
_WRAPPERS = (upsample2x_forward, upsample2x_backward)


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return upsample2x_forward(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_backward(g)


def bilinear_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), in ``x``'s dtype.  Autocast would
    upcast a bf16 input to fp32; the JAX decoder upsamples in its compute
    dtype, so autocast is off here."""
    with torch.autocast(x.device.type, enabled=False):
        return _Upsample2x.apply(x)


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilinear_upsample_x2(x)
