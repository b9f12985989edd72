"""The packed-dataset decoder (``csrc/packer.cpp``) through ``ctypes``.

The port's copy of the JAX package's loader (``betavae_tpu/native/
__init__.py``): multithreaded libpng/libjpeg decode straight into the
packed uint8 ``(N, H, W, C)`` array, built with the host's ``g++`` at
first use (:func:`.._build.load_host`, into ``build/kernels/``).  Where it
cannot build or load, :func:`available` is False and :func:`pack_images`
returns None, and the caller decodes with PIL, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from .. import _build

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = _build.load_host("packer")
        except (OSError, RuntimeError, subprocess.TimeoutExpired):
            return None
        lib.bv_pack_images.restype = ctypes.c_int
        lib.bv_pack_images.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def pack_images(paths, size: int, channels: int,
                n_threads: int = 0) -> np.ndarray | None:
    """Decode ``paths`` into a packed uint8 ``(N, size, size, channels)``
    array (``n_threads`` 0: one thread a core).  None when the library is
    unavailable or any image fails to decode."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, channels), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    err_index = ctypes.c_int(-1)
    errors = lib.bv_pack_images(
        arr, n, size, channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        int(n_threads), ctypes.byref(err_index))
    if errors:
        return None
    return out
