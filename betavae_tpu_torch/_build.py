"""Build the sources in ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/lib<name>-<digest>.so`` at the repository root, then loaded
with ``ctypes``.  The digest covers the source, the ``csrc/*.cuh`` headers
the sources share and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  ``build`` starts
one ``nvcc`` per source, all at once, and waits for them together.

``csrc/<name>.cpp`` is host code (the packed-dataset decoder), compiled by
the host's ``g++`` with the JAX package's flags for its own copy
(``betavae_tpu/native/__init__.py``) into the same directory under the same
digest rule: :func:`load_host`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a source's own flags after the source: graph_launch.cu launches a graph
# from a kernel, which takes relocatable device code and the device runtime
NVCC_EXTRA = {"graph_launch": ("-rdc=true", "-lcudadevrt")}

GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lpng", "-ljpeg", "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _digest_path(src: Path, flags) -> Path:
    data = src.read_bytes() + " ".join(flags).encode()
    if src.suffix == ".cu":
        data += b"".join(h.read_bytes()
                         for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(data).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def _nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + NVCC_EXTRA.get(name, ())


def library_path(name: str) -> Path:
    return _digest_path(SRC_DIR / f"{name}.cu", _nvcc_flags(name))


def host_library_path(name: str) -> Path:
    return _digest_path(SRC_DIR / f"{name}.cpp", GXX_FLAGS + GXX_LIBS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every kernel in ``names`` (default: all sources) that has no
    up-to-date library, in parallel.  Returns seconds spent per kernel
    (0.0 where the library was already built); raises on a failed build."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu"), *NVCC_EXTRA.get(name, ())]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output for the built library (``ptxas`` register and
    shared-memory lines included)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_host(name: str) -> None:
    """Compile ``csrc/<name>.cpp`` with ``g++`` unless its library is up to
    date.  Raises ``OSError`` without ``g++`` and ``RuntimeError`` on a
    failed build (no libpng or libjpeg headers)."""
    out = host_library_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    res = subprocess.run(["g++", *GXX_FLAGS, str(SRC_DIR / f"{name}.cpp"),
                          "-o", str(tmp), *GXX_LIBS],
                         capture_output=True, text=True, timeout=120)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"g++ build of {name}.cpp failed (exit "
                           f"{res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cpp``, building it if needed."""
    key = f"{name}.cpp"
    lib = _loaded.get(key)
    if lib is None:
        build_host(name)
        lib = ctypes.CDLL(str(host_library_path(name)))
        _loaded[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
