"""Device resolution (CUDA by default, the CPU only when asked for by
name) and the cuDNN setting under which the trainer's runs replay."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises when CUDA is asked for
    (the default) and no GPU is present.  Nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def raw_stream(device: torch.device) -> int:
    """The current stream's handle on ``device``, for a kernel's C entry.
    ``torch._C._cuda_getCurrentRawStream`` is private, and used because it
    returns the handle without building a ``torch.cuda.Stream``
    (``torch.cuda.current_stream(device).cuda_stream`` took 5–8 µs of host
    time a call on the H100's host, 12–15 % of a GN call;
    ``chip_smoke.py::gn_host_split`` times both)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block, its benchmark
    autotuner off, both put back as found on the way out.  With PyTorch's
    defaults two fp32 backwards of one state on an H100 part by up to ~2e-5
    (``chip_smoke.py`` phase ``cudnn_determinism``), so a run would not
    replay from its seed.  The two attributes are set directly:
    ``torch.backends.cudnn.flags()`` resets every argument it is not given,
    ``enabled`` among them, to False."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
