"""Device resolution: CUDA by default, the CPU only when asked for by name."""

from __future__ import annotations

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
