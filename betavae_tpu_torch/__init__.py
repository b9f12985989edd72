"""betavae_tpu_torch — the β-VAE framework on PyTorch and CUDA (NVIDIA Hopper).

A port of ``betavae_tpu`` that mirrors its layout (``models/``, ``ops/``,
``data/``, ``train/``) so each module has a named counterpart there.  The
port imports ``torch`` and never JAX or ``betavae_tpu``; the JAX package is
the reference its tests hold it against.

Tensors are NCHW.  Entry points take an explicit ``device`` that defaults
to ``"cuda"`` and raise where no GPU is present; they run on the CPU only
when the caller passes ``device="cpu"``.  The TPU's Pallas kernels become
hand-written CUDA kernels under ``csrc/``, built at first use by
:mod:`betavae_tpu_torch._build`.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
