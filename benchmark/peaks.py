"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet: dense bf16/fp16 tensor-core rate and HBM3
bandwidth, at the full 700 W power limit.  ``torch.cuda.get_device_name()``
of that part is ``NVIDIA H100 80GB HBM3``.  A card this table does not know
gets no roofline or utilisation: its metrics are left out of the line.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def of(kind: str):
    return PEAKS.get(kind)
