"""Device-resident input pipeline: the split on the card + index batching.

Counterpart of ``betavae_tpu/data/pipeline.py``: the packed uint8 split is
uploaded to the device once; each step gathers its batch with an on-device
``index_select`` and converts it to float [0, 1] NCHW.  ``BatchPlan`` gives
the seeded per-epoch order and pads the last short batch with repeated
indices plus a validity mask, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .dataset import ArrayDataset


@dataclass
class DeviceData:
    """A split resident on ``images.device``: uint8 ``(N, H, W, C)``
    images; the labels stay on the host, where only probes read them."""

    images: torch.Tensor
    labels: np.ndarray

    @classmethod
    def from_dataset(cls, ds: ArrayDataset, device: torch.device) -> "DeviceData":
        images = torch.from_numpy(np.ascontiguousarray(ds.images)).to(device)
        return cls(images=images, labels=ds.labels.astype(np.int32))


def gather_batch(images: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """uint8 ``(N, H, W, C)`` rows ``idx`` → float ``(B, C, H, W)`` in [0, 1]."""
    x = images.index_select(0, idx)
    return x.permute(0, 3, 1, 2).float().div_(255.0).contiguous()


class BatchPlan:
    """Seeded epoch batching over ``n`` samples with fixed-size padded
    batches: ``batches(epoch)`` yields ``(idx, mask)`` numpy pairs."""

    def __init__(self, n: int, batch_size: int, *, shuffle: bool, seed: int):
        self.n = int(n)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)

    def epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.n, dtype=np.int32)
        if self.shuffle:
            rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + epoch))
            rng.shuffle(order)
        return order

    def batches(self, epoch: int):
        order = self.epoch_order(epoch)
        bs = self.batch_size
        for start in range(0, self.n, bs):
            chunk = order[start:start + bs]
            k = len(chunk)
            if k < bs:
                idx = np.concatenate([chunk, np.resize(chunk, bs - k)])
                mask = np.zeros(bs, dtype=np.float32)
                mask[:k] = 1.0
            else:
                idx = chunk
                mask = np.ones(bs, dtype=np.float32)
            yield idx.astype(np.int32), mask
