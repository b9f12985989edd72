"""Input pipeline: the split on the card, or fed from the host, + batching.

Counterpart of ``betavae_tpu/data/pipeline.py``: the packed uint8 split is
uploaded to the device once; each step gathers its batch with an on-device
``index_select`` and converts it to float [0, 1] NCHW.  A split over the
device budget (``training.max_device_dataset_mb``) stays in host memory
instead (``host_feed``): each batch is gathered on the host into a pinned
staging buffer and copied to the card on a side stream, up to
``host_feed_chunk_limit`` batches ahead of the step that reads it, and the
step gathers that batch with ``arange(B)``, so the two modes give the same
numbers.  ``BatchPlan`` gives the seeded per-epoch order and pads the last
short batch with repeated indices plus a validity mask, as the JAX package
does.  A data-parallel rank feeds its rows of each batch: with the split
resident it gathers them from its own whole copy (the JAX mesh replicates
the split), and fed from the host it stages only those rows.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from .dataset import ArrayDataset


def host_feed_chunk_limit(batch_size: int, image_shape,
                          budget_mb: float) -> int:
    """How many batches of ``image_shape`` uint8 images fit ``budget_mb``
    (``training.host_feed_chunk_mb``), at least 1: the JAX package's
    largest scan chunk for a host-fed dispatch, and here the depth to which
    batches are staged ahead of the step.  Neither changes a result."""
    bytes_per_step = int(batch_size) * int(np.prod(image_shape))
    return max(1, int(budget_mb * 1024 * 1024) // max(1, bytes_per_step))


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


@dataclass
class _Slot:
    """A pinned staging buffer and the event of its last copy to the card."""

    host: torch.Tensor
    copied: torch.cuda.Event | None = None


@dataclass
class DeviceData:
    """A split for ``device``: uint8 ``(N, H, W, C)`` images resident on it,
    or, with ``host_feed``, the host array they are fed from ``depth``
    batches ahead; the labels stay on the host, where only probes read
    them."""

    images: torch.Tensor | np.ndarray
    labels: np.ndarray
    device: torch.device
    host_feed: bool = False
    depth: int = 1
    _slots: list = field(default_factory=list, repr=False)
    _copy_stream: torch.cuda.Stream | None = field(default=None, repr=False)

    @classmethod
    def from_dataset(cls, ds: ArrayDataset, device: torch.device,
                     max_device_bytes: int | None = None,
                     depth: int = 1) -> "DeviceData":
        labels = ds.labels.astype(np.int32)
        images = np.ascontiguousarray(ds.images)
        if max_device_bytes is not None and images.nbytes > max_device_bytes:
            return cls(images=images, labels=labels, device=device,
                       host_feed=True, depth=max(1, int(depth)))
        return cls(images=_upload(images, device), labels=labels,
                   device=device)

    def feed(self, batches, rows: slice | None = None):
        """``(images, idx, mask)`` on the device for each ``(idx, mask)``
        numpy pair of ``batches``, for ``gather_batch(images, idx)``: the
        resident split and the uploaded indices, or with ``host_feed`` the
        batch itself and ``arange(B)``.  With ``rows`` (a data-parallel
        rank's), only those rows of each batch."""
        if rows is not None:
            batches = [(idx[rows], mask[rows]) for idx, mask in batches]
        if not self.host_feed:
            for idx, mask in batches:
                yield (self.images, _upload(idx.astype(np.int64), self.device),
                       _upload(mask, self.device))
            return
        batches = list(batches)
        depth = min(self.depth, len(batches))
        staged = collections.deque()
        ahead = 0
        for k in range(len(batches)):
            while ahead < min(len(batches), k + 1 + depth):
                staged.append(self._stage(*batches[ahead], ring=depth + 1))
                ahead += 1
            x, copied, idx, mask = staged.popleft()
            if copied is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(copied)
                # the copy stream allocated x: keep its memory from being
                # reused while this stream's step still reads it
                x.record_stream(stream)
            yield x, idx, mask

    def _stage(self, idx: np.ndarray, mask: np.ndarray, ring: int):
        """Start ``images[idx]``'s trip to the card: ``(x, event or None,
        arange(B), mask)``.  On a CUDA device the gather lands in the next
        pinned buffer of a ring of at least ``ring`` (waiting first for that
        buffer's last copy to leave it) and is copied on a side stream."""
        arange = _upload(np.arange(len(idx), dtype=np.int64), self.device)
        mask = _upload(mask, self.device)
        if self.device.type != "cuda":
            return torch.from_numpy(self.images[idx]), None, arange, mask
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        while len(self._slots) < ring:
            self._slots.append(_Slot(torch.empty(
                (len(idx),) + self.images.shape[1:], dtype=torch.uint8,
                pin_memory=True)))
        slot = self._slots.pop(0)
        self._slots.append(slot)
        if slot.copied is not None:
            slot.copied.synchronize()
        np.take(self.images, idx, axis=0, out=slot.host.numpy())
        with torch.cuda.stream(self._copy_stream):
            x = slot.host.to(self.device, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._copy_stream)
        return x, slot.copied, arange, mask


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
