"""Input pipeline: the split on the card, or fed from the host, + batching.

Counterpart of ``betavae_tpu/data/pipeline.py``: the packed uint8 split is
uploaded to the device once; each step gathers its batch with an on-device
``index_select`` and converts it to float [0, 1] NCHW.  A split over the
device budget (``training.max_device_dataset_mb``) stays in host memory
instead (``host_feed``), and is shipped a chunk of steps at a time, as the
JAX loop ships one ``(K, B, H, W, C)`` payload a dispatch: the chunk's
batches are gathered on the host into a pinned buffer (one of two, in
turn) and copied to one static device buffer of ``depth`` batches
(``host_feed_chunk_limit``) in one copy, and step ``j`` of the chunk
gathers rows ``j·b … j·b + b − 1`` of it, so the two modes give the same
numbers.  ``BatchPlan`` gives the seeded per-epoch order and pads the last
short batch with repeated indices plus a validity mask, as the JAX package
does.  A data-parallel rank feeds its rows of each batch: with the split
resident it gathers them from its own whole copy (the JAX mesh replicates
the split), and fed from the host it ships only those rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .dataset import ArrayDataset


def host_feed_chunk_limit(batch_size: int, image_shape,
                          budget_mb: float) -> int:
    """How many batches of ``image_shape`` uint8 images fit ``budget_mb``
    (``training.host_feed_chunk_mb``), at least 1: the JAX package's
    largest scan chunk for a host-fed dispatch, and here too the most steps
    (or validation batches) one upload feeds.  It changes no result."""
    bytes_per_step = int(batch_size) * int(np.prod(image_shape))
    return max(1, int(budget_mb * 1024 * 1024) // max(1, bytes_per_step))


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


@dataclass
class DeviceData:
    """A split for ``device``: uint8 ``(N, H, W, C)`` images resident on it,
    or, with ``host_feed``, the host array they are shipped from, ``depth``
    batches an upload; the labels stay on the host, where only probes read
    them."""

    images: torch.Tensor | np.ndarray
    labels: np.ndarray
    device: torch.device
    host_feed: bool = False
    depth: int = 1
    _source: torch.Tensor | None = field(default=None, repr=False)
    _pinned: list = field(default_factory=list, repr=False)

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

    def source(self, rows: int) -> torch.Tensor:
        """The tensor the steps gather from: the resident split, or with
        ``host_feed`` the static device buffer of ``depth`` batches of
        ``rows`` images (allocated at the first call), which a captured
        step may hold."""
        if not self.host_feed:
            return self.images
        if self._source is None:
            shape = (self.depth * int(rows),) + self.images.shape[1:]
            self._source = torch.empty(shape, dtype=torch.uint8,
                                       device=self.device)
            pin = self.device.type == "cuda"
            self._pinned = [[torch.empty(shape, dtype=torch.uint8,
                                         pin_memory=pin), None]
                            for _ in range(2)]
        return self._source

    def stage(self, idx: list) -> list:
        """Each step's indices into :meth:`source` for the numpy index rows
        ``idx`` (one a step, this rank's rows): the rows themselves when
        the split is resident.  Fed from the host, the steps' images are
        gathered into the next of two pinned buffers (once its last copy
        has left it) and copied to the source in one copy, queued on the
        current stream behind the work already there (the steps that still
        read the source), and step ``j`` reads rows ``j·b … j·b + b − 1``;
        at most ``depth`` steps an upload."""
        if not self.host_feed:
            return list(idx)
        b = len(idx[0])
        if len(idx) > self.depth or any(len(i) != b for i in idx):
            raise ValueError(f"1 to {self.depth} batches of one size an "
                             f"upload, got {[len(i) for i in idx]}")
        source = self.source(b)
        n = len(idx) * b
        slot = self._pinned.pop(0)
        self._pinned.append(slot)
        buf, copied = slot
        if copied is not None:
            copied.synchronize()
        np.take(self.images, np.concatenate(idx), axis=0,
                out=buf[:n].numpy())
        source[:n].copy_(buf[:n], non_blocking=True)
        if self.device.type == "cuda":
            slot[1] = torch.cuda.Event()
            slot[1].record()
        return [np.arange(j * b, (j + 1) * b) for j in range(len(idx))]


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
