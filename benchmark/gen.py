"""Everything a run makes from its ``--seed``: weights, images, batch
order, the schedule row.

The same seed gives the same values on the same device.  Weights and images
are made on the run's device, with a ``torch.Generator`` there, in a few
large calls; the batch order on the host with numpy.  Every seed gives the
same sizes: only values and order change.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# streams of one seed, kept apart
WEIGHTS, IMAGES, TEST_IMAGES = 1, 2, 3
IMAGE_BLOCK = 512


def _generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + stream) & (2**63 - 1))
    return gen


def weights(seed: int, params: list, device) -> dict:
    """Kaiming-normal fan-in weights (std √(2 / fan_in)), zero biases,
    GroupNorm scales 1 and shifts 0, for ``params`` of
    ``reference.betavae.parameters``: one normal draw for all weights, on
    ``device``, fp32."""
    kinds = ("conv", "linear")
    total = sum(math.prod(s) for _, s, k in params if k in kinds)
    flat = torch.randn(total, generator=_generator(seed, WEIGHTS, device),
                       device=device)
    out, at = {}, 0
    for name, shape, kind in params:
        if kind in kinds:
            n = math.prod(shape)
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif kind == "gn_weight":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def images(seed: int, n: int, size: int, channels: int, device,
           stream: int = IMAGES) -> torch.Tensor:
    """``n`` uint8 NHWC images: a smooth 8×8 field upsampled to ``size``,
    with a level and a contrast drawn per image and a little pixel noise, so
    that images, and the loss of each, differ widely across a batch."""
    gen = _generator(seed, stream, device)
    out = torch.empty((n, size, size, channels), dtype=torch.uint8,
                      device=device)
    for s in range(0, n, IMAGE_BLOCK):
        b = min(IMAGE_BLOCK, n - s)
        coarse = torch.rand((b, channels, 8, 8), generator=gen, device=device)
        field = F.interpolate(coarse, size=(size, size), mode="bilinear",
                              align_corners=False)
        level = torch.rand((b, 1, 1, 1), generator=gen, device=device)
        amp = torch.rand((b, 1, 1, 1), generator=gen, device=device)
        noise = torch.rand((b, channels, size, size), generator=gen,
                           device=device)
        x = 0.15 + 0.7 * level + amp * 1.2 * (field - 0.5) + 0.1 * (noise - 0.5)
        out[s:s + b] = (x.clamp(0.0, 1.0) * 255.0).round().to(
            torch.uint8).permute(0, 2, 3, 1)
    return out


class Order:
    """Step ``t`` (1-based) takes batch ``(t − 1) mod E`` of epoch
    ``(t − 1) // E``'s permutation of the ``n`` rows, ``E = n // batch``
    whole batches an epoch, so the rows of one epoch's steps all differ."""

    def __init__(self, seed: int, n: int, batch: int):
        if n < batch:
            raise ValueError(f"{n} images hold no batch of {batch}")
        self.seed, self.n, self.batch = int(seed), int(n), int(batch)
        self.per_epoch = self.n // self.batch
        self._epoch, self._perm = None, None

    def rows(self, step: int) -> np.ndarray:
        epoch, j = divmod(int(step) - 1, self.per_epoch)
        if epoch != self._epoch:
            rng = np.random.default_rng([self.seed & (2**63 - 1), epoch])
            self._perm = rng.permutation(self.n).astype(np.int64)
            self._epoch = epoch
        return self._perm[j * self.batch:(j + 1) * self.batch]


def schedule(cfg: dict, epoch: int) -> dict:
    """The schedule row of 1-based ``epoch``: β (constant), the capacity
    ``C_start → C_end`` over its warm-up epochs, the capacity weight, free
    bits 0 (capacity mode) and the cosine learning rate stepped per epoch
    over ``training.epochs``."""
    if cfg["beta_schedule"]["type"] != "constant":
        raise NotImplementedError("only a constant β schedule")
    cap = cfg["loss"]["capacity_schedule"]
    if not cap.get("enabled"):
        raise NotImplementedError("only the capacity objective")
    warm = int(cap.get("warmup_epochs", 0))
    c0, c1 = float(cap["C_start"]), float(cap["C_end"])
    capacity = (c0 + min(1.0, epoch / max(1, warm)) * (c1 - c0)
                if epoch <= warm else c1)
    opt = cfg["optimization"]
    if str(opt["scheduler"]).lower() != "cosine":
        raise NotImplementedError("only the cosine learning rate")
    total = int(cfg["training"]["epochs"])
    t = min(epoch - 1, total)
    lr = 0.5 * float(opt["lr"]) * (1 + math.cos(math.pi * t / total))
    return {"beta": float(cfg["beta_schedule"]["end_beta"]),
            "capacity": capacity,
            "capacity_weight": float(cfg["loss"]["capacity_weight"]),
            "free_bits": 0.0, "lr": lr}


def augmentation(cfg: dict) -> dict:
    a = cfg["augmentation"]
    if not a.get("use_augmentations", False):
        return {"flip": False, "degrees": 0.0, "brightness": 0.0}
    return {"flip": bool(a.get("horizontal_flip")),
            "degrees": float(a.get("rotation_degrees") or 0.0),
            "brightness": float(a.get("brightness") or 0.0)}
