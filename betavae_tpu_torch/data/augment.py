"""On-device data augmentation over NCHW batches.

Counterpart of ``betavae_tpu/data/augment.py``: horizontal flip (p = 0.5),
rotation by U[−deg, +deg], brightness factor U[max(0, 1−b), 1+b] with a
clip to [0, 1], applied in that order and each gated by the
``augmentation`` config.  Rotation samples bilinearly with zero fill about
the pixel centre ``(H−1)/2``: the semantics of ``rotate_exact``, done
directly (the JAX package's 3-shear form is a TPU workaround).

Random draws come from an explicit ``torch.Generator``; each op also takes
its draws (flip mask, angles, factors) so tests can feed JAX the same ones.
:func:`draw_augment` draws a batch's uniforms apart from their use and
:func:`apply_augment` applies them, so the trainers draw a chunk's ahead
on the card and a captured step applies its own (``train/chunks.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the images where the boolean ``flip`` (B,) is set."""
    return torch.where(flip[:, None, None, None], x.flip(-1), x)


def rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate each image by ``angles`` (B,) radians: output pixel (y, x)
    samples the source at ``R(θ)·(y−cy, x−cx) + (cy, cx)`` bilinearly, zero
    outside."""
    b, _, h, w = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, device=x.device, dtype=torch.float32)[:, None] - cy
    xx = torch.arange(w, device=x.device, dtype=torch.float32)[None, :] - cx
    cos = torch.cos(angles)[:, None, None]
    sin = torch.sin(angles)[:, None, None]
    src_y = cos * yy - sin * xx + cy
    src_x = sin * yy + cos * xx + cx
    # grid_sample with align_corners=True maps -1 and 1 onto the centres of
    # the first and last pixels
    grid = torch.stack([src_x / (w - 1) * 2.0 - 1.0,
                        src_y / (h - 1) * 2.0 - 1.0], dim=-1)
    return F.grid_sample(x, grid.to(x.dtype), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def brightness(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * factors[:, None, None, None], 0.0, 1.0)


def draw_augment(generator: torch.Generator, batch: int, *,
                 use_flip: bool = True, degrees: float = 0.0,
                 brightness_range: float = 0.0,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The uniforms :func:`augment_batch` draws from ``generator`` for a
    batch of ``batch``, in its order (flip, angle, brightness, each only
    when its op is on), as rows 0, 1 and 2 of a float ``[3, batch]`` on the
    generator's device (``out``, when given); a row whose op is off is
    left as it was (zeros in a fresh tensor)."""
    if out is None:
        out = torch.zeros((3, batch), device=generator.device)
    ons = (use_flip, bool(degrees and degrees > 0),
           bool(brightness_range and brightness_range > 0))
    for row, on in enumerate(ons):
        if on:
            torch.rand(batch, generator=generator, device=out.device,
                       out=out[row])
    return out


def apply_augment(x: torch.Tensor, draws: torch.Tensor, *,
                  use_flip: bool = True, degrees: float = 0.0,
                  brightness_range: float = 0.0,
                  rows: slice | None = None) -> torch.Tensor:
    """Flip → rotate → brightness of ``x`` from ``draws``, the ``[3, B]``
    uniforms of :func:`draw_augment`: with ``rows``, ``x`` is those rows of
    the batch of B the draws are for."""
    take = slice(None) if rows is None else rows

    def uniform(row: int, lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * draws[row][take]

    if use_flip:
        x = hflip(x, uniform(0, 0.0, 1.0) < 0.5)
    if degrees and degrees > 0:
        max_rad = math.radians(float(degrees))
        x = rotate(x, uniform(1, -max_rad, max_rad))
    if brightness_range and brightness_range > 0:
        x = brightness(x, uniform(2, max(0.0, 1.0 - brightness_range),
                                  1.0 + brightness_range))
    return x


def augment_batch(x: torch.Tensor, generator: torch.Generator, *,
                  use_flip: bool = True, degrees: float = 0.0,
                  brightness_range: float = 0.0, rows: slice | None = None,
                  global_batch: int | None = None) -> torch.Tensor:
    """Flip → rotate → brightness, with every draw taken from ``generator``
    (which must live on ``x``'s device).  With ``rows``, ``x`` is those rows
    of a batch of ``global_batch`` (a data-parallel rank's share): each op
    draws its values for the whole batch and applies the rows', so the
    rank's images are bitwise those rows of the single-process batch."""
    kw = {"use_flip": use_flip, "degrees": degrees,
          "brightness_range": brightness_range}
    b = x.shape[0] if rows is None else int(global_batch)
    return apply_augment(x, draw_augment(generator, b, **kw), rows=rows, **kw)


def augment_config_kwargs(cfg) -> dict:
    """Keyword arguments for :func:`augment_batch` from ``augmentation``."""
    a = cfg.augmentation
    if not a.use_augmentations:
        return {"use_flip": False, "degrees": 0.0, "brightness_range": 0.0}
    return {
        "use_flip": bool(a.horizontal_flip),
        "degrees": float(a.rotation_degrees or 0.0),
        "brightness_range": float(a.brightness or 0.0),
    }
