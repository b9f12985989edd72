"""The random streams of a training step, worked out again in plain torch.

A frozen copy of the algorithms the program draws with, so that the plain
reference sees the same noise and the same augmentation as the step under
test without taking anything the program made:

- ε of step ``n``: element ``i`` of the flattened ``[batch, latent]`` draw
  is Box–Muller (cosine branch) on words 0 and 1 of Philox4x32-10 with key
  ``seed`` and counter ``(i, n)``;
- the augmentation uniforms of step ``n``: a ``torch.Generator`` on the
  step's device seeded from ``(seed · 1000003 + n) mod 2⁶³``, three
  ``torch.rand(batch)`` rows (flip, angle, brightness), each drawn only when
  its op is on;
- flip (u < 0.5), rotation by U[−deg, deg] about the pixel centre with
  bilinear sampling and zero fill, brightness U[1 − b, 1 + b] clipped to
  [0, 1], in that order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
TWO_PI = 6.283185307179586


def _mulhilo(a: int, x: torch.Tensor):
    """High and low 32-bit words of ``a · x``, ``x`` int64 in [0, 2³²), in
    16-bit halves so that no int64 product overflows."""
    p1 = x * (a >> 16)
    p0 = x * (a & 0xFFFF)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def step_noise(shape, seed: int, step: int, device) -> torch.Tensor:
    """ε of step ``step``, fp32, of ``shape``."""
    n = math.prod(shape)
    seed &= MASK64
    step &= MASK64
    idx = torch.arange(n, dtype=torch.int64, device=device)
    c2 = torch.full_like(idx, step & MASK32)
    c3 = torch.full_like(idx, step >> 32)
    r0, r1, _, _ = philox4x32_10(idx & MASK32, idx >> 32, c2, c3,
                                 seed & MASK32, seed >> 32)
    u1 = torch.clamp_min((r0 >> 8).to(torch.float32) * (1.0 / 16777216.0),
                         1e-7)
    u2 = (r1 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)
    return eps.reshape(shape)


def augment_uniforms(seed: int, step: int, batch: int, aug: dict,
                     device) -> torch.Tensor:
    """The ``[3, batch]`` uniforms of step ``step``; a row whose op is off
    stays 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) & (2**63 - 1))
    out = torch.zeros((3, batch), device=device)
    ons = (aug["flip"], aug["degrees"] > 0, aug["brightness"] > 0)
    for row, on in enumerate(ons):
        if on:
            out[row] = torch.rand(batch, generator=gen, device=device)
    return out


def augment(x: torch.Tensor, u: torch.Tensor, aug: dict) -> torch.Tensor:
    """Flip → rotate → brightness of NCHW fp32 ``x`` by the uniforms ``u``."""
    if aug["flip"]:
        x = torch.where((u[0] < 0.5)[:, None, None, None], x.flip(-1), x)
    if aug["degrees"] > 0:
        r = math.radians(aug["degrees"])
        theta = -r + 2.0 * r * u[1]
        b, _, h, w = x.shape
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy = torch.arange(h, device=x.device, dtype=torch.float32)[:, None] - cy
        xx = torch.arange(w, device=x.device, dtype=torch.float32)[None, :] - cx
        cos = torch.cos(theta)[:, None, None]
        sin = torch.sin(theta)[:, None, None]
        src_y = cos * yy - sin * xx + cy
        src_x = sin * yy + cos * xx + cx
        grid = torch.stack([src_x / (w - 1) * 2.0 - 1.0,
                            src_y / (h - 1) * 2.0 - 1.0], dim=-1)
        x = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
    if aug["brightness"] > 0:
        lo = max(0.0, 1.0 - aug["brightness"])
        hi = 1.0 + aug["brightness"]
        x = torch.clamp(x * (lo + (hi - lo) * u[2])[:, None, None, None],
                        0.0, 1.0)
    return x
