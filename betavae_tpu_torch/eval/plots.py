"""PIL drawing for the evaluation figures.

The JAX package draws its figures with matplotlib, which the port's
runtime does not carry (torch, numpy, scipy and PIL only).  This module
holds what the port's figures share: class colours (matplotlib's default
blue/red pair for binary labels, tab10 for multiclass), the diverging
``RdBu_r`` colormap, :class:`Axes` (a data rectangle with ticks, a title,
and points, polygons, solid or dashed polylines in data coordinates and a
legend) and image panels.  Text uses
PIL's default font.
"""

from __future__ import annotations

import functools

import numpy as np
from PIL import Image, ImageDraw, ImageFont

BINARY_COLORS = ("#1f77b4", "#d62728")
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
# matplotlib's RdBu_r at -1, -0.5, 0, 0.5, 1
_RDBU_R = np.array([(5, 48, 97), (67, 147, 195), (247, 247, 247),
                    (214, 96, 77), (103, 0, 31)], np.float64)


@functools.cache
def font():
    return ImageFont.load_default()


def text_size(draw: ImageDraw.ImageDraw, s: str) -> tuple:
    x0, y0, x1, y1 = draw.textbbox((0, 0), s, font=font())
    return x1 - x0, y1 - y0


def centered_text(draw: ImageDraw.ImageDraw, center: tuple, s: str,
                  fill="black") -> None:
    w, h = text_size(draw, s)
    draw.text((center[0] - w / 2, center[1] - h / 2), s, fill=fill,
              font=font())


def rdbu_r(values: np.ndarray) -> np.ndarray:
    """``uint8 [..., 3]`` colours of ``values`` in [-1, 1]."""
    v = np.clip(np.asarray(values, np.float64), -1.0, 1.0)
    knots = np.linspace(-1.0, 1.0, len(_RDBU_R))
    rgb = [np.interp(v, knots, _RDBU_R[:, ch]) for ch in range(3)]
    return np.stack(rgb, axis=-1).round().astype(np.uint8)


def nice_ticks(lo: float, hi: float, count: int = 5) -> np.ndarray:
    """About ``count`` round tick values inside ``[lo, hi]``."""
    if not hi > lo:
        return np.array([lo])
    raw = (hi - lo) / count
    mag = 10.0 ** np.floor(np.log10(raw))
    step = mag * min((m for m in (1, 2, 5, 10) if m * mag >= raw))
    return np.arange(np.ceil(lo / step), np.floor(hi / step) + 1) * step


class Axes:
    """Data limits ``xlim × ylim`` drawn into the pixel box ``(x0, y0, x1,
    y1)`` of ``draw``, y up."""

    def __init__(self, draw: ImageDraw.ImageDraw, box: tuple, xlim: tuple,
                 ylim: tuple, title: str | None = None):
        self.draw, self.box = draw, box
        self.xlim, self.ylim = xlim, ylim
        draw.rectangle(box, outline="black")
        if title:
            centered_text(draw, ((box[0] + box[2]) / 2, box[1] - 10), title)

    def px(self, x, y):
        (x0, y0, x1, y1), (a, b), (c, d) = self.box, self.xlim, self.ylim
        u = x0 + (np.asarray(x, np.float64) - a) / ((b - a) or 1.0) * (x1 - x0)
        v = y1 - (np.asarray(y, np.float64) - c) / ((d - c) or 1.0) * (y1 - y0)
        return u, v

    def xticks(self, values, labels=None) -> None:
        labels = labels if labels is not None else [f"{v:g}" for v in values]
        for val, lab in zip(values, labels):
            u, _ = self.px(val, self.ylim[0])
            y1 = self.box[3]
            self.draw.line([(u, y1), (u, y1 + 4)], fill="black")
            centered_text(self.draw, (u, y1 + 12), str(lab))

    def yticks(self, values, labels=None) -> None:
        labels = labels if labels is not None else [f"{v:g}" for v in values]
        for val, lab in zip(values, labels):
            _, v = self.px(self.xlim[0], val)
            x0 = self.box[0]
            self.draw.line([(x0 - 4, v), (x0, v)], fill="black")
            w, h = text_size(self.draw, str(lab))
            self.draw.text((x0 - 7 - w, v - h / 2), str(lab), fill="black",
                           font=font())

    def points(self, xs, ys, color, radius: float = 2.5) -> None:
        us, vs = self.px(xs, ys)
        for u, v in zip(np.atleast_1d(us), np.atleast_1d(vs)):
            self.draw.ellipse([u - radius, v - radius, u + radius, v + radius],
                              fill=color)

    def polygon(self, xs, ys, color) -> None:
        us, vs = self.px(xs, ys)
        self.draw.polygon(list(zip(us.tolist(), vs.tolist())), fill=color,
                          outline="black")

    def line(self, xs, ys, color, dashed: bool = False,
             width: int = 2) -> None:
        """A polyline through ``(xs, ys)``, broken where a value is NaN (as
        matplotlib breaks one); ``dashed`` draws 8 px on, 5 off."""
        us, vs = self.px(xs, ys)
        runs, run = [], []
        for u, v in zip(np.atleast_1d(us).tolist(), np.atleast_1d(vs).tolist()):
            if np.isfinite(u) and np.isfinite(v):
                run.append((u, v))
            elif run:
                runs.append(run)
                run = []
        runs.append(run)
        for pts in runs:
            if len(pts) > 1 and not dashed:
                self.draw.line(pts, fill=color, width=width)
            elif len(pts) > 1:
                _dashes(self.draw, pts, color, width)

    def legend(self, entries) -> None:
        """``(label, color, dashed)`` entries in a box at the upper right."""
        rows = [text_size(self.draw, label) for label, _, _ in entries]
        w = 40 + max(tw for tw, _ in rows)
        h = 8 + 18 * len(entries)
        x1, y0 = self.box[2] - 8, self.box[1] + 8
        self.draw.rectangle((x1 - w, y0, x1, y0 + h), fill="white",
                            outline="#cccccc")
        for i, (label, color, dashed) in enumerate(entries):
            y = y0 + 13 + 18 * i
            pts = [(x1 - w + 6, y), (x1 - w + 30, y)]
            if dashed:
                _dashes(self.draw, pts, color, 2)
            else:
                self.draw.line(pts, fill=color, width=2)
            self.draw.text((x1 - w + 34, y - rows[i][1] / 2 - 1), label,
                           fill="black", font=font())


def _dashes(draw: ImageDraw.ImageDraw, pts: list, color, width: int,
            on: float = 8.0, off: float = 5.0) -> None:
    """A dashed polyline through pixel points, its pattern running on
    across the corners."""
    phase = 0.0
    for (u0, v0), (u1, v1) in zip(pts, pts[1:]):
        seg = float(np.hypot(u1 - u0, v1 - v0))
        t = 0.0
        while t < seg:
            pos = phase % (on + off)
            step = min((on - pos) if pos < on else (on + off - pos), seg - t)
            if pos < on:
                a, b = t / seg, (t + step) / seg
                draw.line([(u0 + a * (u1 - u0), v0 + a * (v1 - v0)),
                           (u0 + b * (u1 - u0), v0 + b * (v1 - v0))],
                          fill=color, width=width)
            t += step
            phase += step


def image_panel(img: np.ndarray, size: int) -> Image.Image:
    """An ``[H, W, C]`` image in [0, 1] as a ``size`` × ``size`` RGB
    panel (grayscale for one channel)."""
    arr = np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255)
    arr = arr.astype(np.uint8)
    im = Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr)
    return im.convert("RGB").resize((size, size), Image.NEAREST)
