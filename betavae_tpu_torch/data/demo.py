"""Seeded synthetic MRI stand-in: four separable grayscale classes.

The port's own copy of ``betavae_tpu/data/demo.py``, numerically identical
(same per-class recipes, train seed 0 / test seed 1), so both packages
train on the same demo bytes.  Writes
``processed/{train,test}/<class>/<class>_<i>.png``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CLASSES = ("glioma", "meningioma", "pituitary", "notumor")


def make_canvas(rng: np.random.Generator, size: int, base_level=0.3,
                noise=0.05):
    return np.clip(rng.normal(base_level, noise, size=(size, size)), 0, 1)


def _disk_mask(size: int) -> np.ndarray:
    yy, xx = np.mgrid[:size, :size]
    r2 = (xx - size // 2) ** 2 + (yy - size // 2) ** 2
    return r2 <= (size // 4) ** 2


def _band_mask(size: int) -> np.ndarray:
    yy = np.mgrid[:size, :size][0]
    return (yy % (size // 8)) < (size // 16)


def _hatch_mask(size: int) -> np.ndarray:
    yy, xx = np.mgrid[:size, :size]
    period, width = size // 6, size // 16
    return (((xx + yy) % period) < width) | (((xx - yy) % period) < width)


_OVERLAYS = {
    "glioma": (_disk_mask, 0.35),
    "meningioma": (_band_mask, 0.25),
    "pituitary": (_hatch_mask, 0.25),
}


def pattern_for_class(cls: str, rng: np.random.Generator,
                      size: int) -> np.ndarray:
    arr = make_canvas(rng, size, 0.25, 0.08)
    if cls in _OVERLAYS:
        build, lift = _OVERLAYS[cls]
        arr = arr + lift * build(size)
    else:  # notumor: texture only
        arr = arr + rng.normal(0.0, 0.02, size=arr.shape)
    return np.clip(arr, 0, 1)


def write_split(proc_root, split: str, classes, per_class: int, size: int,
                seed: int):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls in classes:
        out_dir = Path(proc_root) / split / cls
        out_dir.mkdir(parents=True, exist_ok=True)
        for idx in range(per_class):
            sample = pattern_for_class(cls, rng, size)
            as_u8 = (sample * 255).astype(np.uint8)  # truncating, as the JAX package
            Image.fromarray(as_u8, mode="L").save(out_dir / f"{cls}_{idx}.png")


def generate_demo_data(proc_root, train_subdir="train", test_subdir="test",
                       train_per_class=24, test_per_class=12, size=128,
                       classes=CLASSES):
    write_split(proc_root, train_subdir, classes, train_per_class, size,
                seed=0)
    write_split(proc_root, test_subdir, classes, test_per_class, size,
                seed=1)
    return Path(proc_root)
