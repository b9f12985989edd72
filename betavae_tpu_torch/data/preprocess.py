"""Raw → processed preprocessing: split or copy, resize, normalise, verify.

The port's own copy of ``betavae_tpu/data/preprocess.py``, PIL and numpy
only, writing the same files byte for byte:

- :func:`split_from_raw` / :func:`verify_processed`: a pre-split
  ``Training|train`` / ``Testing|test|validation|val`` tree is copied
  through; otherwise each class folder under ``paths.raw_dir`` is shuffled
  in ``os.listdir`` order by one ``random.Random(data.seed)`` (classes in
  listing order too) and split at ``floor(n · data.train_ratio)``, the
  ratio 0.8 where the config has none;
- :func:`compute_global_stats` / :func:`normalize_and_resize` /
  :func:`preprocess_dataset`: in-place resize to ``data.image_size``, with
  ``minmax`` (resize only) or ``global_z`` (the train split's pixel mean
  and std, then a per-image min-max back to uint8); the statistics go to
  ``data/intermediate/norm_stats.json`` under the working directory.

A one-time host pipeline: the trainer reads its output through
``data/dataset.py``.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from math import floor

import numpy as np

from ..config import get_config
from ..io.artifacts import ensure_dirs
from .dataset import load_image

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _find_presplit_dirs(raw_root: str):
    subs = [d for d in os.listdir(raw_root)
            if os.path.isdir(os.path.join(raw_root, d))]
    train_dir = test_dir = None
    for s in subs:
        if s.lower() in ("training", "train"):
            train_dir = os.path.join(raw_root, s)
        if s.lower() in ("testing", "test", "validation", "val"):
            test_dir = os.path.join(raw_root, s)
    if train_dir and test_dir:
        return train_dir, test_dir
    return None, None


def _copy_class_split(src_split_dir: str, dst_split_dir: str) -> None:
    for cls in os.listdir(src_split_dir):
        cls_src = os.path.join(src_split_dir, cls)
        if not os.path.isdir(cls_src):
            continue
        cls_dst = os.path.join(dst_split_dir, cls)
        os.makedirs(cls_dst, exist_ok=True)
        for f in os.listdir(cls_src):
            if f.lower().endswith(IMAGE_EXTS):
                shutil.copy2(os.path.join(cls_src, f), os.path.join(cls_dst, f))


def split_from_raw(overwrite: bool = False) -> None:
    """Fill ``processed/{train,test}`` from the raw tree; a no-op where
    either split exists, unless ``overwrite`` (which removes the processed
    tree first)."""
    cfg = get_config()
    raw = cfg.paths.raw_dir
    proc = cfg.paths.processed_dir
    train_dir = os.path.join(proc, cfg.data.train_subdir)
    test_dir = os.path.join(proc, cfg.data.test_subdir)

    if (os.path.exists(train_dir) or os.path.exists(test_dir)) and not overwrite:
        return
    if overwrite and os.path.isdir(proc):
        shutil.rmtree(proc)

    pre_train, pre_test = _find_presplit_dirs(raw)
    if pre_train and pre_test:
        os.makedirs(train_dir, exist_ok=True)
        os.makedirs(test_dir, exist_ok=True)
        _copy_class_split(pre_train, train_dir)
        _copy_class_split(pre_test, test_dir)
        return

    classes = [c for c in os.listdir(raw) if os.path.isdir(os.path.join(raw, c))]
    train_ratio = getattr(cfg.data, "train_ratio", 0.8)
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    rng = random.Random(cfg.data.seed)
    for cls in classes:
        cls_raw = os.path.join(raw, cls)
        files = [f for f in os.listdir(cls_raw) if f.lower().endswith(IMAGE_EXTS)]
        rng.shuffle(files)
        n_train = floor(len(files) * train_ratio)
        for split_dir, names in ((train_dir, files[:n_train]),
                                 (test_dir, files[n_train:])):
            tgt = os.path.join(split_dir, cls)
            os.makedirs(tgt, exist_ok=True)
            for f in names:
                shutil.copy2(os.path.join(cls_raw, f), os.path.join(tgt, f))


def verify_processed() -> bool:
    """Both split directories exist and hold class folders; raises
    otherwise."""
    cfg = get_config()
    for sub in (cfg.data.train_subdir, cfg.data.test_subdir):
        d = os.path.join(cfg.paths.processed_dir, sub)
        if not os.path.isdir(d):
            raise RuntimeError(f"Missing split directory {d}")
        classes = [c for c in os.listdir(d) if os.path.isdir(os.path.join(d, c))]
        if len(classes) == 0:
            raise RuntimeError(f"No class folders in {d}")
    return True


def _gather_image_paths(root: str) -> list:
    out = []
    for cls in sorted(os.listdir(root)):
        cpath = os.path.join(root, cls)
        if not os.path.isdir(cpath):
            continue
        for f in os.listdir(cpath):
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(cpath, f))
    return out


def compute_global_stats(split_dirs, sample_limit=None) -> dict:
    """Pixel mean and std over the resized images of ``split_dirs``,
    summed image by image in float (the JAX copy's order)."""
    cfg = get_config()
    imgs = []
    for d in split_dirs:
        imgs.extend(_gather_image_paths(d))
    if sample_limit is not None:
        imgs = imgs[:sample_limit]
    size = cfg.data.image_size
    s = ss = 0.0
    n = 0
    for p in imgs:
        t = load_image(p, cfg.data.grayscale, size=size)
        s += float(t.sum())
        ss += float((t.astype(np.float64) ** 2).sum())
        n += t.size
    mean = s / n
    std = float(np.sqrt(ss / n - mean**2))
    return {"mean": mean, "std": std}


def normalize_and_resize(split_root: str, stats=None, mode: str = "minmax",
                         overwrite: bool = False) -> None:
    """Resize every image of a split in place; under ``global_z`` with
    ``stats``, z-score it and stretch it back to the full uint8 range."""
    from PIL import Image

    cfg = get_config()
    size = cfg.data.image_size
    for cls in os.listdir(split_root):
        cls_dir = os.path.join(split_root, cls)
        if not os.path.isdir(cls_dir):
            continue
        for f in os.listdir(cls_dir):
            if not f.lower().endswith(IMAGE_EXTS):
                continue
            path = os.path.join(cls_dir, f)
            with Image.open(path) as src:
                im = src.convert("L" if cfg.data.grayscale else "RGB")
            im = im.resize((size, size))
            if mode == "global_z" and stats is not None:
                t = np.asarray(im, dtype=np.float32) / 255.0
                t = (t - stats["mean"]) / (stats["std"] + 1e-8)
                t = (t - t.min()) / (t.max() - t.min() + 1e-8)
                im = Image.fromarray(np.clip(t * 255.0, 0, 255).astype(np.uint8))
            im.save(path)


def write_stats(stats: dict) -> str:
    stats_dir = os.path.join("data", "intermediate")
    os.makedirs(stats_dir, exist_ok=True)
    path = os.path.join(stats_dir, "norm_stats.json")
    with open(path, "w") as f:
        json.dump(stats, f, indent=2)
    return path


def preprocess_dataset(compute_stats: bool = True,
                       normalization_mode: str = "minmax"):
    """Resize (and under ``global_z`` normalise) both processed splits in
    place; returns the statistics, or ``None``."""
    cfg = get_config()
    ensure_dirs()
    train_root = os.path.join(cfg.paths.processed_dir, cfg.data.train_subdir)
    test_root = os.path.join(cfg.paths.processed_dir, cfg.data.test_subdir)
    stats = None
    if compute_stats and normalization_mode == "global_z":
        stats = compute_global_stats([train_root])
        write_stats(stats)
    normalize_and_resize(train_root, stats=stats, mode=normalization_mode)
    normalize_and_resize(test_root, stats=stats, mode=normalization_mode)
    return stats
