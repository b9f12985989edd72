"""Dataset scan + packed uint8 arrays.

The port's own copy of ``betavae_tpu/data/dataset.py``: scans
``processed/{train,test}/<class>/*``, classes sorted, shuffles with
``seed`` (train) or ``seed + 1`` (test) then truncates to the limit;
multiclass labels are the sorted-class index, binary labels are
``0 if class == 'notumor' else 1``.  Images are decoded once into a packed
``(N, H, W, C)`` uint8 array by the native decoder (:mod:`.native`, the
JAX package's libpng/libjpeg code and bilinear resize), as the JAX
``load_split`` does, and with PIL only where it cannot build or an image
fails to decode; :func:`build_datasets` gives
both splits with the debug alias; :func:`load_image` decodes one file as
``betavae_tpu/data/preprocess.py::_load_image`` does.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field

import numpy as np

from ..config import get, get_config
from ..logging_utils import init_logger

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".bmp", ".tiff")


@dataclass
class ArrayDataset:
    images: np.ndarray          # (N, H, W, C) uint8
    labels: np.ndarray          # (N,) int32
    paths: list = field(default_factory=list)
    class_names: list = field(default_factory=list)
    original_classes: list = field(default_factory=list)
    class_to_idx: dict = field(default_factory=dict)
    class_mode: str = "multiclass"
    decoder: str = ""           # "native" or "PIL": what load_split took

    def __len__(self) -> int:
        return int(self.images.shape[0])

    @property
    def idx_to_class(self) -> dict:
        return {v: k for k, v in self.class_to_idx.items()}


def scan_split(root_dir: str, split: str, sample_limit=None):
    """``(path, class)`` pairs with the reference's shuffle/limit rule."""
    cfg = get_config()
    sub = cfg.data.train_subdir if split == "train" else cfg.data.test_subdir
    split_dir = os.path.join(root_dir, sub)
    if not os.path.exists(split_dir):
        raise FileNotFoundError(
            f"Processed data split not found: {split_dir}. "
            "Did you run preprocessing or create a demo set?")
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    if not classes:
        raise ValueError(f"No class folders found under {split_dir}.")
    samples = []
    for cls in classes:
        cls_dir = os.path.join(split_dir, cls)
        for fname in os.listdir(cls_dir):
            if fname.lower().endswith(IMAGE_EXTS):
                samples.append((os.path.join(cls_dir, fname), cls))
    if not samples:
        raise ValueError(f"No images found under {split_dir}.")
    rng = random.Random(cfg.data.seed if split == "train" else cfg.data.seed + 1)
    rng.shuffle(samples)
    if sample_limit is not None:
        samples = samples[:sample_limit]
    return samples, classes


_decoders_logged: set = set()


def _log_decoder(decoder: str) -> None:
    """Log once a process which decoder ``load_split`` took."""
    if decoder not in _decoders_logged:
        _decoders_logged.add(decoder)
        init_logger().info("[DATA] load_split decodes with %s", decoder)


def decode_pil(paths, size: int, grayscale: bool) -> np.ndarray:
    """The PIL decode of ``paths`` into a packed ``(N, size, size, C)``
    uint8 array (``convert`` then a bicubic ``resize`` where the size
    differs): the JAX ``load_split``'s fallback."""
    from PIL import Image

    images = np.empty((len(paths), size, size, 1 if grayscale else 3),
                      dtype=np.uint8)
    for i, path in enumerate(paths):
        with Image.open(path) as im:
            im = im.convert("L" if grayscale else "RGB")
            if im.size != (size, size):
                im = im.resize((size, size))
            arr = np.asarray(im, dtype=np.uint8)
        images[i] = arr[..., None] if arr.ndim == 2 else arr
    return images


def load_split(split: str, sample_limit=None) -> ArrayDataset:
    """Decode one split into a packed ArrayDataset at ``data.image_size``:
    the native decoder, else PIL (:func:`decode_pil`)."""
    from . import native

    cfg = get_config()
    samples, classes = scan_split(cfg.paths.processed_dir, split, sample_limit)
    size = int(cfg.data.image_size)
    grayscale = bool(cfg.data.grayscale)
    c = 1 if grayscale else 3
    class_mode = cfg.data.class_mode
    if class_mode == "multiclass":
        class_to_idx = {name: i for i, name in enumerate(classes)}
    else:
        class_to_idx = {"healthy": 0, "tumor": 1}

    n = len(samples)
    labels = np.empty((n,), dtype=np.int32)
    for i, (_, cls) in enumerate(samples):
        if class_mode == "multiclass":
            labels[i] = class_to_idx[cls]
        else:
            labels[i] = 0 if cls == "notumor" else 1
    paths = [p for p, _ in samples]
    images = native.pack_images(paths, size, c)
    decoder = "native" if images is not None else "PIL"
    _log_decoder(decoder)
    if images is None:
        images = decode_pil(paths, size, grayscale)
    return ArrayDataset(
        images=images, labels=labels, paths=paths,
        class_names=[cls for _, cls in samples], original_classes=classes,
        class_to_idx=class_to_idx, class_mode=class_mode, decoder=decoder)


def build_datasets(train_limit=None, test_limit=None):
    """``(train, test)`` splits, each cut to its limit after the shuffle;
    under ``model.deterministic_overfit`` with ``debug.enabled`` the test
    split is the train split (the reference's debug alias)."""
    cfg = get_config()
    train_ds = load_split("train", sample_limit=train_limit)
    test_ds = load_split("test", sample_limit=test_limit)
    if get(cfg.model, "deterministic_overfit", False) and get(
            get(cfg, "debug", None), "enabled", False):
        test_ds = train_ds
    return train_ds, test_ds


def images_to_tensor(images: np.ndarray, device) -> "torch.Tensor":
    """Packed ``(N, H, W, C)`` uint8 images (or float images already in
    [0, 1]) as the model's float32 NCHW input in [0, 1] on ``device``."""
    import torch

    x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    x = x.permute(0, 3, 1, 2).float()
    return x / 255.0 if images.dtype == np.uint8 else x


def load_image(path: str, grayscale: bool, size: int | None = None) -> np.ndarray:
    """One image file as float32 ``(H, W, C)`` in [0, 1], resized to
    ``size`` × ``size`` when given."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("L" if grayscale else "RGB")
        if size is not None:
            im = im.resize((size, size))
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return arr[..., None] if arr.ndim == 2 else arr
