"""The port's data path against the JAX package's, on the CPU.

The demo generator writes the same bytes, ``load_split`` packs the same
images, labels and order under the shuffle, limit and label rules,
``BatchPlan`` yields the same indices and masks, and ``gather_batch`` gives
the same floats (NHWC there, NCHW here).  The port's native decoder
(``csrc/packer.cpp``) gives ``betavae_tpu.native.pack_images``'s bytes on
same-size, resized, RGB-PNG and JPEG files, and ``load_split`` the JAX
one's on resized and RGB trees, through the native decoder and through
PIL alike.  All exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betavae_tpu import native as jax_native
from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.data.dataset import load_split as jax_load_split
from betavae_tpu.data.demo import generate_demo_data as jax_generate_demo
from betavae_tpu.data.pipeline import BatchPlan as JaxBatchPlan
from betavae_tpu.data.pipeline import gather_batch as jax_gather_batch

from betavae_tpu_torch.config import get_config, reset_config_cache
from betavae_tpu_torch.data import dataset as port_dataset
from betavae_tpu_torch.data import native
from betavae_tpu_torch.data.dataset import load_split
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.data.pipeline import BatchPlan, DeviceData, gather_batch


@pytest.fixture(autouse=True)
def _fresh_port_config():
    reset_config_cache()
    yield
    reset_config_cache()


def test_demo_generator_writes_the_jax_bytes(tmp_path):
    from PIL import Image

    jax_generate_demo(tmp_path / "jax", train_per_class=2, test_per_class=1,
                      size=16)
    generate_demo_data(tmp_path / "port", train_per_class=2,
                       test_per_class=1, size=16)
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*.png"))
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*.png"))
    assert got == want and len(got) == 12
    for rel in want:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / rel)),
            np.asarray(Image.open(tmp_path / "jax" / rel)))


@pytest.mark.parametrize("class_mode,split,limit", [
    ("multiclass", "train", None), ("multiclass", "test", 3),
    ("binary", "train", 5)])
def test_load_split_matches_jax(demo_config_factory, tmp_path, class_mode,
                                split, limit):
    path = demo_config_factory(class_mode=class_mode)
    generate_demo_data(tmp_path / "processed", train_per_class=3,
                       test_per_class=2, size=32)
    jax_reset_config()
    jax_get_config(path)
    want = jax_load_split(split, sample_limit=limit)
    get_config(path)
    got = load_split(split, sample_limit=limit)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.paths == want.paths
    assert got.class_names == want.class_names
    assert got.class_to_idx == want.class_to_idx
    assert len(got) == (limit or len(want))


@pytest.mark.parametrize("n,batch_size,shuffle", [
    (10, 4, True), (10, 4, False), (8, 4, True), (3, 8, True)])
def test_batch_plan_matches_jax(n, batch_size, shuffle):
    want = JaxBatchPlan(n, batch_size, shuffle=shuffle, seed=115)
    got = BatchPlan(n, batch_size, shuffle=shuffle, seed=115)
    for epoch in (1, 2):
        pairs = list(got.batches(epoch))
        ref = list(want.batches(epoch))
        assert len(pairs) == len(ref) == -(-n // batch_size)
        for (idx, mask), (ridx, rmask) in zip(pairs, ref):
            np.testing.assert_array_equal(idx, ridx)
            np.testing.assert_array_equal(mask, rmask)
            assert idx.dtype == np.int32 and idx.shape == (batch_size,)


def test_gather_batch_matches_jax(demo_config_factory, tmp_path):
    path = demo_config_factory()
    generate_demo_data(tmp_path / "processed", train_per_class=2,
                       test_per_class=1, size=32)
    get_config(path)
    ds = load_split("train")
    idx = np.array([5, 0, 7, 7], np.int32)
    want = np.asarray(jax_gather_batch(jnp.asarray(ds.images),
                                       jnp.asarray(idx)))
    images = DeviceData.from_dataset(ds, torch.device("cpu")).images
    got = gather_batch(images, torch.from_numpy(idx.astype(np.int64)))
    assert got.dtype == torch.float32 and got.shape == (4, 1, 32, 32)
    np.testing.assert_array_equal(got.numpy(), np.transpose(want, (0, 3, 1, 2)))


# --------------------------------------------------------------------------
# the native decoder
# --------------------------------------------------------------------------

def _write_images(folder, n, px, mode, fmt, seed):
    """``n`` seeded images of ``px`` × ``px`` in PIL ``mode`` ("L" or
    "RGB"), smooth gradients plus noise (so that a resize and a gray
    conversion both have work), as ``fmt`` ("png" or "jpg")."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    ramp = np.linspace(0, 1, px, dtype=np.float32)
    paths = []
    for i in range(n):
        base = 200 * np.outer(ramp, ramp[::-1])[..., None]
        chans = 1 if mode == "L" else 3
        arr = base + rng.normal(0, 25, size=(px, px, chans))
        arr = np.clip(arr + 20 * np.arange(chans), 0, 255).astype(np.uint8)
        im = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
        path = folder / f"img_{i}.{fmt}"
        im.save(path)
        paths.append(str(path))
    return paths


# name: (source px, target size, PIL mode, format, channels asked for)
DECODE_CASES = {
    "gray_png_same_size": (32, 32, "L", "png", 1),
    "gray_png_128_to_256": (128, 256, "L", "png", 1),
    "gray_png_256_to_128": (256, 128, "L", "png", 1),
    "rgb_png_as_gray": (48, 48, "RGB", "png", 1),
    "rgb_png_as_rgb_resized": (48, 40, "RGB", "png", 3),
    "gray_jpeg": (40, 40, "L", "jpg", 1),
    "rgb_jpeg_as_gray_resized": (40, 32, "RGB", "jpg", 1),
    "rgb_jpeg_as_rgb": (40, 40, "RGB", "jpg", 3),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_pack_images_is_byte_for_byte_the_jax_decoder(tmp_path, case):
    px, size, mode, fmt, channels = DECODE_CASES[case]
    paths = _write_images(tmp_path, 3, px, mode, fmt, seed=px + channels)
    want = jax_native.pack_images(paths, size, channels)
    got = native.pack_images(paths, size, channels)
    assert want is not None and got is not None
    assert got.shape == (3, size, size, channels) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # one thread, and one thread a core, decode alike
    np.testing.assert_array_equal(native.pack_images(paths, size, channels,
                                                     n_threads=1), got)


def test_pack_images_gives_none_on_a_bad_file_as_the_jax_decoder(tmp_path):
    paths = _write_images(tmp_path, 2, 16, "L", "png", seed=0)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    paths.insert(1, str(bad))
    assert native.available()
    assert jax_native.pack_images(paths, 16, 1) is None
    assert native.pack_images(paths, 16, 1) is None


def _tree(root, px, mode, fmt="png"):
    """A processed tree of two classes (``glioma``, ``notumor``) a split,
    3 train and 2 test images each, at ``px``."""
    for split, n in (("train", 3), ("test", 2)):
        for k, cls in enumerate(("glioma", "notumor")):
            _write_images(root / split / cls, n, px, mode, fmt,
                          seed=100 * k + n + px)


# name: (stored px, data.image_size, PIL mode, data.grayscale)
TREES = {"resized_128_to_256": (128, 256, "L", True),
         "rgb_png_as_gray": (32, 32, "RGB", True),
         "rgb_png_as_rgb": (32, 24, "RGB", False)}


def _load_both(path, split):
    jax_reset_config()
    jax_get_config(path)
    want = jax_load_split(split)
    reset_config_cache()
    get_config(path)
    return load_split(split), want


@pytest.mark.parametrize("tree", sorted(TREES))
def test_load_split_matches_jax_on_resized_and_rgb_trees(
        demo_config_factory, tmp_path, tree, monkeypatch, capsys):
    """The trees on which PIL and the native decoder disagree: the port's
    ``load_split`` equals the JAX one bitwise, both through the native
    decoder (the port says so once), and both through PIL when neither
    decoder is there."""
    from betavae_tpu_torch.logging_utils import reset_logger

    px, size, mode, gray = TREES[tree]
    _tree(tmp_path / "processed", px, mode)
    path = demo_config_factory(image_size=size,
                               **{"data.grayscale": gray})
    monkeypatch.setattr(port_dataset, "_decoders_logged", set())
    reset_logger()                      # its stream: this test's stdout
    assert jax_native.available() and native.available()
    for split in ("train", "test"):
        got, want = _load_both(path, split)
        assert got.images.shape == (len(want), size, size, 1 if gray else 3)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.paths == want.paths and got.decoder == "native"
    # on these trees the two decoders disagree: the check has teeth
    assert not np.array_equal(got.images, port_dataset.decode_pil(
        got.paths, size, gray))
    assert capsys.readouterr().out.count(
        "[DATA] load_split decodes with native") == 1

    monkeypatch.setattr(jax_native, "pack_images", lambda *a, **k: None)
    monkeypatch.setattr(native, "pack_images", lambda *a, **k: None)
    got, want = _load_both(path, "train")
    assert got.decoder == "PIL"
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.images, port_dataset.decode_pil(
        got.paths, size, gray))
    assert "[DATA] load_split decodes with PIL" in capsys.readouterr().out
    reset_logger()
