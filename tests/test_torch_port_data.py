"""The port's data path against the JAX package's, on the CPU.

The demo generator writes the same bytes, ``load_split`` packs the same
images, labels and order under the shuffle, limit and label rules,
``BatchPlan`` yields the same indices and masks, and ``gather_batch`` gives
the same floats (NHWC there, NCHW here).  All exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.config import reset_config_cache as jax_reset_config
from betavae_tpu.data.dataset import load_split as jax_load_split
from betavae_tpu.data.demo import generate_demo_data as jax_generate_demo
from betavae_tpu.data.pipeline import BatchPlan as JaxBatchPlan
from betavae_tpu.data.pipeline import gather_batch as jax_gather_batch

from betavae_tpu_torch.config import get_config, reset_config_cache
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
