"""The port's few-step trainer on demo data, on the CPU.

Its ``CONFIG`` line must carry the same config as the JAX package's, and
its train ``METRICS`` lines the same keys as JAX ``train()``'s, so the
repo's log parsers read either package's logs.
"""

import json
import math

import pytest

from betavae_tpu.config import get_config as jax_get_config
from betavae_tpu.train.loop import train as jax_train

from betavae_tpu_torch.config import reset_config_cache
from betavae_tpu_torch.data.demo import generate_demo_data
from betavae_tpu_torch.logging_utils import reset_logger
from betavae_tpu_torch.ops.elbo import fused_reparam_kl
from betavae_tpu_torch.train.__main__ import main
from betavae_tpu_torch.train.loop import train_steps


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    reset_config_cache()
    reset_logger()
    yield
    reset_config_cache()
    reset_logger()


def _records(text: str, tag: str) -> list:
    return [json.loads(line.split(f"{tag} ", 1)[1])
            for line in text.splitlines() if f"| {tag} " in line]


@pytest.fixture
def demo_cfg(demo_config_factory, tmp_path):
    # debug config: 24 train images (6 batches of 4), 3 batches an epoch
    path = demo_config_factory(**{"debug.epochs": 1})
    generate_demo_data(tmp_path / "processed", train_per_class=6,
                       test_per_class=3, size=32)
    return path


def test_train_steps_lines_match_jax_train(demo_cfg, capsys):
    jax_get_config(demo_cfg)
    jax_train()
    jax_out = capsys.readouterr().out
    fused_reparam_kl.launches = 0
    result = train_steps(demo_cfg, max_steps=3, device="cpu")
    port_out = capsys.readouterr().out

    assert _records(port_out, "CONFIG") == _records(jax_out, "CONFIG")
    jax_train_lines = [m for m in _records(jax_out, "METRICS")
                       if m["phase"] == "train"]
    port_lines = _records(port_out, "METRICS")
    assert [m["step"] for m in port_lines] == [1, 2, 3]  # log_every_n_steps 1
    assert all(m["phase"] == "train" for m in port_lines)
    assert {tuple(m) for m in port_lines} == {tuple(jax_train_lines[0])}
    assert result["steps"] == 3 and len(result["totals"]) == 3
    assert all(math.isfinite(t) for t in result["totals"])
    assert fused_reparam_kl.launches == 0  # CPU tensors: the plain version


def test_cli_trains_under_bf16_autocast(demo_config_factory, tmp_path,
                                        capsys):
    path = demo_config_factory(**{"training.mixed_precision": True,
                                  "loss.use_ffl": True})
    generate_demo_data(tmp_path / "processed", train_per_class=2,
                       test_per_class=1, size=32)
    main(["--config", path, "--max-steps", "2", "--device", "cpu"])
    lines = _records(capsys.readouterr().out, "METRICS")
    assert len(lines) == 2
    assert all(math.isfinite(m["train_total_loss"]) and m["train_recon_ffl"] > 0
               for m in lines)
