"""Early stopping and checkpoint management.

The port's own copy of ``betavae_tpu/train/callbacks.py``:

- :class:`EarlyStopping`: patience on a monitor that must fall (the JAX
  class's ``min_delta`` and ``mode`` keep their trainer's values, 0 and
  min); a non-finite monitor never becomes ``best`` and counts as a bad
  epoch,
- :class:`CheckpointManager`: ``save_latest`` and a monitored ``save_best``
  (val_total, min; a non-finite value is skipped with a warning) as
  NUM_SHARDS-way sharded checkpoints ``<run_id>_{latest,best}.pt`` in the JAX package's
  format, payload ``{epoch, total_steps, model_state, optim_state,
  val_total}``; ``restore_best_history`` re-arms ``save_best`` after a
  resume from the best checkpoint's recorded ``val_total``.

Writes are synchronous: the JAX package's background writer is not ported
(its files are the same bytes either way).  :func:`restore_training_state`
loads a payload written by either package into the port's model and
optimizer.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..io.artifacts import model_checkpoint_path
from ..io.checkpoint import read_checkpoint_meta, save_sharded_checkpoint
from ..io.weights import (adam_state_from_optax, optim_state_from_flat,
                          optim_state_to_flat, params_from_jax)
from .optim import OptimizerChain

NUM_SHARDS = 2


class EarlyStopping:
    def __init__(self, patience: int = 20):
        self.patience = patience
        self.best = None
        self.num_bad = 0
        self.should_stop = False

    def _bad_epoch(self) -> None:
        self.num_bad += 1
        if self.num_bad >= self.patience:
            self.should_stop = True

    def update(self, value: float) -> None:
        if not math.isfinite(value):
            self._bad_epoch()
            return
        if self.best is None:
            # the first finite value is an improvement, also after
            # non-finite ones
            self.best = value
            self.num_bad = 0
            return
        if value < self.best:
            self.best = value
            self.num_bad = 0
        else:
            self._bad_epoch()


def restore_training_state(payload: dict, model: torch.nn.Module,
                           optimizer: OptimizerChain) -> None:
    """Load a checkpoint payload into ``model`` and ``optimizer``.

    The port's own checkpoints hold torch names and index-keyed optimizer
    state; the JAX package's hold flax paths (``params/...``,
    ``batch_stats/...``) and an optax state, whose Adam moments are mapped
    through the parameter mapping (other optimizer states are not, and the
    run resumes with a fresh optimizer, with a warning).
    """
    state = payload["model_state"]
    optim = payload.get("optim_state") or {}
    if any("/" in key for key in state):                   # the JAX package
        model.load_state_dict(params_from_jax(state), strict=True)
        if not isinstance(optimizer.optimizer,
                          (torch.optim.Adam, torch.optim.AdamW)):
            logging.getLogger("beta_vae_se_torch").warning(
                "resume: the optimizer is not Adam; its state starts fresh")
            return
        names = [name for name, _ in model.named_parameters()]
        adam = adam_state_from_optax(optim, state, names)
        if adam is not None:
            sd = optimizer.optimizer.state_dict()
            sd["state"] = adam
            optimizer.optimizer.load_state_dict(sd)
        return
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    if optim:
        optim_state_from_flat(optim, optimizer.optimizer)


class CheckpointManager:
    """``<models_dir>/<run_id>_{latest,best}.pt`` as NUM_SHARDS shards."""

    def __init__(self):
        self.best_value = None

    def _save(self, tag: str, model, optimizer, epoch: int, total_steps: int,
              extra: dict) -> list:
        payload = {
            "epoch": int(epoch),
            "total_steps": int(total_steps),
            "model_state": {k: v.detach().cpu().numpy()
                            for k, v in model.state_dict().items()},
            "optim_state": optim_state_to_flat(optimizer.optimizer),
            **{k: float(v) for k, v in extra.items()},
        }
        return save_sharded_checkpoint(model_checkpoint_path(tag), payload,
                                       num_shards=NUM_SHARDS)

    def save_latest(self, model, optimizer, epoch: int, total_steps: int,
                    extra: dict) -> list:
        return self._save("latest", model, optimizer, epoch, total_steps,
                          extra)

    def restore_best_history(self) -> None:
        """Re-arm ``save_best`` with the best checkpoint's ``val_total``
        (metadata only), so a resumed run does not overwrite a better
        best with its first epoch."""
        try:
            meta = read_checkpoint_meta(model_checkpoint_path("best"))
        except FileNotFoundError:
            return
        if meta.get("val_total") is not None:
            self.best_value = float(meta["val_total"])

    def save_best(self, model, optimizer, epoch: int, total_steps: int,
                  extra: dict, monitor_value: float):
        if not math.isfinite(monitor_value):
            logging.getLogger("beta_vae_se_torch").warning(
                "save_best: non-finite monitor %r at epoch %d — skipping "
                "best-checkpoint update", monitor_value, epoch)
            return None
        if self.best_value is None or monitor_value < self.best_value:
            self.best_value = monitor_value
            return self._save("best", model, optimizer, epoch, total_steps,
                              extra)
        return None
