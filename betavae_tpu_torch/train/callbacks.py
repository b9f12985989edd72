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
  resume from the best checkpoint's recorded ``val_total``; with
  ``async_io`` the writes run on a background thread, as the JAX
  package's ``CheckpointManager(async_io=True)`` does (the same files);
  a save writes a :class:`StateSnapshot`, the caller's (as the JAX saves'
  ``presnapshot`` do) or one it takes,
- :class:`StateSnapshot`: the training state copied on the device in one
  multi-tensor copy into buffers allocated once, and copied back in place
  (the trainer's epoch rotation saves from it and rolls back to it).

:func:`restore_training_state` loads a payload written by either package,
or the reference's torch pickles, into the port's model and optimizer.
"""

from __future__ import annotations

import logging
import math
import threading

import numpy as np
import torch

from ..io.artifacts import model_checkpoint_path
from ..io.checkpoint import read_checkpoint_meta, save_sharded_checkpoint
from ..io.weights import (adam_state_from_optax, adam_state_from_reference,
                          is_jax_state, optim_state_from_flat,
                          optim_state_tensors, params_from_jax)
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


def load_model_state(model: torch.nn.Module, state: dict) -> None:
    """Load a checkpoint's ``model_state`` (either package's, or the
    reference's as ``io/checkpoint.py`` reads it) into ``model`` with
    ``strict=True``."""
    if is_jax_state(state):
        model.load_state_dict(params_from_jax(state), strict=True)
    else:
        model.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in state.items()}, strict=True)


def _load_adam_state(optimizer: OptimizerChain, adam: dict) -> None:
    sd = optimizer.optimizer.state_dict()
    sd["state"] = adam
    optimizer.optimizer.load_state_dict(sd)


def restore_training_state(payload: dict, model: torch.nn.Module,
                           optimizer: OptimizerChain) -> None:
    """Load a checkpoint payload into ``model`` and ``optimizer``.

    The port's own checkpoints hold torch names and index-keyed optimizer
    state; the JAX package's hold flax paths (``params/...``,
    ``batch_stats/...``) and an optax state, whose Adam moments are mapped
    through the parameter mapping; the reference's torch pickles hold torch
    names and an index-keyed Adam state (``reference_optim_state``), loaded
    when the model's parameters are in the reference's order.  Other
    optimizer states are not mapped, and the run resumes with a fresh
    optimizer, with a warning.
    """
    state = payload["model_state"]
    optim = payload.get("optim_state") or {}
    reference_optim = payload.get("reference_optim_state")
    load_model_state(model, state)
    if is_jax_state(state) or reference_optim:
        if not isinstance(optimizer.optimizer,
                          (torch.optim.Adam, torch.optim.AdamW)):
            logging.getLogger("beta_vae_se_torch").warning(
                "resume: the optimizer is not Adam; its state starts fresh")
            return
        names = [name for name, _ in model.named_parameters()]
        if reference_optim:
            adam = adam_state_from_reference(reference_optim, state, names)
        else:
            adam = adam_state_from_optax(optim, state, names)
        if adam is not None:
            _load_adam_state(optimizer, adam)
            if reference_optim:
                print("[RESUME] imported torch Adam moments (step count "
                      f"{int(adam[0]['step'])})")
        return
    if optim:
        optim_state_from_flat(optim, optimizer.optimizer)


def _pull_finish(host: dict, done) -> dict:
    """:meth:`StateSnapshot.pull`'s copies as numpy arrays, once they
    landed."""
    if done is not None:
        done.synchronize()
    return {sec: {k: v.numpy() for k, v in t.items()}
            for sec, t in host.items()}


def _live_sections(model, optimizer) -> dict:
    """The tensors a checkpoint saves, by section and name: the model's
    state and the optimizer's, the live tensors themselves."""
    return {"model_state": dict(model.state_dict(keep_vars=True)),
            "optim_state": optim_state_tensors(optimizer.optimizer)}


class StateSnapshot:
    """The training state of ``model`` and ``optimizer`` (every parameter,
    buffer, optimizer moment and the step count) and the tensors of
    ``extra``, copied on the device by :meth:`take` in one multi-tensor
    copy into one flat buffer allocated once, and copied back in place by
    :meth:`restore`: the live tensors are never rebound, so a captured
    CUDA graph that holds their addresses replays on the restored values.

    ``sections`` holds the copies under a checkpoint's section and key
    names.  :meth:`pull` starts their trip to the host, one copy of the
    flat buffer a snapshot (:meth:`CheckpointManager.save_latest` and
    ``save_best`` share it); the next :meth:`take` waits for it on the
    device, as it would otherwise overwrite what is read.  ``fence`` (the
    run's ``DeviceQueue.fence``) is called before a :meth:`restore`, so
    that the copy back is queued behind the steps dispatched since."""

    def __init__(self, model, optimizer, extra=(), fence=None):
        self._fence = fence
        optimizer.bind_state()
        live = _live_sections(model, optimizer)
        tensors = {}
        for t in [*model.parameters(), *model.buffers(),
                  *(v for sec in live.values() for v in sec.values()),
                  *optimizer.state_tensors(), *extra]:
            tensors.setdefault(id(t), t)
        self._live = list(tensors.values())
        self._layout, at = [], 0
        for t in self._live:
            at = -(-at // 16) * 16
            self._layout.append((at, t.numel() * t.element_size()))
            at += t.numel() * t.element_size()
        self._flat = torch.empty(at, dtype=torch.uint8,
                                 device=self._live[0].device)
        self._copies = self._views(self._flat)
        index = {key: i for i, key in enumerate(tensors)}
        self._index = {sec: {name: index[id(t)] for name, t in part.items()}
                       for sec, part in live.items()}
        self.sections = self._sections(self._copies)
        self.ready = None
        self._pulled = None

    def _views(self, flat: torch.Tensor) -> list:
        """Each live tensor's place in ``flat`` (a buffer of the layout)."""
        return [flat[at:at + n].view(t.dtype).view(t.shape)
                for (at, n), t in zip(self._layout, self._live)]

    def _sections(self, views: list) -> dict:
        return {sec: {name: views[i] for name, i in part.items()}
                for sec, part in self._index.items()}

    @torch.no_grad()
    def take(self) -> None:
        """Copy the live state into the buffer, behind the work queued on
        the current stream and behind the last pull."""
        if self._pulled is not None and self._pulled[1] is not None:
            torch.cuda.current_stream(self._flat.device).wait_event(
                self._pulled[1])
        self._pulled = None
        torch._foreach_copy_(self._copies, self._live)
        if self._flat.is_cuda:
            self.ready = torch.cuda.Event()
            self.ready.record()

    @torch.no_grad()
    def restore(self) -> None:
        """Copy the buffer back into the live tensors, in place, after the
        fence."""
        if self._fence is not None:
            self._fence()
        torch._foreach_copy_(self._live, self._copies)

    def pull(self) -> tuple:
        """``(host, done)``: the copies of the last :meth:`take` on the host,
        by section and name, and the event recorded behind their copy (None
        on the CPU).  One copy of the flat buffer into pinned memory on a
        side stream that waits for the take alone, so it neither queues
        behind the steps launched since nor holds up those launched after
        (a copy at once on the CPU); started at the first call after a
        take."""
        if self._pulled is None:
            done = None
            if self._flat.is_cuda:
                stream = torch.cuda.Stream(device=self._flat.device)
                with torch.cuda.stream(stream):
                    stream.wait_event(self.ready)
                    host = torch.empty(self._flat.shape, dtype=torch.uint8,
                                       pin_memory=True)
                    host.copy_(self._flat, non_blocking=True)
                    # the buffer may be freed before the copy has run
                    self._flat.record_stream(stream)
                    done = torch.cuda.Event()
                    done.record(stream)
            else:
                host = self._flat.clone()
            self._pulled = (self._sections(self._views(host)), done)
        return self._pulled


class CheckpointManager:
    """``<models_dir>/<run_id>_{latest,best}.pt`` as NUM_SHARDS shards.

    A save writes a :class:`StateSnapshot`: the caller's ``snapshot=``
    (taken before the steps dispatched since, which may already be changing
    the live tensors), else one taken at the save.  Its pull to pinned host
    memory (:meth:`StateSnapshot.pull`, one pull for ``latest`` and
    ``best``) is the save's only copy.

    ``async_io=True`` (``training.async_checkpoint``) takes the writes off
    the training thread, as the JAX package's writer does: the pulls are
    queued per tag, depth 1, latest wins (a queued one is replaced, and
    counted in ``coalesced``).  A daemon thread writes ``best`` before
    ``latest``: it waits for the pull and calls ``save_sharded_checkpoint``,
    so the files are those of a synchronous save.  A failed write is raised
    at the next save and at :meth:`drain`, which the trainer calls when it
    ends, however it ends.  ``writes`` counts the checkpoints written.
    """

    def __init__(self, async_io: bool = False):
        self.best_value = None
        self.async_io = async_io
        self.writes = 0
        self.coalesced = 0
        self._lock = threading.Lock()
        self._queue = {}          # tag -> (path, scalars, host, done)
        self._worker = None
        self._pending_error = None

    def _save(self, tag: str, model, optimizer, epoch: int, total_steps: int,
              extra: dict, snapshot: StateSnapshot | None = None):
        path = model_checkpoint_path(tag)
        scalars = {"epoch": int(epoch), "total_steps": int(total_steps),
                   **{k: float(v) for k, v in extra.items()}}
        if self.async_io:
            self._raise_pending()
        if snapshot is None:
            snapshot = StateSnapshot(model, optimizer)
            snapshot.take()
        host, done = snapshot.pull()
        if not self.async_io:
            paths = save_sharded_checkpoint(
                path, {**scalars, **_pull_finish(host, done)},
                num_shards=NUM_SHARDS)
            self.writes += 1
            return paths
        with self._lock:
            if tag in self._queue:
                self.coalesced += 1
            self._queue[tag] = (path, scalars, host, done)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run_worker, daemon=True,
                    name="betavae-ckpt-writer")
                self._worker.start()
        return path

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._pending_error = self._pending_error, None
        if err is not None:
            raise err

    def _run_worker(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    self._worker = None
                    return
                # best before latest: the rarer and more valuable file
                tag = "best" if "best" in self._queue else next(iter(self._queue))
                path, scalars, host, done = self._queue.pop(tag)
            try:
                save_sharded_checkpoint(path,
                                        {**scalars, **_pull_finish(host, done)},
                                        num_shards=NUM_SHARDS)
                self.writes += 1
            except Exception as err:  # raised at the next save or drain()
                with self._lock:
                    if self._pending_error is None:
                        self._pending_error = err

    def drain(self) -> None:
        """Wait until every queued snapshot is written; raise the first
        failed write, if any."""
        while True:
            with self._lock:
                worker = self._worker
            if worker is None:
                break
            worker.join()
        self._raise_pending()

    def save_latest(self, model, optimizer, epoch: int, total_steps: int,
                    extra: dict, snapshot: StateSnapshot | None = None):
        return self._save("latest", model, optimizer, epoch, total_steps,
                          extra, snapshot)

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
                  extra: dict, monitor_value: float,
                  snapshot: StateSnapshot | None = None):
        if not math.isfinite(monitor_value):
            logging.getLogger("beta_vae_se_torch").warning(
                "save_best: non-finite monitor %r at epoch %d — skipping "
                "best-checkpoint update", monitor_value, epoch)
            return None
        if self.best_value is None or monitor_value < self.best_value:
            self.best_value = monitor_value
            # a queued best is only ever replaced by a strictly better one
            return self._save("best", model, optimizer, epoch, total_steps,
                              extra, snapshot)
        return None
