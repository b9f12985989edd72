"""Sharded checkpoints in the JAX package's on-disk format.

The port's own copy of ``betavae_tpu/io/checkpoint.py``, without JAX, so
either package reads the other's checkpoints:

- shard files ``<base>_shard{i}<ext>`` beside the base path (default
  extension ``.pt``), each an uncompressed zip of ``.npy`` members plus a
  ``__meta__.json`` member holding the payload's scalars and the shard's
  ``shard_id`` / ``num_shards``;
- the keys of every array section (``model_state``, ``optim_state``,
  ``torch_adam_moments``, and ``reference_optim_state`` where a reference
  torch checkpoint was read, so a reshard of one keeps its Adam state)
  sorted and dealt round-robin over the shards;
- each shard written to ``<shard>.tmp`` and moved into place with
  ``os.replace``; shards of an earlier, wider save and a stale unsharded
  base file removed after a save;
- the reference's ``torch.save`` shards (a zip holding ``data.pkl``, or a
  legacy pickle) read with ``torch.load(..., weights_only=True)`` and
  nothing less safe: their model state mapped to the port's names
  (``io/weights.py::model_state_from_reference``), their Adam
  ``optim_state`` kept, flat by ``<param index>/<field>``, as the
  ``reference_optim_state`` section, for ``train/callbacks.py::
  restore_training_state``; :func:`save_torch_reference_checkpoint` writes
  them;
- :func:`normalize_base_path` and :func:`checkpoint_shard_count`, which
  the reshard CLI (``scripts/reshard_checkpoint.py``) uses, as the JAX
  copy's;
- a load that checks the shard set is whole: every shard's recorded
  ``num_shards`` equals the files found, and ``epoch`` / ``total_steps``
  agree across shards.

Two faults of the JAX copy are fixed here: the shard glob escapes the base
path (a ``run_id`` holding ``[`` or ``*`` matched other files, or none),
and the moments' count key is written and read only with the moments, so
it never leaks into the payload's scalars.

Payload: ``{"epoch": int, "total_steps": int, "model_state": {key:
ndarray}, "optim_state": {key: ndarray}, ...json scalars...}``.
"""

from __future__ import annotations

import glob
import io as _io
import json
import os
import warnings
import zipfile

import numpy as np
import torch

from .weights import export_model_state, model_state_from_reference

_META_KEY = "__meta__"
_ARRAY_SECTIONS = ("model_state", "optim_state", "torch_adam_moments",
                   "reference_optim_state")
_MOMENTS_COUNT_KEY = "torch_adam_moments_count"
_SHARD_KEYS = ("shard_id", "num_shards")


def _shard_paths(base_path: str, num_shards: int) -> list:
    root, ext = os.path.splitext(base_path)
    return [f"{root}_shard{i}{ext or '.pt'}" for i in range(num_shards)]


def normalize_base_path(base_path: str) -> str:
    """``base_path`` with the default ``.pt`` extension where it has none."""
    return base_path if os.path.splitext(base_path)[1] else base_path + ".pt"


def discover_shards(base_path: str) -> list:
    """The on-disk ``<base>_shard*<ext>`` files of a checkpoint base, the
    base path taken literally (``glob.escape``)."""
    root, ext = os.path.splitext(base_path)
    return sorted(glob.glob(f"{glob.escape(root)}_shard*{ext or '.pt'}"))


def checkpoint_shard_count(base_path: str) -> int:
    """How many files hold the checkpoint at ``base_path`` (1: an unsharded
    base file); raises ``FileNotFoundError`` where there is neither."""
    found = discover_shards(base_path)
    if found:
        return len(found)
    if os.path.exists(base_path):
        return 1
    raise FileNotFoundError(
        f"checkpoint not found: no shard files and no base file at "
        f"{base_path}")


def _write_shard(path: str, arrays: dict, meta: dict) -> None:
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr(_META_KEY + ".json", json.dumps(meta))
        for key, arr in arrays.items():
            buf = _io.BytesIO()
            np.save(buf, np.asarray(arr), allow_pickle=False)
            zf.writestr(key + ".npy", buf.getvalue())
    os.replace(tmp, path)


def _read_torch_shard(path: str):
    """``(arrays, meta)`` of one of the reference's ``torch.save`` shards,
    loaded with ``weights_only=True``: a pickle that needs more (one that
    would run code of its own when loaded) raises ``ValueError`` naming the
    file, and is never loaded unsafely."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as err:
        raise ValueError(
            f"{path}: torch.load(weights_only=True) cannot read this torch "
            f"pickle ({type(err).__name__}: {err}); it is not loaded with "
            "weights_only=False, which would run code from the file") from err
    if not isinstance(payload, dict) or not isinstance(
            payload.get("model_state"), dict):
        raise ValueError(f"{path} is a torch pickle without a model_state "
                         "dict: not a checkpoint shard of the reference")

    def host(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    arrays, meta = {}, {}
    for key, val in payload.items():
        if key == "model_state":
            state = model_state_from_reference(
                {k: host(t) for k, t in val.items()})
            arrays.update({f"model_state/{k}": v for k, v in state.items()})
        elif key == "optim_state":
            for idx, fields in (val.get("state") or {}).items():
                for field, t in fields.items():
                    arrays[f"reference_optim_state/{idx}/{field}"] = host(t)
        elif _json_scalar(val):
            meta[key] = val
    return arrays, meta


def _read_shard(path: str):
    """``(arrays, meta)`` of one shard, of this format or a reference torch
    pickle; anything else raises ``ValueError``."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            names = zf.namelist()
            if _META_KEY + ".json" not in names:
                if any(name.endswith("data.pkl") for name in names):
                    return _read_torch_shard(path)
                raise ValueError(f"{path} is a zip without {_META_KEY}.json: "
                                 "not a checkpoint shard of this format")
            meta = json.loads(zf.read(_META_KEY + ".json").decode("utf-8"))
            arrays = {name[:-len(".npy")]: np.load(_io.BytesIO(zf.read(name)),
                                                   allow_pickle=False)
                      for name in names if name.endswith(".npy")}
    except zipfile.BadZipFile as err:
        with open(path, "rb") as f:
            if f.read(1) == b"\x80":       # a legacy (pre-zip) torch pickle
                return _read_torch_shard(path)
        raise ValueError(f"checkpoint shard {path} is not a zip: the file is "
                         "corrupt or truncated") from err
    return arrays, meta


def read_checkpoint_meta(base_path: str) -> dict:
    """The payload's scalars (epoch, val_total, ...) from one shard's
    metadata member, without reading any array (a torch pickle has no such
    member, and is read whole)."""
    shards = discover_shards(base_path)
    target = shards[0] if shards else base_path
    if not os.path.exists(target):
        raise FileNotFoundError(f"No checkpoint found at {base_path}")
    try:
        with zipfile.ZipFile(target, "r") as zf:
            meta = json.loads(zf.read(_META_KEY + ".json").decode("utf-8"))
    except (zipfile.BadZipFile, KeyError):
        meta = _read_shard(target)[1]   # a torch pickle: read it whole
    return {k: v for k, v in meta.items() if k not in _SHARD_KEYS}


def _json_scalar(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def save_sharded_checkpoint(base_path: str, payload: dict,
                            num_shards: int = 2) -> list:
    """Write ``payload`` over ``num_shards`` files; returns their paths."""
    if payload.get("model_state") is None:
        raise ValueError("payload missing model_state for sharded checkpoint "
                         "save")
    parent = os.path.dirname(base_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    num_shards = max(1, int(num_shards))

    payload = dict(payload)
    moments = payload.pop("torch_adam_moments", None)
    if moments and (moments.get("mu") or moments.get("nu")):
        payload["torch_adam_moments"] = {
            f"{m}/{k}": v for m in ("mu", "nu")
            for k, v in (moments.get(m) or {}).items()}
        payload[_MOMENTS_COUNT_KEY] = int(moments.get("count", 0))

    meta_base = {k: v for k, v in payload.items()
                 if k not in _ARRAY_SECTIONS and _json_scalar(v)}
    dropped = [k for k in payload
               if k not in _ARRAY_SECTIONS and k not in meta_base]
    if dropped:
        warnings.warn(f"save_sharded_checkpoint: dropping non-serializable "
                      f"payload entries {dropped} — they will NOT survive a "
                      f"load of {base_path}")

    paths = _shard_paths(base_path, num_shards)
    per_shard = [{} for _ in paths]
    for sec in _ARRAY_SECTIONS:
        state = payload.get(sec) or {}
        for i, key in enumerate(sorted(state)):
            per_shard[i % num_shards][f"{sec}/{key}"] = state[key]
    for shard_id, (path, arrays) in enumerate(zip(paths, per_shard)):
        _write_shard(path, arrays, {**meta_base, "shard_id": shard_id,
                                    "num_shards": num_shards})
    # a later load globs every shard file: drop those of a wider save
    for stale in discover_shards(base_path):
        if stale not in paths:
            os.remove(stale)
    if os.path.exists(base_path):
        os.remove(base_path)
    return paths


def _validate_shard_set(seen_meta: list) -> None:
    """Fail on a torn set: a stale shard of an earlier save, or shards of
    different epochs after an interrupted save."""
    for path, meta in seen_meta:
        n = meta.get("num_shards")
        if n is not None and int(n) != len(seen_meta):
            raise ValueError(
                f"checkpoint shard set is inconsistent: {path} records "
                f"num_shards={n} but {len(seen_meta)} shard files were found "
                "— a stale shard from an earlier save is mixed in; delete "
                "the stale files or reshard explicitly")
    for key in ("epoch", "total_steps"):
        vals = {p: m[key] for p, m in seen_meta if key in m}
        if len(set(vals.values())) > 1:
            raise ValueError(
                f"checkpoint shard set is torn: {key} differs across shards "
                f"({vals}) — an interrupted save mixed epochs; resume from "
                "the best checkpoint or an earlier epoch instead")


def _renest_moments(out: dict) -> dict:
    """The nested ``torch_adam_moments`` from its flat section; the count
    key is consumed whether or not moments are present."""
    count = out.pop(_MOMENTS_COUNT_KEY, 0)
    flat = out.pop("torch_adam_moments", None)
    if flat:
        out["torch_adam_moments"] = {
            "count": int(count),
            **{m: {k[len(m) + 1:]: v for k, v in flat.items()
                   if k.startswith(f"{m}/")} for m in ("mu", "nu")}}
    return out


def load_sharded_checkpoint(base_path: str,
                            num_shards: int | None = None) -> dict:
    """Merge a checkpoint's shards (or read its unsharded base file) into
    one payload; raises ``FileNotFoundError`` when neither exists.  With
    ``num_shards``, the shards read are ``<base>_shard0`` to
    ``_shard{num_shards - 1}`` where all of them exist, else the base
    file."""
    if num_shards is None:
        shard_paths = discover_shards(base_path)
    else:
        shard_paths = _shard_paths(base_path, int(num_shards))
        if not all(os.path.exists(p) for p in shard_paths):
            shard_paths = []
    if not shard_paths:
        if not os.path.exists(base_path):
            raise FileNotFoundError(
                f"No checkpoint found at {base_path} or shards")
        shard_paths = [base_path]
    out, seen_meta = {}, []
    for path in shard_paths:
        arrays, meta = _read_shard(path)
        for key, arr in arrays.items():
            sec, _, rest = key.partition("/")
            out.setdefault(sec, {})[rest] = arr
        seen_meta.append((path, meta))
    if shard_paths != [base_path]:
        _validate_shard_set(seen_meta)
    out.update({k: v for k, v in seen_meta[0][1].items()
                if k not in _SHARD_KEYS})
    return _renest_moments(out)


def save_torch_reference_checkpoint(base_path: str, payload: dict,
                                    num_shards: int = 2,
                                    optim_state: dict | None = None) -> list:
    """``torch.save`` ``payload`` in the reference's shard layout, as the
    JAX package's ``save_torch_reference_checkpoint`` does: the model state
    (either package's, exported to the reference's names) sorted and dealt
    round-robin over ``<base>_shard{i}<ext>``, every JSON scalar of the
    payload and ``optim_state`` (an ``Adam.state_dict()`` payload from
    ``io/weights.py::export_adam_optim_state``) in every shard, with
    ``exported_by`` naming this package.  Each shard is written to
    ``<shard>.tmp`` and moved into place.  Returns the shard paths."""
    state = payload.get("model_state")
    if state is None:
        raise ValueError("payload missing model_state")
    tensors = {k: torch.from_numpy(v)
               for k, v in export_model_state(state).items()}
    meta = {k: v for k, v in payload.items()
            if k not in _ARRAY_SECTIONS and _json_scalar(v)}
    meta["exported_by"] = "betavae_tpu_torch"
    if optim_state is not None:
        meta["optim_state"] = optim_state
    parent = os.path.dirname(base_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    num_shards = max(1, int(num_shards))
    keys = sorted(tensors)
    paths = _shard_paths(base_path, num_shards)
    for shard_id, path in enumerate(paths):
        torch.save({**meta,
                    "model_state": {k: tensors[k]
                                    for k in keys[shard_id::num_shards]},
                    "shard_id": shard_id, "num_shards": num_shards},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
    return paths
