"""Sharded checkpoints in the JAX package's on-disk format.

The port's own copy of ``betavae_tpu/io/checkpoint.py``, without JAX, so
either package reads the other's checkpoints:

- shard files ``<base>_shard{i}<ext>`` beside the base path (default
  extension ``.pt``), each an uncompressed zip of ``.npy`` members plus a
  ``__meta__.json`` member holding the payload's scalars and the shard's
  ``shard_id`` / ``num_shards``;
- the keys of every array section (``model_state``, ``optim_state``,
  ``torch_adam_moments``) sorted and dealt round-robin over the shards;
- each shard written to ``<shard>.tmp`` and moved into place with
  ``os.replace``; shards of an earlier, wider save and a stale unsharded
  base file removed after a save;
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

_META_KEY = "__meta__"
_ARRAY_SECTIONS = ("model_state", "optim_state", "torch_adam_moments")
_MOMENTS_COUNT_KEY = "torch_adam_moments_count"
_SHARD_KEYS = ("shard_id", "num_shards")


def _shard_paths(base_path: str, num_shards: int) -> list:
    root, ext = os.path.splitext(base_path)
    return [f"{root}_shard{i}{ext or '.pt'}" for i in range(num_shards)]


def discover_shards(base_path: str) -> list:
    """The on-disk ``<base>_shard*<ext>`` files of a checkpoint base, the
    base path taken literally (``glob.escape``)."""
    root, ext = os.path.splitext(base_path)
    return sorted(glob.glob(f"{glob.escape(root)}_shard*{ext or '.pt'}"))


def _write_shard(path: str, arrays: dict, meta: dict) -> None:
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr(_META_KEY + ".json", json.dumps(meta))
        for key, arr in arrays.items():
            buf = _io.BytesIO()
            np.save(buf, np.asarray(arr), allow_pickle=False)
            zf.writestr(key + ".npy", buf.getvalue())
    os.replace(tmp, path)


def _read_shard(path: str):
    """``(arrays, meta)`` of one shard; anything but this format raises."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            names = zf.namelist()
            if _META_KEY + ".json" not in names:
                raise ValueError(f"{path} is a zip without {_META_KEY}.json: "
                                 "not a checkpoint shard of this format")
            meta = json.loads(zf.read(_META_KEY + ".json").decode("utf-8"))
            arrays = {name[:-len(".npy")]: np.load(_io.BytesIO(zf.read(name)),
                                                   allow_pickle=False)
                      for name in names if name.endswith(".npy")}
    except zipfile.BadZipFile as err:
        raise ValueError(f"checkpoint shard {path} is not a zip: the file is "
                         "corrupt or truncated") from err
    return arrays, meta


def read_checkpoint_meta(base_path: str) -> dict:
    """The payload's scalars (epoch, val_total, ...) from one shard's
    metadata member, without reading any array."""
    shards = discover_shards(base_path)
    target = shards[0] if shards else base_path
    if not os.path.exists(target):
        raise FileNotFoundError(f"No checkpoint found at {base_path}")
    with zipfile.ZipFile(target, "r") as zf:
        meta = json.loads(zf.read(_META_KEY + ".json").decode("utf-8"))
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


def load_sharded_checkpoint(base_path: str) -> dict:
    """Merge a checkpoint's shards (or read its unsharded base file) into
    one payload; raises ``FileNotFoundError`` when neither exists."""
    shard_paths = discover_shards(base_path)
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
