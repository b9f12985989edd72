"""YAML config system: frozen attribute-tree singleton with env-based resolution.

The port's own copy of ``betavae_tpu/config.py``: the same resolution order
(explicit path > ``CONFIG_PATH`` > ``configs/beta_vae_se.yaml`` >
``configs/overfit_capacity.yaml``), the same 12 required sections and
validation, and the same YAML files in ``configs/``.
"""

from __future__ import annotations

import os
from copy import deepcopy
from threading import Lock

import yaml

_REQUIRED_TOP_KEYS = (
    "paths",
    "data",
    "model",
    "training",
    "optimization",
    "beta_schedule",
    "augmentation",
    "evaluation",
    "inference",
    "logging",
    "experiment",
    "debug",
)

_VALID_CLASS_MODES = ("binary", "multiclass")
_VALID_BETA_TYPES = ("constant", "linear", "cyclical", "cosine")


class Frozen:
    """Immutable attribute-tree view over a nested dict."""

    def __init__(self, d: dict):
        for k, v in d.items():
            if isinstance(v, dict):
                v = Frozen(v)
            super().__setattr__(k, v)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, Frozen) else v
        return out

    def keys(self):
        return self.__dict__.keys()

    def __getitem__(self, item):
        return getattr(self, item)

    def __contains__(self, item):
        return item in self.__dict__

    def __setattr__(self, key, value):
        raise AttributeError("Frozen config is immutable")

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Frozen({self.to_dict()!r})"


def get(node, name, default=None):
    """``getattr`` with default that also works on plain dicts."""
    if node is None:
        return default
    if isinstance(node, dict):
        return node.get(name, default)
    return getattr(node, name, default)


_config_cache = None
_config_cache_path = None
_config_lock = Lock()


def validate(raw: dict) -> dict:
    missing = [k for k in _REQUIRED_TOP_KEYS if k not in raw]
    if missing:
        raise ValueError(f"Missing required top-level keys: {missing}")
    if raw["data"]["class_mode"] not in _VALID_CLASS_MODES:
        raise ValueError("data.class_mode must be binary or multiclass")
    if raw["beta_schedule"]["type"] not in _VALID_BETA_TYPES:
        raise ValueError("beta_schedule.type invalid")
    return raw


def resolve_config_path(path: str | None = None) -> str:
    candidates = []
    if path:
        candidates.append(path)
    env_path = os.environ.get("CONFIG_PATH")
    if env_path:
        candidates.append(env_path)
    candidates.append("configs/beta_vae_se.yaml")
    candidates.append("configs/overfit_capacity.yaml")

    tried = []
    for cand in candidates:
        cand = os.path.expanduser(str(cand))
        tried.append(cand)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"Config file not found. Set CONFIG_PATH or pass a path. Tried: {tried}"
    )


def load_config(path: str | None = None) -> dict:
    with open(resolve_config_path(path), "r") as f:
        raw = yaml.safe_load(f)
    validate(raw)
    return raw


def get_config(path: str | None = None) -> Frozen:
    """Return the cached frozen config, loading it on first use; an
    explicit ``path`` other than the cached one switches the cache to it."""
    global _config_cache, _config_cache_path
    requested = resolve_config_path(path) if path else None
    if _config_cache is None or (requested and requested != _config_cache_path):
        with _config_lock:
            if _config_cache is None or (
                requested and requested != _config_cache_path
            ):
                _config_cache = Frozen(deepcopy(load_config(path)))
                _config_cache_path = resolve_config_path(path)
    return _config_cache


def reset_config_cache() -> None:
    """Drop the config singleton (tests / multi-config processes)."""
    global _config_cache, _config_cache_path
    with _config_lock:
        _config_cache = None
        _config_cache_path = None
