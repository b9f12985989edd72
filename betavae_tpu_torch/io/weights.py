"""Weights and optimizer state across the two packages.

:func:`params_from_jax` is the port's own copy of the mapping in
``betavae_tpu/io/torch_compat.py`` (``export_model_state``): conv kernels
HWIO → OIHW, dense kernels transposed, SE ``fc1``/``fc2`` →
``se.block.fc.0``/``.2``, GroupNorm and BatchNorm params (running statistics
from ``batch_stats/``), and the bottleneck-flatten permutation on
``fc_mu``, ``fc_logvar`` and ``fc_dec``: flax flattens the (S, S, C)
bottleneck H-major, torch flattens (C, S, S) C-major.  A key the mapping
does not consume raises.

Optimizer state: the port's checkpoints hold its ``torch.optim`` state
flat, ``<param index>/<field>`` (``exp_avg``, ``exp_avg_sq``, ``step`` for
Adam), indexed in ``model.parameters()`` order, which is the reference
torch model's registration order; the JAX loader converts exactly that
layout (``torch_compat.convert_adam_moments``).  The other way,
:func:`adam_state_from_optax` maps an optax Adam state's ``mu`` / ``nu`` /
``count`` through the same parameter mapping (moments are elementwise
companions of their parameter).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def flat_permutation(channels: int, side: int) -> np.ndarray:
    """``perm[f] = t``: the torch C-major flat index of flax H-major index
    ``f`` (torch ``c·S·S + h·S + w``, flax ``(h·S + w)·C + c``)."""
    h, w, c = np.meshgrid(np.arange(side), np.arange(side),
                          np.arange(channels), indexing="ij")
    return (c * side * side + h * side + w).reshape(-1)


class _Tracked:
    """Dict view that records every key read, for the unconsumed-key guard."""

    def __init__(self, d: dict):
        self._d = d
        self.used: set = set()

    def __getitem__(self, key):
        self.used.add(key)
        return self._d[key]

    def __contains__(self, key):
        return key in self._d


def _block(src: _Tracked, fx: str, tp: str, conv_name: str) -> dict:
    out = {
        f"{tp}.{conv_name}.weight": np.transpose(
            src[f"params/{fx}/conv/kernel"], (3, 2, 0, 1)),  # HWIO -> OIHW
        f"{tp}.{conv_name}.bias": src[f"params/{fx}/conv/bias"],
    }
    if f"params/{fx}/norm/bn/scale" in src:
        out[f"{tp}.norm.weight"] = src[f"params/{fx}/norm/bn/scale"]
        out[f"{tp}.norm.bias"] = src[f"params/{fx}/norm/bn/bias"]
        out[f"{tp}.norm.running_mean"] = src[f"batch_stats/{fx}/norm/bn/mean"]
        out[f"{tp}.norm.running_var"] = src[f"batch_stats/{fx}/norm/bn/var"]
        out[f"{tp}.norm.num_batches_tracked"] = np.asarray(0, np.int64)
    elif f"params/{fx}/norm/gn/scale" in src:
        out[f"{tp}.norm.weight"] = src[f"params/{fx}/norm/gn/scale"]
        out[f"{tp}.norm.bias"] = src[f"params/{fx}/norm/gn/bias"]
    if f"params/{fx}/se/fc1/kernel" in src:
        out[f"{tp}.se.block.fc.0.weight"] = src[f"params/{fx}/se/fc1/kernel"].T
        out[f"{tp}.se.block.fc.0.bias"] = src[f"params/{fx}/se/fc1/bias"]
        out[f"{tp}.se.block.fc.2.weight"] = src[f"params/{fx}/se/fc2/kernel"].T
        out[f"{tp}.se.block.fc.2.bias"] = src[f"params/{fx}/se/fc2/bias"]
    return out


def params_from_jax(flat: dict) -> dict:
    """``{"params/enc_0/conv/kernel": array, ..., "batch_stats/...": ...}``
    → ``{"encoder.0.conv.weight": tensor, ...}`` for
    ``BetaVAEModule.load_state_dict(strict=True)``."""
    raw = {k: np.asarray(v) for k, v in flat.items()}
    src = _Tracked(raw)

    def block_ids(prefix: str):
        return sorted({int(k.split("/")[1].split("_")[-1]) for k in raw
                       if k.startswith(f"params/{prefix}_")})

    enc_ids, dec_ids = block_ids("enc"), block_ids("dec")
    if not enc_ids or "params/fc_mu/kernel" not in raw:
        raise ValueError("flat params do not look like the JAX BetaVAE "
                         f"(keys: {sorted(raw)[:6]}...)")

    out = {}
    for i in enc_ids:
        out.update(_block(src, f"enc_{i}", f"encoder.{i}", "conv"))
    for i in dec_ids:
        out.update(_block(src, f"dec_{i}", f"decoder_blocks.{i}", "up.1"))
    out["final_conv.weight"] = np.transpose(src["params/final_conv/kernel"],
                                            (3, 2, 0, 1))
    out["final_conv.bias"] = src["params/final_conv/bias"]

    k_mu = src["params/fc_mu/kernel"]                       # (flat, latent)
    flat_dim = k_mu.shape[0]
    channels = raw[f"params/enc_{enc_ids[-1]}/conv/kernel"].shape[3]
    if flat_dim == channels:
        perm = np.arange(flat_dim)  # gap pooling: nothing spatial to reorder
    else:
        side = int(round((flat_dim // channels) ** 0.5))
        if channels * side * side != flat_dim:
            raise ValueError(f"cannot infer bottleneck geometry: "
                             f"flat={flat_dim}, C={channels}")
        perm = flat_permutation(channels, side)
    for head in ("fc_mu", "fc_logvar"):
        k = src[f"params/{head}/kernel"]
        w = np.empty((k.shape[1], k.shape[0]), k.dtype)
        w[:, perm] = k.T
        out[f"{head}.weight"] = w
        out[f"{head}.bias"] = src[f"params/{head}/bias"]
    k_dec = src["params/fc_dec/kernel"]                     # (latent, flat)
    w = np.empty_like(k_dec)
    w[:, perm] = k_dec
    out["fc_dec.weight"] = w.T
    b_dec = src["params/fc_dec/bias"]
    b = np.empty_like(b_dec)
    b[perm] = b_dec
    out["fc_dec.bias"] = b

    leftovers = set(raw) - src.used
    if leftovers:
        raise ValueError(f"unconsumed JAX parameters: {sorted(leftovers)}")
    return {k: torch.from_numpy(np.ascontiguousarray(
                v if v.dtype == np.int64 else v.astype(np.float32)))
            for k, v in out.items()}


def optim_state_tensors(optimizer: torch.optim.Optimizer) -> dict:
    """``{"<param index>/<field>": tensor}`` of the optimizer's state: the
    live tensors, on their devices, not copies."""
    return {f"{idx}/{field}": torch.as_tensor(val).detach()
            for idx, fields in optimizer.state_dict()["state"].items()
            for field, val in fields.items()}


def optim_state_from_flat(flat: dict, optimizer: torch.optim.Optimizer) -> None:
    """Load :func:`optim_state_tensors` output, as host arrays, into
    ``optimizer`` (its own hyperparameters kept)."""
    state: dict = {}
    for key, arr in flat.items():
        idx, _, field = key.partition("/")
        state.setdefault(int(idx), {})[field] = torch.from_numpy(
            np.array(arr))
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)


def _optax_adam(optim_flat: dict):
    """``(mu, nu, count)`` of the ScaleByAdamState in a flat optax state: the
    prefix whose ``mu/``, ``nu/`` and ``count`` entries sit side by side
    (``mu`` a whole path segment, as ``fc_mu`` also holds the letters)."""
    prefixes = set()
    for key in optim_flat:
        segs = key.split("/")
        prefixes.update("/".join(segs[:i]) for i, seg in enumerate(segs[:-1])
                        if seg == "mu")
    for prefix in sorted(prefixes):
        pre = f"{prefix}/" if prefix else ""
        mu = {k[len(pre) + 3:]: np.asarray(v) for k, v in optim_flat.items()
              if k.startswith(f"{pre}mu/")}
        nu = {k[len(pre) + 3:]: np.asarray(v) for k, v in optim_flat.items()
              if k.startswith(f"{pre}nu/")}
        if mu and set(mu) == set(nu) and f"{pre}count" in optim_flat:
            return mu, nu, int(np.asarray(optim_flat[f"{pre}count"]).reshape(()))
    return None


def adam_state_from_optax(optim_flat: dict, model_flat: dict,
                          param_names: list):
    """A JAX checkpoint's optax Adam state → torch Adam ``state``
    (``{index: {"step", "exp_avg", "exp_avg_sq"}}``, indexed like
    ``param_names``), or ``None`` with a warning when it holds no Adam
    moments for exactly these parameters (e.g. sgd): the run then resumes
    with a fresh optimizer, as the JAX package does."""
    found = _optax_adam(optim_flat)
    params = {k[len("params/"):] for k in model_flat if k.startswith("params/")}
    if found is None or set(found[0]) != params:
        warnings.warn("optimizer-state import skipped: the checkpoint's optax "
                      "state has no Adam moments for these parameters; "
                      "resuming with a FRESH optimizer")
        return None
    mu, nu, count = found
    moments = {}
    for field, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        swapped = dict(model_flat)   # batch_stats keep their real values
        swapped.update({f"params/{path}": m for path, m in tree.items()})
        moments[field] = params_from_jax(swapped)
    return {i: {"step": torch.tensor(float(count)),
                "exp_avg": moments["exp_avg"][name],
                "exp_avg_sq": moments["exp_avg_sq"][name]}
            for i, name in enumerate(param_names)}
