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

The reference's own torch-pickle checkpoints hold the same torch names, so
their model state maps by name (:func:`model_state_from_reference`), and
their Adam ``optim_state`` is keyed by parameter index in the reference's
registration order (:func:`reference_param_order`), which the port's
``model.parameters()`` follows: :func:`adam_state_from_reference` loads it
when the orders agree, else warns and gives ``None`` (a fresh optimizer),
as the JAX package's ``convert_adam_moments`` does.  The write side,
:func:`export_model_state` and :func:`export_adam_optim_state`, turns a
checkpoint of either package into the reference's payload.
"""

from __future__ import annotations

import re
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
    live tensors themselves, on their devices, not copies."""
    return {f"{idx}/{field}": torch.as_tensor(val)
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


def _adam_from_optax(optim_flat: dict, model_flat: dict, param_names: list):
    """``(state, None)``: an optax Adam state as torch Adam ``state``
    (``{index: {"step", "exp_avg", "exp_avg_sq"}}``, indexed like
    ``param_names``); ``(None, reason)`` when it holds no Adam moments for
    exactly these parameters (e.g. sgd)."""
    found = _optax_adam(optim_flat)
    params = {k[len("params/"):] for k in model_flat if k.startswith("params/")}
    if found is None or set(found[0]) != params:
        return None, ("the checkpoint's optax state has no Adam moments for "
                      "these parameters")
    mu, nu, count = found
    moments = {}
    for field, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        swapped = dict(model_flat)   # batch_stats keep their real values
        swapped.update({f"params/{path}": m for path, m in tree.items()})
        moments[field] = params_from_jax(swapped)
    return {i: {"step": torch.tensor(float(count)),
                "exp_avg": moments["exp_avg"][name],
                "exp_avg_sq": moments["exp_avg_sq"][name]}
            for i, name in enumerate(param_names)}, None


def adam_state_from_optax(optim_flat: dict, model_flat: dict,
                          param_names: list):
    """A JAX checkpoint's optax Adam state → torch Adam ``state``
    (``{index: {"step", "exp_avg", "exp_avg_sq"}}``, indexed like
    ``param_names``), or ``None`` with a warning when it holds no Adam
    moments for exactly these parameters (e.g. sgd): the run then resumes
    with a fresh optimizer, as the JAX package does."""
    state, reason = _adam_from_optax(optim_flat, model_flat, param_names)
    if state is None:
        warnings.warn(f"optimizer-state import skipped: {reason}; resuming "
                      "with a FRESH optimizer")
    return state


# ---------------------------------------------------------------------------
# the reference's torch-pickle checkpoints
# ---------------------------------------------------------------------------

# entries of the reference's model state that are not the model's: its loss
# modules, registered on the model, and BatchNorm's batch counter, which
# the JAX package does not track (the port's is set to 0, as
# params_from_jax sets it)
_SKIP_PREFIXES = ("lpips_loss.", "ffl_loss.")
_SKIP_SUFFIXES = (".num_batches_tracked",)
# a reference DeconvBlock whose conv is ``up`` itself rather than ``up.1``
# of an (upsample, conv) Sequential
_BARE_UP = re.compile(r"^(decoder_blocks\.\d+)\.up\.(weight|bias)$")


def is_jax_state(state: dict) -> bool:
    """Whether a checkpoint's model state holds the JAX package's flax
    paths (``params/...``) rather than torch module names."""
    return any("/" in key for key in state)


def model_state_from_reference(state: dict) -> dict:
    """The reference's torch-named model state under the port's names, as
    numpy arrays: the loss modules' entries dropped, the decoder conv's
    ``decoder_blocks.{i}.up`` spelling renamed ``.up.1``, and every
    ``num_batches_tracked`` 0."""
    out = {}
    for key, val in state.items():
        if key.startswith(_SKIP_PREFIXES):
            continue
        key = _BARE_UP.sub(r"\1.up.1.\2", key)
        out[key] = (np.asarray(0, np.int64) if key.endswith(_SKIP_SUFFIXES)
                    else np.asarray(val))
    return out


def reference_param_order(model_state_keys) -> list:
    """The reference BetaVAE's parameter names in ``model.parameters()``
    order, from a torch-named model state's keys (the JAX package's
    ``_torch_param_order``): each encoder block's conv, norm and SE, then
    ``fc_mu``, ``fc_logvar``, ``fc_dec``, each decoder block, and
    ``final_conv``, each module's ``weight`` before its ``bias``; buffers
    are not parameters."""
    keys = set(model_state_keys)

    def present(*names):
        return [n for n in names if n in keys]

    def block(tp: str, conv: str) -> list:
        return (present(f"{conv}.weight", f"{conv}.bias")
                + present(f"{tp}.norm.weight", f"{tp}.norm.bias")
                + present(f"{tp}.se.block.fc.0.weight",
                          f"{tp}.se.block.fc.0.bias",
                          f"{tp}.se.block.fc.2.weight",
                          f"{tp}.se.block.fc.2.bias"))

    def ids(prefix: str) -> list:
        return sorted({int(k.split(".")[1]) for k in keys
                       if k.startswith(prefix)})

    order = []
    for i in ids("encoder."):
        order += block(f"encoder.{i}", f"encoder.{i}.conv")
    order += present("fc_mu.weight", "fc_mu.bias", "fc_logvar.weight",
                     "fc_logvar.bias", "fc_dec.weight", "fc_dec.bias")
    for i in ids("decoder_blocks."):
        conv = (f"decoder_blocks.{i}.up.1"
                if f"decoder_blocks.{i}.up.1.weight" in keys
                else f"decoder_blocks.{i}.up")
        order += block(f"decoder_blocks.{i}", conv)
    return order + present("final_conv.weight", "final_conv.bias")


def _adam_from_index_keyed(optim_flat: dict, model_state: dict):
    """``(state, None)``: torch Adam state flat by ``<index>/<field>`` (the
    reference's, or the port's own) as ``{index: {"step", "exp_avg",
    "exp_avg_sq"}}`` with every ``step`` the one global count, the largest
    (the JAX package's rule), checked against the parameters of
    ``model_state`` in :func:`reference_param_order`; ``(None, reason)``
    when it does not fit them."""
    by_idx, steps = {}, []
    for key, arr in optim_flat.items():
        idx, _, field = key.partition("/")
        if not idx.isdigit():
            return None, f"non-integer param index {idx!r}"
        if field in ("exp_avg", "exp_avg_sq"):
            by_idx.setdefault(int(idx), {})[field] = np.asarray(arr)
        elif field == "step":
            steps.append(float(np.asarray(arr).reshape(())))
    if not by_idx:
        return None, "no exp_avg/exp_avg_sq tensors found (not Adam?)"
    order = reference_param_order(model_state)
    if set(by_idx) != set(range(len(order))):
        return None, (f"param count mismatch: the model has {len(order)} "
                      f"parameters, the optimizer state covers "
                      f"{len(by_idx)} indices")
    state = {}
    for i, name in enumerate(order):
        fields = by_idx[i]
        for field in ("exp_avg", "exp_avg_sq"):
            if field not in fields:
                return None, f"param {i} ({name}) has no {field}"
            if fields[field].shape != np.shape(model_state[name]):
                return None, (f"shape mismatch at param {i} ({name}): "
                              f"moment {fields[field].shape} vs parameter "
                              f"{np.shape(model_state[name])}")
        state[i] = {"exp_avg": torch.from_numpy(np.array(
                        fields["exp_avg"], np.float32)),
                    "exp_avg_sq": torch.from_numpy(np.array(
                        fields["exp_avg_sq"], np.float32))}
    if len(set(steps)) > 1:
        warnings.warn("torch Adam per-param step counts differ; using the "
                      "largest as the one global count")
    count = max(steps) if steps else 0.0
    for fields in state.values():
        fields["step"] = torch.tensor(count)
    return state, None


def adam_state_from_reference(optim_flat: dict, model_state: dict,
                              param_names: list):
    """The reference's Adam ``optim_state`` (flat ``<index>/<field>``) as
    torch Adam ``state`` for a model whose parameters are ``param_names``
    (``model.named_parameters()`` order), with one global step count; or
    ``None`` with a warning, and the run resumes with a fresh optimizer, when
    that order is not the reference's (:func:`reference_param_order` of
    ``model_state``) or the state does not fit the parameters."""
    if reference_param_order(model_state) != list(param_names):
        state, reason = None, ("the model's parameters are not in the "
                               "reference's registration order")
    else:
        state, reason = _adam_from_index_keyed(optim_flat, model_state)
    if state is None:
        warnings.warn(f"torch optimizer-state import skipped: {reason}; "
                      "resuming with a FRESH optimizer (moments lost)")
    return state


def export_model_state(state: dict) -> dict:
    """A checkpoint's model state, either package's, under the reference's
    torch names: C-contiguous float32 numpy arrays (``num_batches_tracked``
    int64)."""
    if is_jax_state(state):
        return {k: v.numpy() for k, v in params_from_jax(state).items()}
    return {k: np.array(v, np.int64 if np.asarray(v).dtype == np.int64
                        else np.float32, order="C")
            for k, v in state.items()}


def export_adam_optim_state(optim_flat: dict, model_state: dict, *,
                            lr: float, weight_decay: float = 0.0):
    """A checkpoint's optimizer state → the reference's ``Adam.state_dict()``
    payload ``{"state": {index: {"step", "exp_avg", "exp_avg_sq"}},
    "param_groups": [...]}``, indexed in the reference's registration order
    with one global step count, ``param_groups`` the reference's Adam
    defaults (betas (0.9, 0.999), eps 1e-8) with ``lr`` and
    ``weight_decay``: the JAX package's ``export_adam_optim_state``.  The
    optimizer state is an optax one for a JAX checkpoint, flat
    ``<index>/<field>`` for the port's own or the reference's.  ``None``
    with a warning when it holds no Adam moments for these parameters; the
    reference's ``--resume`` then restarts its optimizer."""
    exported = export_model_state(model_state)
    order = reference_param_order(exported)
    if is_jax_state(model_state):
        state, reason = _adam_from_optax(optim_flat, model_state, order)
    else:
        state, reason = _adam_from_index_keyed(optim_flat, exported)
    if state is None:
        warnings.warn(f"torch optimizer-state export skipped: {reason}; the "
                      "reference's --resume will restart its optimizer")
        return None
    return {"state": state,
            "param_groups": [{"lr": float(lr), "betas": (0.9, 0.999),
                              "eps": 1e-8, "weight_decay": float(weight_decay),
                              "amsgrad": False, "maximize": False,
                              "params": list(range(len(order)))}]}
