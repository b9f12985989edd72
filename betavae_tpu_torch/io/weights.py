"""The JAX package's flat flax params → the port's ``state_dict``.

The port's own copy of the mapping in ``betavae_tpu/io/torch_compat.py``
(``export_model_state``): conv kernels HWIO → OIHW, dense kernels
transposed, SE ``fc1``/``fc2`` → ``se.block.fc.0``/``.2``, GroupNorm and
BatchNorm params (running statistics from ``batch_stats/``), and the
bottleneck-flatten permutation on ``fc_mu``, ``fc_logvar`` and ``fc_dec``:
flax flattens the (S, S, C) bottleneck H-major, torch flattens (C, S, S)
C-major.  A key the mapping does not consume raises.
"""

from __future__ import annotations

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
