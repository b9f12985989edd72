"""The hand-written kernels' wrappers, with their plain versions."""

from __future__ import annotations

import functools


@functools.cache
def kernel_wrappers() -> dict:
    """Every wrapper that launches a hand-written kernel, by name, each
    counting its launches in ``.launches`` (and by path in
    ``.launches_by_path`` where a kernel has more than one): the objects
    themselves, as the first call finds them, whatever a caller patches
    into the modules later (a wrapper around a wrapper counts nothing)."""
    from .elbo import fused_reparam_kl, reparam_kl_backward
    from .gn import gn_backward, gn_forward
    from .gn_silu import gn_silu_backward, gn_silu_forward
    from .head import head_forward, head_m
    from .upsample import upsample2x_backward, upsample2x_forward

    return {"fused_reparam_kl": fused_reparam_kl,
            "reparam_kl_backward": reparam_kl_backward,
            "head_forward": head_forward, "head_m": head_m,
            "gn_forward": gn_forward, "gn_backward": gn_backward,
            "gn_silu_forward": gn_silu_forward,
            "gn_silu_backward": gn_silu_backward,
            "upsample_forward": upsample2x_forward,
            "upsample_backward": upsample2x_backward}
