"""The operations of a training step of Stable Diffusion's autoencoder
(``model.architecture: autoencoder_kl``), from its sizes alone, and the
shapes of its GroupNorms and attention calls.

Per image, the forward's multiply-adds × 2 of every convolution (3×3 and
1×1, ``quant_conv`` and ``post_quant_conv`` among them) and of each
attention's two matmuls (qᵀk and the product with v); a training step is
three times the forward (the backward's input and weight gradients),
times the batch.  Norms, swish, the resampling, the reparameterisation and
the loss are not counted; no recomputed operation is counted.
"""

from __future__ import annotations


def _layers(cfg: dict) -> dict:
    """``convs`` (out side, cout, cin, k), ``attn`` (side, C) and
    ``norms`` (C, side) of one image's forward."""
    m, d = cfg["model"], cfg["data"]
    ch, mult = int(m["ch"]), [int(c) for c in m["ch_mult"]]
    blocks, z = int(m["num_res_blocks"]), int(m["z_channels"])
    attn_at = {int(r) for r in m.get("attn_resolutions") or ()}
    cin_img = 1 if d["grayscale"] else 3
    widths = [ch * c for c in mult]
    out = {"convs": [], "attn": [], "norms": []}

    def resnet(s, cin, cout):
        out["norms"] += [(cin, s), (cout, s)]
        out["convs"] += [(s, cout, cin, 3), (s, cout, cout, 3)]
        if cin != cout:
            out["convs"].append((s, cout, cin, 1))

    def attn(s, c):
        out["norms"].append((c, s))
        out["convs"] += [(s, c, c, 1)] * 4
        out["attn"].append((s, c))

    def mid(s, c):
        resnet(s, c, c)
        attn(s, c)
        resnet(s, c, c)

    s = int(d["image_size"])
    out["convs"].append((s, ch, cin_img, 3))
    c = ch
    for i, w in enumerate(widths):
        for _ in range(blocks):
            resnet(s, c, w)
            c = w
            if s in attn_at:
                attn(s, w)
        if i < len(widths) - 1:
            s //= 2
            out["convs"].append((s, w, w, 3))
    mid(s, c)
    out["norms"].append((c, s))
    out["convs"] += [(s, 2 * z, c, 3), (s, 2 * z, 2 * z, 1), (s, z, z, 1),
                     (s, widths[-1], z, 3)]
    c = widths[-1]
    mid(s, c)
    for i in reversed(range(len(widths))):
        for _ in range(blocks + 1):
            resnet(s, c, widths[i])
            c = widths[i]
            if s in attn_at:
                attn(s, c)
        if i:
            s *= 2
            out["convs"].append((s, c, c, 3))
    out["norms"].append((c, s))
    out["convs"].append((s, cin_img, c, 3))
    return out


def attention_calls(cfg: dict) -> list:
    """``(side, C)`` of each attention call of one forward."""
    return _layers(cfg)["attn"]


def norm_shapes(cfg: dict) -> list:
    """``(C, side)`` of each GroupNorm of one forward."""
    return _layers(cfg)["norms"]


def forward_flops_per_image(cfg: dict) -> int:
    layers = _layers(cfg)
    total = sum(2 * s * s * cout * cin * k * k
                for s, cout, cin, k in layers["convs"])
    return total + sum(2 * 2 * (s * s) ** 2 * c for s, c in layers["attn"])


def train_step_flops(batch: int, cfg: dict) -> int:
    return 3 * forward_flops_per_image(cfg) * batch
