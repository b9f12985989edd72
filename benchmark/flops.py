"""The operations of a training step of the β-VAE, from its sizes alone.

A frozen copy of the program's analytic count: per image, the forward's
multiply-adds × 2 of every convolution, the dense layers (``fc_mu``,
``fc_logvar``, ``fc_dec``) and the SE layers; a training step is three
times the forward (the backward's input and weight gradients), times the
batch.  Norms, activations, the upsample and the loss are not counted; no
recomputed operation is counted.
"""

from __future__ import annotations


def _conv(out_hw: int, cout: int, cin: int, k: int = 3) -> int:
    return 2 * out_hw * out_hw * cout * k * k * cin


def forward_flops_per_image(image_size: int, in_channels: int, latent: int,
                            base: int, blocks: int, decoder_se: bool = True,
                            se_reduction: int = 8) -> int:
    chs = [base * 2**i for i in range(blocks)]
    total, s, cin = 0, image_size, in_channels
    for c in chs:
        s = (s + 1) // 2
        total += _conv(s, c, cin) + 2 * (c * max(1, c // se_reduction) * 2)
        cin = c
    flat = chs[-1] * s * s
    total += 3 * 2 * flat * latent
    dec = list(reversed(chs))
    for i in range(blocks):
        cout = dec[i + 1] if i + 1 < blocks else dec[-1]
        s *= 2
        total += _conv(s, cout, cin)
        if decoder_se:
            total += 2 * (cout * max(1, cout // se_reduction) * 2)
        cin = cout
    return total + _conv(s, in_channels, cin)


def train_step_flops(batch: int, **sizes) -> int:
    return 3 * forward_flops_per_image(**sizes) * batch


def sizes(cfg: dict) -> dict:
    """The keyword sizes of a configuration file's ``model`` and ``data``."""
    m, d = cfg["model"], cfg["data"]
    return {"image_size": int(d["image_size"]),
            "in_channels": 1 if d["grayscale"] else 3,
            "latent": int(m["latent_dim"]), "base": int(m["base_channels"]),
            "blocks": int(m["num_blocks"]),
            "decoder_se": bool(m["use_decoder_se"]),
            "se_reduction": int(m["se_reduction_ratio"])}
