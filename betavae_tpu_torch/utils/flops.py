"""Analytic FLOP accounting for the β-VAE: per-layer counts and the step's
roofline floor on an H100.

The port's own copy of ``betavae_tpu/utils/flops.py`` with the same counts;
only the card changes: the defaults are the H100 SXM's data sheet (dense
bf16 on the tensor cores, HBM3 bandwidth, at the full 700 W power limit)
instead of the TPU's, and ``data_parallel_scaling`` models the gradient
all-reduce over NVLink instead of the TPU's interconnect.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
H100_SXM_BF16_TFLOPS = 989.0
H100_SXM_HBM_GBPS = 3350.0
# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s a GPU in both directions
# together, so 450 GB/s a direction: what each rank of a ring sends at most
H100_SXM_NVLINK_GBPS = 450.0


@dataclass
class LayerFlops:
    name: str
    flops: int          # forward multiply-adds × 2
    out_shape: tuple


def _conv_flops(out_h, out_w, cout, kh, kw, cin):
    return 2 * out_h * out_w * cout * kh * kw * cin


def model_forward_flops(image_size: int, in_channels: int, latent_dim: int,
                        base_channels: int, num_blocks: int,
                        use_decoder_se: bool = True,
                        se_reduction: int = 8):
    """Per-image forward FLOPs of the model (convs + dense + SE)."""
    layers = []
    chs = [base_channels * (2**i) for i in range(num_blocks)]

    s = image_size
    cin = in_channels
    for i, c in enumerate(chs):
        s = (s + 1) // 2
        layers.append(LayerFlops(f"enc_{i}.conv",
                                 _conv_flops(s, s, c, 3, 3, cin), (s, s, c)))
        r = max(1, c // se_reduction)
        layers.append(LayerFlops(f"enc_{i}.se", 2 * (c * r * 2), (c,)))
        cin = c
    flat = chs[-1] * s * s
    layers.append(LayerFlops("fc_mu", 2 * flat * latent_dim, (latent_dim,)))
    layers.append(LayerFlops("fc_logvar", 2 * flat * latent_dim,
                             (latent_dim,)))
    layers.append(LayerFlops("fc_dec", 2 * latent_dim * flat, (flat,)))

    dec_chs = list(reversed(chs))
    cin = dec_chs[0]
    for i in range(num_blocks):
        cout = dec_chs[i + 1] if i + 1 < len(dec_chs) else dec_chs[-1]
        s = s * 2
        layers.append(LayerFlops(f"dec_{i}.conv",
                                 _conv_flops(s, s, cout, 3, 3, cin),
                                 (s, s, cout)))
        if use_decoder_se:
            r = max(1, cout // se_reduction)
            layers.append(LayerFlops(f"dec_{i}.se", 2 * (cout * r * 2),
                                     (cout,)))
        cin = cout
    layers.append(LayerFlops("final_conv",
                             _conv_flops(s, s, in_channels, 3, 3, cin),
                             (s, s, in_channels)))
    return layers


def train_step_flops(image_size: int, in_channels: int, latent_dim: int,
                     base_channels: int, num_blocks: int, batch_size: int,
                     remat: bool = False, **kw) -> dict:
    """Total train-step FLOPs: fwd + ~2x fwd backward (+1x fwd if remat)."""
    layers = model_forward_flops(image_size, in_channels, latent_dim,
                                 base_channels, num_blocks, **kw)
    fwd = sum(l.flops for l in layers)
    mult = 4.0 if remat else 3.0
    return {
        "forward_flops_per_image": fwd,
        "train_flops_per_image": int(fwd * mult),
        "train_flops_per_step": int(fwd * mult * batch_size),
        "layers": layers,
    }


def utilization(step_seconds: float, flops_per_step: int,
                peak_tflops: float = H100_SXM_BF16_TFLOPS) -> dict:
    """Achieved TFLOP/s and its share of the peak (``mfu``)."""
    achieved = flops_per_step / step_seconds / 1e12
    return {"achieved_tflops": round(achieved, 2),
            "peak_tflops": peak_tflops,
            "mfu": round(achieved / peak_tflops, 4)}


def speed_of_light_ms(image_size: int, in_channels: int, latent_dim: int,
                      base_channels: int, num_blocks: int, batch_size: int,
                      use_decoder_se: bool = True, dtype_bytes: int = 2,
                      param_count: int | None = None,
                      peak_tflops: float = H100_SXM_BF16_TFLOPS,
                      hbm_gbps: float = H100_SXM_HBM_GBPS) -> dict:
    """Per-op lower bound on step time: max(FLOP time, HBM time) summed.

    Models the fwd+bwd pass layer by layer: convs (fwd + dX + dW each
    max(compute, read-in + write-out)), GroupNorm (3 passes fwd / 4 bwd),
    SE gating (2/3 passes), bilinear upsample, the dense heads, the Adam
    update (7 fp32 passes over params), at the card's peak bf16 rate and
    HBM bandwidth.  Unreachable in practice (no fusion is perfect), but it
    says how much of a measured step is intrinsic.
    """
    peak = peak_tflops * 1e12
    bw = hbm_gbps * 1e9
    B = batch_size
    rows = []

    def conv(name, h_out, w_out, cin, cout, hw_in, k=3):
        fl = 2 * h_out * w_out * cout * k * k * cin * B
        bin_ = hw_in * hw_in * cin * dtype_bytes * B
        bout = h_out * w_out * cout * dtype_bytes * B
        wb = k * k * cin * cout * dtype_bytes
        fwd = max(fl / peak, (bin_ + bout + wb) / bw)
        bwd = 2 * max(fl / peak, (bin_ + bout + wb) / bw)   # dX + dW
        rows.append((name, fwd, bwd))

    def passes(name, numel, fwd_passes, bwd_passes):
        t = numel * dtype_bytes * B / bw
        rows.append((name, fwd_passes * t, bwd_passes * t))

    chs = [base_channels * (2**i) for i in range(num_blocks)]
    s = image_size
    cin = in_channels
    for i, c in enumerate(chs):
        so = (s + 1) // 2
        conv(f"enc{i}.conv", so, so, cin, c, s)
        passes(f"enc{i}.gn+relu", so * so * c, 3, 4)
        passes(f"enc{i}.se", so * so * c, 2, 3)
        s, cin = so, c

    flat = chs[-1] * s * s
    for nm, di, do in (("fc_mu", flat, latent_dim),
                       ("fc_logvar", flat, latent_dim),
                       ("fc_dec", latent_dim, flat)):
        fl = 2 * di * do * B
        byts = di * do * dtype_bytes + (di + do) * dtype_bytes * B
        t = max(fl / peak, byts / bw)
        rows.append((nm, t, 2 * t))

    dec = list(reversed(chs))
    for i in range(num_blocks):
        cin = dec[i]
        cout = dec[i + 1] if i + 1 < num_blocks else dec[-1]
        so = s * 2
        passes(f"dec{i}.up", s * s * cin + so * so * cin, 1, 1)
        conv(f"dec{i}.conv", so, so, cin, cout, so)
        passes(f"dec{i}.gn+relu", so * so * cout, 3, 4)
        if use_decoder_se:
            passes(f"dec{i}.se", so * so * cout, 2, 3)
        s = so

    conv("final_conv", s, s, chs[0], in_channels, s)
    passes("recon_tail", s * s * in_channels * 2, 6, 6)  # fp32 sigmoid/loss
    if param_count:
        rows.append(("adam", 0.0, 7 * param_count * 4 / bw))

    fwd_ms = sum(r[1] for r in rows) * 1e3
    bwd_ms = sum(r[2] for r in rows) * 1e3
    return {"sol_fwd_ms": round(fwd_ms, 3), "sol_bwd_ms": round(bwd_ms, 3),
            "sol_step_ms": round(fwd_ms + bwd_ms, 3),
            "layers": [(n, round(f * 1e3, 4), round(b * 1e3, 4))
                       for n, f, b in rows]}


def data_parallel_scaling(per_chip_step_ms: float, param_count: int,
                          n_chips: int,
                          link_gb_per_s: float = H100_SXM_NVLINK_GBPS,
                          grad_bytes_per_param: int = 4,
                          bwd_fraction: float = 0.6) -> dict:
    """Analytic N-GPU data-parallel efficiency: a prediction, never a
    measurement.

    The JAX package's model (``utils/flops.py::data_parallel_scaling``)
    with the link changed: the step's gradient all-reduce as a ring, each
    GPU moving ``2·(N−1)/N · param_count · grad_bytes`` bytes (reduce-scatter
    then all-gather) at ``link_gb_per_s``, by default the H100 SXM's NVLink
    4 rate a direction from the data sheet.  Gradients are fp32 (4 bytes a
    parameter; parameters stay fp32 under bf16 autocast).
    ``per_chip_step_ms`` is the single-GPU step at the per-GPU batch.
    ``overlapped`` assumes the all-reduce hides under the last
    ``bwd_fraction`` of the step (DDP starts a bucket's all-reduce as soon
    as its gradients are ready), ``serial`` that it does not.
    """
    if n_chips <= 1:
        return {"n_chips": n_chips, "comm_ms": 0.0,
                "step_ms_overlapped": per_chip_step_ms,
                "step_ms_serial": per_chip_step_ms,
                "efficiency_overlapped": 1.0, "efficiency_serial": 1.0}
    grad_bytes = param_count * grad_bytes_per_param
    wire = 2.0 * (n_chips - 1) / n_chips * grad_bytes
    comm_ms = wire / (link_gb_per_s * 1e9) * 1e3
    bwd_ms = bwd_fraction * per_chip_step_ms
    fwd_ms = per_chip_step_ms - bwd_ms
    overlapped = fwd_ms + max(bwd_ms, comm_ms)
    serial = per_chip_step_ms + comm_ms
    return {
        "n_chips": n_chips,
        "comm_ms": round(comm_ms, 4),
        "step_ms_overlapped": round(overlapped, 3),
        "step_ms_serial": round(serial, 3),
        "efficiency_overlapped": round(per_chip_step_ms / overlapped, 4),
        "efficiency_serial": round(per_chip_step_ms / serial, 4),
    }
