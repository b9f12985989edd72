"""The plain reference of the β-VAE training step, in float32 torch.

What it computes, from the configuration file alone (no module of the
program is imported, nothing the program made is read):

- encoder: ``num_blocks`` × [3×3 stride-2 conv → GroupNorm(1, eps 1e-6) →
  ReLU → SE], widths ``base·2^i``; flatten; ``fc_mu`` and ``fc_logvar``,
  logσ² clamped to ``model.logvar_clamp``;
- z = μ + ε·exp(½ logσ²) with ε of :func:`.streams.step_noise`;
- decoder: ``fc_dec`` reshaped to the bottleneck grid, ``num_blocks`` ×
  [bilinear ×2 (half-pixel centres, edge clamp) → 3×3 conv → GroupNorm(1)
  → ReLU → SE], a final 3×3 conv and a sigmoid;
- SE: mean over H, W → Linear(C → max(1, C // r)) → ReLU → Linear → sigmoid
  → channel scale;
- loss: per-sample summed squared error, masked mean over the batch; the
  focal frequency loss (ortho 2-D FFT of the difference, focal weight
  ``(dist / per-channel mean)^α`` clamped at 1e-8) times its weight; the
  capacity term ``γ·|KL_mean − C|``;
- the update: optax's global-norm clip ``g · clip / max(‖g‖, clip)``, then
  Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, no weight decay).

Parameters are named as the published torch model names them
(``encoder.{i}.conv``, ``encoder.{i}.se.block.fc.{0,2}``, ``fc_mu``,
``decoder_blocks.{i}.up.1``, ``final_conv``, …), which is how the benchmark
hands the same seeded weights to both sides.

``precision="fp8"`` is the control: every convolution's and linear layer's
input and weight rounded to float8 e4m3 with a per-tensor scale (amax /
448) on the way in, the rest as above.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import streams

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0


@dataclass(frozen=True)
class Spec:
    image_size: int
    in_channels: int
    latent: int
    base: int
    blocks: int
    se_reduction: int
    decoder_se: bool
    logvar_clamp: tuple
    ffl_weight: float
    ffl_alpha: float
    grad_clip: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Spec":
        m, loss, tr = cfg["model"], cfg["loss"], cfg["training"]
        unsupported = {
            "model.encoder_norm": (m["encoder_norm"], "layer"),
            "model.activation": (m["activation"], "relu"),
            "model.reconstruction_loss": (m["reconstruction_loss"], "mse"),
            "model.encoder_pooling": (m.get("encoder_pooling", "flatten"),
                                      "flatten"),
            "model.latent_clamp": (m.get("latent_clamp"), None),
            "model.deterministic_overfit": (
                bool(m.get("deterministic_overfit", False)), False),
            "loss.use_lpips": (bool(loss.get("use_lpips", False)), False),
            "optimization.optimizer": (cfg["optimization"]["optimizer"],
                                       "adam"),
            "optimization.weight_decay": (
                float(cfg["optimization"].get("weight_decay") or 0.0), 0.0),
        }
        for key, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(f"the plain reference has no "
                                          f"{key} = {got!r}")
        clamp = m.get("logvar_clamp") or (-10.0, 10.0)
        return cls(
            image_size=int(cfg["data"]["image_size"]),
            in_channels=1 if cfg["data"]["grayscale"] else 3,
            latent=int(m["latent_dim"]), base=int(m["base_channels"]),
            blocks=int(m["num_blocks"]),
            se_reduction=int(m["se_reduction_ratio"]),
            decoder_se=bool(m["use_decoder_se"]),
            logvar_clamp=(float(clamp[0]), float(clamp[1])),
            ffl_weight=(float(loss.get("ffl_weight") or 0.0)
                        if loss.get("use_ffl") else 0.0),
            ffl_alpha=float(loss.get("ffl_alpha", 1.0)),
            grad_clip=float(tr.get("grad_clip") or 0.0))

    @property
    def widths(self) -> list:
        return [self.base * 2**i for i in range(self.blocks)]

    @property
    def bottleneck(self) -> int:
        s = self.image_size
        for _ in range(self.blocks):
            s = (s + 1) // 2
        return s


def parameters(spec: Spec) -> list:
    """``(name, shape, kind)`` of every parameter; ``kind`` is ``conv``,
    ``linear`` (weights, fan-in from the shape), ``bias``, ``gn_weight`` or
    ``gn_bias``."""
    out = []

    def conv(name, cout, cin):
        out.append((f"{name}.weight", (cout, cin, 3, 3), "conv"))
        out.append((f"{name}.bias", (cout,), "bias"))

    def linear(name, fout, fin):
        out.append((f"{name}.weight", (fout, fin), "linear"))
        out.append((f"{name}.bias", (fout,), "bias"))

    def gn(name, c):
        out.append((f"{name}.weight", (c,), "gn_weight"))
        out.append((f"{name}.bias", (c,), "gn_bias"))

    def se(name, c):
        r = max(1, c // spec.se_reduction)
        linear(f"{name}.block.fc.0", r, c)
        linear(f"{name}.block.fc.2", c, r)

    chs = spec.widths
    for i, c in enumerate(chs):
        conv(f"encoder.{i}.conv", c, spec.in_channels if i == 0 else chs[i - 1])
        gn(f"encoder.{i}.norm", c)
        se(f"encoder.{i}.se", c)
    flat = chs[-1] * spec.bottleneck ** 2
    linear("fc_mu", spec.latent, flat)
    linear("fc_logvar", spec.latent, flat)
    linear("fc_dec", flat, spec.latent)
    dec = list(reversed(chs))
    for i in range(spec.blocks):
        cout = dec[i + 1] if i + 1 < len(dec) else dec[-1]
        conv(f"decoder_blocks.{i}.up.1", cout, dec[i])
        gn(f"decoder_blocks.{i}.norm", cout)
        if spec.decoder_se:
            se(f"decoder_blocks.{i}.se", cout)
    conv("final_conv", spec.in_channels, dec[-1])
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale, passed straight through
    in the backward."""
    x = t.detach().float()
    scale = x.abs().amax().clamp_min(1e-12) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q.to(t.dtype) - t.detach())


class _Ops:
    """The operations at a precision: ``fp32``; ``bf16``, the program's
    mixed precision (autocast to bf16 over the blocks, the SE layers and
    ``fc_dec``; GroupNorm computed in fp32 and returned in its input's
    dtype; ``fc_mu``, ``fc_logvar``, ε and the sigmoid in fp32); ``fp8``,
    the control: ``bf16`` with every convolution's and linear layer's
    operands rounded to e4m3 first."""

    def __init__(self, precision: str, device_type: str):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision fp32, bf16 or fp8, got {precision!r}")
        self.q = _fp8 if precision == "fp8" else (lambda t: t)
        self.mixed = precision != "fp32"
        self.device_type = device_type

    def autocast(self, on: bool = True):
        return torch.autocast(self.device_type, dtype=torch.bfloat16,
                              enabled=self.mixed and on)

    def conv(self, x, P, name, stride=1):
        return F.conv2d(self.q(x), self.q(P[f"{name}.weight"]),
                        P[f"{name}.bias"], stride=stride, padding=1)

    def linear(self, x, P, name):
        return F.linear(self.q(x), self.q(P[f"{name}.weight"]),
                        P[f"{name}.bias"])

    def se(self, x, P, name):
        h = F.relu(self.linear(x.mean(dim=(2, 3)), P, f"{name}.block.fc.0"))
        gate = torch.sigmoid(self.linear(h, P, f"{name}.block.fc.2"))
        return x * gate[:, :, None, None]

    def block(self, x, P, name, conv_name, stride, se):
        h = self.conv(x, P, conv_name, stride)
        h = F.group_norm(h, 1, P[f"{name}.norm.weight"],
                         P[f"{name}.norm.bias"], eps=1e-6).to(h.dtype)
        h = F.relu(h)
        return self.se(h, P, f"{name}.se") if se else h


def forward(P: dict, x: torch.Tensor, eps: torch.Tensor, spec: Spec,
            ops: _Ops):
    """``(recon, mu, logvar)`` of NCHW ``x`` in [0, 1]."""
    with ops.autocast():
        h = x
        for i in range(spec.blocks):
            h = ops.block(h, P, f"encoder.{i}", f"encoder.{i}.conv", 2, True)
        h = h.reshape(h.shape[0], -1)
    with ops.autocast(False):
        h = h.float()
        mu = ops.linear(h, P, "fc_mu")
        logvar = ops.linear(h, P, "fc_logvar").clamp(*spec.logvar_clamp)
        z = mu + eps * torch.exp(0.5 * logvar)
    s, c = spec.bottleneck, spec.widths[-1]
    with ops.autocast():
        h = ops.linear(z, P, "fc_dec").reshape(z.shape[0], c, s, s)
        for i in range(spec.blocks):
            h = F.interpolate(h, scale_factor=2, mode="bilinear",
                              align_corners=False)
            h = ops.block(h, P, f"decoder_blocks.{i}",
                          f"decoder_blocks.{i}.up.1", 1, spec.decoder_se)
        x = ops.conv(h, P, "final_conv")
    return torch.sigmoid(x.float()), mu, logvar


def loss(recon, x, mu, logvar, mask, sched: dict, spec: Spec) -> torch.Tensor:
    msum = torch.clamp_min(mask.sum(), 1.0)
    base = (((recon - x) ** 2).sum(dim=(1, 2, 3)) * mask).sum() / msum
    total = base
    if spec.ffl_weight > 0:
        f = torch.fft.fft2(recon - x, norm="ortho")
        dist = f.real ** 2 + f.imag ** 2
        b, c, h, w = dist.shape
        denom = dist.sum(dim=(0, 2, 3), keepdim=True) / (b * h * w) + 1e-8
        weight = torch.clamp(dist / denom, min=1e-8) ** spec.ffl_alpha
        total = total + spec.ffl_weight * (weight * dist).sum() / (b * c * h * w)
    kl = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar))
    kl_mean = (kl.sum(dim=1) * mask).sum() / msum
    return total + sched["capacity_weight"] * torch.abs(kl_mean
                                                        - sched["capacity"])


def _gradients(P: dict, x, eps, mask, sched, spec, ops):
    """``(loss, grads)`` of the whole batch."""
    names = list(P)
    for p in P.values():
        p.requires_grad_(True)
    recon, mu, logvar = forward(P, x, eps, spec, ops)
    total = loss(recon, x, mu, logvar, mask, sched, spec)
    grads = torch.autograd.grad(total, [P[n] for n in names])
    for p in P.values():
        p.requires_grad_(False)
    return total.detach(), dict(zip(names, grads))


def train(P0: dict, batches, spec: Spec, *, precision: str = "fp32") -> dict:
    """Run the steps of ``batches`` from the weights ``P0`` (left as they
    are): each batch a dict of ``x`` (NCHW fp32 in [0, 1], augmented),
    ``eps``, ``mask`` and ``sched`` (``capacity``, ``capacity_weight``,
    ``lr``).  Returns the readings: ``losses`` a step, ``grad_norms`` (each
    leaf's norm of the first step's clipped gradient) and ``change_norms``
    (each leaf's ‖p − p0‖ after the last step)."""
    ops = _Ops(precision, next(iter(P0.values())).device.type)
    P = {n: p.detach().clone().float() for n, p in P0.items()}
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    losses, grad_norms = [], None
    for t, b in enumerate(batches, start=1):
        total, g = _gradients(P, b["x"], b["eps"], b["mask"], b["sched"],
                              spec, ops)
        losses.append(float(total))
        if spec.grad_clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(x) for x in g.values()]))
            scale = spec.grad_clip / torch.clamp_min(norm, spec.grad_clip)
            g = {n: x * scale for n, x in g.items()}
        if grad_norms is None:
            grad_norms = {n: float(torch.linalg.vector_norm(x))
                          for n, x in g.items()}
        lr = float(b["sched"]["lr"])
        bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
        with torch.no_grad():
            for n in P:
                m[n].mul_(B1).add_(g[n], alpha=1.0 - B1)
                v[n].mul_(B2).addcmul_(g[n], g[n], value=1.0 - B2)
                P[n] -= lr * (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + ADAM_EPS)
        del g
    change = {n: float(torch.linalg.vector_norm(P[n] - P0[n].float()))
              for n in P}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def prepare_batch(images_u8: torch.Tensor, idx: torch.Tensor, seed: int,
                  step: int, aug: dict, latent: int) -> dict:
    """The step's input as the reference takes it: the uint8 NHWC rows
    ``idx`` as NCHW fp32 in [0, 1], augmented by the step's uniforms, and
    the step's ε."""
    x = images_u8.index_select(0, idx).permute(0, 3, 1, 2).float() / 255.0
    u = streams.augment_uniforms(seed, step, x.shape[0], aug, x.device)
    x = streams.augment(x.contiguous(), u, aug)
    eps = streams.step_noise((x.shape[0], latent), seed, step, x.device)
    return {"x": x, "eps": eps}


def initial_weights(spec: Spec, seed: int, device) -> dict:
    """The weights the trainer starts from: Kaiming-normal fan-in weights
    (gain √2) drawn in the order of the published model's modules from one
    CPU ``torch.Generator`` seeded ``seed`` (``data.seed``), zero biases,
    GroupNorm scales 1 and shifts 0."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape, kind in parameters(spec):
        if kind in ("conv", "linear"):
            w = torch.empty(shape)
            torch.nn.init.kaiming_normal_(w, mode="fan_in",
                                          nonlinearity="relu", generator=gen)
        elif kind == "gn_weight":
            w = torch.ones(shape)
        else:
            w = torch.zeros(shape)
        out[name] = w.to(device)
    return out


@torch.no_grad()
def validation(P: dict, batches, spec: Spec, sched: dict,
               precision: str = "fp32") -> float:
    """The mean over ``batches`` (each ``x``, ``eps``, ``mask``) of each
    batch's loss, without augmentation or autograd."""
    ops = _Ops(precision, next(iter(P.values())).device.type)
    totals = []
    for b in batches:
        recon, mu, logvar = forward(P, b["x"], b["eps"], spec, ops)
        totals.append(float(loss(recon, b["x"], mu, logvar, b["mask"], sched,
                                 spec)))
    return sum(totals) / max(1, len(totals))
