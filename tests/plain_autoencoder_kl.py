"""The plain reference of Stable Diffusion's autoencoder (AutoencoderKL
"kl-f8") and its training step, in float32 torch.

What it computes, from the configuration file alone (no module of the
program is imported, nothing the program made is read), after CompVis
latent-diffusion (``ldm/modules/diffusionmodules/model.py``,
``ldm/models/autoencoder.py``, ``ldm/modules/losses/contperceptual.py``):

- ``Norm`` = GroupNorm(``norm_groups``, eps 1e-6, affine); swish x·σ(x);
- ``ResnetBlock``: h = conv3×3(swish(Norm(x))), h = conv3×3(swish(Norm(h))),
  out = shortcut(x) + h, the shortcut a 1×1 conv (``nin_shortcut``) where
  the widths differ; dropout 0;
- ``AttnBlock(C)``: q, k, v 1×1 convs of Norm(x); w = softmax(qᵀk / √C)
  over the keys, by ``bmm`` as ldm writes it; out = x + proj_out(v·wᵀ);
  the scores, the softmax and the weighted sum in fp32 at every precision
  (from bf16 q, k, v under ``bf16``, as a fused attention kernel
  accumulates them; ldm under autocast would round the scores to bf16);
- ``Downsample``: pad (0, 1, 0, 1) with zeros, 3×3 stride-2 conv;
  ``Upsample``: nearest ×2, 3×3 conv;
- encoder: ``conv_in``; ``num_res_blocks`` blocks a level at widths
  ``ch·ch_mult``, attention where the level's side is in
  ``attn_resolutions``, a Downsample after every level but the last; mid
  (block, attention, block); Norm, swish, ``conv_out`` to 2·z;
  ``quant_conv`` 1×1; μ and logσ² its halves, logσ² clamped to [−30, 20];
- z = μ + ε·exp(½ logσ²), ε of :func:`.streams.step_noise` over the
  flattened ``[B, z·h·w]`` latent;
- decoder: ``post_quant_conv`` 1×1, ``conv_in``, mid, ``num_res_blocks +
  1`` blocks a level from the widest down, an Upsample after every level
  but the last, Norm, swish, ``conv_out``; no output activation;
- images: [0, 1] → [−1, 1] (2x − 1) in, the output compared in [−1, 1];
- loss (``LPIPSWithDiscriminator`` before ``disc_start``, with its learned
  logvar at 0, the LPIPS term and the discriminator left out): Σ|x − x̂| / B
  + β · Σ KL / B, KL = ½ Σ (μ² + σ² − 1 − logσ²), masked means over the
  batch;
- the update: Adam (betas from ``optimization.betas``, eps 1e-8,
  bias-corrected, no weight decay), the global-norm clip where
  ``training.grad_clip`` sets one.

Parameters are named as the published model names them
(``encoder.down.{i}.block.{j}.conv1``, ``encoder.mid.attn_1.q``,
``quant_conv``, ``decoder.up.{i}.upsample.conv``, …).

``precision="bf16"`` is the program's mixed precision: autocast to bf16
over the encoder's and the decoder's bodies (GroupNorm computed in fp32
and returned in its input's dtype), ``quant_conv``, ε and the loss in
fp32.  ``precision="fp8"`` is the control: ``bf16`` with every
convolution's input and weight rounded to float8 e4m3 with a per-tensor
scale (amax / 448) on the way in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import streams

ADAM_EPS = 1e-8
FP8_MAX = 448.0
LOGVAR_CLAMP = (-30.0, 20.0)


@dataclass(frozen=True)
class Spec:
    image_size: int
    in_channels: int
    ch: int
    ch_mult: tuple
    num_res_blocks: int
    z_channels: int
    norm_groups: int
    attn_resolutions: tuple
    beta: float
    betas: tuple
    grad_clip: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Spec":
        m, loss, tr = cfg["model"], cfg["loss"], cfg["training"]
        opt = cfg["optimization"]
        unsupported = {
            "model.architecture": (m.get("architecture"), "autoencoder_kl"),
            "model.reconstruction_loss": (m["reconstruction_loss"], "l1"),
            "model.deterministic_overfit": (
                bool(m.get("deterministic_overfit", False)), False),
            "model.latent_reg_lambda": (
                float(m.get("latent_reg_lambda") or 0.0), 0.0),
            "loss.use_lpips": (bool(loss.get("use_lpips", False)), False),
            "loss.use_ffl": (bool(loss.get("use_ffl", False)), False),
            "loss.capacity_schedule.enabled": (
                bool((loss.get("capacity_schedule") or {}).get("enabled")),
                False),
            "loss.free_bits": (float(loss.get("free_bits") or 0.0), 0.0),
            "beta_schedule.type": (cfg["beta_schedule"]["type"], "constant"),
            "optimization.optimizer": (opt["optimizer"], "adam"),
            "optimization.weight_decay": (
                float(opt.get("weight_decay") or 0.0), 0.0),
        }
        for key, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(f"the plain reference has no "
                                          f"{key} = {got!r}")
        return cls(
            image_size=int(cfg["data"]["image_size"]),
            in_channels=1 if cfg["data"]["grayscale"] else 3,
            ch=int(m["ch"]), ch_mult=tuple(int(c) for c in m["ch_mult"]),
            num_res_blocks=int(m["num_res_blocks"]),
            z_channels=int(m["z_channels"]),
            norm_groups=int(m["norm_groups"]),
            attn_resolutions=tuple(int(r) for r in
                                   m.get("attn_resolutions") or ()),
            beta=float(cfg["beta_schedule"]["end_beta"]),
            betas=tuple(float(b) for b in opt.get("betas") or (0.9, 0.999)),
            grad_clip=float(tr.get("grad_clip") or 0.0))

    @property
    def widths(self) -> list:
        return [self.ch * c for c in self.ch_mult]

    @property
    def latent_hw(self) -> int:
        return self.image_size // 2 ** (len(self.ch_mult) - 1)

    @property
    def latent(self) -> int:
        return self.z_channels * self.latent_hw ** 2


def _layout(spec: Spec) -> list:
    """``(name, kind, *sizes)`` of every module with parameters, in the
    order the published model makes them: ``conv`` (cout, cin, k), ``norm``
    (c)."""
    out = []

    def resnet(name, cin, cout):
        out.extend([(f"{name}.norm1", "norm", cin),
                    (f"{name}.conv1", "conv", cout, cin, 3),
                    (f"{name}.norm2", "norm", cout),
                    (f"{name}.conv2", "conv", cout, cout, 3)])
        if cin != cout:
            out.append((f"{name}.nin_shortcut", "conv", cout, cin, 1))

    def attn(name, c):
        out.append((f"{name}.norm", "norm", c))
        for p in ("q", "k", "v", "proj_out"):
            out.append((f"{name}.{p}", "conv", c, c, 1))

    def mid(name, c):
        resnet(f"{name}.block_1", c, c)
        attn(f"{name}.attn_1", c)
        resnet(f"{name}.block_2", c, c)

    w, res = spec.widths, spec.image_size
    out.append(("encoder.conv_in", "conv", spec.ch, spec.in_channels, 3))
    cin = spec.ch
    for i, cout in enumerate(w):
        for j in range(spec.num_res_blocks):
            resnet(f"encoder.down.{i}.block.{j}", cin, cout)
            cin = cout
            if res in spec.attn_resolutions:
                attn(f"encoder.down.{i}.attn.{j}", cout)
        if i < len(w) - 1:
            out.append((f"encoder.down.{i}.downsample.conv", "conv", cout,
                        cout, 3))
            res //= 2
    mid("encoder.mid", cin)
    out.append(("encoder.norm_out", "norm", cin))
    out.append(("encoder.conv_out", "conv", 2 * spec.z_channels, cin, 3))
    cin, res = w[-1], spec.latent_hw
    out.append(("decoder.conv_in", "conv", cin, spec.z_channels, 3))
    mid("decoder.mid", cin)
    for i in reversed(range(len(w))):
        for j in range(spec.num_res_blocks + 1):
            resnet(f"decoder.up.{i}.block.{j}", cin, w[i])
            cin = w[i]
            if res in spec.attn_resolutions:
                attn(f"decoder.up.{i}.attn.{j}", cin)
        if i:
            out.append((f"decoder.up.{i}.upsample.conv", "conv", cin, cin, 3))
            res *= 2
    out.append(("decoder.norm_out", "norm", cin))
    out.append(("decoder.conv_out", "conv", spec.in_channels, cin, 3))
    z2 = 2 * spec.z_channels
    out.append(("quant_conv", "conv", z2, z2, 1))
    out.append(("post_quant_conv", "conv", spec.z_channels, spec.z_channels,
                1))
    return out


def parameters(spec: Spec) -> list:
    """``(name, shape, kind)`` of every parameter; ``kind`` is ``conv``
    (weights, fan-in from the shape), ``bias``, ``gn_weight`` or
    ``gn_bias``."""
    out = []
    for name, kind, *s in _layout(spec):
        if kind == "conv":
            cout, cin, k = s
            out.append((f"{name}.weight", (cout, cin, k, k), "conv"))
            out.append((f"{name}.bias", (cout,), "bias"))
        else:
            out.append((f"{name}.weight", (s[0],), "gn_weight"))
            out.append((f"{name}.bias", (s[0],), "gn_bias"))
    return out


def initial_weights(spec: Spec, seed: int, device) -> dict:
    """PyTorch's default initialisation of the modules, drawn in the order
    they are made from one CPU ``torch.Generator`` seeded ``seed``: each
    conv's weight Kaiming-uniform (a = √5) and bias U(±1/√fan_in);
    GroupNorm scales 1 and shifts 0."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, kind, *s in _layout(spec):
        if kind == "conv":
            cout, cin, k = s
            w = torch.empty((cout, cin, k, k))
            torch.nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
            bound = 1.0 / math.sqrt(cin * k * k)
            b = torch.empty(cout).uniform_(-bound, bound, generator=gen)
        else:
            w, b = torch.ones(s[0]), torch.zeros(s[0])
        out[f"{name}.weight"], out[f"{name}.bias"] = w.to(device), b.to(device)
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale, passed straight through
    in the backward."""
    x = t.detach().float()
    scale = x.abs().amax().clamp_min(1e-12) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q.to(t.dtype) - t.detach())


class _Ops:
    """The operations at a precision: ``fp32``, ``bf16`` (autocast over
    the bodies) or ``fp8`` (the control)."""

    def __init__(self, precision: str, device_type: str, groups: int):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision fp32, bf16 or fp8, got {precision!r}")
        self.q = _fp8 if precision == "fp8" else (lambda t: t)
        self.mixed = precision != "fp32"
        self.device_type = device_type
        self.groups = groups

    def autocast(self, on: bool = True):
        return torch.autocast(self.device_type, dtype=torch.bfloat16,
                              enabled=self.mixed and on)

    def conv(self, x, P, name, stride=1, padding=None):
        w = P[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        return F.conv2d(self.q(x), self.q(w), P[f"{name}.bias"],
                        stride=stride, padding=pad)

    def norm(self, x, P, name):
        return F.group_norm(x, self.groups, P[f"{name}.weight"],
                            P[f"{name}.bias"], eps=1e-6).to(x.dtype)

    def norm_swish(self, x, P, name):
        return F.silu(self.norm(x, P, name))

    def resnet(self, x, P, name):
        h = self.conv(self.norm_swish(x, P, f"{name}.norm1"), P,
                      f"{name}.conv1")
        h = self.conv(self.norm_swish(h, P, f"{name}.norm2"), P,
                      f"{name}.conv2")
        if f"{name}.nin_shortcut.weight" in P:
            x = self.conv(x, P, f"{name}.nin_shortcut")
        return x + h

    def attn(self, x, P, name):
        h = self.norm(x, P, f"{name}.norm")
        q = self.conv(h, P, f"{name}.q")
        k = self.conv(h, P, f"{name}.k")
        v = self.conv(h, P, f"{name}.v")
        b, c, hh, ww = q.shape
        with self.autocast(False):
            q = q.float().reshape(b, c, hh * ww).permute(0, 2, 1)
            w = torch.bmm(q, k.float().reshape(b, c, hh * ww)) * (int(c) ** -0.5)
            w = torch.softmax(w, dim=2)
            h = torch.bmm(v.float().reshape(b, c, hh * ww), w.permute(0, 2, 1))
        return x + self.conv(h.reshape(b, c, hh, ww).to(x.dtype), P,
                             f"{name}.proj_out")

    def mid(self, h, P, name):
        h = self.resnet(h, P, f"{name}.block_1")
        h = self.attn(h, P, f"{name}.attn_1")
        return self.resnet(h, P, f"{name}.block_2")


def forward(P: dict, x: torch.Tensor, eps: torch.Tensor, spec: Spec,
            ops: _Ops):
    """``(recon, mu, logvar)`` of NCHW ``x`` in [0, 1]: ``recon`` in
    [−1, 1] space, fp32; μ and logσ² flattened, fp32."""
    w = spec.widths
    with ops.autocast():
        h = ops.conv(x * 2.0 - 1.0, P, "encoder.conv_in")
        res = spec.image_size
        for i in range(len(w)):
            for j in range(spec.num_res_blocks):
                h = ops.resnet(h, P, f"encoder.down.{i}.block.{j}")
                if res in spec.attn_resolutions:
                    h = ops.attn(h, P, f"encoder.down.{i}.attn.{j}")
            if i < len(w) - 1:
                h = ops.conv(F.pad(h, (0, 1, 0, 1)), P,
                             f"encoder.down.{i}.downsample.conv", stride=2,
                             padding=0)
                res //= 2
        h = ops.mid(h, P, "encoder.mid")
        h = ops.conv(ops.norm_swish(h, P, "encoder.norm_out"), P,
                     "encoder.conv_out")
    with ops.autocast(False):
        moments = ops.conv(h.float(), P, "quant_conv")
        mu, logvar = moments.chunk(2, dim=1)
        mu = mu.flatten(1)
        logvar = logvar.clamp(*LOGVAR_CLAMP).flatten(1)
        z = mu + eps * torch.exp(0.5 * logvar)
    s = spec.latent_hw
    with ops.autocast():
        h = ops.conv(z.reshape(z.shape[0], spec.z_channels, s, s), P,
                     "post_quant_conv")
        h = ops.conv(h, P, "decoder.conv_in")
        h = ops.mid(h, P, "decoder.mid")
        res = s
        for i in reversed(range(len(w))):
            for j in range(spec.num_res_blocks + 1):
                h = ops.resnet(h, P, f"decoder.up.{i}.block.{j}")
                if res in spec.attn_resolutions:
                    h = ops.attn(h, P, f"decoder.up.{i}.attn.{j}")
            if i:
                h = ops.conv(F.interpolate(h, scale_factor=2.0,
                                           mode="nearest"),
                             P, f"decoder.up.{i}.upsample.conv")
                res *= 2
        h = ops.conv(ops.norm_swish(h, P, "decoder.norm_out"), P,
                     "decoder.conv_out")
    return h.float(), mu, logvar


def loss(recon, x, mu, logvar, mask, spec: Spec) -> torch.Tensor:
    """``recon`` in [−1, 1], ``x`` in [0, 1]."""
    msum = torch.clamp_min(mask.sum(), 1.0)
    rec = ((recon - (x * 2.0 - 1.0)).abs().sum(dim=(1, 2, 3)) * mask).sum()
    kl = 0.5 * (mu * mu + torch.exp(logvar) - 1.0 - logvar)
    return rec / msum + spec.beta * (kl.sum(dim=1) * mask).sum() / msum


def _gradients(P: dict, x, eps, mask, spec, ops):
    """``(loss, grads)`` of the whole batch."""
    names = list(P)
    for p in P.values():
        p.requires_grad_(True)
    recon, mu, logvar = forward(P, x, eps, spec, ops)
    total = loss(recon, x, mu, logvar, mask, spec)
    grads = torch.autograd.grad(total, [P[n] for n in names])
    for p in P.values():
        p.requires_grad_(False)
    return total.detach(), dict(zip(names, grads))


def train(P0: dict, batches, spec: Spec, *, precision: str = "fp32") -> dict:
    """Run the steps of ``batches`` from the weights ``P0`` (left as they
    are): each batch a dict of ``x`` (NCHW fp32 in [0, 1]), ``eps``,
    ``mask`` and ``sched`` (``lr``).  Returns the readings: ``losses`` a
    step, ``grad_norms`` (each leaf's norm of the first step's gradient,
    after the clip) and ``change_norms`` (each leaf's ‖p − p0‖ after the
    last step)."""
    ops = _Ops(precision, next(iter(P0.values())).device.type,
               spec.norm_groups)
    b1, b2 = spec.betas
    P = {n: p.detach().clone().float() for n, p in P0.items()}
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    losses, grad_norms = [], None
    for t, b in enumerate(batches, start=1):
        total, g = _gradients(P, b["x"], b["eps"], b["mask"], spec, ops)
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
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for n in P:
                m[n].mul_(b1).add_(g[n], alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g[n], g[n], value=1.0 - b2)
                P[n] -= lr * (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + ADAM_EPS)
        del g
    change = {n: float(torch.linalg.vector_norm(P[n] - P0[n].float()))
              for n in P}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def prepare_batch(images_u8: torch.Tensor, idx: torch.Tensor, seed: int,
                  step: int, latent: int) -> dict:
    """The step's input as the reference takes it: the uint8 NHWC rows
    ``idx`` as NCHW fp32 in [0, 1] (no augmentation), and the step's ε."""
    x = images_u8.index_select(0, idx).permute(0, 3, 1, 2).float() / 255.0
    eps = streams.step_noise((x.shape[0], latent), seed, step, x.device)
    return {"x": x.contiguous(), "eps": eps}
