"""First-stage (autoencoder) training losses: LPIPS + PatchGAN.

Counterpart of ``celebbasis_tpu/train/ae_loss.py``, after the reference's
``ldm/modules/losses``:

* ``LPIPSWithDiscriminator`` (``contperceptual.py``) -- the KL
  autoencoder's loss: per-element L1 plus weighted LPIPS, scaled by
  ``exp(-logvar)``, the KL term, and an adaptively weighted PatchGAN pair;
* ``VQLPIPSWithDiscriminator`` (``vqperceptual.py``) -- the VQ variant: mean
  NLL without logvar, the codebook term, perplexity logging;
* ``NLayerDiscriminator``, ``ActNorm``, the train-mode BatchNorm,
  ``hinge_d_loss`` / ``vanilla_d_loss``, ``adopt_weight`` -- taming's
  PatchGAN stack.

The adaptive weight is the reference's own form: ``torch.autograd.grad`` of
the NLL and of the generator loss with respect to the decoder's last conv
weight (``calculate_adaptive_weight``), where the JAX package pulls a
cotangent back through that conv.  Each loss is an ``nn.Module`` owning
``lpips`` (frozen), ``disc`` (the discriminator) and the scalar ``logvar``,
so that its state dict carries what the JAX package keeps in its
``{"lpips", "disc", "logvar"}`` variables.  Images are
channels-last ``(B, H, W, C)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.models.lpips import LPIPS
from celebbasis_tpu_torch.ops.basic import to_nchw, to_nhwc


class _TrainBatchNorm(nn.Module):
    """torch BatchNorm2d in training mode: normalise with the batch's
    statistics (float32), learnable affine; no running statistics are kept
    (the discriminator runs only inside training steps)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.float(), None, None, self.weight, self.bias,
                         training=True, eps=1e-5)
        return y.to(x.dtype)


class ActNorm(nn.Module):
    """Per-channel affine ``(x + loc) * scale`` (taming's ActNorm without
    the data-dependent initialisation; starts at identity)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(channels))
        self.weight = nn.Parameter(torch.ones(channels))   # flax "scale"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x + self.loc[None, :, None, None]) \
            * self.weight[None, :, None, None]


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator: 4x4 stride-2 convs with leaky ReLU, a norm
    after every conv but the first, a stride-1 last level and a 1-channel
    logit head.  (B, H, W, C) -> (B, h, w, 1) float32 logits."""

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 n_layers: int = 3, use_actnorm: bool = False):
        super().__init__()
        self.n_layers = n_layers
        norm = ActNorm if use_actnorm else _TrainBatchNorm
        self.conv_0 = nn.Conv2d(in_channels, ndf, 4, 2, 1)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            # a bias only where the norm is not BatchNorm, as in torch
            setattr(self, f"conv_{n}", nn.Conv2d(cin, cout, 4, stride, 1,
                                                 bias=use_actnorm))
            setattr(self, f"norm_{n}", norm(cout))
            cin = cout
        self.conv_out = nn.Conv2d(cin, 1, 4, 1, 1)
        for m in self.modules():       # weights_init: N(0, 0.02)
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_0(to_nchw(x.float())), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm_{n}")(h), 0.2)
        return to_nhwc(self.conv_out(h))


@torch.no_grad()
def init_discriminator(disc: NLayerDiscriminator,
                       generator: torch.Generator) -> NLayerDiscriminator:
    """taming's ``weights_init`` drawn from ``generator``: conv kernels
    N(0, 0.02), BatchNorm scales N(1, 0.02), biases and shifts zero, ActNorm
    scales one."""
    def normal(p, mean):
        p.copy_(mean + 0.02 * torch.randn(p.shape, generator=generator,
                                          device=generator.device))
    for m in disc.modules():
        if isinstance(m, nn.Conv2d):
            normal(m.weight, 0.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _TrainBatchNorm):
            normal(m.weight, 1.0)
            m.bias.zero_()
        elif isinstance(m, ActNorm):
            m.weight.fill_(1.0)
            m.loc.zero_()
    return disc


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean()
                  + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean()
                  + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int,
                 value: float = 0.0) -> float:
    return value if global_step < threshold else weight


def measure_perplexity(indices: torch.Tensor, n_embed: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook usage: (perplexity, codes used)."""
    enc = F.one_hot(indices.reshape(-1).long(), n_embed).float()
    avg = enc.mean(0)
    perplexity = torch.exp(-(avg * torch.log(avg + 1e-10)).sum())
    return perplexity, (avg > 0).sum()


def adaptive_weight(nll_grads: torch.Tensor, g_grads: torch.Tensor,
                    disc_weight: float) -> torch.Tensor:
    """||grad nll|| / (||grad g|| + 1e-4), clipped to [0, 1e4], detached,
    times ``disc_weight``."""
    d_w = nll_grads.norm() / (g_grads.norm() + 1e-4)
    return d_w.clamp(0.0, 1e4).detach() * disc_weight


@dataclass(frozen=True)
class DiscLossConfig:
    """The knobs of both loss classes (the reference's constructor
    arguments)."""
    disc_start: int = 0
    disc_num_layers: int = 3
    disc_in_channels: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    pixelloss_weight: float = 1.0
    use_actnorm: bool = False
    disc_conditional: bool = False
    disc_loss: str = "hinge"
    disc_ndf: int = 64
    # KL variant only
    logvar_init: float = 0.0
    kl_weight: float = 1.0
    # VQ variant only
    codebook_weight: float = 1.0
    pixel_loss: str = "l1"
    n_classes: Optional[int] = None

    def __post_init__(self):
        assert self.disc_loss in ("hinge", "vanilla"), self.disc_loss
        assert self.pixel_loss in ("l1", "l2"), self.pixel_loss


class LPIPSWithDiscriminator(nn.Module):
    """The KL autoencoder's loss pair.  ``lpips`` is frozen; ``logvar``
    (a scalar parameter) is in neither optimizer of ``AETrainer``, as in the
    reference; ``disc`` trains in the discriminator pass."""

    def __init__(self, cfg: DiscLossConfig):
        super().__init__()
        self.cfg = cfg
        self.lpips = LPIPS().requires_grad_(False)
        self.disc = NLayerDiscriminator(
            cfg.disc_in_channels, cfg.disc_ndf, cfg.disc_num_layers,
            cfg.use_actnorm)
        self.logvar = nn.Parameter(torch.tensor(float(cfg.logvar_init)),
                                   requires_grad=False)
        self._d_loss = hinge_d_loss if cfg.disc_loss == "hinge" \
            else vanilla_d_loss

    # -- shared pieces --------------------------------------------------
    def nll_of(self, inputs: torch.Tensor, recons: torch.Tensor,
               weights=None):
        """(weighted NLL, NLL, mean rec loss): per-element L1 plus weighted
        LPIPS, scaled by exp(-logvar), summed and divided by the batch."""
        cfg = self.cfg
        rec = (inputs - recons).abs()
        if cfg.perceptual_weight > 0:
            rec = rec + cfg.perceptual_weight * self.lpips(inputs, recons)
        nll = rec / torch.exp(self.logvar) + self.logvar
        wnll = nll if weights is None else weights * nll
        B = inputs.shape[0]
        return wnll.sum() / B, nll.sum() / B, rec.mean()

    def _logits_fake(self, recons, cond):
        if cond is None:
            assert not self.cfg.disc_conditional
            return self.disc(recons)
        assert self.cfg.disc_conditional
        return self.disc(torch.cat([recons, cond], dim=-1))

    def _d_weight(self, nll: torch.Tensor, g_loss: torch.Tensor,
                  last_layer: Optional[torch.Tensor]) -> torch.Tensor:
        if last_layer is None:
            return torch.zeros((), device=nll.device)
        nll_grads = torch.autograd.grad(nll, last_layer, retain_graph=True)[0]
        g_grads = torch.autograd.grad(g_loss, last_layer,
                                      retain_graph=True)[0]
        return adaptive_weight(nll_grads, g_grads, self.cfg.disc_weight)

    # -- optimizer_idx == 0 ---------------------------------------------
    def generator_loss(self, inputs: torch.Tensor, recons: torch.Tensor,
                       kl: torch.Tensor, disc_factor: float,
                       last_layer: Optional[torch.Tensor] = None,
                       weights=None, cond=None, split: str = "train"
                       ) -> Tuple[torch.Tensor, Dict]:
        """The generator pass.  ``disc_factor`` is ``adopt_weight``'s value
        at the step (0 before ``disc_start``), resolved by the caller so
        that a captured pass reads no step.  ``last_layer`` is the
        decoder's last conv weight, whose gradients set the adaptive
        weight; None gives ``d_weight`` 0, as the reference's eval-mode
        branch does."""
        cfg = self.cfg
        wnll, nll, rec_mean = self.nll_of(inputs, recons, weights)
        kl_loss = kl.sum() / inputs.shape[0]
        g_loss = -self._logits_fake(recons, cond).mean()
        d_weight = self._d_weight(
            nll, g_loss, last_layer if cfg.disc_factor > 0.0 else None)
        loss = wnll + cfg.kl_weight * kl_loss \
            + d_weight * disc_factor * g_loss
        log = {f"{split}/total_loss": loss, f"{split}/logvar": self.logvar,
               f"{split}/kl_loss": kl_loss, f"{split}/nll_loss": nll,
               f"{split}/rec_loss": rec_mean, f"{split}/d_weight": d_weight,
               f"{split}/disc_factor": g_loss.new_full((), disc_factor),
               f"{split}/g_loss": g_loss}
        return loss, {k: v.detach() for k, v in log.items()}

    # -- optimizer_idx == 1 ---------------------------------------------
    def discriminator_loss(self, inputs: torch.Tensor, recons: torch.Tensor,
                           disc_factor: float, cond=None,
                           split: str = "train"
                           ) -> Tuple[torch.Tensor, Dict]:
        inputs, recons = inputs.detach(), recons.detach()
        if cond is not None:
            inputs = torch.cat([inputs, cond], dim=-1)
            recons = torch.cat([recons, cond], dim=-1)
        logits_real = self.disc(inputs)
        logits_fake = self.disc(recons)
        d_loss = disc_factor * self._d_loss(logits_real, logits_fake)
        log = {f"{split}/disc_loss": d_loss,
               f"{split}/logits_real": logits_real.mean(),
               f"{split}/logits_fake": logits_fake.mean()}
        return d_loss, {k: v.detach() for k, v in log.items()}


class VQLPIPSWithDiscriminator(LPIPSWithDiscriminator):
    """The VQ autoencoder's loss pair: mean NLL without the logvar scaling,
    plus the codebook term; perplexity logging."""

    def nll_of(self, inputs: torch.Tensor, recons: torch.Tensor,
               weights=None):
        cfg = self.cfg
        rec = (inputs - recons).abs() if cfg.pixel_loss == "l1" \
            else (inputs - recons) ** 2
        if cfg.perceptual_weight > 0:
            rec = rec + cfg.perceptual_weight * self.lpips(inputs, recons)
        nll = rec.mean()
        return nll, nll, rec.mean()

    def generator_loss(self, inputs: torch.Tensor,   # type: ignore[override]
                       recons: torch.Tensor, codebook_loss: torch.Tensor,
                       disc_factor: float,
                       last_layer: Optional[torch.Tensor] = None,
                       predicted_indices: Optional[torch.Tensor] = None,
                       cond=None, split: str = "train"
                       ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        nll, _, rec_mean = self.nll_of(inputs, recons)
        g_loss = -self._logits_fake(recons, cond).mean()
        d_weight = self._d_weight(nll, g_loss, last_layer)
        loss = nll + d_weight * disc_factor * g_loss \
            + cfg.codebook_weight * codebook_loss.mean()
        log = {f"{split}/total_loss": loss,
               f"{split}/quant_loss": codebook_loss.mean(),
               f"{split}/nll_loss": nll, f"{split}/rec_loss": rec_mean,
               f"{split}/d_weight": d_weight,
               f"{split}/disc_factor": g_loss.new_full((), disc_factor),
               f"{split}/g_loss": g_loss}
        if predicted_indices is not None:
            assert cfg.n_classes is not None
            perplexity, usage = measure_perplexity(predicted_indices,
                                                   cfg.n_classes)
            log[f"{split}/perplexity"] = perplexity
            log[f"{split}/cluster_usage"] = usage
        return loss, {k: v.detach() for k, v in log.items()}
