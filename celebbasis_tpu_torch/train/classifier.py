"""Noise-level latent classifier: the reference's
``NoisyLatentImageClassifier``.

Counterpart of ``celebbasis_tpu/train/classifier.py``: an
``EncoderUNetModel`` (or a full ``UNetModel`` for per-pixel
``'segmentation'`` labels) learns to classify latents noised to random
diffusion timesteps by a frozen latent-diffusion model's schedule (used
upstream for classifier guidance).  The train step -- q_sample, the
classifier, cross-entropy and top-k accuracies, AdamW -- and the eval step
of the noise sweep each run as a captured function (``utils.graphs``; the
JAX package's two ``jax.jit``): a CUDA graph on a card, captured at the
first call and replayed after.  AdamW is ``capturable`` there, its rate a
device tensor that a scheduler writes between steps.  Randomness: t and
the q-noise are drawn before the step from the generator handed to it, t
first, unless ``t_override`` / ``noise_override`` are given; the sweep's
level reaches its graph as a tensor.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from celebbasis_tpu_torch.diffusion.ddpm import ScheduleArrays, q_sample
from celebbasis_tpu_torch.diffusion.schedules import make_schedule
from celebbasis_tpu_torch.loader import resolve_device
from celebbasis_tpu_torch.models.unet import (EncoderUNetModel, UNetConfig,
                                              UNetModel)
from celebbasis_tpu_torch.train.lr_schedule import set_lr
from celebbasis_tpu_torch.train.step import allocate_state, written_in_place
from celebbasis_tpu_torch.utils import graphs


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-entry cross-entropy over the trailing class dim
    (``reduction='none'``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).squeeze(-1)


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   k: int) -> torch.Tensor:
    """The share of rows whose label is among the k largest logits."""
    top = logits.topk(k, dim=-1).indices
    return (top == labels.long()[:, None]).float().sum(-1).mean()


@dataclass
class ClassifierConfig:
    """The reference's constructor surface without the Lightning plumbing:
    the diffusion model's schedule and the classifier net's shape."""
    num_classes: int
    unet: UNetConfig                       # the diffusion model's UNet
    label_key: str = "class_label"         # 'class_label' | 'segmentation'
    pool: str = "attention"
    image_size: int = 64                   # latent side
    timesteps: int = 1000
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    weight_decay: float = 1e-2
    log_steps: int = 10

    def classifier_cfg(self) -> UNetConfig:
        """The diffusion UNet's config with in = its out channels and out =
        the number of classes (the reference's ``load_classifier``)."""
        return dataclasses.replace(self.unet,
                                   in_channels=self.unet.out_channels,
                                   out_channels=self.num_classes)


class NoisyLatentClassifier:
    """Trains ``self.model`` in place, on ``device`` (``cuda`` unless the
    caller asks for the CPU):

        clf = NoisyLatentClassifier(cfg)
        state = clf.init_state(lr=1e-4)
        state, log = clf.train_step(state, z, labels, generator)
    """

    def __init__(self, cfg: ClassifierConfig,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        self.cfg = cfg
        ccfg = cfg.classifier_cfg()
        self.device = resolve_device(device)
        with self.device:
            if cfg.label_key == "class_label":
                self.model = EncoderUNetModel(ccfg, image_size=cfg.image_size,
                                              pool=cfg.pool, dtype=dtype)
            elif cfg.label_key == "segmentation":
                self.model = UNetModel(ccfg, dtype=dtype)
            else:
                raise NotImplementedError(cfg.label_key)
        # (z, labels, t, noise) -> the logs, no update
        self.eval_step = graphs.Captured(self._eval_body)
        self.sched = ScheduleArrays.from_schedule(
            make_schedule("linear", cfg.timesteps,
                          linear_start=cfg.linear_start,
                          linear_end=cfg.linear_end), device=self.device)

    # -- setup ----------------------------------------------------------
    def make_optimizer(self, lr: float) -> torch.optim.AdamW:
        """AdamW at the config's weight decay (the reference's
        ``configure_optimizers``); on a card ``capturable``, its rate a
        device tensor, its state and the gradients allocated now."""
        params = list(self.model.parameters())
        on_card = params[0].is_cuda
        opt = torch.optim.AdamW(
            params, lr=torch.tensor(lr, device=params[0].device)
            if on_card else lr, weight_decay=self.cfg.weight_decay,
            capturable=on_card)
        if on_card:
            allocate_state(opt)
        return opt

    def init_state(self, lr: float = 1e-4,
                   scheduler: Optional[Callable[[int], float]] = None
                   ) -> Dict:
        """``scheduler``: a multiplier of ``lr`` by step (LambdaLR
        style).  ``state["graph"]`` is the captured train step of this
        state's optimizer (``.eager``: the same uncaptured)."""
        opt = self.make_optimizer(lr)
        graph = graphs.Captured(functools.partial(self._train_body, opt),
                                restore=lambda: written_in_place(opt))
        return {"opt": opt, "lr": lr, "scheduler": scheduler, "step": 0,
                "graph": graph}

    # -- steps ----------------------------------------------------------
    def _forward(self, z_noisy: torch.Tensor, t: torch.Tensor):
        if self.cfg.label_key == "segmentation":
            return self.model(z_noisy, t, None)
        return self.model(z_noisy, t)

    def draw_t_noise(self, z: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     t_override: Optional[torch.Tensor] = None,
                     noise_override: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Random timesteps (B,) and the q-noise, t first, from
        ``generator``, unless given."""
        t = t_override.long() if t_override is not None else \
            torch.randint(0, self.cfg.timesteps, (z.shape[0],),
                          generator=generator,
                          device=generator.device).to(z.device)
        noise = noise_override if noise_override is not None else \
            torch.randn(z.shape, generator=generator,
                        device=generator.device).to(z.device)
        return t, noise

    def shared(self, z: torch.Tensor, labels: torch.Tensor, t: torch.Tensor,
               noise: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Noise ``z`` to the timesteps ``t`` (B,) with ``noise``, classify,
        and take the mean cross-entropy and top-1 / top-k accuracies.
        Segmentation labels arrive as class indices on the latent grid."""
        logits = self._forward(q_sample(self.sched, z, t, noise), t)
        loss = cross_entropy(logits, labels).mean()
        k5 = min(5, self.cfg.num_classes)
        flat_l = logits.reshape(-1, logits.shape[-1])
        flat_y = labels.reshape(-1)
        log = {"loss": loss.detach(),
               "acc@1": top_k_accuracy(flat_l, flat_y, 1).detach(),
               f"acc@{k5}": top_k_accuracy(flat_l, flat_y, k5).detach()}
        return loss, log

    def _train_body(self, opt, z, labels, t, noise) -> Dict:
        loss, log = self.shared(z, labels, t, noise)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        return log

    def train_step(self, state: Dict, z: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   t_override: Optional[torch.Tensor] = None,
                   noise_override: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict, Dict]:
        opt = state["opt"]
        if state["scheduler"] is not None:
            set_lr(opt, state["lr"] * state["scheduler"](state["step"]))
        self.model.train()
        t, noise = self.draw_t_noise(z, generator, t_override,
                                     noise_override)
        log = state["graph"](z, labels, t, noise)
        state["step"] += 1
        return state, {f"train/{k}": v for k, v in log.items()}

    def _eval_body(self, z, labels, t, noise) -> Dict:
        return self.shared(z, labels, t, noise)[1]

    @torch.no_grad()
    def validate_noise_sweep(self, z: torch.Tensor, labels: torch.Tensor,
                             generator: torch.Generator,
                             log_every_t: int = 200) -> Dict[int, Dict]:
        """Accuracy at the fixed noise levels 0, log_every_t, 2 *
        log_every_t, ...; one q-noise draw serves every level, as one key
        does in the JAX sweep.  Each level is a call of one captured eval
        step, the level a (B,) tensor."""
        noise = torch.randn(z.shape, generator=generator,
                            device=generator.device).to(z.device)
        self.model.eval()
        out = {}
        for t in range(0, self.cfg.timesteps, log_every_t):
            tb = torch.full((z.shape[0],), t, dtype=torch.long,
                            device=z.device)
            log = self.eval_step(z, labels, tb, noise)
            out[t] = {k: float(v) for k, v in log.items()}
        return out
