"""End-to-end CelebBasis pipeline: models + basis + manager glued together.

Counterpart of ``celebbasis_tpu/pipeline.py``:

    tokens -> CLIP token table -> identity injection -> CLIP encoder
           -> (context) -> UNet eps -> DDIM / PLMS loop -> VAE decode

The pipeline is an ``nn.Module`` that owns the three models (``unet``,
``vae``, ``clip``), so one ``state_dict`` carries what the JAX package keeps
in its ``{"unet", "vae", "clip"}`` params tree, and ``.to(device)`` moves it.
``make_txt2img_fn`` (identities from saved coefficients) and
``make_txt2img_faces_fn`` (identities from a live MetaIdNet forward on face
crops) return functions from prompt tokens to finished images that run under
``torch.inference_mode()``.

The textual-inversion variant (``make_txt2img_ti_fn``) waits for
``core/textual_inversion.py`` (ROADMAP A5).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from celebbasis_tpu_torch.core import manager as mgr
from celebbasis_tpu_torch.core.basis import BasisConfig
from celebbasis_tpu_torch.diffusion.sampler import (SamplerConfig,
                                                    ddim_sample, plms_sample)
from celebbasis_tpu_torch.diffusion.schedules import (NoiseSchedule,
                                                      make_ddim_schedule,
                                                      make_schedule)
from celebbasis_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                   CLIPTextEncoder)
from celebbasis_tpu_torch.models.unet import UNetConfig, UNetModel
from celebbasis_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from celebbasis_tpu_torch.text.tokenizer import (PLACEHOLDER_WORDS,
                                                 CLIPTokenizer,
                                                 token_for_string)


def finish_images(img: torch.Tensor, output: str) -> torch.Tensor:
    """Final on-device image formatting.

    ``output='float'``: clipped [-1, 1] float32.  ``output='uint8'``
    additionally quantises to display pixels on the device,
    ``((x + 1) * 127.5).clip(0, 255)`` truncated toward zero.
    """
    img = img.clamp(-1.0, 1.0)
    if output == "float":
        return img
    if output == "uint8":
        scaled = (img.float() + 1.0) * 127.5
        return scaled.clamp(0.0, 255.0).to(torch.uint8)
    raise ValueError(f"unknown output mode {output!r}")


@dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig = UNetConfig.sd_v1()
    vae: VAEConfig = VAEConfig.sd_v1()
    clip: CLIPTextConfig = CLIPTextConfig.sd_v1()
    basis: BasisConfig = BasisConfig()
    placeholder_strings: Tuple[str, ...] = PLACEHOLDER_WORDS
    scale_factor: float = 0.18215
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd_v1() -> "PipelineConfig":
        return PipelineConfig()

    @staticmethod
    def tiny() -> "PipelineConfig":
        """Structurally identical, toy-sized config for tests."""
        clip = CLIPTextConfig.tiny()
        return PipelineConfig(
            unet=UNetConfig.tiny(context_dim=clip.width),
            vae=VAEConfig.tiny(),
            clip=clip,
            basis=BasisConfig(n_components=8, special_id_threshold=1022),
            dtype=torch.float32,
        )


class CelebBasisPipeline(nn.Module):
    """Bundles the models, tokenizer, schedule and manager config."""

    def __init__(self, cfg: PipelineConfig, tokenizer: CLIPTokenizer):
        super().__init__()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.unet = UNetModel(cfg.unet, cfg.dtype)
        self.vae = AutoencoderKL(cfg.vae, cfg.dtype)
        self.clip = CLIPTextEncoder(cfg.clip, cfg.dtype)
        self.schedule: NoiseSchedule = make_schedule(
            "linear", cfg.timesteps, cfg.linear_start, cfg.linear_end)
        ph_ids = [token_for_string(tokenizer, s)
                  for s in cfg.placeholder_strings]
        self.manager_cfg = mgr.ManagerConfig(
            placeholder_token_ids=tuple(ph_ids),
            num_es=cfg.basis.num_embeds_per_token,
            inner_dim=cfg.basis.n_components,
            token_dim=cfg.clip.width,
        )

    @property
    def latent_factor(self) -> int:
        """VAE spatial downsample factor (8 for SD v1's f=8 KL autoencoder)."""
        return 2 ** (len(self.cfg.vae.ch_mult) - 1)

    @property
    def device(self) -> torch.device:
        return self.clip.position_embedding.device

    def token_table(self):
        """The CLIP token-embedding matrix as float32 numpy (vocab, width)."""
        return self.clip.token_embedding.weight.detach().float().cpu().numpy()

    # -- conditioning -------------------------------------------------------
    def conditioning(self, tokens: torch.Tensor,
                     manager_state: Optional[mgr.ManagerState] = None,
                     basis: Optional[torch.Tensor] = None,
                     ids: Optional[torch.Tensor] = None,
                     num_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens -> (B, 77, D) context, with identity injection when ids
        are given."""
        embeds = self.clip.token_embed(tokens)
        if ids is not None:
            if manager_state is None or basis is None:
                raise ValueError("identity injection needs the manager state "
                                 "and the basis")
            embeds = mgr.test_inject(self.manager_cfg, manager_state, basis,
                                     tokens, embeds, ids, num_ids)
        return self.clip.encode(embeds)

    def eps_model(self):
        return self.unet

    # -- end-to-end samplers ------------------------------------------------
    def _sample_and_decode(self, sampler: str, num_steps: int,
                           guidance_scale: float, eta: float,
                           image_size: int, output: str):
        """-> run(cond, uncond, generators, x_T) -> finished images: the
        sampler named ``sampler`` ("ddim" or "plms") over a fixed DDIM
        schedule, then the VAE decode and :func:`finish_images`."""
        samplers = {"ddim": ddim_sample, "plms": plms_sample}
        if sampler not in samplers:
            raise ValueError(f"unknown sampler {sampler!r}; expected one of "
                             f"{sorted(samplers)}")
        sample_fn = samplers[sampler]
        ddim = make_ddim_schedule(self.schedule, num_steps, eta)
        lat = image_size // self.latent_factor
        scfg = SamplerConfig(guidance_scale=guidance_scale, eta=eta)

        def run(cond, uncond, generators, x_T):
            x = sample_fn(self.eps_model(), ddim, generators=generators,
                          shape=(cond.shape[0], lat, lat, 4), cond=cond,
                          uncond=uncond, cfg=scfg, x_T=x_T)
            img = self.vae.decode(x / self.cfg.scale_factor)
            return finish_images(img, output)

        return run

    def make_txt2img_fn(self, num_steps: int = 50,
                        guidance_scale: float = 10.0, eta: float = 0.0,
                        image_size: int = 512, sampler: str = "ddim",
                        output: str = "float"):
        """Returns fn(manager_state, basis, tokens, uncond_tokens, ids,
        num_ids, generators, x_T=None) -> images (B, H, W, 3) in [-1, 1] (or
        uint8 pixels when ``output='uint8'``, see :func:`finish_images`).

        ``generators``: one ``torch.Generator`` per row (see
        ``diffusion.sampler``); ``x_T``: optional explicit start latents
        (B, lat, lat, 4).  ``sampler``: "ddim" or "plms".  Default recipe:
        DDIM 50 / scale 10 / eta 0.
        """
        run = self._sample_and_decode(sampler, num_steps, guidance_scale,
                                      eta, image_size, output)

        @torch.inference_mode()
        def fn(manager_state, basis, tokens, uncond_tokens, ids, num_ids,
               generators: Optional[Sequence[torch.Generator]], x_T=None):
            cond = self.conditioning(tokens, manager_state, basis, ids,
                                     num_ids)
            return run(cond, self.conditioning(uncond_tokens), generators,
                       x_T)

        return fn

    def make_txt2img_faces_fn(self, meta_net, num_steps: int = 50,
                              guidance_scale: float = 10.0, eta: float = 0.0,
                              image_size: int = 512, sampler: str = "ddim",
                              output: str = "float"):
        """Live-face personalisation at inference (``test_mode='image'``):
        the identity embeddings come from a MetaIdNet forward on face crops
        instead of saved coefficients.

        Returns fn(basis, tokens, uncond_tokens, faces, ids, num_ids,
        generators, x_T=None) -> images; faces (B, k, Hf, Wf, 3) aligned
        crops in [-1, 1], ids (B, k) the face slots' identity indices.
        """
        run = self._sample_and_decode(sampler, num_steps, guidance_scale,
                                      eta, image_size, output)
        m_cfg = dataclasses.replace(self.manager_cfg, test_mode="image")

        @torch.inference_mode()
        def fn(basis, tokens, uncond_tokens, faces, ids, num_ids,
               generators: Optional[Sequence[torch.Generator]], x_T=None):
            pred_z, _ = meta_net.multi_faces(faces, ids, basis)
            embeds = self.clip.token_embed(tokens)
            embeds = mgr.test_inject(m_cfg, None, basis, tokens, embeds, ids,
                                     num_ids, pred_z=pred_z)
            return run(self.clip.encode(embeds),
                       self.conditioning(uncond_tokens), generators, x_T)

        return fn
