"""End-to-end CelebBasis pipeline: models + basis + manager glued together.

Counterpart of ``celebbasis_tpu/pipeline.py``:

    tokens -> CLIP token table -> identity injection -> CLIP encoder
           -> (context) -> UNet eps -> DDIM / PLMS loop -> VAE decode

The pipeline is an ``nn.Module`` that owns the three models (``unet``,
``vae``, ``clip``), so one ``state_dict`` carries what the JAX package keeps
in its ``{"unet", "vae", "clip"}`` params tree, and ``.to(device)`` moves it.
``make_txt2img_fn`` (identities from saved coefficients),
``make_txt2img_faces_fn`` (identities from a live MetaIdNet forward on face
crops) and ``make_txt2img_ti_fn`` (learned textual-inversion vectors in
place of placeholders) return functions from prompt tokens to finished
images that run under ``torch.inference_mode()``.

Each behaves like the JAX ``jax.jit(fn)``: the generators' draws (x_T, and
the step noise at eta > 0) are taken first, then the whole function
(conditioning, the DDIM or PLMS chain, the VAE decode and
``finish_images``) runs as one CUDA graph, captured by the first call with
a given shape signature and replayed by later ones (``utils.graphs``).  The
step constants are Python floats baked into the graph, as they are into the
JAX program, and PLMS's first steps unroll at capture.  On CPU tensors the
same Python runs eagerly.  The returned function's ``eager`` attribute is
the same function uncaptured, for comparisons; ``captured`` is its
``utils.graphs.Captured``.  The graph reads the models' weights where they
lie when it is captured: load or cast them before the first call.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from celebbasis_tpu_torch.core import manager as mgr
from celebbasis_tpu_torch.core.basis import BasisConfig
from celebbasis_tpu_torch.diffusion.sampler import (SamplerConfig,
                                                    batched_normal,
                                                    ddim_sample, plms_sample,
                                                    step_noise)
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
from celebbasis_tpu_torch.utils import graphs


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
        """-> (draws, run): ``draws(generators, batch, x_T) -> (x_T,
        noise)`` takes the chain's random numbers from the generators (x_T
        unless given, then the DDIM step noise at eta > 0); ``run(cond,
        uncond, x_T, noise)`` -> finished images runs the sampler named
        ``sampler`` ("ddim" or "plms") over a fixed DDIM schedule, the VAE
        decode and :func:`finish_images`, and draws nothing."""
        samplers = {"ddim": ddim_sample, "plms": plms_sample}
        if sampler not in samplers:
            raise ValueError(f"unknown sampler {sampler!r}; expected one of "
                             f"{sorted(samplers)}")
        ddim = make_ddim_schedule(self.schedule, num_steps, eta)
        lat = image_size // self.latent_factor
        scfg = SamplerConfig(guidance_scale=guidance_scale, eta=eta)

        def draws(generators, batch, x_T):
            shape, dev = (batch, lat, lat, 4), self.device
            x_T = (batched_normal(generators, shape, dev) if x_T is None
                   else x_T.to(device=dev, dtype=torch.float32))
            noise = (step_noise(generators, ddim, shape, dev)
                     if sampler == "ddim" else None)
            return x_T, noise

        def run(cond, uncond, x_T, noise):
            kw = {"noise": noise} if sampler == "ddim" else {}
            x = samplers[sampler](
                self.eps_model(), ddim, generators=None,
                shape=(cond.shape[0], lat, lat, 4), cond=cond, uncond=uncond,
                cfg=scfg, x_T=x_T, **kw)
            img = self.vae.decode(x / self.cfg.scale_factor)
            return finish_images(img, output)

        return draws, run

    @staticmethod
    def _entry(body, draws, tokens_at: int):
        """fn(*inputs, generators, x_T=None) -> images: the draws first
        (the batch is ``inputs[tokens_at].shape[0]``), then ``body(*inputs,
        x_T, noise)`` captured; ``fn.eager`` is the same uncaptured."""
        def make(run):
            @torch.inference_mode()
            def fn(*args, x_T=None):
                *inputs, generators = args
                x_T, noise = draws(generators, inputs[tokens_at].shape[0],
                                   x_T)
                return run(*inputs, x_T, noise)
            return fn

        return graphs.entry(make, body)

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
        DDIM 50 / scale 10 / eta 0.  Captured per shape signature on a card
        (module docstring).
        """
        draws, run = self._sample_and_decode(sampler, num_steps,
                                             guidance_scale, eta, image_size,
                                             output)

        def body(manager_state, basis, tokens, uncond_tokens, ids, num_ids,
                 x_T, noise):
            cond = self.conditioning(tokens, manager_state, basis, ids,
                                     num_ids)
            return run(cond, self.conditioning(uncond_tokens), x_T, noise)

        return self._entry(body, draws, tokens_at=2)

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
        Captured per shape signature on a card, the face net's forward
        included.
        """
        draws, run = self._sample_and_decode(sampler, num_steps,
                                             guidance_scale, eta, image_size,
                                             output)
        m_cfg = dataclasses.replace(self.manager_cfg, test_mode="image")

        def body(basis, tokens, uncond_tokens, faces, ids, num_ids, x_T,
                 noise):
            pred_z, _ = meta_net.multi_faces(faces, ids, basis)
            embeds = self.clip.token_embed(tokens)
            embeds = mgr.test_inject(m_cfg, None, basis, tokens, embeds, ids,
                                     num_ids, pred_z=pred_z)
            return run(self.clip.encode(embeds),
                       self.conditioning(uncond_tokens), x_T, noise)

        return self._entry(body, draws, tokens_at=1)

    def make_txt2img_ti_fn(self, ti_cfg, ph_ids, num_steps: int = 50,
                           guidance_scale: float = 7.5, eta: float = 0.0,
                           image_size: int = 512, sampler: str = "ddim",
                           output: str = "float"):
        """Textual-inversion sampling: the learned vectors replace the
        placeholders (the reference's ``main.py`` / textual-test path).

        Returns fn(ti_params, tokens, uncond_tokens, generators, x_T=None)
        -> images; ``ti_params`` (P, V, D) as ``core.textual_inversion``
        keeps them, ``ph_ids`` the placeholders' token ids.  Captured per
        shape signature on a card.
        """
        from celebbasis_tpu_torch.core import textual_inversion as ti
        draws, run = self._sample_and_decode(sampler, num_steps,
                                             guidance_scale, eta, image_size,
                                             output)
        ph = torch.as_tensor(ph_ids, dtype=torch.int64, device=self.device)

        def body(ti_params, tokens, uncond_tokens, x_T, noise):
            embeds = ti.ti_inject(ti_cfg, ti_params, ph, tokens,
                                  self.clip.token_embed(tokens))
            return run(self.clip.encode(embeds),
                       self.conditioning(uncond_tokens), x_T, noise)

        return self._entry(body, draws, tokens_at=1)
