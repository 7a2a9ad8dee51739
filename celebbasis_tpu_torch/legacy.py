"""Legacy latent-diffusion family: runnable models from the reference's
latent-diffusion configs.

Counterpart of ``celebbasis_tpu/legacy.py``.  Each config is a
``LatentDiffusion`` with a first stage (AutoencoderKL or VQModelInterface), a
cond stage (unconditional, ClassEmbedder, BERTEmbedder, FrozenCLIPEmbedder,
SpatialRescaler, Identity, or the first stage itself) and a UNet with the
legacy knobs.  ``build_legacy_ldm`` maps such a YAML dict onto the port's
modules and returns a :class:`LegacyLDM`, an ``nn.Module`` that owns
``unet``, ``first_stage`` and ``cond_stage`` (so its ``state_dict`` carries
what the JAX package keeps in its ``{"unet", "first_stage", "cond_stage"}``
params tree) and can encode, decode, condition, sample and take a training
step (``make_train_step``; the trainer of ``cli/train_legacy.py`` builds on
its loss).

``make_sample_fn`` behaves like the JAX function under ``jax.jit``: the
generators' draws come first (x_T, and the DDIM step noise at eta > 0), then
the conditioning, the whole DDIM chain and the first-stage decode run as one
CUDA graph, captured at the first call with a given shape signature and
replayed after (``utils.graphs``); on CPU tensors the same Python runs
eagerly.  The 1,000-step DDPM chain runs eagerly and draws at each step.
The graph reads the weights where they lie when it is captured: load or cast
them before the first call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from celebbasis_tpu_torch.diffusion.ddpm import ScheduleArrays, q_sample
from celebbasis_tpu_torch.diffusion.sampler import (SamplerConfig,
                                                    batched_normal,
                                                    ddim_sample, ddpm_sample,
                                                    step_noise)
from celebbasis_tpu_torch.diffusion.schedules import (make_ddim_schedule,
                                                      make_schedule)
from celebbasis_tpu_torch.loader import init_weights, resolve_device
from celebbasis_tpu_torch.models.bert_text import (BERTTextConfig,
                                                   BERTTextEncoder,
                                                   ClassEmbedder)
from celebbasis_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                   CLIPTextEncoder)
from celebbasis_tpu_torch.models.cond_stages import SpatialRescaler
from celebbasis_tpu_torch.models.unet import UNetConfig, UNetModel
from celebbasis_tpu_torch.models.vae import (AutoencoderKL, VAEConfig,
                                             sample_posterior)
from celebbasis_tpu_torch.models.vq import VectorQuantizer, VQModelInterface
from celebbasis_tpu_torch.text.bert_tokenizer import default_bert_tokenizer
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.utils import bridge, graphs
from celebbasis_tpu_torch.utils.config import get
from celebbasis_tpu_torch.utils.precision import cast_float_params
from celebbasis_tpu_torch.utils.pt_io import load_pt


def _unet_cfg(up: Dict) -> UNetConfig:
    """openaimodel.UNetModel params -> UNetConfig.  The reference's
    ``use_spatial_transformer`` defaults to False: the legacy configs run
    plain AttentionBlock self-attention."""
    return UNetConfig(
        in_channels=up.get("in_channels", 4),
        out_channels=up.get("out_channels", 4),
        model_channels=up.get("model_channels", 320),
        num_res_blocks=up.get("num_res_blocks", 2),
        attention_resolutions=tuple(up.get("attention_resolutions",
                                           (4, 2, 1))),
        channel_mult=tuple(up.get("channel_mult", (1, 2, 4, 4))),
        num_heads=up.get("num_heads", -1),
        transformer_depth=up.get("transformer_depth", 1),
        context_dim=up.get("context_dim") or 768,
        remat=up.get("use_checkpoint", False),
        dropout=up.get("dropout", 0.0),
        use_spatial_transformer=up.get("use_spatial_transformer", False),
        num_head_channels=up.get("num_head_channels", -1),
        use_scale_shift_norm=up.get("use_scale_shift_norm", False),
        resblock_updown=up.get("resblock_updown", False),
    )


def _vae_cfg(fs_params: Dict, scale_factor: float = 1.0) -> VAEConfig:
    dd = fs_params.get("ddconfig", {})
    return VAEConfig(
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        z_channels=dd.get("z_channels", 4),
        embed_dim=fs_params.get("embed_dim", 4),
        in_ch=dd.get("in_channels", 3),
        out_ch=dd.get("out_ch", 3),
        scale_factor=scale_factor,
        attn_resolutions=tuple(dd.get("attn_resolutions", ()) or ()),
        double_z=dd.get("double_z", True),
        resolution=dd.get("resolution", 256),
        attn_type=dd.get("attn_type", "vanilla"),
    )


class LegacyLDM(nn.Module):
    """A reference latent-diffusion config, instantiated in the port."""

    def __init__(self, unet: UNetModel, first_stage: nn.Module,
                 first_stage_kind: str, cond_kind: str,
                 cond_stage: Optional[nn.Module], cond_mode: str,
                 cond_stage_params: Dict, tokenizer: Any, image_size: int,
                 channels: int, timesteps: int, linear_start: float,
                 linear_end: float, scale_factor: float, scale_by_std: bool,
                 loss_type: str, cond_stage_key: str, raw: Dict):
        super().__init__()
        self.unet, self.first_stage = unet, first_stage
        self.cond_stage = cond_stage
        self.first_stage_kind = first_stage_kind      # 'kl' | 'vq'
        # 'uncond' | 'class' | 'bert' | 'clip' | 'rescaler' | 'identity'
        # | 'first_stage'
        self.cond_kind = cond_kind
        self.cond_mode = cond_mode          # 'none' | 'concat' | 'crossattn'
        self.cond_stage_params = cond_stage_params
        self.tokenizer = tokenizer
        self.image_size, self.channels = image_size, channels
        self.timesteps = timesteps
        self.linear_start, self.linear_end = linear_start, linear_end
        self.scale_factor, self.scale_by_std = scale_factor, scale_by_std
        self.loss_type, self.cond_stage_key = loss_type, cond_stage_key
        self.raw = raw

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # -- first stage ------------------------------------------------------
    def encode_first_stage(self, x: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """image (B, H, W, 3) in [-1, 1] -> scaled latent.  KL stages sample
        the posterior when ``generator`` is given, else take its mode."""
        if self.first_stage_kind == "vq":
            z = self.first_stage.encode(x)
        else:
            mean, logvar = self.first_stage.encode(x)
            z = (sample_posterior(generator, mean, logvar)
                 if generator is not None else mean)
        return self.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        z = z / self.scale_factor
        if self.first_stage_kind == "vq":
            return self.first_stage.decode(z, force_not_quantize)
        return self.first_stage.decode(z)

    # -- conditioning -----------------------------------------------------
    def conditioning_input(self, batch) -> Optional[torch.Tensor]:
        """The host side of the conditioning: prompts -> token ids, labels
        -> int64, images -> float32, on the model's device."""
        dev = self.device
        if self.cond_kind == "uncond":
            return None
        if self.cond_kind in ("bert", "clip"):
            ids = self.tokenizer(list(batch))
            return torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
        if self.cond_kind == "class":
            return torch.as_tensor(np.asarray(batch), dtype=torch.int64,
                                   device=dev)
        return torch.as_tensor(np.asarray(batch, np.float32), device=dev)

    def learned_conditioning(self, c_in: torch.Tensor,
                             inject: Optional[Callable] = None
                             ) -> Optional[torch.Tensor]:
        """The device side: ids / labels -> (B, T, D) context, conditioning
        images -> (B, h, w, c) concat maps.  ``inject`` is the
        textual-inversion hook on the token embeddings."""
        if self.cond_kind == "uncond":
            return None
        if self.cond_kind == "identity":
            return c_in
        if self.cond_kind in ("class", "rescaler"):
            return self.cond_stage(c_in)
        if self.cond_kind == "first_stage":
            # the cond stage IS the first stage; the reference calls
            # .encode() directly: no scale_factor
            return self.encode_first_stage(c_in) / self.scale_factor
        if self.cond_kind == "clip":
            embeds = self.cond_stage.token_embed(c_in)
            if inject is not None:
                embeds = inject(c_in, embeds)
            return self.cond_stage.encode(embeds)
        return self.cond_stage(c_in, inject)

    def get_learned_conditioning(self, batch,
                                 inject: Optional[Callable] = None
                                 ) -> Optional[torch.Tensor]:
        """prompts / labels / conditioning images -> conditioning."""
        return self.learned_conditioning(self.conditioning_input(batch),
                                         inject)

    def eps_model(self) -> Callable:
        """(x, t, cond) -> eps: crossattn feeds cond as attention context,
        concat appends it to the input channels."""
        if self.cond_mode == "concat":
            return lambda x, t, ctx: self.unet(
                torch.cat([x, ctx.to(x.dtype)], dim=-1), t, None)
        return lambda x, t, ctx: self.unet(x, t, ctx)

    # -- training ---------------------------------------------------------
    def schedule_arrays(self) -> ScheduleArrays:
        """The linear beta schedule's arrays on the model's device."""
        return ScheduleArrays.from_schedule(
            make_schedule("linear", self.timesteps,
                          linear_start=self.linear_start,
                          linear_end=self.linear_end), device=self.device)

    def eps_loss(self, sched: ScheduleArrays, z: torch.Tensor,
                 ctx: Optional[torch.Tensor], t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """The reference's ``p_losses`` with eps prediction: noise ``z`` to
        ``t``, predict eps (ctx as attention context, or appended to the
        channels in concat mode) and take the config's l1 or l2 mean."""
        x_t = q_sample(sched, z, t, noise)
        if self.cond_mode == "concat" and ctx is not None:
            eps = self.unet(torch.cat([x_t, ctx.to(x_t.dtype)], dim=-1), t,
                            None)
        else:
            eps = self.unet(x_t, t, ctx)
        if self.loss_type == "l1":
            return (eps - noise).abs().mean()
        return ((eps - noise) ** 2).mean()

    def draw_t_noise(self, z: torch.Tensor, generator: torch.Generator):
        """A step's draws, t then eps, from ``generator``."""
        t = torch.randint(0, self.timesteps, (z.shape[0],),
                          generator=generator,
                          device=generator.device).to(z.device)
        noise = torch.randn(z.shape, generator=generator,
                            device=generator.device).to(z.device)
        return t, noise

    def make_train_step(self, optimizer) -> Callable:
        """-> ``step(batch_z, ctx, generator=None, override_t=None,
        override_noise=None) -> loss``: the eps-prediction loss at the
        config's ``loss_type``, its backward and one step of ``optimizer``,
        which holds the UNet's parameters (and the cond stage's, when the
        caller computes ``ctx`` with grad through a trainable cond stage).
        t and eps come from ``generator`` unless given; the parameters are
        updated in place."""
        sched = self.schedule_arrays()

        def step(batch_z, ctx, generator=None, override_t=None,
                 override_noise=None):
            t, noise = override_t, override_noise
            if t is None or noise is None:
                t_d, n_d = self.draw_t_noise(batch_z, generator)
                t = t_d if t is None else t
                noise = n_d if noise is None else noise
            loss = self.eps_loss(sched, batch_z, ctx, t, noise)
            optimizer.zero_grad(set_to_none=False)
            loss.backward()
            optimizer.step()
            return loss.detach()
        return step

    # -- sampling ---------------------------------------------------------
    def _uncond_input(self, n: int, guidance_scale: float,
                      uncond_label: Optional[int]):
        """The host side of the CFG 'unconditional' branch, or None."""
        if guidance_scale == 1.0:
            return None
        if self.cond_mode == "concat":
            raise ValueError(
                "CFG over concat conditioning has no uncond source (no "
                "reference workload guides inpaint/SR/semantic)")
        if self.cond_kind in ("bert", "clip"):
            return self.conditioning_input([""] * n)
        if self.cond_kind == "class":
            lbl = (uncond_label if uncond_label is not None
                   else self.cond_stage.n_classes - 1)
            return self.conditioning_input(np.full((n,), lbl, np.int64))
        return None

    def make_sample_fn(self, num_steps: int = 50, eta: float = 0.0,
                       ddim: bool = True, guidance_scale: float = 1.0,
                       force_not_quantize: bool = False,
                       inject: Optional[Callable] = None,
                       uncond_label: Optional[int] = None,
                       raw_cond: bool = False) -> Callable:
        """-> fn(cond_batch, n, generators, x_T=None) -> images (n, H, W, 3)
        float32 in about [-1, 1] (the decoder's output, unclipped).

        ``cond_batch``: prompts, labels or conditioning images (None for the
        unconditional configs); with ``raw_cond`` the caller's composed
        context tensor (``cli/inpaint.py``).  ``generators``: one per row.
        DDIM, or the full DDPM chain with ``ddim=False``.
        ``guidance_scale`` != 1 guides against the empty prompt for text
        conditioning, or against the learned ``uncond_label`` class
        (default ``n_classes - 1``).  The DDIM path is captured on a card
        (module docstring); ``fn.eager`` is the same function uncaptured,
        and ``fn.body(c_in, u_in, x_T, noise)`` the chain and the decode from
        the conditioning inputs and the draws, for callers that capture a
        longer path around it (``cli/inpaint.py``).
        """
        sched = make_schedule("linear", self.timesteps,
                              linear_start=self.linear_start,
                              linear_end=self.linear_end)
        scfg = SamplerConfig(guidance_scale=guidance_scale, eta=eta)
        dd = make_ddim_schedule(sched, num_steps, eta=eta) if ddim else None
        eps = self.eps_model()

        def contexts(c_in, u_in, n):
            if c_in is None:
                cond = torch.zeros((n, 1, 1), device=self.device)
                return (lambda x, t, c: eps(x, t, None)), cond, None
            ctx = c_in if raw_cond else self.learned_conditioning(c_in,
                                                                  inject)
            uncond = (None if u_in is None
                      else self.learned_conditioning(u_in))
            return eps, ctx, uncond

        def shape(n):
            return (n, self.image_size, self.image_size, self.channels)

        def body(c_in, u_in, x_T, noise):
            n = x_T.shape[0]
            model, cond, uncond = contexts(c_in, u_in, n)
            z = ddim_sample(model, dd, generators=None, shape=shape(n),
                            cond=cond, uncond=uncond, cfg=scfg, x_T=x_T,
                            noise=noise)
            return self.decode_first_stage(
                z, force_not_quantize=force_not_quantize)

        def inputs(cond_batch, n):
            if cond_batch is None:
                c_in = None
            elif raw_cond:
                c_in = torch.as_tensor(cond_batch, dtype=torch.float32,
                                       device=self.device)
            else:
                c_in = self.conditioning_input(cond_batch)
            u_in = (None if c_in is None
                    else self._uncond_input(n, guidance_scale, uncond_label))
            return c_in, u_in

        if not ddim:
            @torch.inference_mode()
            def ddpm_fn(cond_batch, n, generators, x_T=None):
                c_in, u_in = inputs(cond_batch, n)
                model, cond, uncond = contexts(c_in, u_in, n)
                z = ddpm_sample(model, sched, generators=generators,
                                shape=shape(n), cond=cond, uncond=uncond,
                                cfg=scfg, x_T=x_T)
                return self.decode_first_stage(
                    z, force_not_quantize=force_not_quantize)
            return ddpm_fn

        def make(run):
            @torch.inference_mode()
            def fn(cond_batch, n, generators, x_T=None):
                c_in, u_in = inputs(cond_batch, n)
                dev = self.device
                x_T = (batched_normal(generators, shape(n), dev)
                       if x_T is None
                       else x_T.to(device=dev, dtype=torch.float32))
                noise = step_noise(generators, dd, shape(n), dev)
                return run(c_in, u_in, x_T, noise)
            return fn

        fn = graphs.entry(make, body)
        fn.body = body
        return fn

    @torch.inference_mode()
    def calibrate_scale(self, batch_images: torch.Tensor) -> "LegacyLDM":
        """scale_by_std: set scale_factor to 1/std of the first batch's
        latents.  Returns self, for chaining."""
        assert self.scale_by_std
        z = self.encode_first_stage(batch_images) / self.scale_factor
        self.scale_factor = float(1.0 / z.float().std(unbiased=False))
        return self


def load_reference_checkpoint(ldm: LegacyLDM, path: str) -> list:
    """A CompVis latent-diffusion ``.ckpt`` (``model.diffusion_model.*``,
    ``first_stage_model.*``, ``cond_stage_model.transformer.*`` for BERT)
    into `ldm`, each part strictly; -> the file's keys that were not
    used."""
    ckpt = load_pt(path)
    state = {k: v for k, v in ckpt.get("state_dict", ckpt).items()
             if isinstance(v, torch.Tensor)}
    used: set = set()
    ldm.unet.load_state_dict(bridge.convert_unet(state, ldm.unet.cfg,
                                                 used=used), strict=True)
    convert = (bridge.convert_vq if ldm.first_stage_kind == "vq"
               else bridge.convert_vae)
    ldm.first_stage.load_state_dict(convert(state, ldm.first_stage.cfg,
                                            used=used), strict=True)
    if ldm.cond_kind == "bert":
        ldm.cond_stage.load_state_dict(bridge.convert_bert_text(
            state, ldm.cond_stage.cfg.depth, used=used), strict=True)
    return sorted(set(state) - used)


def prepare(cfg: Dict, *, ckpt: Optional[str] = None, seed: int = 0,
            device=None, precision: str = "bf16") -> LegacyLDM:
    """What the legacy CLIs run: the config's model on ``device`` (``cuda``
    unless the caller asks for the CPU), random weights from ``seed``
    (``loader.init_weights``, zero-initialised output convs kept), the
    reference checkpoint's weights where ``ckpt`` is given, bf16 compute
    and storage (the codebook kept float32) or fp32, frozen."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    ldm = build_legacy_ldm(cfg, dtype=dtype, device=dev)
    init_weights(ldm, torch.Generator(device=dev).manual_seed(seed))
    if ckpt:
        load_reference_checkpoint(ldm, ckpt)
    if dtype == torch.bfloat16:
        # the VQ codebook stays float32 for the nearest-code search
        cast_float_params(ldm, dtype, keep=[
            m for m in ldm.modules() if isinstance(m, VectorQuantizer)])
    return ldm.requires_grad_(False).eval()


def build_legacy_ldm(cfg: Dict, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> LegacyLDM:
    """Reference LatentDiffusion YAML dict -> :class:`LegacyLDM` on
    ``device`` (the modules' own initialisation; load or draw weights
    after).  Raises with the offending target string for a first or cond
    stage it does not know."""
    mp = get(cfg, "model.params", {}) or {}
    with torch.device(device or "cpu"):
        return _build(cfg, mp, dtype)


def _build(cfg: Dict, mp: Dict, dtype: torch.dtype) -> LegacyLDM:
    unet = UNetModel(_unet_cfg(get(cfg, "model.params.unet_config.params",
                                   {}) or {}), dtype=dtype)
    fs = get(cfg, "model.params.first_stage_config", {}) or {}
    fs_target = fs.get("target", "")
    fs_params = fs.get("params", {}) or {}
    scale_factor = mp.get("scale_factor", 1.0)
    vae_cfg = _vae_cfg(fs_params, scale_factor)
    if fs_target.endswith("VQModelInterface"):
        first_stage = VQModelInterface(vae_cfg, n_embed=fs_params["n_embed"],
                                       dtype=dtype)
        fs_kind = "vq"
    elif fs_target.endswith("AutoencoderKL"):
        first_stage = AutoencoderKL(vae_cfg, dtype=dtype)
        fs_kind = "kl"
    else:
        raise ValueError(f"unsupported first_stage target {fs_target!r}")

    cs = get(cfg, "model.params.cond_stage_config", "__is_unconditional__")
    tokenizer, cs_params, cond_stage = None, {}, None
    if cs in ("__is_unconditional__", None):
        cond_kind = "uncond"
    elif cs == "__is_first_stage__":
        cond_kind = "first_stage"
    else:
        target = cs.get("target", "")
        cp = cs_params = cs.get("params", {}) or {}
        if target.endswith("ClassEmbedder"):
            cond_kind = "class"
            cond_stage = ClassEmbedder(cp.get("n_classes", 1000),
                                       cp["embed_dim"])
        elif target.endswith("BERTEmbedder"):
            cond_kind = "bert"
            tokenizer = default_bert_tokenizer()
            cond_stage = BERTTextEncoder(BERTTextConfig(
                vocab_size=cp.get("vocab_size", 30522),
                max_seq_len=cp.get("max_seq_len", 77),
                dim=cp["n_embed"], depth=cp["n_layer"]), dtype=dtype)
        elif target.endswith("FrozenCLIPEmbedder"):
            cond_kind = "clip"
            tokenizer = CLIPTokenizer.synthetic()
            cond_stage = CLIPTextEncoder(CLIPTextConfig.sd_v1(), dtype=dtype)
        elif target.endswith("SpatialRescaler"):
            cond_kind = "rescaler"
            cond_stage = SpatialRescaler(
                n_stages=cp.get("n_stages", 1),
                method=cp.get("method", "bilinear"),
                multiplier=cp.get("multiplier", 0.5),
                in_channels=cp.get("in_channels", 3),
                out_channels=cp.get("out_channels"),
                bias=cp.get("bias", False))
        elif target.endswith("Identity"):
            cond_kind = "identity"
        else:
            raise ValueError(f"unsupported cond_stage target {target!r}")

    # an explicit conditioning_key wins, else concat_mode (default True)
    # decides; unconditional forces none
    if cond_kind == "uncond":
        cond_mode = "none"
    else:
        cond_mode = mp.get("conditioning_key") or \
            ("concat" if mp.get("concat_mode", True) else "crossattn")
    if cond_mode not in ("none", "concat", "crossattn"):
        raise NotImplementedError(
            f"conditioning_key {cond_mode!r} (no shipped reference config "
            "uses hybrid/adm)")

    return LegacyLDM(
        unet=unet, first_stage=first_stage, first_stage_kind=fs_kind,
        cond_kind=cond_kind, cond_stage=cond_stage, cond_mode=cond_mode,
        cond_stage_params=cs_params, tokenizer=tokenizer,
        image_size=mp.get("image_size", 64), channels=mp.get("channels", 3),
        timesteps=mp.get("timesteps", 1000),
        linear_start=mp.get("linear_start", 0.0015),
        linear_end=mp.get("linear_end", 0.0195),
        scale_factor=scale_factor, scale_by_std=mp.get("scale_by_std", False),
        loss_type=mp.get("loss_type", "l2"),
        cond_stage_key=mp.get("cond_stage_key", "caption"), raw=cfg)
