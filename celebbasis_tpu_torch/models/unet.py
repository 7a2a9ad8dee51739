"""Stable Diffusion v1 UNet: bf16-or-fp32 compute, fp32 norms and softmax.

Counterpart of the SD path of ``celebbasis_tpu/models/unet.py`` and of the
SD v1.4 config: model_channels 320, channel_mult [1,2,4,4], 2 res blocks per
level, spatial transformers (depth 1, context 768) at downsample rates
{1,2,4}, 8 heads, middle block Res+Attn+Res, skip-concat decoder with 3
blocks per level.

Layout.  ``UNetModel`` takes and returns channels-last ``(B, H, W, C)``
latents like the JAX module.  Inside, the same memory is viewed as
``(B, C, H, W)`` in ``channels_last`` format (a free permute), which is what
cuDNN's convolutions like; ``ResBlock`` and ``SpatialTransformer`` take that
view.  The transformer blocks work on ``(B, HW, C)`` tokens.

Attribute names follow the flax tree (``down_0_res_0.conv1``,
``down_0_attn_0.block_0.attn1.to_q``, ``block_0.norm3`` ...), so weights are
carried over by one generic walk (``utils.bridge.from_jax_params``).

``UNetConfig.remat`` (a config's ``use_checkpoint``) recomputes each
``ResBlock`` and each ``SpatialTransformer`` in the backward pass instead of
keeping its activations (``torch.utils.checkpoint``), as ``nn.remat`` does
around the same blocks in the JAX module; the values are those without it.

The legacy-LDM knobs of the JAX config (plain ``AttentionBlock``, FiLM
conditioning, ``resblock_updown``, ``EncoderUNetModel``, ``AttentionPool2d``)
are not ported yet; ``UNetConfig`` raises on them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from celebbasis_tpu_torch.ops.attention import attention
from celebbasis_tpu_torch.ops.basic import (Conv, Dense, GroupNorm, LayerNorm,
                                            ZeroConv, from_tokens,
                                            timestep_embedding, to_nchw,
                                            to_nhwc, to_tokens)
from celebbasis_tpu_torch.ops.geglu import geglu_block, geglu_ffn
from celebbasis_tpu_torch.ops.resize import upsample2x_nearest_nchw


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    dropout: float = 0.0
    remat: bool = False
    # legacy-LDM knobs, kept so that configs read alike; only the defaults
    # are supported so far
    use_spatial_transformer: bool = True
    num_head_channels: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False

    def __post_init__(self):
        legacy = {"use_spatial_transformer": True, "num_head_channels": -1,
                  "use_scale_shift_norm": False, "resblock_updown": False}
        for name, default in legacy.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"UNetConfig.{name}={getattr(self, name)!r}: the legacy "
                    f"LDM variants are not ported yet")
        if self.dropout:
            raise NotImplementedError("dropout is a training-side knob that "
                                      "is not ported yet")

    def heads_for(self, ch: int) -> int:
        return self.num_heads

    @staticmethod
    def sd_v1() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny(context_dim: int = 64) -> "UNetConfig":
        return UNetConfig(model_channels=32, channel_mult=(1, 2), num_heads=4,
                          context_dim=context_dim, num_res_blocks=1,
                          attention_resolutions=(1, 2))


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + time-emb, GN -> SiLU -> zero-conv, residual.
    x: (B, C, H, W) view; emb: (B, E)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype=dtype)
        self.emb_proj = Dense(emb_ch, out_ch, dtype=dtype)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = ZeroConv(out_ch, out_ch, 3, dtype=dtype)
        if in_ch != out_ch:
            self.skip = Conv(in_ch, out_ch, 1, dtype=dtype)

    def forward(self, x, emb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    """QKV projections (no bias) + out projection around the attention
    core."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        inner = heads * dim_head
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x, context=None):
        context = x if context is None else context
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context),
                        num_heads=self.heads)
        return self.to_out(out)


class FeedForwardGEGLU(nn.Module):
    """GEGLU MLP: project to 2*4d, h * gelu_tanh(gate), back to d.  With
    ``ln`` (the norm3 weight and bias) it computes the whole residual
    sub-block ``x + GEGLU(LN(x))`` through ``ops.geglu.geglu_block``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj_in = nn.Linear(dim, dim * 8)
        self.proj_out = nn.Linear(dim * 4, dim)

    def forward(self, x, ln=None):
        w1, b1 = self.proj_in.weight.t(), self.proj_in.bias
        w2, b2 = self.proj_out.weight.t(), self.proj_out.bias
        x = x.to(self.dtype)
        if ln is None:
            return geglu_ffn(x, w1, b1, w2, b2)
        return geglu_block(x, ln[0], ln[1], w1, b1, w2, b2)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype)
        self.norm3 = LayerNorm(dim)    # consumed by the fused FF sub-block
        self.ff = FeedForwardGEGLU(dim, dtype)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return self.ff(x, ln=(self.norm3.weight, self.norm3.bias))


class SpatialTransformer(nn.Module):
    """GN -> 1x1 in -> transformer blocks on (B, HW, C) tokens -> zero 1x1
    out + residual.  x: (B, C, H, W) view."""

    def __init__(self, ch: int, context_dim: int, heads: int, depth: int,
                 dtype: torch.dtype):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(ch)
        self.proj_in = Conv(ch, ch, 1, dtype=dtype)
        for i in range(depth):
            setattr(self, f"block_{i}", BasicTransformerBlock(
                ch, context_dim, heads, ch // heads, dtype))
        self.proj_out = ZeroConv(ch, ch, 1, dtype=dtype)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = to_tokens(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        return x + self.proj_out(from_tokens(h, H, W))


class UNetModel(nn.Module):
    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        ch0 = cfg.model_channels
        emb_ch = ch0 * 4
        self.time_fc1 = Dense(ch0, emb_ch, dtype=dtype)
        self.time_fc2 = Dense(emb_ch, emb_ch, dtype=dtype)
        self.conv_in = Conv(cfg.in_channels, ch0, 3, dtype=dtype)

        def attn(ch):
            return SpatialTransformer(ch, cfg.context_dim, cfg.heads_for(ch),
                                      cfg.transformer_depth, dtype)

        # the forward pass walks this plan: (kind, attribute name)
        plan = []
        skip_chs = [ch0]
        cur, ds = ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            ch = ch0 * mult
            for j in range(cfg.num_res_blocks):
                name = f"down_{level}_res_{j}"
                setattr(self, name, ResBlock(cur, ch, emb_ch, dtype))
                plan.append(("res", name))
                cur = ch
                if ds in cfg.attention_resolutions:
                    name = f"down_{level}_attn_{j}"
                    setattr(self, name, attn(ch))
                    plan.append(("attn", name))
                plan.append(("push", None))
                skip_chs.append(cur)
            if level != len(cfg.channel_mult) - 1:
                name = f"down_{level}_downsample"
                setattr(self, name, Conv(ch, ch, 3, stride=2, padding=1,
                                         dtype=dtype))
                plan.append(("conv", name))
                plan.append(("push", None))
                skip_chs.append(cur)
                ds *= 2
        self.mid_res_0 = ResBlock(cur, cur, emb_ch, dtype)
        self.mid_attn = attn(cur)
        self.mid_res_1 = ResBlock(cur, cur, emb_ch, dtype)
        plan += [("res", "mid_res_0"), ("attn", "mid_attn"),
                 ("res", "mid_res_1")]
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            ch = ch0 * mult
            for j in range(cfg.num_res_blocks + 1):
                name = f"up_{level}_res_{j}"
                setattr(self, name,
                        ResBlock(cur + skip_chs.pop(), ch, emb_ch, dtype))
                plan += [("pop", None), ("res", name)]
                cur = ch
                if ds in cfg.attention_resolutions:
                    name = f"up_{level}_attn_{j}"
                    setattr(self, name, attn(ch))
                    plan.append(("attn", name))
            if level != 0:
                name = f"up_{level}_upsample"
                setattr(self, name, Conv(ch, ch, 3, dtype=dtype))
                plan += [("up", None), ("conv", name)]
                ds //= 2
        assert not skip_chs
        self._plan = tuple(plan)
        self.norm_out = GroupNorm(cur)
        self.conv_out = ZeroConv(cur, cfg.out_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) latents; timesteps: (B,); context: (B, T, D)
        cross-attention tokens.  Returns the eps prediction
        (B, H, W, out_channels) in float32."""
        dt = self.dtype
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels)
        emb = self.time_fc2(F.silu(self.time_fc1(t_emb.to(dt))))
        context = context.to(dt)
        h = self.conv_in(to_nchw(x.to(dt)))
        skips = [h]
        remat = self.cfg.remat and torch.is_grad_enabled()
        for kind, name in self._plan:
            if kind in ("res", "attn"):
                block = getattr(self, name)
                arg = emb if kind == "res" else context
                # the blocks draw nothing, so no RNG state is kept: reading
                # and setting the card's RNG state is refused in a captured
                # CUDA graph (utils.graphs)
                h = checkpoint(block, h, arg, use_reentrant=False,
                               preserve_rng_state=False) if remat \
                    else block(h, arg)
            elif kind == "conv":
                h = getattr(self, name)(h)
            elif kind == "push":
                skips.append(h)
            elif kind == "pop":
                h = torch.cat([h, skips.pop()], dim=1)
            else:   # "up"
                h = upsample2x_nearest_nchw(h)
        assert not skips
        h = self.conv_out(F.silu(self.norm_out(h)))
        return to_nhwc(h).float()
