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

The legacy-LDM knobs of the JAX config are here too: plain spatial
self-attention (``AttentionBlock``, ``use_spatial_transformer=False``) with
``num_head_channels`` pinning the head width, FiLM time conditioning
(``use_scale_shift_norm``) and residual up/downsampling blocks
(``resblock_updown``).

``dropout`` (a config's ``dropout``) drops the ``ResBlock``'s hidden
activations before its output conv, as ``nn.Dropout`` does there in the JAX
module.  It applies only in training mode with grad enabled (never in
``eval()`` nor under ``no_grad``), and its masks are drawn from the
``torch.Generator`` the caller hands ``set_dropout_generator``: a captured
train step registers that generator with its graph (``utils.graphs``), so
each replay draws new masks.  The JAX UNet runs its dropout deterministic
(it never passes ``deterministic=False``), so a UNet in ``eval()`` is the one
the JAX package computes, whatever ``dropout`` says.  A training step with
both ``remat`` and dropout raises: a recomputed block would draw another
mask.

``EncoderUNetModel`` is the half-UNet classifier trunk (the encoder levels
and the middle block, then an ``'adaptive'``, ``'attention'``
(``AttentionPool2d``, through ``ops.attention.attention``) or
``'spatial'`` / ``'spatial_v2'`` head), which the noisy-latent classifier
(``train/classifier.py``) trains.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from celebbasis_tpu_torch.ops.attention import (attention,
                                                attention_heads)
from celebbasis_tpu_torch.ops.basic import (Conv, Dense, GroupNorm, LayerNorm,
                                            ZeroConv, from_tokens,
                                            timestep_embedding, to_nchw,
                                            to_nhwc, to_tokens)
from celebbasis_tpu_torch.ops.geglu import (geglu_block, geglu_ffn,
                                            geglu_xla, ln_xla)
from celebbasis_tpu_torch.ops.geglu import resolved_impl as geglu_impl
from celebbasis_tpu_torch.ops.resize import upsample2x_nearest_nchw
from celebbasis_tpu_torch.parallel.mesh import all_reduce_sum


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
    # legacy-LDM knobs (the reference openaimodel.UNetModel): plain spatial
    # self-attention instead of the cross-attention transformer, per-head
    # channel width, FiLM-style time conditioning, residual resampling
    use_spatial_transformer: bool = True
    num_head_channels: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False

    def heads_for(self, ch: int) -> int:
        """A fixed head count unless num_head_channels pins the head
        width."""
        if self.num_head_channels == -1:
            return self.num_heads
        assert ch % self.num_head_channels == 0, (ch, self.num_head_channels)
        return ch // self.num_head_channels

    @staticmethod
    def sd_v1() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny(context_dim: int = 64) -> "UNetConfig":
        return UNetConfig(model_channels=32, channel_mult=(1, 2), num_heads=4,
                          context_dim=context_dim, num_res_blocks=1,
                          attention_resolutions=(1, 2))


def dropout(h: torch.Tensor, p: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: zero each entry with probability ``p`` (a mask drawn
    from ``generator`` on h's device) and scale the rest by 1 / (1 - p)."""
    if generator is None:
        raise ValueError("dropout in training mode needs the generator "
                         "handed to set_dropout_generator")
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
    return h * keep.to(h.dtype) * (1.0 / (1.0 - p))


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + time-emb, GN -> SiLU -> [dropout] -> zero-conv,
    residual.  ``scale_shift`` is the FiLM conditioning ``norm2(h) * (1 +
    scale) + shift``; ``up`` / ``down`` put a parameter-free nearest 2x
    upsample or 2x2 average pool into both branches (resblock_updown).
    x: (B, C, H, W) view; emb: (B, E)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int,
                 dtype: torch.dtype, scale_shift: bool = False,
                 up: bool = False, down: bool = False, p_drop: float = 0.0):
        super().__init__()
        self.scale_shift, self.up, self.down = scale_shift, up, down
        self.p_drop, self.generator = p_drop, None
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype=dtype)
        self.emb_proj = Dense(emb_ch, 2 * out_ch if scale_shift else out_ch,
                              dtype=dtype)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = ZeroConv(out_ch, out_ch, 3, dtype=dtype)
        if in_ch != out_ch:
            self.skip = Conv(in_ch, out_ch, 1, dtype=dtype)

    def forward(self, x, emb):
        h = F.silu(self.norm1(x))
        if self.up:
            h, x = upsample2x_nearest_nchw(h), upsample2x_nearest_nchw(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.conv1(h)
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.scale_shift:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.norm2(h) * (1 + scale) + shift
        else:
            h = self.norm2(h + emb_out)
        h = F.silu(h)
        if self.p_drop and self.training and torch.is_grad_enabled():
            h = dropout(h, self.p_drop, self.generator)
        h = self.conv2(h)
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Plain spatial self-attention: GN -> fused qkv projection whose
    channels run [head][q|k|v][dh] (the reference's QKVAttentionLegacy
    layout) -> softmax(q k^T / sqrt(dh)) v -> zero out-projection, residual.
    q, k and v are strided views of the projection, handed to the per-head
    attention entry as they are (no copy).  x: (B, C, H, W) view; the
    context is ignored."""

    def __init__(self, ch: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm(ch)
        self.qkv = Dense(ch, 3 * ch, dtype=dtype)
        self.proj_out = Dense(ch, ch, dtype=dtype)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        qkv = self.qkv(to_tokens(self.norm(x)))
        qkv = qkv.view(B, H * W, self.heads, 3, C // self.heads)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
        out = attention_heads(q, k, v).transpose(1, 2).reshape(B, H * W, C)
        return x + from_tokens(self.proj_out(out), H, W)


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
    sub-block ``x + GEGLU(LN(x))`` through ``ops.geglu.geglu_block``.

    Under tensor parallelism (``parallel.mesh.shard_params``) ``proj_in``
    holds this rank's block of h and of the gate, ``proj_out`` the matching
    input rows, and ``proj_out.tp_group`` is set: the partial products are
    summed over the group, then ``proj_out``'s bias and the residual are
    added once.  That runs on the ``"xla"`` route; the fused kernel adds the
    residual inside, so the ``"cuda"`` route raises there."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj_in = nn.Linear(dim, dim * 8)
        self.proj_out = nn.Linear(dim * 4, dim)

    def forward(self, x, ln=None):
        w1, b1 = self.proj_in.weight.t(), self.proj_in.bias
        w2, b2 = self.proj_out.weight.t(), self.proj_out.bias
        x = x.to(self.dtype)
        group = getattr(self.proj_out, "tp_group", None)
        if group is None:
            if ln is None:
                return geglu_ffn(x, w1, b1, w2, b2)
            return geglu_block(x, ln[0], ln[1], w1, b1, w2, b2)
        if geglu_impl() != "xla":
            raise ValueError("tensor-parallel FF blocks take the 'xla' GEGLU "
                             "route: the fused kernel adds the residual "
                             "inside, once per rank")
        u = x if ln is None else ln_xla(x, ln[0], ln[1])
        y = all_reduce_sum(geglu_xla(u, w1, b1, w2, None), group)
        y = y + b2.to(y.dtype)
        return y if ln is None else x + y


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
            if not cfg.use_spatial_transformer:
                return AttentionBlock(ch, cfg.heads_for(ch), dtype)
            return SpatialTransformer(ch, cfg.context_dim, cfg.heads_for(ch),
                                      cfg.transformer_depth, dtype)

        def res(in_ch, out_ch, **updown):
            return ResBlock(in_ch, out_ch, emb_ch, dtype,
                            cfg.use_scale_shift_norm, p_drop=cfg.dropout,
                            **updown)

        # the forward pass walks this plan: (kind, attribute name)
        plan = []
        skip_chs = [ch0]
        cur, ds = ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            ch = ch0 * mult
            for j in range(cfg.num_res_blocks):
                name = f"down_{level}_res_{j}"
                setattr(self, name, res(cur, ch))
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
                if cfg.resblock_updown:
                    setattr(self, name, res(ch, ch, down=True))
                    plan.append(("res", name))
                else:
                    setattr(self, name, Conv(ch, ch, 3, stride=2, padding=1,
                                             dtype=dtype))
                    plan.append(("conv", name))
                plan.append(("push", None))
                skip_chs.append(cur)
                ds *= 2
        self.mid_res_0 = res(cur, cur)
        self.mid_attn = attn(cur)
        self.mid_res_1 = res(cur, cur)
        plan += [("res", "mid_res_0"), ("attn", "mid_attn"),
                 ("res", "mid_res_1")]
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            ch = ch0 * mult
            for j in range(cfg.num_res_blocks + 1):
                name = f"up_{level}_res_{j}"
                setattr(self, name, res(cur + skip_chs.pop(), ch))
                plan += [("pop", None), ("res", name)]
                cur = ch
                if ds in cfg.attention_resolutions:
                    name = f"up_{level}_attn_{j}"
                    setattr(self, name, attn(ch))
                    plan.append(("attn", name))
            if level != 0:
                name = f"up_{level}_upsample"
                if cfg.resblock_updown:
                    setattr(self, name, res(ch, ch, up=True))
                    plan.append(("res", name))
                else:
                    setattr(self, name, Conv(ch, ch, 3, dtype=dtype))
                    plan += [("up", None), ("conv", name)]
                ds //= 2
        assert not skip_chs
        self._plan = tuple(plan)
        self.norm_out = GroupNorm(cur)
        self.conv_out = ZeroConv(cur, cfg.out_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, H, W, C) latents; timesteps: (B,); context: (B, T, D)
        cross-attention tokens (None for the legacy configs whose
        ``AttentionBlock`` is self-attention only).  Returns the eps
        prediction (B, H, W, out_channels) in float32."""
        dt = self.dtype
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels)
        emb = self.time_fc2(F.silu(self.time_fc1(t_emb.to(dt))))
        if context is not None:
            context = context.to(dt)
        h = self.conv_in(to_nchw(x.to(dt)))
        skips = [h]
        remat = self.cfg.remat and torch.is_grad_enabled()
        if remat and self.training and self.cfg.dropout:
            raise NotImplementedError(
                "remat with dropout in training: a block recomputed in the "
                "backward would draw another mask")
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


def set_dropout_generator(model: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Hand every ``ResBlock`` of ``model`` the generator its dropout masks
    are drawn from (None takes it away)."""
    for m in model.modules():
        if isinstance(m, ResBlock):
            m.generator = generator


def dropout_generators(model: nn.Module) -> list:
    """The generators the dropout of ``model`` draws from in training mode
    (what a captured step registers with its graph)."""
    gens = []
    for m in model.modules():
        if isinstance(m, ResBlock) and m.p_drop and m.training \
                and m.generator is not None \
                and all(g is not m.generator for g in gens):
            gens.append(m.generator)
    return gens


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling: the spatial mean prepended as a query
    token, a learned positional table, one multi-head attention round
    through ``ops.attention.attention``, the pooled token projected.  The
    fused qkv projection is chunked q|k|v along channels before the heads
    split (the reference's QKVAttention, new order).  x: (B, C, H, W) view
    -> (B, out_channels) float32."""

    def __init__(self, ch: int, tokens: int, num_head_channels: int,
                 out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.heads = ch // num_head_channels
        self.pos_emb = nn.Parameter(torch.randn(tokens + 1, ch) * ch ** -0.5)
        self.qkv = Dense(ch, 3 * ch, dtype=dtype)
        self.c_proj = Dense(ch, out_channels, dtype=dtype)

    def forward(self, x):
        t = to_tokens(x)
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        t = t.float() + self.pos_emb[None].float()
        q, k, v = self.qkv(t).chunk(3, dim=-1)
        out = attention(q, k, v, num_heads=self.heads)
        return self.c_proj(out)[:, 0].float()


class EncoderUNetModel(nn.Module):
    """The half-UNet classifier trunk: the encoder levels and middle block
    of :class:`UNetModel` (plain ``AttentionBlock``s at the attention
    resolutions), then a pooling head -- ``'adaptive'`` (GN -> SiLU ->
    global mean -> zero 1x1 conv), ``'attention'`` (``AttentionPool2d``) or
    ``'spatial'`` / ``'spatial_v2'`` (each block's spatial mean concatenated
    -> MLP).  ``cfg.out_channels`` is the number of classes; ``image_size``
    (the latent side) sizes the attention pool's positional table.  x: (B,
    H, W, C) latents, timesteps (B,) -> (B, classes) float32 logits."""

    def __init__(self, cfg: UNetConfig, image_size: int = 64,
                 pool: str = "adaptive", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.pool, self.dtype = cfg, pool, dtype
        ch0 = cfg.model_channels
        emb_ch = ch0 * 4
        self.time_fc1 = Dense(ch0, emb_ch, dtype=dtype)
        self.time_fc2 = Dense(emb_ch, emb_ch, dtype=dtype)
        self.conv_in = Conv(cfg.in_channels, ch0, 3, dtype=dtype)

        def res(in_ch, out_ch, **updown):
            return ResBlock(in_ch, out_ch, emb_ch, dtype,
                            cfg.use_scale_shift_norm, p_drop=cfg.dropout,
                            **updown)

        plan, cur, ds, widths = [], ch0, 1, [ch0]
        for level, mult in enumerate(cfg.channel_mult):
            ch = ch0 * mult
            for j in range(cfg.num_res_blocks):
                name = f"down_{level}_res_{j}"
                setattr(self, name, res(cur, ch))
                plan.append(("res", name))
                cur = ch
                if ds in cfg.attention_resolutions:
                    name = f"down_{level}_attn_{j}"
                    setattr(self, name,
                            AttentionBlock(ch, cfg.heads_for(ch), dtype))
                    plan.append(("attn", name))
                plan.append(("mean", None))
                widths.append(ch)
            if level != len(cfg.channel_mult) - 1:
                name = f"down_{level}_downsample"
                if cfg.resblock_updown:
                    setattr(self, name, res(ch, ch, down=True))
                    plan.append(("res", name))
                else:
                    setattr(self, name, Conv(ch, ch, 3, stride=2, padding=1,
                                             dtype=dtype))
                    plan.append(("conv", name))
                plan.append(("mean", None))
                widths.append(ch)
                ds *= 2
        self.mid_res_0 = res(cur, cur)
        self.mid_attn = AttentionBlock(cur, cfg.heads_for(cur), dtype)
        self.mid_res_1 = res(cur, cur)
        plan += [("res", "mid_res_0"), ("attn", "mid_attn"),
                 ("res", "mid_res_1")]
        self._plan = tuple(plan)
        if pool.startswith("spatial"):
            widths.append(cur)
            self.fc1 = Dense(sum(widths), 2048, dtype=torch.float32)
            if pool == "spatial_v2":
                # torch's GroupNorm eps (1e-5), as in the JAX head
                self.fc_norm = GroupNorm(2048, epsilon=1e-5)
            self.fc2 = Dense(2048, cfg.out_channels, dtype=torch.float32)
        elif pool in ("adaptive", "attention"):
            self.norm_out = GroupNorm(cur)
            if pool == "adaptive":
                self.conv_out = ZeroConv(cur, cfg.out_channels, 1,
                                         dtype=dtype)
            else:
                assert cfg.num_head_channels != -1
                side = image_size // ds
                self.attn_pool = AttentionPool2d(
                    cur, side * side, cfg.num_head_channels,
                    cfg.out_channels, dtype)
        else:
            raise NotImplementedError(f"Unexpected {pool} pooling")

    def forward(self, x: torch.Tensor,
                timesteps: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels)
        emb = self.time_fc2(F.silu(self.time_fc1(t_emb.to(dt))))
        h = self.conv_in(to_nchw(x.to(dt)))
        means = [h.float().mean(dim=(2, 3))]
        for kind, name in self._plan:
            if kind == "res":
                h = getattr(self, name)(h, emb)
            elif kind in ("attn", "conv"):
                h = getattr(self, name)(h)
            else:   # "mean"
                means.append(h.float().mean(dim=(2, 3)))
        if self.pool.startswith("spatial"):
            means.append(h.float().mean(dim=(2, 3)))
            hid = self.fc1(torch.cat(means, dim=-1))
            hid = (F.silu(self.fc_norm(hid)) if self.pool == "spatial_v2"
                   else F.relu(hid))
            return self.fc2(hid).float()
        h = F.silu(self.norm_out(h))
        if self.pool == "adaptive":
            h = self.conv_out(h.mean(dim=(2, 3), keepdim=True))
            return h.reshape(h.shape[0], -1).float()
        return self.attn_pool(h)
