"""AutoencoderKL (f=8 KL VAE): bf16-or-fp32 compute, fp32 norms.

Counterpart of ``celebbasis_tpu/models/vae.py`` for the aigc_id config: ch
128, ch_mult [1,2,4,4], 2 res blocks, no attention except mid, double_z,
embed_dim 4; the caller applies scale_factor 0.18215.

The encoder's downsample pads (0,1,0,1) and runs a stride-2 VALID conv (not
the UNet's symmetric padding); the decoder's upsample is nearest-2x + conv.
The mid block's single-head full attention goes through the shared attention
core; at d=512 it is beyond the flash kernel's head-dim limit and takes the
plain core (``ops/attention.py``).

``encode``/``decode`` take and return channels-last ``(B, H, W, C)`` like the
JAX module; the blocks inside work on the ``(B, C, H, W)`` channels_last
view.

The legacy-LDM first-stage knobs: in-level single-head attention at the
listed *spatial resolutions* (``attn_resolutions``; ``resolution`` anchors
the per-level ladder, ``resolution >> level``), single-moment encoders for
the VQ stages (``double_z=False``), and ``attn_type='none'`` (no attention
block anywhere, the mid block's included).  An attention block takes the
flash kernel where its width is at most 256 and the plain core above, by
``ops.attention``'s rule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.ops.attention import attention
from celebbasis_tpu_torch.ops.basic import (Conv, GroupNorm, from_tokens,
                                            to_nchw, to_nhwc, to_tokens)
from celebbasis_tpu_torch.ops.resize import upsample2x_nearest_nchw


@dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    in_ch: int = 3
    out_ch: int = 3
    scale_factor: float = 0.18215
    attn_resolutions: Tuple[int, ...] = ()
    double_z: bool = True
    resolution: int = 256
    # 'vanilla' full attention, or 'none' (no attention block at all)
    attn_type: str = "vanilla"

    def level_res(self, level: int) -> int:
        """Spatial resolution at `level`."""
        return self.resolution >> level

    def level_attn(self, level: int) -> bool:
        return (self.level_res(level) in self.attn_resolutions
                and self.attn_type != "none")

    @property
    def moments(self) -> int:
        """The encoder's output channels."""
        return (2 if self.double_z else 1) * self.z_channels

    @staticmethod
    def sd_v1() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)


class VAEResBlock(nn.Module):
    """GN -> SiLU -> conv1, GN -> SiLU -> conv2, residual (through the 1x1
    ``nin_shortcut`` where the width changes).  Under ``conv_tp``
    (``parallel.mesh.shard_params``; ``tp`` is this rank's ``ModelShard``)
    conv1 holds a block of the output channels and conv2 the matching input
    channels: norm2 runs on this rank's channels and conv2 sums its partial
    product over the model group (``ops.basic.Conv``); ``nin_shortcut``
    stays replicated."""

    runs_conv_tp = True
    tp = None

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype=dtype)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype=dtype)
        if in_ch != out_ch:
            self.nin_shortcut = Conv(in_ch, out_ch, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h, self.tp)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head full self-attention over spatial tokens."""

    def __init__(self, ch: int, dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm(ch)
        self.q = Conv(ch, ch, 1, dtype=dtype)
        self.k = Conv(ch, ch, 1, dtype=dtype)
        self.v = Conv(ch, ch, 1, dtype=dtype)
        self.proj_out = Conv(ch, ch, 1, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        out = attention(to_tokens(self.q(h)), to_tokens(self.k(h)),
                        to_tokens(self.v(h)), num_heads=1)
        return x + self.proj_out(from_tokens(out, H, W))


def _mid_block(owner: nn.Module, cfg: VAEConfig, ch: int,
               dtype: torch.dtype) -> list:
    """Sets res, attention (unless attn_type 'none') and res on `owner`;
    -> their plan entries."""
    owner.mid_res_0 = VAEResBlock(ch, ch, dtype)
    plan = [("block", "mid_res_0")]
    if cfg.attn_type != "none":
        owner.mid_attn = VAEAttnBlock(ch, dtype)
        plan.append(("block", "mid_attn"))
    owner.mid_res_1 = VAEResBlock(ch, ch, dtype)
    return plan + [("block", "mid_res_1")]


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.conv_in = Conv(cfg.in_ch, cfg.ch, 3, dtype=dtype)
        cur = cfg.ch
        plan = []
        for level, mult in enumerate(cfg.ch_mult):
            ch = cfg.ch * mult
            for j in range(cfg.num_res_blocks):
                name = f"down_{level}_res_{j}"
                setattr(self, name, VAEResBlock(cur, ch, dtype))
                plan.append(("block", name))
                cur = ch
                if cfg.level_attn(level):
                    name = f"down_{level}_attn_{j}"
                    setattr(self, name, VAEAttnBlock(ch, dtype))
                    plan.append(("block", name))
            if level != len(cfg.ch_mult) - 1:
                name = f"down_{level}_downsample"
                setattr(self, name, Conv(ch, ch, 3, stride=2, padding=0,
                                         dtype=dtype))
                plan.append(("down", name))
        plan += _mid_block(self, cfg, cur, dtype)
        self._plan = tuple(plan)
        self.norm_out = GroupNorm(cur)
        self.conv_out = Conv(cur, cfg.moments, 3, dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x.to(self.dtype))
        for kind, name in self._plan:
            if kind == "down":   # pad right and bottom by one, VALID conv
                h = F.pad(h, (0, 1, 0, 1))
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        cur = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, cur, 3, dtype=dtype)
        plan = _mid_block(self, cfg, cur, dtype)
        for level, mult in reversed(list(enumerate(cfg.ch_mult))):
            ch = cfg.ch * mult
            for j in range(cfg.num_res_blocks + 1):
                name = f"up_{level}_res_{j}"
                setattr(self, name, VAEResBlock(cur, ch, dtype))
                plan.append(("block", name))
                cur = ch
                if cfg.level_attn(level):
                    name = f"up_{level}_attn_{j}"
                    setattr(self, name, VAEAttnBlock(ch, dtype))
                    plan.append(("block", name))
            if level != 0:
                name = f"up_{level}_upsample"
                setattr(self, name, Conv(ch, ch, 3, dtype=dtype))
                plan.append(("up", name))
        self._plan = tuple(plan)
        self.norm_out = GroupNorm(cur)
        self.conv_out = Conv(cur, cfg.out_ch, 3, dtype=dtype)

    def forward(self, z):
        h = self.conv_in(z.to(self.dtype))
        for kind, name in self._plan:
            if kind == "up":
                h = upsample2x_nearest_nchw(h)
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h))).float()


class AutoencoderKL(nn.Module):
    """encode -> (mean, logvar); decode(z) -> image.  The caller applies
    0.18215."""

    def __init__(self, cfg: VAEConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.quant_conv = Conv(cfg.moments, 2 * cfg.embed_dim, 1,
                               dtype=dtype)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, 1,
                                    dtype=dtype)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) in [-1, 1] -> posterior (mean, logvar), each
        (B, H/8, W/8, 4), float32."""
        moments = self.quant_conv(self.encoder(to_nchw(x))).float()
        mean, logvar = to_nhwc(moments).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, h, w, 4) -> image (B, 8h, 8w, 3), float32."""
        h = self.post_quant_conv(to_nchw(z.to(self.dtype)))
        return to_nhwc(self.decoder(h))

    def forward(self, x: torch.Tensor, generator: torch.Generator):
        mean, logvar = self.encode(x)
        z = sample_posterior(generator, mean, logvar)
        return self.decode(z), mean, logvar


def sample_posterior(generator: torch.Generator, mean, logvar):
    noise = torch.randn(mean.shape, generator=generator,
                        device=generator.device).to(mean.device)
    return mean + torch.exp(0.5 * logvar) * noise
