"""Shared numerical building blocks (fp32 norms, bf16-or-fp32 compute).

Counterpart of ``celebbasis_tpu/ops/basic.py``:

* sinusoidal timestep embedding is ``concat([cos, sin])``;
* GroupNorm is 32 groups, eps 1e-6 (not torch's default 1e-5);
* CLIP's activation is quick-GELU ``x * sigmoid(1.702 x)``.

Normalisations compute in float32 whatever the storage or compute type,
apply float32 scale and bias, and round once to the input's type, as the
JAX package's do.  A bf16 input on a CUDA device whose parameters are bf16
too (bf16 serving stores them so) goes to ATen's kernels as it is: they
accumulate statistics and apply the affine in float32 and round once, the
same arithmetic without two cast passes over the activation.  With float32
parameters and a bf16 input (the train step: fp32 storage, bf16 compute)
the input is cast up instead: ATen's CUDA norms refuse that mix, and
rounding the parameters to bf16 would change the result.

Layout: public tensors of the port are channels-last ``(B, H, W, C)`` like the
JAX package's.  Inside the conv stacks the same memory is viewed as
``(B, C, H, W)`` in ``channels_last`` format (a free permute), so ``GroupNorm``,
``Conv`` and ``ZeroConv`` here take that view.

``Dense`` and ``Conv`` mirror flax's ``dtype``/``param_dtype`` split: the
parameters may be stored in another type than the compute type; input and
parameters are cast to the compute type at the call (a no-op when they agree).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.parallel.mesh import (all_reduce_shared,
                                                all_reduce_sum, copy_to_model)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """(N,) fractional timesteps -> (N, dim) sinusoidal embedding, cos-first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _native_fp32_stats(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """True where ATen's norm kernels compute in float32 on the tensor and
    parameters as they are (CUDA, bf16 input and parameters): no up-cast copy
    is needed."""
    return x.is_cuda and x.dtype == torch.bfloat16 and all(
        p.dtype == torch.bfloat16 for p in params)


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``|out - ref|`` per element in units of the bf16 spacing at
    ``max(|ref|, 1/64)``.  A result rounded once from the float32 formula is
    at most one unit from another such result (the two sum the statistics in
    different orders); parameters rounded to bf16 before the affine move
    elements by more."""
    out, ref = out.float(), ref.float()
    _, e = torch.frexp(ref.abs().clamp_min(2.0 ** -6))
    return (out - ref).abs() / torch.ldexp(torch.ones_like(ref), e - 8)


class GroupNorm(nn.Module):
    """float32 GroupNorm(32, eps=1e-6) over the channel axis of a
    ``(B, C, ...)`` tensor (axis 1).

    ``shard`` (a ``parallel.mesh.ModelShard``): x holds this rank's block of
    the channels, and the affine, which stays whole, is read through this
    rank's slice of it.  Where the shards split the groups evenly, each
    rank normalises its whole groups alone; where groups straddle the
    shards, the per-group sums and sums of squares are summed over the
    model group in one all-reduce (``group_sums``,
    ``group_norm_from_sums``)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 epsilon: float = 1e-6):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        w, b, groups = self.weight, self.bias, self.num_groups
        if shard is not None:
            w, b = shard.block(w, 0), shard.block(b, 0)
            if groups % shard.size:
                n = w.shape[0]
                channels, first = n * shard.size, n * shard.index
                sums = all_reduce_shared(
                    group_sums(x, groups, channels, first), shard.group)
                return group_norm_from_sums(x, sums, groups, channels, first,
                                            w, b, self.epsilon)
            groups //= shard.size
        if _native_fp32_stats(x, w, b):
            return F.group_norm(x, groups, w, b, self.epsilon)
        y = F.group_norm(x.float(), groups, w.float(), b.float(),
                         self.epsilon)
        return y.to(x.dtype)


def _group_of(first: int, n: int, channels: int, groups: int,
              device) -> torch.Tensor:
    """The group of each of the channels ``first .. first + n``."""
    return torch.arange(first, first + n, device=device) // (
        channels // groups)


def group_sums(x: torch.Tensor, groups: int, channels: int,
               first: int) -> torch.Tensor:
    """The float32 sum and sum of squares, ``(B, groups, 2)``, that the
    channels ``first .. first + x.shape[1]`` of a ``(B, channels, ...)``
    tensor's GroupNorm contribute to each group (zero where they reach none):
    summed over the blocks of a channel split, they are the whole tensor's."""
    xf = x.float().flatten(2)
    per = torch.stack([xf.sum(-1), xf.square().sum(-1)], dim=-1)
    gid = _group_of(first, x.shape[1], channels, groups, x.device)
    return per.new_zeros(x.shape[0], groups, 2).index_add(1, gid, per)


def group_norm_from_sums(x: torch.Tensor, sums: torch.Tensor, groups: int,
                         channels: int, first: int, weight: torch.Tensor,
                         bias: torch.Tensor, epsilon: float) -> torch.Tensor:
    """GroupNorm of the block of channels ``first ..`` that ``x`` holds,
    from the whole tensor's per-group ``sums`` (``group_sums``, summed over
    the blocks): float32 statistics and affine (``weight`` / ``bias``: the
    block's), one rounding to x's type."""
    B, n = x.shape[:2]
    count = channels // groups * x[0, 0].numel()
    mean = sums[..., 0] / count
    var = (sums[..., 1] / count - mean.square()).clamp_min(0.0)
    gid = _group_of(first, n, channels, groups, x.device)
    shape = (B, n) + (1,) * (x.ndim - 2)
    scale = torch.rsqrt(var + epsilon)[:, gid] * weight.float()
    y = (x.float() - mean[:, gid].view(shape)) * scale.view(shape)
    return (y + bias.float().view((1, n) + (1,) * (x.ndim - 2))).to(x.dtype)


class LayerNorm(nn.Module):
    """float32 LayerNorm over the last axis, eps 1e-5."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.features, self.epsilon = features, epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _native_fp32_stats(x, self.weight, self.bias):
            return F.layer_norm(x, (self.features,), self.weight, self.bias,
                                self.epsilon)
        y = F.layer_norm(x.float(), (self.features,), self.weight.float(),
                         self.bias.float(), self.epsilon)
        return y.to(x.dtype)


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)`` semantics: x / max(||x||, eps)."""
    return x / x.norm(dim=axis, keepdim=True).clamp_min(eps)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` whatever its storage type.

    Under tensor parallelism (``parallel.mesh.shard_params``) a row-parallel
    layer holds a block of the input features and ``tp_group`` is set: its
    partial product is summed over that group, then the bias is added
    once.  A column-parallel layer holds a block of the output features and
    ``tp_input_group`` is set: the gradient of its replicated input is
    summed over that group."""

    tp_group = None
    tp_input_group = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp_input_group is not None:
            x = copy_to_model(x, self.tp_input_group)
        if self.tp_group is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        y = all_reduce_sum(F.linear(x.to(dt), self.weight.to(dt)),
                           self.tp_group)
        return y if b is None else y + b


class Conv(nn.Conv2d):
    """``nn.Conv2d`` on ``(B, C, H, W)`` that computes in ``dtype``.
    ``kernel``, ``stride`` and ``padding`` may be pairs; ``padding`` defaults
    to half a square kernel.  ``tp_group`` / ``tp_input_group``: a row- /
    column-parallel conv over channel shards, as ``Dense``."""

    tp_group = None
    tp_input_group = None

    def __init__(self, in_ch: int, out_ch: int, kernel=3, stride=1,
                 padding=None, dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        pad = kernel // 2 if padding is None else padding
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=pad,
                         bias=bias)
        self.compute_dtype = dtype

    def product(self, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        """This layer's convolution with ``weight`` and ``bias`` in place of
        its own (a slice of them), in the compute type."""
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), weight.to(dt),
                        None if bias is None else bias.to(dt), self.stride,
                        self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_input_group is not None:
            x = copy_to_model(x, self.tp_input_group)
        if self.tp_group is None:
            return self.product(x, self.weight, self.bias)
        y = all_reduce_sum(self.product(x, self.weight), self.tp_group)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype)[:, None, None]


class ZeroConv(Conv):
    """Conv initialised to zero: the output layers of the reference's
    ``zero_module(conv_nd)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, dtype=dtype)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the same memory viewed as (B, C, H, W), channels_last."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H, W, C); free when x is channels_last."""
    return x.permute(0, 2, 3, 1)


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H*W, C) tokens; no copy when x is
    channels_last."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).contiguous().reshape(B, H * W, C)


def from_tokens(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H*W, C) tokens -> the (B, C, H, W) channels_last view."""
    B, _, C = x.shape
    return x.reshape(B, H, W, C).permute(0, 3, 1, 2)
