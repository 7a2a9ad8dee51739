"""IResNet face-recognition backbones (ArcFace/CosFace family).

Counterpart of ``celebbasis_tpu/models/iresnet.py``: the frozen CosFace
IResNet-100 used as the training path's face encoder (112x112 in, 512-d id
vector out) and its smaller siblings.

Per IBasicBlock: BN - conv3x3 - BN - PReLU - conv3x3(stride) - BN, plus a
conv1x1 + BN shortcut where the shape changes; stem conv3x3/BN/PReLU; head
BN - flatten - Dense - BN1d.  The net always runs frozen, so BatchNorm applies
stored statistics: ``scale``/``bias`` are (frozen) parameters named ``weight``
and ``bias``, the running ``mean`` and ``var`` are buffers.

Layout: the input is channels-last ``(B, S, S, 3)`` like every public tensor
of the port; inside, the same memory is viewed as ``(B, C, H, W)``
(channels_last).  The head flattens in ``(H, W, C)`` order, the JAX package's,
so its ``fc`` weight is the flax kernel transposed and nothing else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

from celebbasis_tpu_torch.ops.basic import Conv, Dense, to_nchw, to_nhwc


@dataclass(frozen=True)
class IResNetConfig:
    layers: Tuple[int, int, int, int] = (3, 13, 30, 3)  # r100
    feat_dim: int = 512
    base: int = 64          # stem width; levels are base * (1,2,4,8)
    input_size: int = 112

    @staticmethod
    def r100() -> "IResNetConfig":
        return IResNetConfig((3, 13, 30, 3))

    @staticmethod
    def r50() -> "IResNetConfig":
        return IResNetConfig((3, 4, 14, 3))

    @staticmethod
    def r18() -> "IResNetConfig":
        return IResNetConfig((2, 2, 2, 2))

    @staticmethod
    def tiny() -> "IResNetConfig":
        return IResNetConfig((1, 1, 1, 1), feat_dim=64, base=8, input_size=32)


class FrozenBN(nn.Module):
    """Inference-mode BatchNorm over the channel axis (axis 1 of a
    ``(B, C, ...)`` tensor): (x - mean) / sqrt(var + eps) * scale + bias, in
    float32."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """``shard`` (a ``parallel.mesh.ModelShard``): x holds this rank's
        block of the channels, normalised with its slice of the
        statistics and the affine."""
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean, var, w, b = self.mean, self.var, self.weight, self.bias
        if shard is not None:
            mean, var, w, b = (shard.block(t, 0) for t in (mean, var, w, b))
        inv = torch.rsqrt(var.float() + self.epsilon) * w.float()
        return ((x.float() - mean.float().view(shape)) * inv.view(shape)
                + b.float().view(shape))


class PReLU(nn.Module):
    """Per-channel parametric ReLU over axis 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((dim,), 0.25))

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        alpha = self.alpha if shard is None else shard.block(self.alpha, 0)
        alpha = alpha.to(x.dtype).view((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x >= 0, x, alpha * x)


class IBasicBlock(nn.Module):
    """BN -> conv1 -> BN -> PReLU -> conv2 -> BN, plus the shortcut.  Under
    ``conv_tp`` (``parallel.mesh.shard_params``; ``tp`` is this rank's
    ``ModelShard``) conv1 holds a block of the output channels and conv2
    the matching input channels: bn2 and the PReLU take this rank's slice of
    their channels, and conv2 sums its partial product over the model group
    (``ops.basic.Conv``) before bn3."""

    runs_conv_tp = True
    tp = None

    def __init__(self, in_planes: int, planes: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.bn1 = FrozenBN(in_planes)
        self.conv1 = Conv(in_planes, planes, 3, dtype=dtype, bias=False)
        self.bn2 = FrozenBN(planes)
        self.prelu = PReLU(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, dtype=dtype,
                          bias=False)
        self.bn3 = FrozenBN(planes)
        if stride != 1 or in_planes != planes:
            self.down_conv = Conv(in_planes, planes, 1, stride=stride,
                                  dtype=dtype, bias=False)
            self.down_bn = FrozenBN(planes)

    def forward(self, x):
        h = self.conv1(self.bn1(x).to(self.dtype))
        h = self.prelu(self.bn2(h, self.tp), self.tp).to(self.dtype)
        h = self.bn3(self.conv2(h))
        sc = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") \
            else x
        return (h + sc).to(self.dtype)


class IResNet(nn.Module):
    def __init__(self, cfg: IResNetConfig,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        base = cfg.base
        self.stem_conv = Conv(3, base, 3, dtype=dtype, bias=False)
        self.stem_bn = FrozenBN(base)
        self.stem_prelu = PReLU(base)
        names, cur, size = [], base, cfg.input_size
        for li, n_blocks in enumerate(cfg.layers):
            planes = base * (2 ** li)
            for bi in range(n_blocks):
                name = f"layer{li + 1}_block{bi}"
                setattr(self, name, IBasicBlock(cur, planes,
                                                2 if bi == 0 else 1, dtype))
                names.append(name)
                cur = planes
            size = (size + 1) // 2
        self._blocks = tuple(names)
        self.head_bn = FrozenBN(cur)
        self.fc = Dense(cur * size * size, cfg.feat_dim, dtype=torch.float32)
        self.features = FrozenBN(cfg.feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, S, 3) in [-1, 1] -> (B, feat_dim) float32 id features."""
        h = self.stem_conv(to_nchw(x).to(self.dtype))
        h = self.stem_prelu(self.stem_bn(h)).to(self.dtype)
        for name in self._blocks:
            h = getattr(self, name)(h)
        h = to_nhwc(self.head_bn(h))
        h = self.fc(h.reshape(h.shape[0], -1))
        return self.features(h)
