"""CosFace sphere20 / sphere64, the evaluation's face encoder.

Counterpart of ``celebbasis_tpu/eval/sphere.py`` (the reference's
``evaluation/face_align/cosface/net.py``, the identity scorer of
``IdentityEvaluator``): four stages of [stride-2 conv + PReLU + N residual
(conv-PReLU-conv-PReLU) blocks], then fc(512*7*7 -> 512) on 112x112 inputs.

Layout: the input is channels-last ``(B, 112, 112, 3)``; inside, the same
memory is viewed as ``(B, C, H, W)`` (channels_last).  The head flattens in
``(H, W, C)`` order, the JAX package's, so the ``fc`` weight is the flax
kernel transposed, and ``convert_sphere`` reorders the torch file's
channel-major ``(C, H, W)`` flatten into it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Set, Tuple

import torch
import torch.nn as nn

from celebbasis_tpu_torch.models.iresnet import PReLU
from celebbasis_tpu_torch.ops.basic import Conv, Dense, to_nchw, to_nhwc
from celebbasis_tpu_torch.utils.bridge import _Reader


@dataclass(frozen=True)
class SphereConfig:
    layers: Tuple[int, int, int, int] = (1, 2, 4, 1)    # sphere20
    filters: Tuple[int, ...] = (64, 128, 256, 512)
    feat_dim: int = 512
    input_size: int = 112

    @staticmethod
    def sphere20():
        return SphereConfig((1, 2, 4, 1))

    @staticmethod
    def sphere64():
        return SphereConfig((3, 7, 16, 3))

    @staticmethod
    def tiny():
        return SphereConfig((1, 1, 1, 1), (8, 16, 32, 64), feat_dim=64,
                            input_size=32)


class SphereBlock(nn.Module):
    def __init__(self, planes: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(planes, planes, 3, dtype=dtype, bias=False)
        self.prelu1 = PReLU(planes)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype, bias=False)
        self.prelu2 = PReLU(planes)

    def forward(self, x):
        h = self.prelu1(self.conv1(x)).to(self.dtype)
        return x + self.prelu2(self.conv2(h)).to(self.dtype)


class SphereNet(nn.Module):
    def __init__(self, cfg: SphereConfig = SphereConfig.sphere20(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        cur, size, names = 3, cfg.input_size, []
        for li, (n_blocks, planes) in enumerate(zip(cfg.layers, cfg.filters),
                                                start=1):
            setattr(self, f"layer{li}_down",
                    Conv(cur, planes, 3, stride=2, padding=1, dtype=dtype))
            setattr(self, f"layer{li}_prelu", PReLU(planes))
            blocks = [f"layer{li}_block{bi}" for bi in range(n_blocks)]
            for name in blocks:
                setattr(self, name, SphereBlock(planes, dtype))
            names.append((f"layer{li}", tuple(blocks)))
            cur, size = planes, (size + 1) // 2
        self._stages = tuple(names)
        self.fc = Dense(cur * size * size, cfg.feat_dim, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, S, 3) in [-1, 1] -> (B, feat_dim) float32."""
        h = to_nchw(x).to(self.dtype)
        for stage, blocks in self._stages:
            h = getattr(self, f"{stage}_down")(h)
            h = getattr(self, f"{stage}_prelu")(h).to(self.dtype)
            for name in blocks:
                h = getattr(self, name)(h)
        h = to_nhwc(h)
        return self.fc(h.reshape(h.shape[0], -1).float())


def convert_sphere(state: Mapping, cfg: SphereConfig = SphereConfig.sphere20(),
                   used: Optional[Set[str]] = None) -> Dict[str, torch.Tensor]:
    """A torch sphere state dict (``nn.Sequential`` ``layerX.Y`` keys, with
    or without DataParallel's ``module.``) -> ``SphereNet``'s state dict,
    float32."""
    state = {k[7:] if k.startswith("module.") else k: torch.as_tensor(v)
             for k, v in state.items() if hasattr(v, "shape")}
    rd = _Reader(state, "", used)
    for li, n_blocks in enumerate(cfg.layers, start=1):
        rd.weight(f"layer{li}_down", f"layer{li}.0")
        rd.put(f"layer{li}_prelu.alpha", rd.take(f"layer{li}.1.weight"))
        for bi in range(n_blocks):
            s, d = f"layer{li}.{2 + bi}", f"layer{li}_block{bi}"
            rd.weight(f"{d}.conv1", f"{s}.conv1")
            rd.put(f"{d}.prelu1.alpha", rd.take(f"{s}.prelu1.weight"))
            rd.weight(f"{d}.conv2", f"{s}.conv2")
            rd.put(f"{d}.prelu2.alpha", rd.take(f"{s}.prelu2.weight"))
    fc_w = rd.take("fc.weight")                  # (out, C * H * W)
    C = cfg.filters[-1]
    side = int(round((fc_w.shape[1] // C) ** 0.5))
    rd.put("fc.weight", fc_w.reshape(-1, C, side, side).permute(0, 2, 3, 1)
           .reshape(fc_w.shape[0], -1).contiguous())
    rd.put("fc.bias", rd.take("fc.bias"))
    return rd.out
