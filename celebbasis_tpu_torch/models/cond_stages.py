"""Spatial conditioning stages of the concat-mode legacy workloads.

Counterpart of ``celebbasis_tpu/models/cond_stages.py``: the reference's
``SpatialRescaler`` (the semantic-synthesis configs: a one-hot segmentation
rescaled to latent resolution, then an optional 1x1 channel-mapping conv,
concat-fed to the UNet).  ``torch.nn.Identity`` cond stages need no module
(``legacy.py`` passes the array through).

``F.interpolate(mode='bilinear', align_corners=False)`` at scale 0.5 without
antialias samples every output pixel at the centre of a 2x2 input block,
i.e. it is 2x2 average pooling, which is what runs here; ``nearest`` at 0.5
is a stride-2 slice.  Other (method, multiplier) pairs are used by no
shipped config and raise, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.ops.basic import Conv, to_nchw, to_nhwc


class SpatialRescaler(nn.Module):
    """(B, H, W, C) -> (B, H*m^n, W*m^n, C or out_channels); the channel
    mapper computes in float32, as the JAX conv does on float32 inputs."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear",
                 multiplier: float = 0.5, in_channels: int = 3,
                 out_channels: int | None = None, bias: bool = False):
        super().__init__()
        if multiplier != 0.5 or method not in ("bilinear", "nearest"):
            raise NotImplementedError(
                f"SpatialRescaler({method!r}, {multiplier}): the shipped "
                "reference configs only use bilinear x0.5")
        self.n_stages, self.method = n_stages, method
        self.multiplier, self.out_channels = multiplier, out_channels
        if out_channels is not None:
            self.channel_mapper = Conv(in_channels, out_channels, 1,
                                       bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for _ in range(self.n_stages):
            if self.method == "bilinear":
                h = to_nhwc(F.avg_pool2d(to_nchw(h), 2))
            else:
                h = h[:, ::2, ::2, :]
        if self.out_channels is not None:
            h = to_nhwc(self.channel_mapper(to_nchw(h)))
        return h

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)
