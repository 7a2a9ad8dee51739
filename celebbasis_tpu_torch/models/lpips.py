"""LPIPS perceptual distance (VGG16 variant), the autoencoder loss's
perceptual term.

Counterpart of ``celebbasis_tpu/models/lpips.py`` (taming's ``LPIPS`` as
the reference's ``contperceptual.py`` uses it, ``LPIPS().eval()``): a frozen
VGG16 trunk tapped after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3,
features unit-normalised along channels, squared differences weighted by
learned non-negative per-channel heads, averaged over space and summed over
the taps.  The trunk follows torchvision's ``vgg16().features`` (its
weights carried by ``utils.bridge.convert_vgg16``), the heads a taming /
LPIPS checkpoint (``convert_lpips``); without files both are random.

Attribute names follow the flax tree (``vgg.conv_0`` ... ``vgg.conv_12``,
``lin_0`` ... ``lin_4``).  Images are channels-last ``(B, H, W, 3)`` in
[-1, 1]; the trunk runs on the ``(B, C, H, W)`` channels_last view.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.ops.basic import Conv, to_nchw

# torchvision's vgg16 conv plan; 'M' = 2x2 max pool
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512)
# the relu taps: how many convs run before each
_TAPS = (2, 4, 7, 10, 13)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
TAP_CHANNELS = (64, 128, 256, 512, 512)


class VGG16Features(nn.Module):
    """VGG16's conv trunk returning the five LPIPS relu taps, each
    ``(B, C, H, W)``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin, i = 3, 0
        for item in _VGG16_PLAN:
            if item != "M":
                setattr(self, f"conv_{i}", Conv(cin, item, 3, dtype=dtype))
                cin, i = item, i + 1
        self.n_convs = i

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, i, h = [], 0, x
        for item in _VGG16_PLAN:
            if item == "M":
                h = F.max_pool2d(h, 2)
                continue
            h = F.relu(getattr(self, f"conv_{i}")(h))
            i += 1
            if i in _TAPS:
                taps.append(h)
        return taps


def _norm_channels(x: torch.Tensor) -> torch.Tensor:
    """x / (sqrt(sum over channels of x^2) + 1e-10), the epsilon outside the
    root (taming's ``normalize_tensor``)."""
    return x / (x.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)


class LPIPS(nn.Module):
    """lpips(x, y): (B, H, W, 3) in [-1, 1] -> (B, 1, 1, 1) float32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGG16Features(dtype)
        for i, c in enumerate(TAP_CHANNELS):
            self.register_parameter(
                f"lin_{i}", nn.Parameter(torch.rand(c) * 0.1))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = self.shift.to(self.dtype)
        scale = self.scale.to(self.dtype)
        fx = self.vgg(to_nchw((x.to(self.dtype) - shift) / scale))
        fy = self.vgg(to_nchw((y.to(self.dtype) - shift) / scale))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_norm_channels(a) - _norm_channels(b)) ** 2
            w = getattr(self, f"lin_{i}").abs().to(d.dtype)
            contrib = (d * w[None, :, None, None]).sum(dim=1, keepdim=True)
            total = total + contrib.mean(dim=(2, 3), keepdim=True)
        return total.float()
