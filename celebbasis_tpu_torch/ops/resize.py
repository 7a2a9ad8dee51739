"""Nearest-neighbour 2x upsampling as broadcast + reshape (counterpart of
``celebbasis_tpu/ops/resize.py``)."""
from __future__ import annotations

import torch


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C), exact nearest-neighbour x2."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, 2 * H, 2 * W, C)


def upsample2x_nearest_nchw(x: torch.Tensor) -> torch.Tensor:
    """The same on the (B, C, H, W) view used inside the conv stacks; the
    result is channels_last when the input is."""
    return upsample2x_nearest(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
