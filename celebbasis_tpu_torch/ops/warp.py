"""Affine warp + bilinear sampling (``F.grid_sample`` semantics) as gathers.

Counterpart of ``celebbasis_tpu/ops/warp.py``.  The reference preprocesses
faces with ``F.affine_grid`` + ``F.grid_sample`` (align_corners=True, zero
padding) followed by ``F.interpolate(112, bilinear, align_corners=True)``.
Because align-corners normalised coordinates do not depend on the resolution,
the warp and the resize can also be composed into a single bilinear gather on
the output grid (``fused=True``).

Images are channels-last like all public tensors of the port: ``(H, W, C)``,
or ``(B, H, W, C)`` with a grid or matrix per image or shared.  The math is
written out (not ``F.grid_sample``) so that it matches the JAX functions tap
for tap, out-of-range taps included.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _norm_grid(h: int, w: int, device=None) -> torch.Tensor:
    """align_corners=True normalised coords: pixel i -> -1 + 2i/(n-1).
    (h, w, 2), xy order."""
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = True) -> torch.Tensor:
    """img: (H, W, C) or (B, H, W, C); grid: (h, w, 2) or (B, h, w, 2)
    normalised xy coords -> (h, w, C) or (B, h, w, C).

    Zero padding outside [-1, 1] (padding_mode='zeros').
    """
    batched = img.ndim == 4
    if not batched:
        img = img[None]
    if grid.ndim == 3:
        grid = grid[None].expand(img.shape[0], -1, -1, -1)
    B, H, W, C = img.shape
    h, w = grid.shape[1:3]
    x, y = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (x + 1.0) * 0.5 * (W - 1)
        fy = (y + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((x + 1.0) * W - 1.0) * 0.5
        fy = ((y + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx = (fx - x0)[..., None].to(img.dtype)
    wy = (fy - y0)[..., None].to(img.dtype)
    flat = img.reshape(B, H * W, C)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        lin = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        vals = torch.gather(flat, 1, lin.reshape(B, h * w, 1).expand(-1, -1, C))
        return vals.reshape(B, h, w, C) * inb[..., None].to(img.dtype)

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    out = top * (1 - wy) + bot * wy
    return out if batched else out[0]


def _affine_grid(h: int, w: int, M: torch.Tensor) -> torch.Tensor:
    """The (h, w) output grid mapped through the 2x3 normalised-coords
    affine M ((2, 3) -> (h, w, 2); (B, 2, 3) -> (B, h, w, 2))."""
    base = _norm_grid(h, w, device=M.device)
    hom = torch.cat([base, torch.ones_like(base[..., :1])], dim=-1)
    return torch.einsum("hwk,...ck->...hwc", hom, M.to(hom.dtype))


def affine_warp(img: torch.Tensor, M: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """affine_grid + grid_sample at the input resolution; img (H, W, C) or
    (B, H, W, C), M (2, 3) or (B, 2, 3)."""
    H, W = img.shape[-3:-1]
    return grid_sample_bilinear(img, _affine_grid(H, W, M), align_corners)


def affine_warp_resize(img: torch.Tensor, M: torch.Tensor,
                       out_hw: Tuple[int, int], align_corners: bool = True,
                       fused: bool = False) -> torch.Tensor:
    """Warp by the 2x3 normalised-coords affine M, then resize to ``out_hw``.

    ``fused=False`` (default) is the reference's two-stage resample (affine
    grid_sample at full resolution, then bilinear align-corners interpolate).
    ``fused=True`` composes both into a single gather on the output grid:
    cheaper, slightly different filtering.
    """
    if fused:
        return grid_sample_bilinear(img, _affine_grid(*out_hw, M),
                                    align_corners)
    warped = affine_warp(img, M, align_corners)
    return bilinear_resize_align_corners(warped, out_hw)


def batched_affine_warp_resize(imgs: torch.Tensor, M: torch.Tensor,
                               out_hw: Tuple[int, int]) -> torch.Tensor:
    """imgs: (B, H, W, C); M: (2, 3) shared or (B, 2, 3)."""
    return affine_warp_resize(imgs, M, out_hw)


def bilinear_resize_align_corners(img: torch.Tensor, out_hw: Tuple[int, int]
                                  ) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=True) for (H, W, C) or
    (B, H, W, C)."""
    return grid_sample_bilinear(img, _norm_grid(*out_hw, device=img.device),
                                align_corners=True)


# The reference's fixed FFHQ-crop -> ArcFace-crop normalised affine (including
# its '/512' correction of the translation).
INSIGHTFACE_TRANS_MATRIX = torch.tensor(
    [[1.07695457, -0.03625215, -1.56352194 / 512],
     [0.03625215, 1.07695457, -5.32134629 / 512]], dtype=torch.float32)
