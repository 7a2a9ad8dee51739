"""Face alignment math: 98 -> 5 landmarks, the similarity fit, the crop.

Counterpart of ``celebbasis_tpu/align/alignment.py`` (the reference's
``alignment/landmarks.py`` get_5_from_98 and ``alignment/alignment.py``
estimate_norm / norm_crop).  The templates are the standard public
arcface / set1 / ffhq / mtcnn 5-point targets.

The similarity fit is Umeyama's closed form in float64.  ``norm_crop``
warps the uint8 image with OpenCV's warpAffine arithmetic on the host
(``align.cv_resample``), so its crops are those of the reference chain bit
for bit; ``warp_affine_pixels`` is the same warp as a float bilinear gather
on a tensor's device (``ops.warp.grid_sample_bilinear``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from celebbasis_tpu_torch.align import cv_resample
from celebbasis_tpu_torch.ops.warp import grid_sample_bilinear

SET1 = np.array([[41.125, 50.75], [71.75, 49.4375], [49.875, 73.0625],
                 [45.9375, 87.9375], [70.4375, 87.9375]], np.float32)
ARCFACE = np.array([[38.2946, 51.6963], [73.5318, 51.5014],
                    [56.0252, 71.7366], [41.5493, 92.3655],
                    [70.7299, 92.2041]], np.float32)
FFHQ = np.array([[192.98138, 239.94708], [318.90277, 240.1936],
                 [256.63416, 314.01935], [201.26117, 371.41043],
                 [313.08905, 371.15118]], np.float32)
MTCNN = np.array([[40.95041, 52.341854], [70.90203, 52.17619],
                  [56.02142, 69.376114], [43.716904, 86.910675],
                  [68.52042, 86.77348]], np.float32)

_TEMPLATES = {"set1": (SET1, 112), "arcface": (ARCFACE, 112),
              "ffhq": (FFHQ, 512), "mtcnn": (MTCNN, 112)}


def get_5_from_98(lmk: np.ndarray) -> np.ndarray:
    """WFLW 98 landmarks -> [left eye, right eye, nose, mouth corners], in
    float64 (the eye centres are thirds of integer sums, which the fit
    takes at full precision)."""
    left_eye = (lmk[60] + lmk[64] + lmk[96]) / 3
    right_eye = (lmk[68] + lmk[72] + lmk[97]) / 3
    return np.asarray([left_eye, right_eye, lmk[54], lmk[76], lmk[82]],
                      np.float64)


def extract_five_from_68(lmk: np.ndarray) -> np.ndarray:
    """68-point (dlib / 300W) landmarks -> the same 5 points."""
    left_eye = lmk[36:42, :2].mean(axis=0)
    right_eye = lmk[42:48, :2].mean(axis=0)
    return np.asarray([left_eye, right_eye, lmk[30, :2], lmk[48, :2],
                       lmk[54, :2]], np.float32)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform src -> dst (Umeyama 1991), a
    (2, 3) float64 matrix."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.ones(d)
    if np.linalg.det(cov) < 0:
        sgn[-1] = -1
    R = U @ np.diag(sgn) @ Vt
    var_s = (sc ** 2).sum() / n
    scale = (S * sgn).sum() / var_s
    t = mu_d - scale * R @ mu_s
    M = np.zeros((2, 3))
    M[:, :2] = scale * R
    M[:, 2] = t
    return M


def estimate_norm(lmk5: np.ndarray, image_size: int = 112,
                  mode: str = "ffhq") -> np.ndarray:
    """The similarity transform from the 5 points to the template scaled
    to ``image_size``."""
    if lmk5.shape != (5, 2):
        raise ValueError(f"expected (5, 2) landmarks, got {lmk5.shape}")
    template, base = _TEMPLATES[mode]
    return umeyama_similarity(lmk5, template * (float(image_size) / base))


def warp_affine_pixels(image: torch.Tensor, M: np.ndarray,
                       out_size: Tuple[int, int]) -> torch.Tensor:
    """dst(x, y) = src(M^-1 [x, y, 1]), bilinear, zero border, on the
    image's device.  ``image``: (H, W, C) float, or uint8 (converted on the
    device; the result is floored to uint8 after clipping).  ``M``: the
    (2, 3) source-to-output pixel transform; ``out_size``: (h, w)."""
    H, W = image.shape[:2]
    oh, ow = out_size
    A = np.vstack([M, [0, 0, 1]]).astype(np.float64)
    Ainv = torch.from_numpy(np.linalg.inv(A)[:2].astype(np.float32)).to(
        image.device)
    u8 = image.dtype == torch.uint8
    img = image.float()
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=image.device),
        torch.arange(ow, dtype=torch.float32, device=image.device),
        indexing="ij")
    hom = torch.stack([xs, ys, torch.ones_like(xs)], -1)
    coords = hom @ Ainv.T
    grid = torch.stack([2.0 * coords[..., 0] / (W - 1) - 1.0,
                        2.0 * coords[..., 1] / (H - 1) - 1.0], -1)
    out = grid_sample_bilinear(img, grid, align_corners=True)
    if u8:
        out = torch.floor(out.clamp(0.0, 255.0)).to(torch.uint8)
    return out


def norm_crop(image: np.ndarray, lmk5: np.ndarray, image_size: int = 112,
              mode: str = "ffhq") -> np.ndarray:
    """The aligned square crop of a uint8 (H, W, C) image."""
    return norm_crop_with_M(image, lmk5, image_size, mode)[0]


def norm_crop_with_M(image: np.ndarray, lmk5: np.ndarray,
                     image_size: int = 112, mode: str = "ffhq"):
    M = estimate_norm(lmk5, image_size, mode)
    return cv_resample.warp_affine(image, M, (image_size, image_size)), M
