"""OpenCV's uint8 resamplers, bit for bit, without OpenCV.

The face-alignment chain resizes the detector's box crop and warps the
aligned face with OpenCV (``cv2.resize`` and ``cv2.warpAffine``, both
INTER_LINEAR); the aligned crops are the training inputs, so the port
reproduces that integer and float arithmetic exactly
(``native/cv_resample.cpp`` says how) rather than approximating it with a
float bilinear, which differs by one level on about a tenth of the pixels.

* ``resize_linear(img, (w, h))``: ``cv2.resize(img, (w, h))``;
* ``resize_scale(img, s)``: ``cv2.resize(img, None, fx=s, fy=s)``, output
  ``(round(h * s), round(w * s))``;
* ``warp_affine(img, M, (w, h), version)``: ``cv2.warpAffine(img, M,
  (w, h), borderValue=0)`` as OpenCV ``version`` computes it.  The two
  generations give different pixels: OpenCV 4 (and earlier) in fixed
  point, 1/32-pixel positions and 15-bit weights, OpenCV 5 in float with
  fused multiply-adds.  By default the warp is that of the OpenCV
  installed beside the port (read from the package metadata, without
  importing it), which is what the JAX package's chain calls, and OpenCV
  4's, the generation the reference's crops were made with, where none is
  installed.  OpenCV's resize is the same in both.

Images are ``(H, W)`` or ``(H, W, C)`` uint8 arrays on the host; the work is
C++ (built with ``g++`` at first use), which lets other threads run.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from celebbasis_tpu_torch.align import native

_u8p = ctypes.POINTER(ctypes.c_uint8)
_OPENCV_DISTRIBUTIONS = ("opencv-python", "opencv-python-headless",
                         "opencv-contrib-python",
                         "opencv-contrib-python-headless")


@functools.lru_cache(maxsize=1)
def default_warp_version() -> int:
    """The major version of the installed OpenCV if it is 5 or later, else
    4."""
    from importlib import metadata
    for name in _OPENCV_DISTRIBUTIONS:
        try:
            major = int(metadata.version(name).split(".")[0])
        except (metadata.PackageNotFoundError, ValueError):
            continue
        return 5 if major >= 5 else 4
    return 4


def _lib() -> ctypes.CDLL:
    lib = native.load("cv_resample")
    if not getattr(lib, "_typed", False):
        i = ctypes.c_int
        lib.cv_resize_linear_u8.argtypes = [_u8p, i, i, i, _u8p, i, i,
                                            ctypes.c_double, ctypes.c_double]
        lib.cv_resize_linear_u8.restype = None
        lib.cv_warp_affine_u8.argtypes = [_u8p, i, i, i, _u8p, i, i,
                                          ctypes.POINTER(ctypes.c_double), i]
        lib.cv_warp_affine_u8.restype = ctypes.c_int
        lib._typed = True
    return lib


def _prepare(img: np.ndarray) -> Tuple[np.ndarray, int]:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return img, 1 if img.ndim == 2 else img.shape[2]


def _output(h: int, w: int, c: int) -> np.ndarray:
    # like OpenCV's, the result of a one-channel image has no channel axis
    return np.empty((h, w) if c == 1 else (h, w, c), np.uint8)


def _resize(img: np.ndarray, h: int, w: int, inv_x: float,
            inv_y: float) -> np.ndarray:
    img, c = _prepare(img)
    if h < 1 or w < 1:
        raise ValueError(f"empty output size {(w, h)}")
    out = _output(h, w, c)
    _lib().cv_resize_linear_u8(img.ctypes.data_as(_u8p), img.shape[0],
                               img.shape[1], c, out.ctypes.data_as(_u8p), h,
                               w, inv_x, inv_y)
    return out


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (INTER_LINEAR); ``size`` is (w, h)."""
    w, h = (int(s) for s in size)
    return _resize(img, h, w, w / img.shape[1], h / img.shape[0])


def resize_scale(img: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=scale, fy=scale)`` (INTER_LINEAR)."""
    h = int(np.rint(img.shape[0] * scale))
    w = int(np.rint(img.shape[1] * scale))
    return _resize(img, h, w, float(scale), float(scale))


def warp_affine(img: np.ndarray, M: np.ndarray, size: Tuple[int, int],
                version: int | None = None) -> np.ndarray:
    """``cv2.warpAffine(img, M, size, borderValue=0)`` (INTER_LINEAR) as
    OpenCV ``version`` (4 or 5; default ``default_warp_version()``)
    computes it; M is the (2, 3) source-to-output transform, ``size`` is
    (w, h)."""
    version = default_warp_version() if version is None else version
    if version not in (4, 5):
        raise ValueError(f"OpenCV version {version}: 4 or 5")
    img, c = _prepare(img)
    w, h = (int(s) for s in size)
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(2, 3))
    out = _output(h, w, c)
    _lib().cv_warp_affine_u8(img.ctypes.data_as(_u8p), img.shape[0],
                             img.shape[1], c, out.ctypes.data_as(_u8p), h, w,
                             m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                             version)
    return out
