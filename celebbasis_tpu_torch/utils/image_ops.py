"""utils_image grab-bag — torch/cv2-free numpy ports.

The port's own copy of ``celebbasis_tpu/utils/image_ops.py`` (numpy, PIL, scipy
and OpenCV only; it imports nothing of the JAX package), which the tests
hold to it bit for bit.

Parity target: `ldm/modules/image_degradation/utils_image.py`
(the Kai Zhang KAIR util module the BSRGAN degradations import).  The
algorithmic subset is ported faithfully and oracle-tested against the
reference module (tests/test_image_ops.py):

* MATLAB-exact bicubic ``imresize_np`` / ``imresize`` (+ ``cubic``,
  ``calculate_weights_indices``, ref :700-915) — the resize the degradation
  chain's downsample1 coin-flip uses; inner per-row ``mv`` loops become one
  gather + einsum per axis.
* ``calculate_psnr`` / ``calculate_ssim`` / ``ssim`` (:621-697) — MATLAB-style
  SSIM with the 11x11 sigma-1.5 Gaussian window, valid region.
* ``rgb2ycbcr`` / ``bgr2ycbcr`` / ``ycbcr2rgb`` / ``channel_convert``
  (:529-618) incl. the reference's uint8-round / float-rescale dtype contract.
* ``augment_img`` (8 dihedral modes) / ``augment_img_np3`` / ``augment_imgs``
  (:380-492; the rng is threaded instead of the reference's global
  ``random``), ``modcrop`` / ``shave`` (:494-526), ``patches_from_image`` /
  ``imssave`` / ``split_imageset`` (:93-151, PIL-backed IO),
  ``imread_uint`` / ``imsave`` (:185-216), ``uint2single`` family (:249-272),
  ``is_image_file`` / ``get_image_paths`` (:29-90).

Torch-only tensor shims (``*tensor*``, ``tensor2img``) are intentionally
absent — torch interop goes through ``utils/pt_io`` and the bridges, and the
package never imports torch.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = [".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm",
                  ".PPM", ".bmp", ".BMP", ".tif"]


def is_image_file(filename: str) -> bool:
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def get_image_paths(dataroot: Optional[str]) -> Optional[List[str]]:
    paths = None
    if dataroot is not None:
        paths = sorted(_get_paths_from_images(dataroot))
    return paths


def _get_paths_from_images(path: str) -> List[str]:
    assert os.path.isdir(path), f"{path} is not a valid directory"
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    assert images, f"{path} has no valid image file"
    return images


# ---------------------------------------------------------------------------
# conversions (ref :249-272)

def uint2single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8((img.clip(0, 1) * 255.0).round())


def uint162single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 65535.0)


def single2uint16(img: np.ndarray) -> np.ndarray:
    return np.uint16((img.clip(0, 1) * 65535.0).round())


# ---------------------------------------------------------------------------
# IO (ref :185-216; PIL instead of cv2, same RGB contract)

def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """HxWx3 RGB (or replicated gray), or HxWx1 gray (ref :185-198)."""
    from PIL import Image
    img = Image.open(path)
    if n_channels == 1:
        return np.asarray(img.convert("L"))[..., None]
    return np.asarray(img.convert("RGB"))


def imsave(img: np.ndarray, img_path: str):
    """The reference BGR-flips then cv2.imwrite's (which writes BGR), so the
    file holds the array's own channel order — PIL does that directly."""
    from PIL import Image
    img = np.squeeze(img)
    Image.fromarray(img).save(img_path)


imwrite = imsave


# ---------------------------------------------------------------------------
# patches (ref :93-151)

def patches_from_image(img: np.ndarray, p_size: int = 512,
                       p_overlap: int = 64, p_max: int = 800
                       ) -> List[np.ndarray]:
    w, h = img.shape[:2]
    patches = []
    if w > p_max and h > p_max:
        w1 = list(np.arange(0, w - p_size, p_size - p_overlap, dtype=int))
        h1 = list(np.arange(0, h - p_size, p_size - p_overlap, dtype=int))
        w1.append(w - p_size)
        h1.append(h - p_size)
        for i in w1:
            for j in h1:
                patches.append(img[i:i + p_size, j:j + p_size, :])
    else:
        patches.append(img)
    return patches


def imssave(imgs: Sequence[np.ndarray], img_path: str):
    img_name, _ = os.path.splitext(os.path.basename(img_path))
    for i, img in enumerate(imgs):
        new_path = os.path.join(os.path.dirname(img_path),
                                img_name + f"_s{i:04d}.png")
        imsave(img, new_path)


def split_imageset(original_dataroot: str, target_dataroot: str,
                   n_channels: int = 3, p_size: int = 800,
                   p_overlap: int = 96, p_max: int = 1000):
    for img_path in get_image_paths(original_dataroot):
        img = imread_uint(img_path, n_channels=n_channels)
        patches = patches_from_image(img, p_size, p_overlap, p_max)
        imssave(patches,
                os.path.join(target_dataroot, os.path.basename(img_path)))


# ---------------------------------------------------------------------------
# augmentations (ref :380-492)

def augment_img(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """The 8 dihedral modes, exact rot90/flipud composition (ref :380-398)."""
    if mode == 0:
        return img
    elif mode == 1:
        return np.flipud(np.rot90(img))
    elif mode == 2:
        return np.flipud(img)
    elif mode == 3:
        return np.rot90(img, k=3)
    elif mode == 4:
        return np.flipud(np.rot90(img, k=2))
    elif mode == 5:
        return np.rot90(img)
    elif mode == 6:
        return np.rot90(img, k=2)
    elif mode == 7:
        return np.flipud(np.rot90(img, k=3))
    raise ValueError(f"mode must be in [0, 8), got {mode}")


def augment_img_np3(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """Transpose/flip formulation (ref :441-466) — note modes 1/3/5/7 differ
    from augment_img's rot90 composition; replicated as-is."""
    if mode == 0:
        return img
    elif mode == 1:
        return img.transpose(1, 0, 2)
    elif mode == 2:
        return img[::-1, :, :]
    elif mode == 3:
        return img[::-1, :, :].transpose(1, 0, 2)
    elif mode == 4:
        return img[:, ::-1, :]
    elif mode == 5:
        return img[:, ::-1, :].transpose(1, 0, 2)
    elif mode == 6:
        return img[:, ::-1, :][::-1, :, :]
    elif mode == 7:
        return img[:, ::-1, :][::-1, :, :].transpose(1, 0, 2)
    raise ValueError(f"mode must be in [0, 8), got {mode}")


def augment_imgs(img_list: Sequence[np.ndarray], hflip: bool = True,
                 rot: bool = True,
                 rng: Optional[np.random.Generator] = None
                 ) -> List[np.ndarray]:
    """hflip-or-rotate (ref :469-491); rng threaded instead of global
    ``random``."""
    rng = rng or np.random.default_rng()
    hflip = hflip and rng.random() < 0.5
    vflip = rot and rng.random() < 0.5
    rot90 = rot and rng.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, :]
        if vflip:
            img = img[::-1, :, :]
        if rot90:
            img = img.transpose(1, 0, 2)
        return img

    return [_augment(img) for img in img_list]


def modcrop(img_in: np.ndarray, scale: int) -> np.ndarray:
    img = np.copy(img_in)
    if img.ndim == 2:
        h, w = img.shape
        img = img[:h - h % scale, :w - w % scale]
    elif img.ndim == 3:
        h, w, _ = img.shape
        img = img[:h - h % scale, :w - w % scale, :]
    else:
        raise ValueError(f"Wrong img ndim: [{img.ndim:d}].")
    return img


def shave(img_in: np.ndarray, border: int = 0) -> np.ndarray:
    img = np.copy(img_in)
    h, w = img.shape[:2]
    return img[border:h - border, border:w - border]


# ---------------------------------------------------------------------------
# color (ref :529-618) — matlab rgb2ycbcr constants, dtype-dependent
# round/rescale contract kept

def _ycbcr_apply(img: np.ndarray, vec, mat, offset,
                 post_scale: float) -> np.ndarray:
    """Shared dtype contract (ref :544-551): uint8 in -> rounded uint8 out,
    float in -> x255 up / /255 down.  Op order matches the reference exactly:
    matmul first, then scale by ``post_scale``, then add ``offset``.  Unlike
    the reference, the input is never mutated (its float path does
    ``img *= 255.`` in place)."""
    in_type = img.dtype
    x = np.asarray(img)
    if in_type != np.uint8:
        x = x * 255.0
    if vec is not None:
        rlt = np.dot(x, vec)
    else:
        rlt = np.matmul(x, np.asarray(mat, np.float64))
    # post_scale < 1 means the reference divides by 255 (fp-identical to its
    # `/ 255.0`, not a reciprocal multiply); > 1 means it multiplies by 255
    rlt = rlt / 255.0 if post_scale < 1 else rlt * post_scale
    rlt = rlt + np.asarray(offset)
    if in_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.0
    return rlt.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    if only_y:
        return _ycbcr_apply(img, [65.481, 128.553, 24.966], None, 16.0,
                            1 / 255.0)
    return _ycbcr_apply(
        img, None,
        [[65.481, -37.797, 112.0], [128.553, -74.203, -93.786],
         [24.966, 112.0, -18.214]],
        [16, 128, 128], 1 / 255.0)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    if only_y:
        return _ycbcr_apply(img, [24.966, 128.553, 65.481], None, 16.0,
                            1 / 255.0)
    return _ycbcr_apply(
        img, None,
        [[24.966, 112.0, -18.214], [128.553, -74.203, -93.786],
         [65.481, -37.797, 112.0]],
        [16, 128, 128], 1 / 255.0)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    return _ycbcr_apply(
        img, None,
        [[0.00456621, 0.00456621, 0.00456621],
         [0, -0.00153632, 0.00791071],
         [0.00625893, -0.00318811, 0]],
        [-222.921, 135.576, -276.836], 255.0)


def channel_convert(in_c: int, tar_type: str,
                    img_list: Sequence[np.ndarray]) -> List[np.ndarray]:
    """BGR<->gray/y (ref :597-618); cv2's BT.601 gray weights, replicated."""
    if in_c == 3 and tar_type == "gray":    # BGR -> gray
        out = []
        for img in img_list:
            g = np.dot(img.astype(np.float64), [0.114, 0.587, 0.299])
            if img.dtype == np.uint8:
                g = np.round(g).clip(0, 255).astype(np.uint8)
            else:
                g = g.astype(img.dtype)
            out.append(g[..., None])
        return out
    elif in_c == 3 and tar_type == "y":     # BGR -> y
        return [bgr2ycbcr(img, only_y=True)[..., None] for img in img_list]
    elif in_c == 1 and tar_type == "RGB":   # gray -> BGR
        return [np.repeat(img if img.ndim == 3 else img[..., None], 3, axis=2)
                for img in img_list]
    return list(img_list)


# ---------------------------------------------------------------------------
# metrics (ref :621-697)

def calculate_psnr(img1: np.ndarray, img2: np.ndarray,
                   border: int = 0) -> float:
    """[0,255] PSNR over the shaved region (ref :621-638)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    a = img1[border:h - border, border:w - border].astype(np.float64)
    b = img2[border:h - border, border:w - border].astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel outer product: exp(-(i-c)^2/2s^2), normalized."""
    i = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(i ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k)


def _filter_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Correlation, valid region — equals cv2.filter2D(...)[5:-5, 5:-5] for
    the symmetric Gaussian window."""
    from numpy.lib.stride_tricks import sliding_window_view
    patches = sliding_window_view(img, window.shape)
    return np.einsum("ijkl,kl->ij", patches, window)


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style single-channel SSIM (ref :669-688)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window(11, 1.5)

    mu1 = _filter_valid(img1, window)
    mu2 = _filter_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(img1 ** 2, window) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, window) - mu2_sq
    sigma12 = _filter_valid(img1 * img2, window) - mu1_mu2

    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray,
                   border: int = 0) -> float:
    """Channel-mean MATLAB SSIM over the shaved region (ref :642-666)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border:h - border, border:w - border]
    img2 = img2[border:h - border, border:w - border]
    if img1.ndim == 2:
        return ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([ssim(img1[:, :, i], img2[:, :, i])
                                  for i in range(3)]))
        if img1.shape[2] == 1:
            return ssim(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")


# ---------------------------------------------------------------------------
# MATLAB bicubic imresize (ref :700-915)

def cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
            + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
            * ((absx > 1) & (absx <= 2)))


def calculate_weights_indices(in_length: int, out_length: int, scale: float,
                              kernel: str, kernel_width: float,
                              antialiasing: bool
                              ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Reference :708-763 — same trim-first/last-zero-column rule, same
    symmetric-padding bookkeeping; float32 accumulation like torch's
    linspace/cubic path."""
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.linspace(1, out_length, out_length, dtype=np.float32)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = math.ceil(kernel_width) + 2
    indices = left[:, None] + np.linspace(0, p - 1, p, dtype=np.float32)[None]
    distance = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * cubic((distance * scale).astype(np.float32))
    else:
        weights = cubic(distance.astype(np.float32))
    weights = weights / weights.sum(axis=1, keepdims=True)
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(float(zero_cols[0]), 0, rel_tol=1e-6):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    if not math.isclose(float(zero_cols[-1]), 0, rel_tol=1e-6):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]
    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_length)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return weights.astype(np.float32), indices, sym_len_s, sym_len_e


def _resize_axis(img: np.ndarray, weights: np.ndarray, indices: np.ndarray,
                 sym_s: int, sym_e: int) -> np.ndarray:
    """One separable pass along axis 0 of (N, ...): symmetric-reflect pad,
    gather windows, contract with per-output-row weights (replaces the
    reference's per-row ``mv`` loops, :877-882)."""
    n = img.shape[0]
    head = img[:sym_s][::-1]
    tail = img[n - sym_e:][::-1]
    aug = np.concatenate([head, img, tail], axis=0)
    kw = weights.shape[1]
    starts = indices[:, 0]
    win = aug[starts[:, None] + np.arange(kw)[None]]     # (out, kw, ...)
    wts = weights.reshape(weights.shape[0], kw,
                          *([1] * (img.ndim - 1))).astype(np.float32)
    return (win.astype(np.float32) * wts).sum(axis=1)


def imresize_np(img: np.ndarray, scale: float,
                antialiasing: bool = True) -> np.ndarray:
    """MATLAB bicubic for numpy HWC/HW [0,1] images (ref :839-910)."""
    need_squeeze = img.ndim == 2
    if need_squeeze:
        img = img[..., None]
    in_h, in_w = img.shape[:2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)
    kernel_width = 4
    w_h, i_h, s_hs, s_he = calculate_weights_indices(
        in_h, out_h, scale, "cubic", kernel_width, antialiasing)
    w_w, i_w, s_ws, s_we = calculate_weights_indices(
        in_w, out_w, scale, "cubic", kernel_width, antialiasing)
    out = _resize_axis(np.asarray(img, np.float32), w_h, i_h, s_hs, s_he)
    out = _resize_axis(out.transpose(1, 0, 2), w_w, i_w, s_ws, s_we)
    out = out.transpose(1, 0, 2)
    return out[..., 0] if need_squeeze else out


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """CHW/HW variant (ref :766-836) — same math, channel-first layout."""
    need_squeeze = img.ndim == 2
    if need_squeeze:
        img = img[None]
    out = imresize_np(np.transpose(img, (1, 2, 0)), scale, antialiasing)
    out = np.transpose(out, (2, 0, 1))
    return out[0] if need_squeeze else out
