"""BSRGAN blind-SR degradation pipeline — torch-free, seeded.

The port's own copy of ``celebbasis_tpu/data/degradation.py`` (numpy, PIL, scipy
and OpenCV only; it imports nothing of the JAX package), which the tests
hold to it bit for bit.

Parity target: the reference's
`ldm/modules/image_degradation/bsrgan_light.py` (and the
heavier ``bsrgan.py`` variant) — the practical degradation model of
Zhang et al., "Designing a Practical Degradation Model for Deep Blind Image
Super-Resolution" (arXiv:2103.14006): randomized blur (iso/anisotropic
Gaussian), multi-stage rescaling, Gaussian/speckle/Poisson noise, and JPEG
compression, applied in a shuffled order with the final downsample pinned
last.  Consumed by ``data/legacy.py::ImageNetSR`` for
``degradation='bsrgan'/'bsrgan_light'``.

Design deltas from the reference (documented, deliberate):
* one ``np.random.Generator`` threads through every op (the reference mixes
  the global ``random`` and ``np.random`` states — unseedable per-sample);
* ``orth(rand(3,3))`` for the correlated-noise mixing basis becomes a QR
  orthonormalization of the same random matrix (identical distribution
  family, no scipy.linalg dependency at runtime);
* JPEG roundtrips through cv2 when present, else PIL (same quality range).

The deterministic sub-kernels (anisotropic_gaussian_kernel,
gaussian_kernel, blur convolution) are pinned against the reference's own
functions in tests/test_degradation.py.
"""
from __future__ import annotations

import io
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage

from celebbasis_tpu_torch.utils.image_ops import imresize_np


def uint2single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8((img.clip(0, 1) * 255.0).round())


# ---------------------------------------------------------------------------
# kernels (deterministic given args — oracle-tested)
# ---------------------------------------------------------------------------

def gaussian_kernel(hsize: int, sigma: float) -> np.ndarray:
    """matlab fspecial('gaussian') (bsrgan_light.py:187-199)."""
    siz = (hsize - 1.0) / 2.0
    y, x = np.mgrid[-siz:siz + 1, -siz:siz + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    s = h.sum()
    return h / s if s != 0 else h


def anisotropic_gaussian_kernel(ksize: int, theta: float, l1: float,
                                l2: float) -> np.ndarray:
    """Rotated anisotropic Gaussian (bsrgan_light.py:65-95): eigenbasis from
    the rotation of e1 by theta (reflection matrix V), eigenvalues l1/l2,
    density evaluated on the ksize grid centered like the reference
    (center = size/2 + 0.5, offsets +1)."""
    v = np.array([np.cos(theta), np.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.diag([l1, l2])
    sigma = V @ D @ np.linalg.inv(V)
    inv = np.linalg.inv(sigma)
    center = ksize / 2.0 + 0.5
    y, x = np.mgrid[0:ksize, 0:ksize]
    cy, cx = y - center + 1, x - center + 1
    # multivariate normal pdf up to its constant (cancelled by normalization)
    q = (inv[0, 0] * cx * cx + (inv[0, 1] + inv[1, 0]) * cx * cy
         + inv[1, 1] * cy * cy)
    k = np.exp(-0.5 * q) / (2 * np.pi * np.sqrt(np.linalg.det(sigma)))
    return k / k.sum()


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """Sub-pixel shift by (sf-1)/2 via bilinear resampling
    (bsrgan_light.py:98-130; the reference uses scipy interp2d, removed in
    modern scipy — same math via map_coordinates)."""
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    sign = 1.0 if upper_left else -1.0
    y1 = np.clip(np.arange(h) + sign * shift, 0, h - 1)
    x1 = np.clip(np.arange(w) + sign * shift, 0, w - 1)
    yy, xx = np.meshgrid(y1, x1, indexing="ij")
    if x.ndim == 2:
        return ndimage.map_coordinates(x, [yy, xx], order=1, mode="nearest")
    out = np.empty_like(x)
    for c in range(x.shape[2]):
        out[..., c] = ndimage.map_coordinates(x[..., c], [yy, xx], order=1,
                                              mode="nearest")
    return out


def blur(img: np.ndarray, k: np.ndarray, mode: str = "mirror") -> np.ndarray:
    """Channel-wise 2-D convolution (the reference's ndimage convolve with
    an expanded kernel)."""
    return ndimage.convolve(img, k[:, :, None], mode=mode)


# ---------------------------------------------------------------------------
# resize backends
# ---------------------------------------------------------------------------

_CV2_INTERP = (1, 2, 3)   # linear, cubic, area — the reference's choices


def _resize(img: np.ndarray, w: int, h: int, interp: int) -> np.ndarray:
    try:
        import cv2
        return cv2.resize(img, (w, h), interpolation=interp)
    except ImportError:                           # pragma: no cover
        from PIL import Image
        pil = {1: Image.BILINEAR, 2: Image.BICUBIC, 3: Image.BOX}[interp]
        arr = Image.fromarray(single2uint(img)).resize((w, h), resample=pil)
        return uint2single(np.asarray(arr))


# ---------------------------------------------------------------------------
# randomized degradation ops (rng-threaded versions of bsrgan_light.py)
# ---------------------------------------------------------------------------

def add_blur(img: np.ndarray, sf: int, rng: np.random.Generator,
             light: bool = True) -> np.ndarray:
    """bsrgan_light.py:325-340 (light) / bsrgan.py:325-336 (full: wider
    sigmas — no /4 shrink — AND wider odd kernels 2*randint(2,11)+3 in
    both branches)."""
    wd2, wd = 4.0 + sf, 2.0 + 0.2 * sf
    if light:
        wd2, wd = wd2 / 4, wd / 4
    if rng.random() < 0.5:
        ksize = (int(rng.integers(2, 12)) + 3 if light
                 else 2 * int(rng.integers(2, 12)) + 3)
        k = anisotropic_gaussian_kernel(
            ksize=ksize, theta=rng.random() * np.pi,
            l1=wd2 * rng.random(), l2=wd2 * rng.random())
    else:
        ksize = (int(rng.integers(2, 5)) + 3 if light
                 else 2 * int(rng.integers(2, 12)) + 3)
        k = gaussian_kernel(ksize, wd * rng.random())
    return blur(img, k, mode="mirror")


def add_resize(img: np.ndarray, sf: int,
               rng: np.random.Generator) -> np.ndarray:
    rnum = rng.random()
    if rnum > 0.8:
        sf1 = rng.uniform(1, 2)
    elif rnum < 0.7:
        sf1 = rng.uniform(0.5 / sf, 1)
    else:
        sf1 = 1.0
    img = _resize(img, int(sf1 * img.shape[1]), int(sf1 * img.shape[0]),
                  int(rng.choice(_CV2_INTERP)))
    return np.clip(img, 0.0, 1.0)


def _orth3(rng: np.random.Generator) -> np.ndarray:
    q, _ = np.linalg.qr(rng.random((3, 3)))
    return q


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       noise_level1: int = 2,
                       noise_level2: int = 25) -> np.ndarray:
    """bsrgan_light.py:373-387: color / grayscale / channel-correlated."""
    noise_level = int(rng.integers(noise_level1, noise_level2 + 1))
    rnum = rng.random()
    if rnum > 0.6:
        img = img + rng.normal(0, noise_level / 255.0,
                               img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + rng.normal(0, noise_level / 255.0,
                               (*img.shape[:2], 1)).astype(np.float32)
    else:
        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = _orth3(rng)
        conv = np.abs(L ** 2 * (U.T @ D @ U))
        img = img + rng.multivariate_normal(
            [0, 0, 0], conv, img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img: np.ndarray, rng: np.random.Generator,
                      noise_level1: int = 2,
                      noise_level2: int = 25) -> np.ndarray:
    noise_level = int(rng.integers(noise_level1, noise_level2 + 1))
    img = np.clip(img, 0.0, 1.0)
    rnum = rng.random()
    if rnum > 0.6:
        img = img + img * rng.normal(0, noise_level / 255.0,
                                     img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + img * rng.normal(0, noise_level / 255.0,
                                     (*img.shape[:2], 1)).astype(np.float32)
    else:
        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = _orth3(rng)
        conv = np.abs(L ** 2 * (U.T @ D @ U))
        img = img + img * rng.multivariate_normal(
            [0, 0, 0], conv, img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = rng.poisson(img * vals).astype(np.float32) / vals
    else:
        gray = np.dot(img[..., :3], [0.299, 0.587, 0.114])
        gray = np.clip((gray * 255.0).round(), 0, 255) / 255.0
        img = img + (rng.poisson(gray * vals).astype(np.float32) / vals
                     - gray)[:, :, None]
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img: np.ndarray, rng: np.random.Generator,
                   q_low: int = 80, q_high: int = 95) -> np.ndarray:
    quality = int(rng.integers(q_low, q_high + 1))
    u8 = single2uint(img)
    try:
        import cv2
        ok, enc = cv2.imencode(".jpg", cv2.cvtColor(u8, cv2.COLOR_RGB2BGR),
                               [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        return uint2single(cv2.cvtColor(cv2.imdecode(enc, 1),
                                        cv2.COLOR_BGR2RGB))
    except ImportError:                           # pragma: no cover
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(u8).save(buf, format="JPEG", quality=quality)
        return uint2single(np.asarray(Image.open(buf).convert("RGB")))


# ---------------------------------------------------------------------------
# classical degradation toolbox (bsrgan.py:29-335 — deterministic helpers the
# SRMD/DPSR/BlindSR lineages use; oracle-tested in tests/test_degradation.py)
# ---------------------------------------------------------------------------

def modcrop_np(img: np.ndarray, sf: int) -> np.ndarray:
    """bsrgan.py:29-40."""
    w, h = img.shape[:2]
    return np.copy(img)[:w - w % sf, :h - h % sf, ...]


def analytic_kernel(k: np.ndarray) -> np.ndarray:
    """X4 kernel from the X2 kernel (bsrgan.py:49-62): k (x) k on a doubled
    grid, edge-cropped, renormalized — the double loop becomes one
    zero-padded correlation stack."""
    ks = k.shape[0]
    big = np.zeros((3 * ks - 2, 3 * ks - 2))
    for r in range(ks):
        for c in range(ks):
            big[2 * r:2 * r + ks, 2 * c:2 * c + ks] += k[r, c] * k
    crop = ks // 2
    big = big[crop:-crop, crop:-crop]
    return big / big.sum()


def gm_blur_kernel(mean, cov, size: int = 15) -> np.ndarray:
    """Gaussian-mixture blur kernel (bsrgan.py:86-96): multivariate normal
    pdf on the (x, y) grid centered at size/2 + 0.5 - 1, normalized.  The
    per-cell scipy.stats pdf loop is one vectorized quadratic form."""
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    center = size / 2.0 + 0.5
    y, x = np.mgrid[0:size, 0:size]
    pts = np.stack([x - center + 1, y - center + 1], axis=-1) - mean
    inv = np.linalg.inv(cov)
    q = np.einsum("...i,ij,...j->...", pts, inv, pts)
    k = np.exp(-0.5 * q) / (2 * np.pi * np.sqrt(np.linalg.det(cov)))
    return k / k.sum()


def gen_kernel(k_size=(15, 15), scale_factor=(4, 4), min_var: float = 0.6,
               max_var: float = 10.0, noise_level: float = 0,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random shifted anisotropic kernel (bsrgan.py:145-184, the BlindSR
    dataset generator); rng threaded instead of np.random globals."""
    rng = rng or np.random.default_rng()
    k_size = np.asarray(k_size)
    scale_factor = np.asarray(scale_factor)
    lambda_1 = min_var + rng.random() * (max_var - min_var)
    lambda_2 = min_var + rng.random() * (max_var - min_var)
    theta = rng.random() * np.pi
    noise = -noise_level + rng.random(tuple(k_size)) * noise_level * 2

    lam = np.diag([lambda_1, lambda_2])
    q_rot = np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]])
    sigma = q_rot @ lam @ q_rot.T
    inv_sigma = np.linalg.inv(sigma)[None, None]

    mu = (k_size // 2 - 0.5 * (scale_factor - 1))[None, None, :, None]
    xg, yg = np.meshgrid(range(k_size[0]), range(k_size[1]))
    z = np.stack([xg, yg], 2)[:, :, :, None]
    zz = z - mu
    zz_t = zz.transpose(0, 1, 3, 2)
    raw = np.exp(-0.5 * np.squeeze(zz_t @ inv_sigma @ zz)) * (1 + noise)
    return raw / np.sum(raw)


def fspecial_laplacian(alpha: float) -> np.ndarray:
    """matlab fspecial('laplacian') (bsrgan.py:201-207)."""
    alpha = max(0.0, min(float(alpha), 1.0))
    h1 = alpha / (alpha + 1)
    h2 = (1 - alpha) / (alpha + 1)
    return np.array([[h1, h2, h1], [h2, -4 / (alpha + 1), h2], [h1, h2, h1]])


def fspecial(filter_type: str, *args, **kwargs) -> np.ndarray:
    """Dispatcher (bsrgan.py:210-218)."""
    if filter_type == "gaussian":
        return gaussian_kernel(*args, **kwargs)
    if filter_type == "laplacian":
        return fspecial_laplacian(*args, **kwargs)
    raise ValueError(f"unknown fspecial filter: {filter_type}")


def bicubic_degradation(x: np.ndarray, sf: int = 3) -> np.ndarray:
    """MATLAB-bicubic downsample (bsrgan.py:228-237)."""
    return imresize_np(x, scale=1 / sf)


def srmd_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """blur (wrap) + bicubic downsample (bsrgan.py:240-259, SRMD)."""
    x = ndimage.convolve(x, np.expand_dims(k, axis=2), mode="wrap")
    return bicubic_degradation(x, sf=sf)


def dpsr_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """bicubic downsample + blur (bsrgan.py:262-281, DPSR)."""
    x = bicubic_degradation(x, sf=sf)
    return ndimage.convolve(x, np.expand_dims(k, axis=2), mode="wrap")


def classical_degradation(x: np.ndarray, k: np.ndarray,
                          sf: int = 3) -> np.ndarray:
    """blur (wrap) + nearest downsample (bsrgan.py:284-296)."""
    x = ndimage.convolve(x, np.expand_dims(k, axis=2), mode="wrap")
    return x[0::sf, 0::sf, ...]


def _gaussian_blur_cv(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), 0) semantics: sigma from ksize
    (0.3*((k-1)*0.5 - 1) + 0.8), separable, reflect-101 border."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k1 = np.exp(-(i ** 2) / (2 * sigma ** 2))
    k1 /= k1.sum()
    out = ndimage.convolve1d(img, k1, axis=0, mode="mirror")
    return ndimage.convolve1d(out, k1, axis=1, mode="mirror")


def add_sharpening(img: np.ndarray, weight: float = 0.5, radius: int = 50,
                   threshold: int = 10) -> np.ndarray:
    """USM sharpening (bsrgan.py:299-322, borrowed from Real-ESRGAN):
    residual mask blur, soft composite."""
    if radius % 2 == 0:
        radius += 1
    blur_img = _gaussian_blur_cv(img, radius)
    residual = img - blur_img
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = _gaussian_blur_cv(mask, radius)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def random_crop(lq: np.ndarray, hq: np.ndarray, sf: int = 4,
                lq_patchsize: int = 64,
                rng: Optional[np.random.Generator] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned LR/HR crop pair (bsrgan.py:427-435)."""
    rng = rng or np.random.default_rng()
    h, w = lq.shape[:2]
    rnd_h = int(rng.integers(0, h - lq_patchsize + 1))
    rnd_w = int(rng.integers(0, w - lq_patchsize + 1))
    lq = lq[rnd_h:rnd_h + lq_patchsize, rnd_w:rnd_w + lq_patchsize, :]
    hq = hq[rnd_h * sf:(rnd_h + lq_patchsize) * sf,
            rnd_w * sf:(rnd_w + lq_patchsize) * sf, :]
    return lq, hq


# ---------------------------------------------------------------------------
# full pipelines
# ---------------------------------------------------------------------------

def degradation_bsrgan_variant(image: np.ndarray, sf: int = 4,
                               rng: Optional[np.random.Generator] = None,
                               light: bool = True) -> Dict[str, np.ndarray]:
    """bsrgan_light.py:534-622 (light) / bsrgan.py:530- (full): shuffled
    degradation chain with downsample3 pinned after downsample2 and a final
    JPEG pass.  ``image`` is uint8 HWC RGB; returns {"image": uint8 LR}."""
    rng = rng or np.random.default_rng()
    img = uint2single(image)
    jpeg_prob, scale2_prob = 0.9, 0.25
    h1, w1 = img.shape[:2]
    img = img.copy()[:w1 - w1 % sf, :h1 - h1 % sf, ...]   # mod crop (ref quirk: w/h swapped — harmless on square crops, replicated)

    if sf == 4 and rng.random() < scale2_prob:            # early 1/2
        # the reference coin-flips interpolated cv2.resize vs MATLAB bicubic
        # (bsrgan_light.py:553-559)
        if rng.random() < 0.5:
            img = _resize(img, int(1 / 2 * img.shape[1]), int(1 / 2 * img.shape[0]),
                          int(rng.choice(_CV2_INTERP)))
        else:
            img = imresize_np(img, 1 / 2, True)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    order = list(rng.permutation(7))
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:                                           # downsample3 last
        order[i2], order[i3] = order[i3], order[i2]

    a, b = img.shape[1], img.shape[0]
    noise_levels = (1, 2) if light else (2, 25)
    for i in order:
        if i == 0:
            img = add_blur(img, sf=sf, rng=rng, light=light)
        elif i == 1:
            if not light:   # the light variant comments this second blur out
                img = add_blur(img, sf=sf, rng=rng, light=light)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.8:                        # random rescale
                sf1 = rng.uniform(1, 2 * sf)
                img = _resize(img, int(1 / sf1 * img.shape[1]),
                              int(1 / sf1 * img.shape[0]),
                              int(rng.choice(_CV2_INTERP)))
            else:                                         # shifted-kernel blur + nearest ds
                k = gaussian_kernel(25, rng.uniform(0.1, 0.6 * sf))
                ks = shift_pixel(k, sf)
                img = blur(img, ks / ks.sum(), mode="mirror")
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:                                      # final downsample
            img = _resize(img, int(1 / sf * a), int(1 / sf * b),
                          int(rng.choice(_CV2_INTERP)))
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = add_gaussian_noise(img, rng, *noise_levels)
        elif i == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng)
        # i == 6: camera ISP model — reference gates on an isp_model that
        # is never provided (bsrgan_light.py:612-617); skipped identically
    img = add_jpeg_noise(img, rng)
    return {"image": single2uint(img)}


def degradation_bsrgan(img: np.ndarray, sf: int = 4, lq_patchsize: int = 72,
                       rng: Optional[np.random.Generator] = None,
                       light: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Paired LR/HQ variant (bsrgan_light.py:442-531): both blur slots
    active, rescale prob 0.75, Gaussian noise level 2-8, then an aligned
    (lq_patchsize, sf*lq_patchsize) crop pair.  float [0,1] in/out."""
    rng = rng or np.random.default_rng()
    img = uint2single(img) if img.dtype == np.uint8 else np.float32(img)
    jpeg_prob, scale2_prob = 0.9, 0.25
    sf_ori = sf
    h1, w1 = img.shape[:2]
    img = img.copy()[:w1 - w1 % sf, :h1 - h1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")
    hq = img.copy()

    if sf == 4 and rng.random() < scale2_prob:
        if rng.random() < 0.5:                  # same coin (bsrgan_light.py:465-471)
            img = _resize(img, int(1 / 2 * img.shape[1]), int(1 / 2 * img.shape[0]),
                          int(rng.choice(_CV2_INTERP)))
        else:
            img = imresize_np(img, 1 / 2, True)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    order = list(rng.permutation(7))
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:
        order[i2], order[i3] = order[i3], order[i2]

    a, b = img.shape[1], img.shape[0]
    for i in order:
        if i in (0, 1):
            img = add_blur(img, sf=sf, rng=rng, light=light)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf)
                img = _resize(img, int(1 / sf1 * img.shape[1]),
                              int(1 / sf1 * img.shape[0]),
                              int(rng.choice(_CV2_INTERP)))
            else:
                k = gaussian_kernel(25, rng.uniform(0.1, 0.6 * sf))
                ks = shift_pixel(k, sf)
                img = blur(img, ks / ks.sum(), mode="mirror")
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            img = _resize(img, int(1 / sf * a), int(1 / sf * b),
                          int(rng.choice(_CV2_INTERP)))
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = add_gaussian_noise(img, rng, 2, 8)
        elif i == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng)
        # i == 6: ISP model never provided — skipped like the reference
    img = add_jpeg_noise(img, rng)

    rh = int(rng.integers(0, img.shape[0] - lq_patchsize + 1))
    rw = int(rng.integers(0, img.shape[1] - lq_patchsize + 1))
    lq = img[rh:rh + lq_patchsize, rw:rw + lq_patchsize]
    hq = hq[rh * sf_ori:(rh + lq_patchsize) * sf_ori,
            rw * sf_ori:(rw + lq_patchsize) * sf_ori]
    return lq, hq


def degradation_bsrgan_plus(img: np.ndarray, sf: int = 4,
                            shuffle_prob: float = 0.5,
                            use_sharp: bool = True, lq_patchsize: int = 64,
                            rng: Optional[np.random.Generator] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """BSRGAN+Real-ESRGAN hybrid chain (bsrgan.py:617-714): optional USM
    sharpening, 13-slot shuffled (or locally-shuffled) double
    blur/resize/noise pass, final interpolated downsample + JPEG, aligned
    crop pair.  float [0,1] HWC in; (lq, hq) out.  The never-provided
    isp_model slots (5/12) are skipped identically; the reference's
    global-random draws become one threaded rng."""
    rng = rng or np.random.default_rng()
    h1, w1 = img.shape[:2]
    img = img.copy()[:w1 - w1 % sf, :h1 - h1 % sf, ...]   # ref's w/h swap kept
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")

    if use_sharp:
        img = add_sharpening(img)
    hq = img.copy()

    if rng.random() < shuffle_prob:
        order = list(rng.permutation(13))
    else:
        order = list(range(13))
        order[2:6] = list(rng.permutation(order[2:6]))
        order[9:13] = list(rng.permutation(order[9:13]))

    poisson_prob, speckle_prob = 0.1, 0.1
    for i in order:
        if i in (0, 7):
            img = add_blur(img, sf=sf, rng=rng, light=False)
        elif i in (1, 8):
            img = add_resize(img, sf=sf, rng=rng)
        elif i in (2, 9):
            img = add_gaussian_noise(img, rng, 2, 25)
        elif i in (3, 10):
            if rng.random() < poisson_prob:
                img = add_poisson_noise(img, rng)
        elif i in (4, 11):
            if rng.random() < speckle_prob:
                img = add_speckle_noise(img, rng)
        elif i == 6:
            img = add_jpeg_noise(img, rng, 30, 95)
        # i in (5, 12): ISP model never provided — skipped like the reference

    # bsrgan.py:692 writes int(1/sf * shape) — float-multiply THEN truncate,
    # which differs from int(shape/sf) for sf=3 (e.g. 99: 32 vs 33).
    img = _resize(img, int(1 / sf * hq.shape[1]), int(1 / sf * hq.shape[0]),
                  int(rng.choice(_CV2_INTERP)))
    img = add_jpeg_noise(img, rng, 30, 95)
    return random_crop(img, hq, sf, lq_patchsize, rng=rng)
