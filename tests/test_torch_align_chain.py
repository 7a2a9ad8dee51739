"""PyTorch port, the W0 chain against the JAX package with one set of
random weights (FaceBoxesV2, a tiny 98-landmark PIPNet), on PNG photos made
from a seed:

* the detector's device part: every anchor's decoded box within 1e-4 of
  the largest coordinate and its face score within 1e-5, and the
  ``max_pre_nms`` best scores within 1e-5 (anchors whose scores differ by
  less than that may come in either order); its host part
  (threshold, sort, C++ NMS, integer boxes) on the JAX side's own boxes and
  scores gives the JAX detections exactly, at scale 1 and 1.3; the
  detection counts of the whole ``detect`` are equal;
* the 98 landmarks of the first detection within 1 px of the JAX ones (the
  nets agree to about 1e-6 and the landmarks are truncated to integers);
  the crop from the same five points is bit for bit, and where the
  landmarks are equal ``_align_one`` writes the same bytes as the JAX one;
* ``align_folder`` with 4 threads writes the bytes of 1 thread;
* ``cv_resample.warp_affine(version=4)`` (OpenCV 4's fixed-point warp; this
  environment's OpenCV is 5, whose float warp the JAX crops use) bit for
  bit against a plain numpy transcription of OpenCV 4's arithmetic.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from celebbasis_tpu.align import alignment as jal
from celebbasis_tpu.align import faceboxes as jfb
from celebbasis_tpu.align import pipnet as jpip
from celebbasis_tpu.cli import align as jcli
from celebbasis_tpu_torch.align import alignment as tal
from celebbasis_tpu_torch.align import cv_resample
from celebbasis_tpu_torch.align import faceboxes as tfb
from celebbasis_tpu_torch.align import pipnet as tpip
from celebbasis_tpu_torch.cli import align as tcli

from _torch_port_helpers import align_params, write_photos
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

JCFG = dataclasses.replace(jpip.PIPNetConfig.tiny(), num_lms=98)
TCFG = tpip.PIPNetConfig(**JCFG.__dict__)


def _grid_meanface(n):
    g = int(np.ceil(np.sqrt(n)))
    xs, ys = np.meshgrid(np.linspace(0.1, 0.9, g), np.linspace(0.1, 0.9, g))
    return np.stack([xs.ravel(), ys.ravel()], -1)[:n]


@pytest.fixture(scope="module")
def nets():
    pytest.importorskip("cv2")     # the JAX chain resamples through it
    p = align_params(JCFG)
    mf = _grid_meanface(98)
    return dict(
        jdet=jfb.FaceBoxesDetector(p["fb"]),
        jland=jpip.PIPNetLandmarker(p["pip"], JCFG, mf),
        tdet=tfb.FaceBoxesDetector(p["fb_state"], device="cpu"),
        tland=tpip.PIPNetLandmarker(p["pip_state"], TCFG, mf, device="cpu"))


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    return write_photos(str(tmp_path_factory.mktemp("photos")), 4, seed=3)


def _rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _tuple(d):
    return (d.score, d.xmin, d.ymin, d.width, d.height)


def test_detector_device_and_host_parts_match_jax(nets, photos):
    jdet, tdet = nets["jdet"], nets["tdet"]
    for i, path in enumerate(photos):
        rgb = _rgb(path)
        scale = 1.0 if i % 2 == 0 else 1.3
        img = rgb if scale == 1.0 else jfb._resize_scale(rgb, scale)
        sh, sw = img.shape[:2]
        priors = jfb.prior_boxes((sh, sw))
        x = img[None].astype(np.float32) - np.float32(tfb.MEANS)
        jloc, jconf = jax.jit(jdet.net.apply)(jdet.params, jnp.asarray(x))
        jboxes = np.asarray(jfb.decode_boxes(jloc[0], jnp.asarray(priors)))
        with torch.no_grad():
            tloc, tconf = tdet.net(torch.from_numpy(x))
        tboxes = tfb.decode_boxes(tloc[0], torch.from_numpy(priors))
        np.testing.assert_allclose(tboxes.numpy(), jboxes, rtol=0,
                                   atol=1e-4 * np.abs(jboxes).max())
        np.testing.assert_allclose(tconf[0, :, 1].numpy(),
                                   np.asarray(jconf[0, :, 1]), rtol=0,
                                   atol=1e-5)
        jb, js = jdet._jit_fwd(jdet.params, jnp.asarray(img[None]),
                               jnp.asarray(priors))
        jb, js = np.asarray(jb), np.asarray(js)
        _, ts = tdet.forward(torch.from_numpy(img[None].copy()),
                             torch.from_numpy(priors))
        assert 0 < int((js > jdet.thresh).sum()) < len(js)
        assert js.max() < 0.99
        np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-5)
        ref = jdet.detect(rgb, im_scale=scale)
        got = tdet.postprocess(jb, js, (sh, sw), scale)
        assert [_tuple(d) for d in got] == [_tuple(d) for d in ref]
        assert len(tdet.detect(rgb, im_scale=scale)) == len(ref) > 0


def test_landmarks_and_align_one_match_jax(nets, photos, tmp_path):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    tout.mkdir()
    equal = 0
    for path in photos:
        rgb = _rgb(path)
        jd, td = nets["jdet"].detect(rgb, 1.0), nets["tdet"].detect(rgb, 1.0)
        assert len(jd) == len(td) > 0
        jl = nets["jland"].landmarks_for_box(rgb, jd[0])
        tl = nets["tland"].landmarks_for_box(rgb, td[0])
        assert tl.dtype == np.int64 and tl.shape == (98, 2)
        assert np.abs(tl - jl).max() <= 1
        five = jal.get_5_from_98(jl)
        np.testing.assert_array_equal(tal.get_5_from_98(jl), five)
        np.testing.assert_array_equal(tal.norm_crop(rgb, five, 256),
                                      jal.norm_crop(rgb, five, 256))
        assert jcli._align_one(path, str(jout), nets["jdet"], nets["jland"],
                               128, "ffhq")
        assert tcli._align_one(path, str(tout), nets["tdet"], nets["tland"],
                               128, "ffhq")
        name = os.path.basename(path)
        if np.array_equal(tl, jl):
            equal += 1
            assert (tout / name).read_bytes() == (jout / name).read_bytes()
    assert equal >= 1


def test_align_folder_threads_write_the_serial_bytes(nets, photos, tmp_path):
    folder = os.path.dirname(photos[0])
    runs = {}
    for workers in (1, 4):
        out = tmp_path / f"w{workers}"
        n = tcli.align_folder(folder, str(out), nets["tdet"], nets["tland"],
                              crop_size=96, workers=workers)
        runs[workers] = (n, {p: (out / p).read_bytes()
                             for p in sorted(os.listdir(out))})
    assert runs[1][0] == len(photos)
    assert runs[1] == runs[4]


def _warp_opencv4(img, M, size):
    """OpenCV 4's warpAffine (INTER_LINEAR, zero border) written out: M
    inverted in double, positions in 1/32 pixel through a 1/1024 fixed
    point rounded half to even, 15-bit bilinear weights."""
    m = np.asarray(M, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    (w, h), (H, W) = size, img.shape[:2]
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    X = (np.rint((m[1] * ys + m[2]) * 1024).astype(np.int64)[:, None] + 16
         + np.rint(m[0] * xs * 1024).astype(np.int64)[None]) >> 5
    Y = (np.rint((m[4] * ys + m[5]) * 1024).astype(np.int64)[:, None] + 16
         + np.rint(m[3] * xs * 1024).astype(np.int64)[None]) >> 5
    sx, sy, fx, fy = X >> 5, Y >> 5, (X & 31)[..., None], (Y & 31)[..., None]
    src = img.astype(np.int64)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = src[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return v * inside[..., None]

    total = (tap(sy, sx) * (32 - fy) * (32 - fx)
             + tap(sy, sx + 1) * (32 - fy) * fx
             + tap(sy + 1, sx) * fy * (32 - fx)
             + tap(sy + 1, sx + 1) * fy * fx) * 32
    return np.clip((total + (1 << 14)) >> 15, 0, 255).astype(np.uint8)


def test_opencv4_warp_equals_its_transcription():
    r = np.random.default_rng(12)
    for _ in range(30):
        h, w = (int(v) for v in r.integers(5, 300, 2))
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ang, s = r.uniform(-0.7, 0.7), r.uniform(0.2, 4)
        tx, ty = r.uniform(-200, 200, 2)
        M = np.array([[s * np.cos(ang), -s * np.sin(ang), tx],
                      [s * np.sin(ang), s * np.cos(ang), ty]])
        size = (int(r.integers(1, 260)), int(r.integers(1, 260)))
        np.testing.assert_array_equal(
            cv_resample.warp_affine(img, M, size, version=4),
            _warp_opencv4(img, M, size))
