"""PyTorch port, W0 host and device pieces against the JAX package, on the
same inputs from a seed:

* the OpenCV resampler (``align/cv_resample``) against the JAX package's
  ``pipnet._resize_linear``, ``faceboxes._resize_scale`` and
  ``alignment.norm_crop`` (which call OpenCV): bit for bit, at odd sizes,
  upscales, downscales, exact halvings and transforms that leave the image
  (the warp of the installed OpenCV's generation);
  ``warp_affine_pixels`` (the device warp) within one level of the JAX one;
* NMS: the C++ greedy, bitmask and soft variants and their numpy versions
  against the JAX ones, exactly; ``nms_torch``'s keep mask against
  ``nms_jax``'s;
* ``prior_boxes`` and ``meanface_indices`` (a masked row included) exactly;
  ``decode_boxes`` and ``decode_landmarks`` on the same head maps within
  1e-6;
* ``get_5_from_98``, ``estimate_norm`` and ``umeyama_similarity`` in
  float64 within 1e-9; the landmark and verification metrics exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.align import alignment as jal
from celebbasis_tpu.align import faceboxes as jfb
from celebbasis_tpu.align import metrics as jmet
from celebbasis_tpu.align import nms as jnms
from celebbasis_tpu.align import pipnet as jpip
from celebbasis_tpu_torch.align import alignment as tal
from celebbasis_tpu_torch.align import cv_resample
from celebbasis_tpu_torch.align import faceboxes as tfb
from celebbasis_tpu_torch.align import metrics as tmet
from celebbasis_tpu_torch.align import nms as tnms
from celebbasis_tpu_torch.align import pipnet as tpip

from _torch_port_helpers import t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


def _image(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


def test_resize_equals_the_jax_resamplers_bit_for_bit():
    pytest.importorskip("cv2")   # the JAX package resamples through it
    rng = np.random.default_rng(0)
    # (h, w) -> square size: odd sizes, up and down, an exact halving
    for (h, w), size in (((301, 257), 256), ((97, 131), 256),
                         ((512, 512), 256), ((33, 17), 64), ((255, 300), 97),
                         ((7, 9), 256), ((600, 601), 512)):
        img = _image(rng, h, w)
        np.testing.assert_array_equal(cv_resample.resize_linear(
            img, (size, size)), jpip._resize_linear(img, size))
    for (h, w), scale in (((700, 900), 600 / 700), ((601, 800), 600 / 601),
                          ((303, 305), 0.5), ((120, 90), 1.7),
                          ((1000, 640), 600 / 640), ((51, 77), 0.37)):
        img = _image(rng, h, w)
        got = cv_resample.resize_scale(img, scale)
        np.testing.assert_array_equal(got, jfb._resize_scale(img, scale))
    for _ in range(40):                          # random sizes, 1 to 4 ch
        h, w, size = (int(v) for v in rng.integers(2, 200, 3))
        img = _image(rng, h, w, int(rng.choice([1, 3, 4])))
        np.testing.assert_array_equal(cv_resample.resize_linear(
            img, (size, size)), jpip._resize_linear(img, size))


@pytest.mark.parametrize("mode,size", [("ffhq", 256), ("arcface", 112)])
def test_norm_crop_equals_jax_and_device_warp_within_a_level(mode, size):
    cv2 = pytest.importorskip("cv2")
    # the warp reproduces the installed OpenCV's generation, as the JAX
    # package calls it
    major = int(cv2.__version__.split(".")[0])
    assert cv_resample.default_warp_version() == (5 if major >= 5 else 4)
    rng = np.random.default_rng(size)
    for trial in range(12):
        h, w = (int(v) for v in rng.integers(90, 400, 2))
        img = _image(rng, h, w)
        # five points near a face's layout, some of them off the image so
        # that the crop leaves it
        base = np.array([[0.35, 0.4], [0.65, 0.4], [0.5, 0.55],
                         [0.38, 0.72], [0.62, 0.72]])
        shift = rng.uniform(-0.3, 0.3, 2) if trial % 3 else 0.0
        pts = (base + shift) * rng.uniform(0.5, 1.4) * [w, h] \
            + rng.normal(0, 3, (5, 2))
        lmk5 = np.round(pts * 3) / 3              # thirds, as from 98 points
        got = tal.norm_crop(img, lmk5, size, mode)
        ref = jal.norm_crop(img, lmk5, size, mode)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        got_m = tal.norm_crop_with_M(img, lmk5, size, mode)
        np.testing.assert_array_equal(got_m[0], ref)
        np.testing.assert_allclose(got_m[1], jal.estimate_norm(
            lmk5, size, mode), rtol=0, atol=1e-9)
        if trial < 3:
            M = tal.estimate_norm(lmk5, size, mode)
            dev = tal.warp_affine_pixels(torch.from_numpy(img), M,
                                         (size, size)).numpy()
            jdev = jal.warp_affine_pixels(img, M, (size, size))
            assert dev.dtype == np.uint8
            assert np.abs(dev.astype(int) - jdev.astype(int)).max() <= 1


def _rand_dets(n, seed):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 200, (n, 2))
    wh = r.uniform(10, 80, (n, 2))
    return np.hstack([xy, xy + wh, r.uniform(0, 1, (n, 1))]).astype(
        np.float32)


def test_nms_variants_equal_the_jax_ones():
    for n, seed in ((1, 0), (37, 1), (300, 2), (1500, 3)):
        dets = _rand_dets(n, seed)
        for thresh in (0.3, 0.5):
            ref = jnms.greedy_nms(dets, thresh)
            np.testing.assert_array_equal(tnms.greedy_nms(dets, thresh), ref)
            np.testing.assert_array_equal(
                tnms.greedy_nms_numpy(dets, thresh),
                jnms.greedy_nms_numpy(dets, thresh))
            np.testing.assert_array_equal(
                tnms.bitmask_nms(dets, thresh), jnms.bitmask_nms(dets, thresh))
            np.testing.assert_array_equal(tnms.greedy_nms_numpy(dets, thresh),
                                          ref)
        if n <= 300:
            for method in (0, 1, 2):
                got = tnms.soft_nms(dets, method=method)
                np.testing.assert_array_equal(
                    got, jnms.soft_nms(dets, method=method))
                np.testing.assert_array_equal(
                    tnms.soft_nms_numpy(dets, method=method),
                    jnms.soft_nms_numpy(dets, method=method))
                np.testing.assert_allclose(
                    tnms.soft_nms_numpy(dets, method=method), got, atol=1e-6)


def test_nms_torch_mask_equals_nms_jax():
    for n, seed, st in ((64, 4, -np.inf), (200, 5, 0.3), (1, 6, -np.inf)):
        dets = _rand_dets(n, seed)
        for thresh in (0.3, 0.6):
            ref = np.asarray(jnms.nms_jax(jnp.asarray(dets[:, :4]),
                                          jnp.asarray(dets[:, 4]), thresh, st))
            got = tnms.nms_torch(t(dets[:, :4]), t(dets[:, 4]), thresh, st)
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), ref)


def test_priors_meanface_and_decodes():
    for size in ((96, 128), (600, 450), (33, 65)):
        np.testing.assert_array_equal(tfb.prior_boxes(size),
                                      jfb.prior_boxes(size))
    r = np.random.default_rng(7)
    priors = jfb.prior_boxes((96, 128))
    loc = r.standard_normal((len(priors), 4)).astype(np.float32)
    np.testing.assert_allclose(
        tfb.decode_boxes(t(loc), t(priors)).numpy(),
        np.asarray(jfb.decode_boxes(jnp.asarray(loc), jnp.asarray(priors))),
        rtol=0, atol=1e-6)

    meanface = r.uniform(0, 1, (12, 2))
    # a thirteenth landmark far from all others: no one predicts it
    masked = np.vstack([meanface, [[9.0, 9.0]]])
    for mf, nb in ((meanface, 3), (masked, 2)):
        got, ref = tpip.meanface_indices(mf, nb), jpip.meanface_indices(mf, nb)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert (tpip.meanface_indices(masked, 2)[0][-1] == -1).all()

    for mf, nb, net_stride, S in ((meanface, 3, 32, 64), (masked, 2, 16, 64)):
        L, g = len(mf), S // net_stride
        cfg = dict(num_lms=L, num_nb=nb, input_size=S, net_stride=net_stride)
        maps = [r.standard_normal((2, g, g, c)).astype(np.float32)
                for c in (L, L, L, L * nb, L * nb)]
        ri1, ri2, _ = jpip.meanface_indices(mf, nb)
        ref = np.asarray(jpip.decode_landmarks(
            [jnp.asarray(m) for m in maps], jpip.PIPNetConfig(**cfg),
            jnp.asarray(ri1), jnp.asarray(ri2)))
        got = tpip.decode_landmarks([t(m) for m in maps],
                                    tpip.PIPNetConfig(**cfg), t(ri1), t(ri2))
        assert got.shape == (2, L, 2)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_alignment_math_in_float64():
    r = np.random.default_rng(8)
    lmk98 = r.integers(0, 512, (98, 2)).astype(np.int64)
    five = tal.get_5_from_98(lmk98)
    assert five.dtype == np.float64
    np.testing.assert_array_equal(five, jal.get_5_from_98(lmk98))
    lmk68 = r.uniform(0, 300, (68, 3))
    np.testing.assert_array_equal(tal.extract_five_from_68(lmk68),
                                  jal.extract_five_from_68(lmk68))
    for mode in ("ffhq", "arcface", "set1", "mtcnn"):
        for size in (112, 256, 512):
            np.testing.assert_allclose(
                tal.estimate_norm(five, size, mode),
                jal.estimate_norm(five, size, mode), rtol=0, atol=1e-9)
    src = r.uniform(0, 100, (5, 2))
    dst = src[:, ::-1] * 1.3 + 7          # a reflection: det(cov) < 0
    for d in (dst, src * 0.7 + [3, -2]):
        np.testing.assert_allclose(tal.umeyama_similarity(src, d),
                                   jal.umeyama_similarity(src, d), rtol=0,
                                   atol=1e-9)


def test_metrics_equal_the_jax_ones():
    r = np.random.default_rng(9)
    pred, gt = r.uniform(0, 1, (98, 2)), r.uniform(0, 1, (98, 2))
    assert tmet.compute_nme(pred, gt, 0.3) == jmet.compute_nme(pred, gt, 0.3)
    nmes = r.uniform(0, 0.2, 500)
    assert tmet.compute_fr_and_auc(nmes) == jmet.compute_fr_and_auc(nmes)
    scores, labels = r.uniform(-1, 1, 200), r.integers(0, 2, 200)
    assert tmet.verification_accuracy(scores, labels) == \
        jmet.verification_accuracy(scores, labels)
    a, b = r.standard_normal((40, 8)), r.standard_normal((40, 8))
    lab = r.integers(0, 2, 40)
    embed = lambda x: x @ np.arange(64.0).reshape(8, 8)
    assert tmet.pairs_verification(embed, a, b, lab, 4) == \
        jmet.pairs_verification(embed, a, b, lab, 4)
