"""FID computation: activation statistics + Fréchet distance (+ folder prep).

The port's own copy of ``celebbasis_tpu/eval/fid.py`` (numpy only).  The
reference shells out to ``torch-fidelity`` after flattening generated images
into one folder (its ``evaluation/fid/copy_together.py``).  Here the metric
is computed natively:

* ``frechet_distance`` — the closed-form FID between two Gaussians fitted to
  feature activations (matrix sqrt via eigendecomposition of the symmetrized
  product — no scipy needed);
* ``FIDScorer`` — streams image folders through a feature extractor. The
  canonical extractor is InceptionV3-pool3 (``eval.inception``); without
  Inception weights the CLIP ViT image tower is used, giving the
  widely-used "CLIP-FID" variant. Any callable (uint8 RGB batch) -> (B, D) works.
* ``copy_together`` — the flatten-into-one-folder prep step.
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, Tuple

import numpy as np


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh.

    Negative eigenvalues (fp noise on rank-deficient covariances) clip to
    zero — where scipy.linalg.sqrtm's Schur route emits complex entries
    that pytorch-fid then drops via ``covmean.real``, this stays real by
    construction; the traces agree (held to scipy in
    tests/test_inception_fid.py)."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||² + Tr(C1 + C2 - 2 (C1^{1/2} C2 C1^{1/2})^{1/2}).

    Tr((C1^{1/2} C2 C1^{1/2})^{1/2}) == Tr((C1 C2)^{1/2}) for PSD inputs
    (similar matrices), so this matches pytorch-fid's
    ``calculate_frechet_distance`` while staying in symmetric-eigh land.
    The ``eps`` fallback replicates pytorch-fid's exactly: when the sqrt
    comes back non-finite, redo it with eps on BOTH diagonals, keeping the
    original Tr(C1)+Tr(C2) (pytorch_fid/fid_score.py:66-75 semantics)."""
    diff = mu1 - mu2
    c1_half = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(c1_half @ cov2 @ c1_half)
    if not np.isfinite(inner).all():  # pragma: no cover - fp pathologies
        off = np.eye(np.atleast_2d(cov1).shape[0]) * eps
        c1_half = _sqrtm_psd(cov1 + off)
        inner = _sqrtm_psd(c1_half @ (cov2 + off) @ c1_half)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(inner))


def _iter_images(folder: str, exts=(".jpg", ".jpeg", ".png")):
    for name in sorted(os.listdir(folder)):
        if name.lower().endswith(exts):
            yield os.path.join(folder, name)


class FIDScorer:
    def __init__(self, feature_fn: Callable[[np.ndarray], np.ndarray],
                 batch_size: int = 32):
        self.feature_fn = feature_fn
        self.bs = batch_size

    def folder_features(self, folder: str) -> np.ndarray:
        from PIL import Image
        feats, batch = [], []
        for path in _iter_images(folder):
            batch.append(np.asarray(Image.open(path).convert("RGB")))
            if len(batch) == self.bs:
                feats.append(self.feature_fn(np.stack(batch)))
                batch = []
        if batch:
            feats.append(self.feature_fn(np.stack(batch)))
        if not feats:
            raise ValueError(f"no images found in {folder}")
        return np.concatenate(feats)

    def fid(self, folder_a: str, folder_b: str) -> float:
        sa = activation_statistics(self.folder_features(folder_a))
        sb = activation_statistics(self.folder_features(folder_b))
        return frechet_distance(*sa, *sb)


def clip_feature_fn(clip_evaluator) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 RGB batch -> CLIP image features (the CLIP-FID extractor)."""
    def fn(batch_uint8: np.ndarray) -> np.ndarray:
        imgs = batch_uint8.astype(np.float32) / 127.5 - 1.0
        return clip_evaluator.image_features(imgs)
    return fn


def copy_together(src_root: str, dst_folder: str,
                  exts=(".jpg", ".jpeg", ".png")) -> int:
    """Flatten nested generated-image folders into one (copy_together.py)."""
    os.makedirs(dst_folder, exist_ok=True)
    n = 0
    for dirpath, _dirs, files in os.walk(src_root):
        for f in sorted(files):
            if f.lower().endswith(exts):
                flat = os.path.relpath(os.path.join(dirpath, f), src_root)
                flat = flat.replace(os.sep, "__")
                shutil.copy(os.path.join(dirpath, f),
                            os.path.join(dst_folder, flat))
                n += 1
    return n
