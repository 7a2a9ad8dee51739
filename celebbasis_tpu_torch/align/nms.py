"""Non-maximum suppression for the face detector.

Counterpart of ``celebbasis_tpu/align/nms.py`` (the reference's Cython
``cpu_nms`` / ``cpu_soft_nms`` and its CUDA bitmask kernel):

* ``greedy_nms`` / ``soft_nms`` / ``bitmask_nms`` run the package's own C++
  (``native/nms.cpp``), built with ``g++`` at first use and bound through
  ``ctypes``; a failed build raises;
* ``greedy_nms_numpy`` / ``soft_nms_numpy`` are the plain versions;
* ``nms_torch`` is a fixed-shape loop on tensors that returns a keep mask,
  for use on the device.

Boxes are ``(n, 5)`` float32 rows ``[x1, y1, x2, y2, score]``; areas count
the end pixel (``x2 - x1 + 1``), as the reference's do.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from celebbasis_tpu_torch.align import native

_fp = ctypes.POINTER(ctypes.c_float)
_ip = ctypes.POINTER(ctypes.c_int)


def _lib() -> ctypes.CDLL:
    lib = native.load("nms")
    if not getattr(lib, "_typed", False):
        lib.greedy_nms.argtypes = [_fp, ctypes.c_int, ctypes.c_float, _ip]
        lib.greedy_nms.restype = ctypes.c_int
        lib.soft_nms.argtypes = [_fp, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_int]
        lib.soft_nms.restype = ctypes.c_int
        lib.bitmask_nms.argtypes = [_fp, ctypes.c_int, ctypes.c_float, _ip]
        lib.bitmask_nms.restype = ctypes.c_int
        lib._typed = True
    return lib


def _as_dets(dets: np.ndarray) -> np.ndarray:
    dets = np.ascontiguousarray(dets, np.float32)
    if dets.ndim != 2 or dets.shape[1] != 5:
        raise ValueError(f"expected (n, 5) boxes, got {dets.shape}")
    return dets


def greedy_nms_numpy(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Plain greedy NMS (the reference's py_cpu_nms)."""
    dets = _as_dets(dets)
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr < thresh]
    return np.asarray(keep, np.int64)


def _keep_call(fn, dets: np.ndarray, thresh: float) -> np.ndarray:
    dets = _as_dets(dets)
    keep = np.empty(len(dets), np.int32)
    n = fn(dets.ctypes.data_as(_fp), len(dets), thresh,
           keep.ctypes.data_as(_ip))
    return keep[:n].astype(np.int64)


def greedy_nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Indices (into ``dets``) of the kept boxes, by descending score."""
    return _keep_call(_lib().greedy_nms, dets, thresh)


def bitmask_nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS through 64-box suppression bitmasks filled by threads."""
    return _keep_call(_lib().bitmask_nms, dets, thresh)


def soft_nms_numpy(dets: np.ndarray, sigma: float = 0.5, nt: float = 0.3,
                   threshold: float = 0.001, method: int = 1) -> np.ndarray:
    """Plain soft-NMS, step for step the C++ one: in-place score decay,
    the best remaining box swapped to the front, a discarded box swapped
    with the last active one."""
    dets = _as_dets(dets).copy()
    count = len(dets)
    i = 0
    while i < count:
        max_pos = i + int(np.argmax(dets[i:count, 4]))
        dets[[i, max_pos]] = dets[[max_pos, i]]
        bx1, by1, bx2, by2 = dets[i, :4]
        area_i = (bx2 - bx1 + 1) * (by2 - by1 + 1)
        j = i + 1
        while j < count:
            x1 = max(bx1, dets[j, 0])
            y1 = max(by1, dets[j, 1])
            x2 = min(bx2, dets[j, 2])
            y2 = min(by2, dets[j, 3])
            inter = max(0.0, x2 - x1 + 1) * max(0.0, y2 - y1 + 1)
            area_j = ((dets[j, 2] - dets[j, 0] + 1)
                      * (dets[j, 3] - dets[j, 1] + 1))
            ov = inter / (area_i + area_j - inter)
            if method == 1:
                weight = 1.0 - ov if ov > nt else 1.0
            elif method == 2:
                weight = np.exp(-(ov * ov) / sigma)
            else:
                weight = 0.0 if ov > nt else 1.0
            dets[j, 4] *= weight
            if dets[j, 4] < threshold:
                dets[[j, count - 1]] = dets[[count - 1, j]]
                count -= 1
            else:
                j += 1
        i += 1
    return dets[:count]


def soft_nms(dets: np.ndarray, sigma: float = 0.5, nt: float = 0.3,
             threshold: float = 0.001, method: int = 1) -> np.ndarray:
    """The surviving ``(n', 5)`` boxes with their decayed scores; method 0
    hard, 1 linear, 2 gaussian."""
    dets = _as_dets(dets).copy()
    n = _lib().soft_nms(dets.ctypes.data_as(_fp), len(dets), sigma, nt,
                        threshold, method)
    return dets[:n]


def nms_torch(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.3,
              score_threshold: float = -float("inf")) -> torch.Tensor:
    """Greedy NMS as a bool keep mask over ``boxes`` (N, 4) xyxy and
    ``scores`` (N,), computed where the tensors are: at most N rounds of
    argmax and suppression, each of fixed shape."""
    n = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    idx = torch.arange(n, device=boxes.device)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    active = scores > score_threshold
    neg_inf = torch.tensor(-float("inf"), dtype=scores.dtype,
                           device=scores.device)
    while bool(active.any()):
        i = int(torch.argmax(torch.where(active, scores, neg_inf)))
        keep[i] = True
        w = torch.minimum(x2[i], x2) - torch.maximum(x1[i], x1) + 1
        h = torch.minimum(y2[i], y2) - torch.maximum(y1[i], y1) + 1
        inter = w.clamp_min(0) * h.clamp_min(0)
        iou = inter / (areas[i] + areas - inter)
        active = active & ~(iou >= iou_threshold) & (idx != i)
    return keep
