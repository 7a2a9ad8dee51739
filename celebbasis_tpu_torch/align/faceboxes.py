"""FaceBoxes face detector: the nets, the anchors, the decode, the detector.

Counterpart of ``celebbasis_tpu/align/faceboxes.py`` (the reference's
FaceBoxesV2 ``utils/faceboxes.py``, ``prior_box.py``, ``box_utils.py`` and
``faceboxes_detector.py``).  V2: a five-conv stride-2 stem, three Inception
blocks and two stride-2 stages; multibox heads of 21 anchors at stride 32
and one anchor at strides 64 and 128; SSD decode with variances (0.1, 0.2).
V1 (CRelu stem and max pools) reads the original FaceBoxes weights.

The nets take channels-last ``(B, H, W, 3)`` float images and compute on the
``(B, C, H, W)`` view; the heads flatten in (row, column, anchor) order, as
the flax modules' channels-last maps do.  Attribute names follow the flax
tree, so ``utils.bridge.from_jax_params`` carries weights across.

``FaceBoxesDetector`` keeps the net on ``device``: the uint8 image goes
there, is converted and mean-subtracted there (BGR-style means 104, 117,
123, subtracted from whatever channel order the caller holds), and the
``max_pre_nms`` best anchors come back.  Thresholding, the score sort, NMS
(``align.nms``, C++) and the integer boxes are host work.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.align import cv_resample
from celebbasis_tpu_torch.align import nms as nms_mod
from celebbasis_tpu_torch.loader import resolve_device
from celebbasis_tpu_torch.models.iresnet import FrozenBN
from celebbasis_tpu_torch.ops.basic import Conv, to_nchw, to_nhwc
from celebbasis_tpu_torch.utils.precision import no_tf32

CFG = {
    "min_sizes": [[32, 64, 128], [256], [512]],
    "steps": [32, 64, 128],
    "variance": (0.1, 0.2),
    "clip": False,
}
MEANS = (104.0, 117.0, 123.0)


class BasicConv(nn.Module):
    """conv (no bias) + BN (eps 1e-5) + relu."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride=stride, bias=False)
        self.bn = FrozenBN(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CRelu(nn.Module):
    """conv + BN + concat(x, -x) + relu (the V1 stem)."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride=stride, bias=False)
        self.bn = FrozenBN(features)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(torch.cat([x, -x], dim=1))


class Inception(nn.Module):
    """Four branches, one of them an average pool that counts the padded
    zeros (torch's ``count_include_pad=True``)."""

    def __init__(self, in_ch: int = 128):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 32, 1)
        self.branch1x1_2 = BasicConv(in_ch, 32, 1)
        self.branch3x3_reduce = BasicConv(in_ch, 24, 1)
        self.branch3x3 = BasicConv(24, 32, 3)
        self.branch3x3_reduce_2 = BasicConv(in_ch, 24, 1)
        self.branch3x3_2 = BasicConv(24, 32, 3)
        self.branch3x3_3 = BasicConv(32, 32, 3)

    def forward(self, x):
        b1 = self.branch1x1(x)
        pooled = F.avg_pool2d(x, 3, stride=1, padding=1,
                              count_include_pad=True)
        b2 = self.branch1x1_2(pooled)
        b3 = self.branch3x3(self.branch3x3_reduce(x))
        b4 = self.branch3x3_3(self.branch3x3_2(self.branch3x3_reduce_2(x)))
        return torch.cat([b1, b2, b3, b4], dim=1)


class _MultiboxHead(nn.Module):
    def __init__(self, in_ch: int, n_anchors: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.loc = Conv(in_ch, n_anchors * 4, 3)
        self.conf = Conv(in_ch, n_anchors * num_classes, 3)

    def forward(self, x):
        B = x.shape[0]
        # (row, column, anchor) order: the channels-last map, flattened
        return (to_nhwc(self.loc(x)).reshape(B, -1, 4),
                to_nhwc(self.conf(x)).reshape(B, -1, self.num_classes))


class _FaceBoxes(nn.Module):
    """The three sources, the heads and the softmax shared by V1 and V2."""

    def _heads(self, num_classes: int):
        for i, (ch, na) in enumerate(zip((128, 256, 256), (21, 1, 1))):
            setattr(self, f"head{i}", _MultiboxHead(ch, na, num_classes))

    def _out(self, sources):
        locs, confs = zip(*(getattr(self, f"head{i}")(s)
                            for i, s in enumerate(sources)))
        conf = torch.softmax(torch.cat(confs, dim=1).float(), dim=-1)
        return torch.cat(locs, dim=1).float(), conf


class FaceBoxesV2(_FaceBoxes):
    def __init__(self, num_classes: int = 2):
        super().__init__()
        cur = 3
        for i, ch in enumerate((8, 16, 32, 64, 128), start=1):
            setattr(self, f"conv{i}", BasicConv(cur, ch, 3, stride=2))
            cur = ch
        for i in (1, 2, 3):
            setattr(self, f"inception{i}", Inception())
        self.conv6_1 = BasicConv(128, 128, 1)
        self.conv6_2 = BasicConv(128, 256, 3, stride=2)
        self.conv7_1 = BasicConv(256, 128, 1)
        self.conv7_2 = BasicConv(128, 256, 3, stride=2)
        self._heads(num_classes)

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3) float -> loc (B, A, 4), conf (B, A, 2)."""
        x = to_nchw(x.float())
        for i in range(1, 6):
            x = getattr(self, f"conv{i}")(x)
        for i in (1, 2, 3):
            x = getattr(self, f"inception{i}")(x)
        src1 = x
        src2 = self.conv6_2(self.conv6_1(src1))
        src3 = self.conv7_2(self.conv7_1(src2))
        return self._out((src1, src2, src3))


class FaceBoxesV1(_FaceBoxes):
    """The original FaceBoxes (CRelu stem and max pools)."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.conv1 = CRelu(3, 24, 7, 4)
        self.conv2 = CRelu(48, 64, 5, 2)
        for i in (1, 2, 3):
            setattr(self, f"inception{i}", Inception())
        self.conv3_1 = BasicConv(128, 128, 1)
        self.conv3_2 = BasicConv(128, 256, 3, stride=2)
        self.conv4_1 = BasicConv(256, 128, 1)
        self.conv4_2 = BasicConv(128, 256, 3, stride=2)
        self._heads(num_classes)

    def forward(self, x: torch.Tensor):
        x = to_nchw(x.float())
        x = F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)
        x = F.max_pool2d(self.conv2(x), 3, stride=2, padding=1)
        for i in (1, 2, 3):
            x = getattr(self, f"inception{i}")(x)
        src1 = x
        src2 = self.conv3_2(self.conv3_1(src1))
        src3 = self.conv4_2(self.conv4_1(src2))
        return self._out((src1, src2, src3))


def prior_boxes(image_size: Tuple[int, int], cfg: dict = CFG) -> np.ndarray:
    """SSD anchor grid in normalized cxcywh."""
    anchors: List[float] = []
    h, w = image_size
    feature_maps = [(math.ceil(h / s), math.ceil(w / s)) for s in cfg["steps"]]
    for k, (fh, fw) in enumerate(feature_maps):
        step = cfg["steps"][k]
        for i, j in itertools.product(range(fh), range(fw)):
            for min_size in cfg["min_sizes"][k]:
                s_kx = min_size / w
                s_ky = min_size / h
                if min_size == 32:
                    offs = (0, 0.25, 0.5, 0.75)
                elif min_size == 64:
                    offs = (0, 0.5)
                else:
                    offs = (0.5,)
                for oy, ox in itertools.product(offs, offs):
                    anchors += [(j + ox) * step / w, (i + oy) * step / h,
                                s_kx, s_ky]
    out = np.asarray(anchors, np.float32).reshape(-1, 4)
    if cfg["clip"]:
        out = np.clip(out, 0, 1)
    return out


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=(0.1, 0.2)) -> torch.Tensor:
    """SSD offsets (A, 4) against cxcywh priors -> xyxy boxes."""
    cxcy = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    wh = priors[:, 2:] * torch.exp(loc[:, 2:] * variances[1])
    tl = cxcy - wh / 2
    br = tl + wh
    return torch.cat([tl, br], dim=1)


@dataclass
class Detection:
    score: float
    xmin: int
    ymin: int
    width: int
    height: int


class FaceBoxesDetector:
    """``detect(image)`` -> a list of ``Detection`` (the reference
    detector's semantics: score threshold, NMS, at most
    ``max_post_nms``).  ``params`` is the net's state dict in the port's
    names."""

    def __init__(self, params, version: int = 2, thresh: float = 0.6,
                 nms_thresh: float = 0.3, max_pre_nms: int = 5000,
                 max_post_nms: int = 750, device=None):
        self.device = resolve_device(device)
        net = FaceBoxesV2() if version == 2 else FaceBoxesV1()
        net.load_state_dict(params, strict=True)
        self.net = net.to(self.device).requires_grad_(False).eval()
        self.thresh = thresh
        self.nms_thresh = nms_thresh
        self.max_pre = max_pre_nms
        self.max_post = max_post_nms
        self._priors: dict = {}
        self._means = torch.tensor(MEANS, device=self.device)

    def priors(self, size: Tuple[int, int]) -> torch.Tensor:
        """The anchors of an (h, w) input on the device, made once per
        size."""
        priors = self._priors.get(size)
        if priors is None:
            priors = torch.from_numpy(prior_boxes(size)).to(self.device)
            self._priors[size] = priors
        return priors

    def forward(self, image_u8: torch.Tensor, priors: torch.Tensor):
        """(1, H, W, 3) uint8 on the device -> the ``max_pre_nms`` best
        anchors' boxes (k, 4) and face scores (k,), by descending score."""
        with torch.inference_mode(), no_tf32():
            loc, conf = self.net(image_u8.float() - self._means)
            boxes = decode_boxes(loc[0], priors, CFG["variance"])
            scores = conf[0, :, 1]
            k = min(self.max_pre, scores.shape[0])
            top_scores, top_idx = torch.topk(scores, k)
            return boxes[top_idx], top_scores

    def postprocess(self, boxes: np.ndarray, scores: np.ndarray,
                    size: Tuple[int, int], im_scale: float
                    ) -> List[Detection]:
        """Host side of ``detect``: the best anchors' normalized boxes and
        scores, the (h, w) the net saw and its scale -> detections."""
        sh, sw = size
        boxes = boxes * np.asarray([sw, sh, sw, sh], np.float32)
        inds = scores > self.thresh
        boxes, scores = boxes[inds], scores[inds]
        order = scores.argsort()[::-1]
        dets = np.hstack([boxes[order], scores[order, None]]).astype(
            np.float32)
        keep = nms_mod.greedy_nms(dets, self.nms_thresh)
        dets = dets[keep][: self.max_post]
        out = []
        for x1, y1, x2, y2, s in dets:
            xmin = int(x1 / im_scale)
            ymin = int(y1 / im_scale)
            out.append(Detection(float(s), xmin, ymin,
                                 int(x2 / im_scale) - xmin,
                                 int(y2 / im_scale) - ymin))
        return out

    def detect(self, image: np.ndarray, im_scale: float | None = None
               ) -> List[Detection]:
        """``image``: (H, W, 3) uint8 in the channel order the caller holds
        (the reference feeds BGR in its demos and RGB on the alignment
        path, both unchanged).  ``im_scale=None`` shrinks images whose short
        side exceeds 600 px to 600 first (OpenCV's resize, exactly)."""
        h, w = image.shape[:2]
        if im_scale is None:
            im_scale = 600.0 / min(h, w) if min(h, w) > 600 else 1.0
        img = image.astype(np.uint8)
        if im_scale != 1.0:
            img = cv_resample.resize_scale(img, im_scale)
        sh, sw = img.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(img)[None]).to(self.device)
        boxes, scores = self.forward(x, self.priors((sh, sw)))
        return self.postprocess(boxes.cpu().numpy(), scores.cpu().numpy(),
                                (sh, sw), im_scale)
