"""PIPNet landmark detector: the backbones, the PIP heads, the decode, the
landmarker.

Counterpart of ``celebbasis_tpu/align/pipnet.py`` (the reference's
``lib/networks.py`` Pip_* nets, ``lib/functions.py`` forward_pip and
get_meanface, ``lib/tools.py`` demo_image):

* ``PIPNetConfig`` and its named constructors (resnet101 / 50 / 18,
  mbnetv2, mbnetv3; ``tiny()`` for tests);
* the ResNet backbone (bottleneck or basic blocks), MobileNetV2 and the
  reference's MobileNetV3 (with ``SELayer``), and the ``net_stride``
  extras of the ResNet wrappers (stride 64 and 128: stride-2 convs; 16: a
  ``ConvTranspose2d(4, 2, 1)`` upsample); BatchNorm is frozen
  (``models.iresnet.FrozenBN``);
* ``meanface_indices``: the reverse-neighbour index the reference ships as
  a table, derived from the mean face (a landmark no neighbour predicts is
  masked out of the merge);
* ``decode_landmarks``: argmax cell + offsets + the neighbour merge;
* ``PIPNetLandmarker``: detector box -> landmarks in pixels.

The nets take channels-last ``(B, H, W, 3)`` floats, compute on the
``(B, C, H, W)`` view and return the five head maps channels-last
``(B, g, g, C)`` like the flax module; attribute names follow the flax tree
(``utils.bridge.from_jax_params`` carries weights across).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.align import cv_resample
from celebbasis_tpu_torch.loader import resolve_device
from celebbasis_tpu_torch.models.iresnet import FrozenBN
from celebbasis_tpu_torch.ops.basic import Conv, Dense, to_nchw, to_nhwc
from celebbasis_tpu_torch.utils.precision import no_tf32

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class PIPNetConfig:
    num_lms: int = 98
    num_nb: int = 10
    input_size: int = 256
    net_stride: int = 32
    arch: str = "resnet"                        # resnet | mbnetv2 | mbnetv3
    block: str = "bottleneck"                   # bottleneck | basic (resnet)
    layers: Tuple[int, ...] = (3, 4, 23, 3)     # resnet101
    width: int = 64

    @staticmethod
    def tiny() -> "PIPNetConfig":
        return PIPNetConfig(num_lms=12, num_nb=3, input_size=64,
                            layers=(1, 1, 1, 1), width=8)

    @staticmethod
    def resnet101(**kw) -> "PIPNetConfig":
        return PIPNetConfig(layers=(3, 4, 23, 3), **kw)

    @staticmethod
    def resnet50(**kw) -> "PIPNetConfig":
        return PIPNetConfig(layers=(3, 4, 6, 3), **kw)

    @staticmethod
    def resnet18(**kw) -> "PIPNetConfig":
        return PIPNetConfig(block="basic", layers=(2, 2, 2, 2), **kw)

    @staticmethod
    def mbnetv2(**kw) -> "PIPNetConfig":
        return PIPNetConfig(arch="mbnetv2", **kw)

    @staticmethod
    def mbnetv3(**kw) -> "PIPNetConfig":
        return PIPNetConfig(arch="mbnetv3", **kw)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = Conv(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBN(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.down_conv = Conv(in_ch, out_ch, 1, stride=stride, bias=False)
            self.down_bn = FrozenBN(out_ch)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        sc = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") \
            else x
        return F.relu(h + sc)


class BasicBlock(nn.Module):
    """torchvision BasicBlock (resnet18/34): stride on conv1, expansion 1."""
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = Conv(in_ch, planes, 3, stride=stride, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv(planes, planes, 3, bias=False)
        self.bn2 = FrozenBN(planes)
        if stride != 1 or in_ch != planes:
            self.down_conv = Conv(in_ch, planes, 1, stride=stride, bias=False)
            self.down_bn = FrozenBN(planes)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        sc = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") \
            else x
        return F.relu(h + sc)


class ResNetBackbone(nn.Module):
    def __init__(self, cfg: PIPNetConfig):
        super().__init__()
        self.conv1 = Conv(3, cfg.width, 7, stride=2, bias=False)
        self.bn1 = FrozenBN(cfg.width)
        block = Bottleneck if cfg.block == "bottleneck" else BasicBlock
        names, cur = [], cfg.width
        for li, n_blocks in enumerate(cfg.layers):
            planes = cfg.width * (2 ** li)
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                name = f"layer{li + 1}_block{bi}"
                setattr(self, name, block(cur, planes, stride))
                names.append(name)
                cur = planes * block.expansion
        self._blocks = tuple(names)
        self.out_channels = cur

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for name in self._blocks:
            h = getattr(self, name)(h)
        return h


def _hsigmoid(x):
    # the reference's mobilenetv3 h_sigmoid: relu6(x + 3) / 6
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBN(nn.Module):
    """conv + frozen BN + activation ('relu6' | 'hswish' | 'relu' | None)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1,
                 act: str | None = "relu6"):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias=False)
        self.bn = FrozenBN(features)

    def forward(self, x):
        h = self.bn(self.conv(x))
        if self.act == "relu6":
            h = torch.clamp(h, 0.0, 6.0)
        elif self.act == "relu":
            h = F.relu(h)
        elif self.act == "hswish":
            h = h * _hsigmoid(h)
        return h


class SELayer(nn.Module):
    """pool -> fc -> relu -> fc -> hsigmoid, a scale per channel."""

    def __init__(self, channel: int):
        super().__init__()
        self.fc1 = Dense(channel, _make_divisible(channel // 4))
        self.fc2 = Dense(_make_divisible(channel // 4), channel)

    def forward(self, x):
        y = x.float().mean(dim=(2, 3))
        y = _hsigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y[:, :, None, None]


# torchvision MobileNetV2 inverted-residual settings (t, c, n, s)
MBV2_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

# the reference's mobilenetv3_large cfgs (k, t, c, SE, HS, s)
MBV3_LARGE_CFGS = (
    (3, 1, 16, 0, 0, 1), (3, 4, 24, 0, 0, 2), (3, 3, 24, 0, 0, 1),
    (5, 3, 40, 1, 0, 2), (5, 3, 40, 1, 0, 1), (5, 3, 40, 1, 0, 1),
    (3, 6, 80, 0, 1, 2), (3, 2.5, 80, 0, 1, 1), (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1), (3, 6, 112, 1, 1, 1), (3, 6, 112, 1, 1, 1),
    (5, 6, 160, 1, 1, 2), (5, 6, 160, 1, 1, 1), (5, 6, 160, 1, 1, 1))


class MobileNetV2Backbone(nn.Module):
    """torchvision mobilenet_v2 ``features``: stem conv32/s2, 17 inverted
    residuals, 1x1 to 1280, ReLU6 throughout, a residual add where the
    stride is 1 and the width is kept."""

    def __init__(self):
        super().__init__()
        self.stem = _ConvBN(3, 32, 3, 2)
        plan, c_in, bi = [], 32, 1
        for t, c, n, s in MBV2_SETTINGS:
            for i in range(n):
                stride = s if i == 0 else 1
                hidden = c_in * t
                name = f"block{bi}"
                if t != 1:
                    setattr(self, f"{name}_expand",
                            _ConvBN(c_in, hidden, 1, 1))
                setattr(self, f"{name}_dw",
                        _ConvBN(hidden, hidden, 3, stride, groups=hidden))
                setattr(self, f"{name}_pw", _ConvBN(hidden, c, 1, 1, act=None))
                plan.append((name, t != 1, stride == 1 and c_in == c))
                c_in, bi = c, bi + 1
        self._plan = tuple(plan)
        self.last = _ConvBN(c_in, 1280, 1, 1)
        self.out_channels = 1280

    def forward(self, x):
        h = self.stem(x)
        for name, expand, residual in self._plan:
            r = h
            if expand:
                h = getattr(self, f"{name}_expand")(h)
            h = getattr(self, f"{name}_pw")(getattr(self, f"{name}_dw")(h))
            if residual:
                h = h + r
        return self.last(h)


class MobileNetV3Backbone(nn.Module):
    """The reference's own mobilenetv3_large ``features`` and its final
    1x1 ``conv``."""

    def __init__(self):
        super().__init__()
        self.stem = _ConvBN(3, 16, 3, 2, act="hswish")
        plan, c_in = [], 16
        for bi, (k, t, c, use_se, use_hs, s) in enumerate(MBV3_LARGE_CFGS,
                                                          start=1):
            c_out = _make_divisible(c)
            hidden = _make_divisible(c_in * t)
            act = "hswish" if use_hs else "relu"
            name, expand = f"block{bi}", c_in != hidden
            if expand:
                # pw -> dw -> SE -> act -> pw-linear: the activation comes
                # after the SE block on the expanded path
                setattr(self, f"{name}_expand",
                        _ConvBN(c_in, hidden, 1, 1, act=act))
                setattr(self, f"{name}_dw", _ConvBN(
                    hidden, hidden, k, s, groups=hidden, act=None))
            else:
                # dw -> act -> SE -> pw-linear
                setattr(self, f"{name}_dw", _ConvBN(
                    hidden, hidden, k, s, groups=hidden, act=act))
            if use_se:
                setattr(self, f"{name}_se", SELayer(hidden))
            setattr(self, f"{name}_pw", _ConvBN(hidden, c_out, 1, 1, act=None))
            plan.append((name, expand, bool(use_se), bool(use_hs),
                         s == 1 and c_in == c_out))
            c_in = c_out
        self._plan = tuple(plan)
        self.last = _ConvBN(c_in, _make_divisible(c_in * 6), 1, 1,
                            act="hswish")
        self.out_channels = _make_divisible(c_in * 6)

    def forward(self, x):
        h = self.stem(x)
        for name, expand, use_se, use_hs, residual in self._plan:
            r = h
            if expand:
                h = getattr(self, f"{name}_expand")(h)
            h = getattr(self, f"{name}_dw")(h)
            if use_se:
                h = getattr(self, f"{name}_se")(h)
            if expand:
                h = h * _hsigmoid(h) if use_hs else F.relu(h)
            h = getattr(self, f"{name}_pw")(h)
            if residual:
                h = h + r
        return self.last(h)


class PIPNet(nn.Module):
    """Backbone (+ the ResNet wrappers' ``net_stride`` extras) and five
    1x1 heads: cls, x, y (L each), nb_x, nb_y (L * num_nb, L-major)."""

    def __init__(self, cfg: PIPNetConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.arch == "resnet":
            self.backbone = ResNetBackbone(cfg)
        elif cfg.arch == "mbnetv2":
            self.backbone = MobileNetV2Backbone()
        elif cfg.arch == "mbnetv3":
            self.backbone = MobileNetV3Backbone()
        else:
            raise ValueError(f"unknown PIPNet arch: {cfg.arch!r}")
        ch = self.backbone.out_channels
        # net_stride != 32 extras: the ResNet wrappers only (the mbnet
        # wrappers ignore net_stride)
        self._extras = ()
        if cfg.arch == "resnet" and cfg.net_stride != 32:
            if cfg.net_stride in (64, 128):
                self.layer5 = Conv(ch, 512, 3, stride=2)
                self.bn5 = FrozenBN(512)
                self._extras = (("layer5", "bn5"),)
                if cfg.net_stride == 128:
                    self.layer6 = Conv(512, 512, 3, stride=2)
                    self.bn6 = FrozenBN(512)
                    self._extras += (("layer6", "bn6"),)
            elif cfg.net_stride == 16 and cfg.block == "basic":
                # Pip_resnet18's ConvTranspose2d(512, 512, 4, 2, 1, bias=False)
                self.deconv1 = nn.ConvTranspose2d(ch, 512, 4, stride=2,
                                                  padding=1, bias=False)
                self.bn_deconv1 = FrozenBN(512)
                self._extras = (("deconv1", "bn_deconv1"),)
            else:
                raise ValueError(
                    f"net_stride {cfg.net_stride} unsupported for "
                    f"block={cfg.block!r} (the reference's networks.py)")
            ch = 512
        L, nb = cfg.num_lms, cfg.num_nb
        self.cls = Conv(ch, L, 1)
        self.x = Conv(ch, L, 1)
        self.y = Conv(ch, L, 1)
        self.nb_x = Conv(ch, L * nb, 1)
        self.nb_y = Conv(ch, L * nb, 1)

    def forward(self, x: torch.Tensor):
        """x: (B, S, S, 3) float -> five (B, g, g, C) head maps."""
        h = self.backbone(to_nchw(x.float()))
        for conv, bn in self._extras:
            h = F.relu(getattr(self, bn)(getattr(self, conv)(h)))
        return tuple(to_nhwc(getattr(self, n)(h))
                     for n in ("cls", "x", "y", "nb_x", "nb_y"))


# -- the mean face's neighbour index ------------------------------------------

def meanface_indices(meanface: np.ndarray, num_nb: int
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(L, 2) mean face -> (reverse_index1, reverse_index2, max_len).

    Landmark i predicts its num_nb nearest mean-face neighbours; reversed,
    each landmark gets the (source landmark, neighbour slot) pairs that
    predict it, repeated cyclically up to the longest list.  A landmark
    that no neighbour predicts gets the masked row ri1 = -1, which
    ``decode_landmarks`` leaves out of the merge."""
    L = meanface.shape[0]
    dists = ((meanface[:, None] - meanface[None]) ** 2).sum(-1)
    nb = np.argsort(dists, axis=1)[:, 1: 1 + num_nb]
    rev = {i: ([], []) for i in range(L)}
    for i in range(L):
        for j in range(num_nb):
            rev[int(nb[i, j])][0].append(i)
            rev[int(nb[i, j])][1].append(j)
    max_len = max(len(rev[i][0]) for i in range(L))
    ri1 = np.full((L, max_len), -1, np.int32)
    ri2 = np.zeros((L, max_len), np.int32)
    for i in range(L):
        src, slot = rev[i]
        if not src:
            continue
        reps = -(-max_len // len(src))
        ri1[i] = (src * reps)[:max_len]
        ri2[i] = (slot * reps)[:max_len]
    return ri1, ri2, max_len


def read_meanface(path: str) -> np.ndarray:
    """The reference's meanface file: one line of x y pairs -> (L, 2)."""
    with open(path) as f:
        vals = [float(v) for v in f.readlines()[0].strip().split()]
    return np.asarray(vals).reshape(-1, 2)


def load_meanface(path: str, num_nb: int):
    return meanface_indices(read_meanface(path), num_nb)


def decode_landmarks(outputs, cfg: PIPNetConfig, ri1: torch.Tensor,
                     ri2: torch.Tensor) -> torch.Tensor:
    """The five head maps (B, g, g, ·) -> (B, L, 2) normalized landmarks:
    the best cell of each landmark's score map plus its offsets, averaged
    with every neighbour prediction that points at it."""
    cls, ox, oy, nbx, nby = outputs
    B, g, _, L = cls.shape
    num_nb = cfg.num_nb
    grid = cfg.input_size / cfg.net_stride

    flat = lambda a: a.permute(0, 3, 1, 2).reshape(B, L, g * g)
    max_ids = torch.argmax(flat(cls), dim=-1)                    # (B, L)
    sel = lambda a: torch.gather(a, -1, max_ids[..., None])[..., 0]
    gx = (max_ids % g).float()
    gy = torch.div(max_ids, g, rounding_mode="floor").float()
    lx = (gx + sel(flat(ox))) / grid
    ly = (gy + sel(flat(oy))) / grid

    flat_nb = lambda a: a.permute(0, 3, 1, 2).reshape(B, L, num_nb, g * g)
    idx = max_ids[:, :, None, None].expand(B, L, num_nb, 1)
    seln = lambda a: torch.gather(a, -1, idx)[..., 0]           # (B, L, nb)
    nlx = (gx[..., None] + seln(flat_nb(nbx))) / grid
    nly = (gy[..., None] + seln(flat_nb(nby))) / grid

    max_len = ri1.shape[1]
    valid = (ri1 >= 0).reshape(-1)
    src = ri1.reshape(-1).clamp_min(0).long()
    slot = ri2.reshape(-1).long()
    zero = torch.zeros((), dtype=nlx.dtype, device=nlx.device)
    rx = torch.where(valid, nlx[:, src, slot], zero).reshape(B, L, max_len)
    ry = torch.where(valid, nly[:, src, slot], zero).reshape(B, L, max_len)
    denom = 1.0 + valid.reshape(L, max_len).sum(-1)
    mx = (lx + rx.sum(-1)) / denom
    my = (ly + ry.sum(-1)) / denom
    return torch.stack([mx, my], dim=-1)


class PIPNetLandmarker:
    """Detector box -> landmarks in pixels (the reference's demo_image).
    ``params`` is the net's state dict in the port's names; ``ri=(ri1,
    ri2)`` overrides the index derived from ``meanface``."""

    def __init__(self, params, cfg: PIPNetConfig, meanface: np.ndarray,
                 det_box_scale: float = 1.2, ri=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        net = PIPNet(cfg)
        net.load_state_dict(params, strict=True)
        self.net = net.to(self.device).requires_grad_(False).eval()
        self.det_box_scale = det_box_scale
        if ri is None:
            ri1, ri2, _ = meanface_indices(meanface, cfg.num_nb)
        else:
            ri1, ri2 = (np.asarray(r, np.int32) for r in ri)
        self._ri1 = torch.from_numpy(ri1).to(self.device)
        self._ri2 = torch.from_numpy(ri2).to(self.device)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) uint8 on the device -> (B, L, 2) normalized
        landmarks; the ImageNet normalisation runs on the device."""
        with torch.inference_mode(), no_tf32():
            x = (x_u8.float() / 255.0 - self._mean) / self._std
            return decode_landmarks(self.net(x), self.cfg, self._ri1,
                                    self._ri2)

    def landmarks_for_box(self, image: np.ndarray, box) -> np.ndarray:
        """image (H, W, 3) uint8, box a ``Detection`` -> (L, 2) int64 pixel
        coordinates.  The reference's arithmetic, quirks included: the box
        grows by ``det_box_scale`` but its top margin moves down, the crop
        ``image[ymin:ymax, xmin:xmax]`` leaves out the end row and column,
        it is resized to the input size with OpenCV's resize and its
        channels are flipped before the net."""
        H, W = image.shape[:2]
        s = self.det_box_scale
        xmin, ymin = box.xmin, box.ymin
        xmax = xmin + box.width - 1
        ymax = ymin + box.height - 1
        xmin -= int(box.width * (s - 1) / 2)
        ymin += int(box.height * (s - 1) / 2)
        xmax += int(box.width * (s - 1) / 2)
        ymax += int(box.height * (s - 1) / 2)
        xmin, ymin = max(xmin, 0), max(ymin, 0)
        xmax, ymax = min(xmax, W - 1), min(ymax, H - 1)
        w, h = xmax - xmin + 1, ymax - ymin + 1
        crop = image[ymin:ymax, xmin:xmax].astype(np.uint8)
        size = self.cfg.input_size
        crop = cv_resample.resize_linear(crop, (size, size))[:, :, ::-1]
        x = torch.from_numpy(np.ascontiguousarray(crop)[None]).to(self.device)
        lms = self.forward(x)[0].cpu().numpy()
        # int64 like the reference's int() landmark list: get_5_from_98
        # divides sums of them by 3
        out = np.empty((lms.shape[0], 2), np.int64)
        out[:, 0] = (lms[:, 0] * w).astype(np.int64) + xmin
        out[:, 1] = (lms[:, 1] * h).astype(np.int64) + ymin
        return out
