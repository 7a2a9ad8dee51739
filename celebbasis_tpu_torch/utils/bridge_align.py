"""Readers of the alignment nets' checkpoints.

Counterpart of ``celebbasis_tpu/utils/bridge_align.py``: the reference's
``FaceBoxesV2.pth`` (``utils/faceboxes.py`` module names; V1 too) and
PIPNet ``epoch59.pth`` (torchvision ResNet, MobileNetV2 or the reference's
MobileNetV3, with the ``net_stride`` extras and the five 1x1 heads of
``lib/networks.py``), read onto the port's parameter names.  Torch's
layouts are the port's, so nothing is transposed (a ``ConvTranspose2d``
weight is ``(in, out, kh, kw)`` on both sides).  Which optional blocks a
net has (a ResNet block's ``downsample``, a MobileNetV3 block's expansion)
follows from the configuration, as the port's module is built; a key the
module needs and the file lacks raises, and ``load_state_dict(strict=True)``
refuses a shape that differs.  A leading ``module.`` (DataParallel) is
dropped from the file's keys.

The writers go the other way through the same pairs: ``reference_layout``
puts a port state dict on the file's keys, and ``export_pipnet`` writes
what the reference's ``torch.save(net.state_dict())`` holds (the landmark
trainers' ``epoch%d.pth``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Set, Tuple

import torch

from celebbasis_tpu_torch.align.pipnet import PIPNet, PIPNetConfig
from celebbasis_tpu_torch.utils.bridge import _Reader

_PIPNET_HEADS = (("cls", "cls_layer"), ("x", "x_layer"), ("y", "y_layer"),
                 ("nb_x", "nb_x_layer"), ("nb_y", "nb_y_layer"))
_INCEPTION_BRANCHES = ("branch1x1", "branch1x1_2", "branch3x3_reduce",
                       "branch3x3", "branch3x3_reduce_2", "branch3x3_2",
                       "branch3x3_3")


def _strip_module(state: Mapping) -> Dict[str, torch.Tensor]:
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state.items() if isinstance(v, torch.Tensor)}


Pairs = List[Tuple[str, str, str]]      # (kind, port name, file name)


def _conv_bn(pairs: Pairs, dst: str, src: str, conv: str = "conv",
             bn: str = "bn") -> None:
    pairs += [("conv", f"{dst}.conv", f"{src}.{conv}"),
              ("bn", f"{dst}.bn", f"{src}.{bn}")]


def faceboxes_pairs(version: int = 2) -> Pairs:
    """(kind, port module, file module) of every layer of FaceBoxes V2 or
    V1; kind "conv" is a weight and its bias where there is one, "bn" a
    BatchNorm's affine and running statistics."""
    pairs: Pairs = []
    if version == 2:
        stem = [f"conv{i}" for i in range(1, 6)]
        extra = ("conv6_1", "conv6_2", "conv7_1", "conv7_2")
    else:
        stem = ["conv1", "conv2"]
        extra = ("conv3_1", "conv3_2", "conv4_1", "conv4_2")
    for name in stem:
        _conv_bn(pairs, name, name)
    for i in (1, 2, 3):
        for b in _INCEPTION_BRANCHES:
            _conv_bn(pairs, f"inception{i}.{b}", f"inception{i}.{b}")
    for name in extra:
        _conv_bn(pairs, name, name)
    for i in range(3):
        pairs += [("conv", f"head{i}.loc", f"loc.{i}"),
                  ("conv", f"head{i}.conf", f"conf.{i}")]
    return pairs


def _resnet_pairs(pairs: Pairs, net: PIPNet) -> None:
    pairs += [("conv", "backbone.conv1", "conv1"),
              ("bn", "backbone.bn1", "bn1")]
    n_convs = 3 if net.cfg.block == "bottleneck" else 2
    for name in net.backbone._blocks:
        layer, block = name.split("_block")
        dst, src = f"backbone.{name}", f"{layer}.{block}"
        for n in range(1, n_convs + 1):
            pairs += [("conv", f"{dst}.conv{n}", f"{src}.conv{n}"),
                      ("bn", f"{dst}.bn{n}", f"{src}.bn{n}")]
        if hasattr(getattr(net.backbone, name), "down_conv"):
            pairs += [("conv", f"{dst}.down_conv", f"{src}.downsample.0"),
                      ("bn", f"{dst}.down_bn", f"{src}.downsample.1")]
    for conv, bn in net._extras:
        pairs += [("conv", conv, conv), ("bn", bn, bn)]


def _mbnetv2_pairs(pairs: Pairs, net: PIPNet) -> None:
    _conv_bn(pairs, "backbone.stem", "features.0", "0", "1")
    for fi, (name, expand, _) in enumerate(net.backbone._plan, start=1):
        dst, src = f"backbone.{name}", f"features.{fi}.conv"
        if expand:
            _conv_bn(pairs, f"{dst}_expand", f"{src}.0", "0", "1")
            _conv_bn(pairs, f"{dst}_dw", f"{src}.1", "0", "1")
            _conv_bn(pairs, f"{dst}_pw", src, "2", "3")
        else:
            _conv_bn(pairs, f"{dst}_dw", f"{src}.0", "0", "1")
            _conv_bn(pairs, f"{dst}_pw", src, "1", "2")
    _conv_bn(pairs, "backbone.last",
             f"features.{len(net.backbone._plan) + 1}", "0", "1")


def _mbnetv3_pairs(pairs: Pairs, net: PIPNet) -> None:
    _conv_bn(pairs, "backbone.stem", "features.0", "0", "1")
    for fi, (name, expand, use_se, _, _) in enumerate(net.backbone._plan,
                                                      start=1):
        dst, src = f"backbone.{name}", f"features.{fi}.conv"
        # positions of (dw conv, dw bn, SE, pw conv, pw bn) in the block
        idx = (3, 4, 5, 7, 8) if expand else (0, 1, 3, 4, 5)
        if expand:
            _conv_bn(pairs, f"{dst}_expand", src, "0", "1")
        _conv_bn(pairs, f"{dst}_dw", src, str(idx[0]), str(idx[1]))
        if use_se:
            pairs += [("conv", f"{dst}_se.fc1", f"{src}.{idx[2]}.fc.0"),
                      ("conv", f"{dst}_se.fc2", f"{src}.{idx[2]}.fc.2")]
        _conv_bn(pairs, f"{dst}_pw", src, str(idx[3]), str(idx[4]))
    _conv_bn(pairs, "backbone.last", "conv", "0", "1")


def pipnet_pairs(cfg: PIPNetConfig) -> Pairs:
    """(kind, port module, file module) of every layer of ``PIPNet(cfg)``;
    which optional blocks there are follows from the port's module, built
    on the ``meta`` device."""
    with torch.device("meta"):
        net = PIPNet(cfg)
    pairs: Pairs = []
    {"resnet": _resnet_pairs, "mbnetv2": _mbnetv2_pairs,
     "mbnetv3": _mbnetv3_pairs}[cfg.arch](pairs, net)
    pairs += [("conv", dst, src) for dst, src in _PIPNET_HEADS]
    return pairs


def _read(state: Mapping, pairs: Pairs,
          used: Optional[Set[str]]) -> Dict[str, torch.Tensor]:
    rd = _Reader(_strip_module(state), "", used)
    for kind, dst, src in pairs:
        (rd.weight if kind == "conv" else rd.bn)(dst, src)
    return rd.out


def convert_faceboxes(state: Mapping, version: int = 2,
                      used: Optional[Set[str]] = None
                      ) -> Dict[str, torch.Tensor]:
    """A FaceBoxes state dict -> ``align.faceboxes.FaceBoxesV2`` (or V1)'s
    state dict; the keys taken are added to ``used``."""
    return _read(state, faceboxes_pairs(version), used)


def convert_pipnet(state: Mapping, cfg: PIPNetConfig,
                   used: Optional[Set[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """A PIPNet state dict -> ``align.pipnet.PIPNet(cfg)``'s state dict;
    the keys taken are added to ``used``."""
    return _read(state, pipnet_pairs(cfg), used)


def reference_layout(state: Mapping[str, torch.Tensor], pairs: Pairs
                     ) -> Dict[str, torch.Tensor]:
    """A port state dict on the reference's keys, through the readers' own
    (kind, port module, file module) pairs: BatchNorm statistics as
    ``running_mean`` / ``running_var``."""
    out = {}
    for kind, dst, src in pairs:
        leaves = (("weight", "weight"), ("bias", "bias"))
        if kind == "bn":
            leaves += (("mean", "running_mean"), ("var", "running_var"))
        for ours, theirs in leaves:
            if f"{dst}.{ours}" in state:
                out[f"{src}.{theirs}"] = state[f"{dst}.{ours}"]
    return out


def export_pipnet(state: Mapping[str, torch.Tensor], cfg: PIPNetConfig
                  ) -> Dict[str, torch.Tensor]:
    """``PIPNet(cfg)``'s state (port names; a GSSL net's too) -> the keys of
    the reference's ``net.state_dict()``, float32 on the CPU, each
    BatchNorm with a ``num_batches_tracked`` of 0 (the port's BatchNorm
    counts no batches)."""
    pairs = pipnet_pairs(cfg)
    out = reference_layout({k: v.detach().float().cpu()
                            for k, v in state.items()}, pairs)
    for kind, _, src in pairs:
        if kind == "bn":
            out[f"{src}.num_batches_tracked"] = torch.tensor(0)
    return out
