"""InceptionV3-pool3 feature extractor for FID.

Counterpart of ``celebbasis_tpu/eval/inception.py``: the "FID Inception" of
pytorch-fid / torch-fidelity -- torchvision's InceptionV3 graph with the
TF-port quirks:

* BasicConv2d = conv(bias=False) + BatchNorm(eps=1e-3) + ReLU;
* the InceptionA/C and first InceptionE blocks use
  ``avg_pool(count_include_pad=False)`` in their pool branch;
* the last InceptionE block (Mixed_7c) uses a stride-1 **max** pool there;
* input: bilinear resize to 299x299 (half-pixel centres, no antialias),
  then [0, 1] -> [-1, 1].

Module and parameter names are the torch file's
(``Mixed_5b.branch1x1.conv.weight`` ...; BatchNorm's running statistics are
the buffers ``bn.mean`` / ``bn.var``), so ``convert_inception`` renames the
statistics and drops what pool3 does not use.  Activations are NCHW inside;
the public input is channels-last like the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.models.iresnet import FrozenBN
from celebbasis_tpu_torch.ops.basic import Conv, to_nchw
from celebbasis_tpu_torch.utils.precision import no_tf32

POOL3_DIM = 2048


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, out: int, kernel=(1, 1), stride=(1, 1),
                 padding=(0, 0), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(cin, out, kernel, stride=stride, padding=padding,
                         dtype=dtype, bias=False)
        self.bn = FrozenBN(out, epsilon=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))     # float32, as flax's BN


def _avg_pool_3(x):
    """3x3 stride-1 pad-1 average pool, count_include_pad=False."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _cat(*xs):
    return torch.cat(xs, dim=1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype=torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)
        self.branch1x1 = c(cin, 64)
        self.branch5x5_1 = c(cin, 48)
        self.branch5x5_2 = c(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = c(cin, 64)
        self.branch3x3dbl_2 = c(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = c(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = c(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat(self.branch1x1(x), b5, b3,
                    self.branch_pool(_avg_pool_3(x)))


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)
        self.branch3x3 = c(cin, 384, (3, 3), (2, 2))
        self.branch3x3dbl_1 = c(cin, 64)
        self.branch3x3dbl_2 = c(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = c(96, 96, (3, 3), (2, 2))

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat(self.branch3x3(x), bd, F.max_pool2d(x, 3, 2))


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, dtype=torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)
        c7 = channels_7x7
        self.branch1x1 = c(cin, 192)
        self.branch7x7_1 = c(cin, c7)
        self.branch7x7_2 = c(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = c(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = c(cin, c7)
        self.branch7x7dbl_2 = c(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = c(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = c(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = c(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = c(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return _cat(self.branch1x1(x), b7, bd,
                    self.branch_pool(_avg_pool_3(x)))


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)
        self.branch3x3_1 = c(cin, 192)
        self.branch3x3_2 = c(192, 320, (3, 3), (2, 2))
        self.branch7x7x3_1 = c(cin, 192)
        self.branch7x7x3_2 = c(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = c(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = c(192, 192, (3, 3), (2, 2))

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return _cat(self.branch3x3_2(self.branch3x3_1(x)), b7,
                    F.max_pool2d(x, 3, 2))


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str = "avg", dtype=torch.float32):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, dtype=dtype, **k)
        self.pool_kind = pool_kind   # 'avg' (Mixed_7b) | 'max' (Mixed_7c)
        self.branch1x1 = c(cin, 320)
        self.branch3x3_1 = c(cin, 384)
        self.branch3x3_2a = c(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = c(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = c(cin, 448)
        self.branch3x3dbl_2 = c(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = c(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = c(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = c(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = _cat(self.branch3x3_2a(b3), self.branch3x3_2b(b3))
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = _cat(self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd))
        pooled = (F.max_pool2d(x, 3, 1, 1) if self.pool_kind == "max"
                  else _avg_pool_3(x))
        return _cat(self.branch1x1(x), b3, bd, self.branch_pool(pooled))


class InceptionV3(nn.Module):
    """Pool3 features: (N, 299, 299, 3) in [-1, 1] -> (N, 2048) float32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.dtype = dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), (2, 2), dtype=d)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3), dtype=d)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1),
                                         dtype=d)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, dtype=d)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3), dtype=d)
        self.Mixed_5b = InceptionA(192, 32, d)
        self.Mixed_5c = InceptionA(256, 64, d)
        self.Mixed_5d = InceptionA(288, 64, d)
        self.Mixed_6a = InceptionB(288, d)
        self.Mixed_6b = InceptionC(768, 128, d)
        self.Mixed_6c = InceptionC(768, 160, d)
        self.Mixed_6d = InceptionC(768, 160, d)
        self.Mixed_6e = InceptionC(768, 192, d)
        self.Mixed_7a = InceptionD(768, d)
        self.Mixed_7b = InceptionE(1280, "avg", d)
        self.Mixed_7c = InceptionE(2048, "max", d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x).to(self.dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))          # adaptive average pool


# -- input pipeline -----------------------------------------------------------

def resize_bilinear_torch(x: torch.Tensor, size: Tuple[int, int]
                          ) -> torch.Tensor:
    """(B, H, W, C) bilinear resize with torch ``interpolate(align_corners=
    False)`` semantics -- half-pixel centres, no antialiasing -- written as
    the JAX package's gathers."""
    B, H, W, C = x.shape
    h, w = size

    def coords(n_out: int, n_in: int):
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return ((i + 0.5) * (n_in / n_out) - 0.5).clamp(0.0, n_in - 1.0)

    fy, fx = coords(h, H), coords(w, W)
    y0, x0 = fy.floor().long(), fx.floor().long()
    y1, x1 = (y0 + 1).clamp_max(H - 1), (x0 + 1).clamp_max(W - 1)
    wy = (fy - y0)[None, :, None, None]
    wx = (fx - x0)[None, None, :, None]
    rows0, rows1 = x[:, y0], x[:, y1]                # (B, h, W, C)
    top = rows0[:, :, x0] * (1 - wx) + rows0[:, :, x1] * wx
    bot = rows1[:, :, x0] * (1 - wx) + rows1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def preprocess(batch_uint8, size: int = 299, device=None) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> (B, size, size, 3) float32 in [-1, 1]:
    bilinear resize (half-pixel centres, no antialias: what pytorch-fid's
    ``resize_input`` does), then [0, 1] -> [-1, 1]."""
    x = torch.as_tensor(np.asarray(batch_uint8), device=device).float() \
        / 255.0
    if x.shape[1] != size or x.shape[2] != size:
        x = resize_bilinear_torch(x, (size, size))
    return x * 2.0 - 1.0


# -- weights ------------------------------------------------------------------

def convert_inception(state: Mapping) -> Dict[str, torch.Tensor]:
    """A torch InceptionV3 state dict (pytorch-fid's ``pt_inception`` or
    torchvision's ``inception_v3``) -> ``InceptionV3``'s state dict,
    float32: BatchNorm's ``running_mean`` / ``running_var`` become ``mean`` /
    ``var``; the AuxLogits and fc keys and ``num_batches_tracked`` are
    dropped (pool3 does not use them); any other key raises."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state.items():
        if key.startswith(("AuxLogits", "fc.")) or key.endswith(
                "num_batches_tracked"):
            continue
        scope, mod, leaf = key.rsplit(".", 2)
        val = torch.as_tensor(val).float()
        if mod == "conv" and leaf == "weight":
            out[key] = val
        elif mod == "bn" and leaf in ("weight", "bias"):
            out[key] = val
        elif mod == "bn" and leaf in ("running_mean", "running_var"):
            out[f"{scope}.bn.{leaf[len('running_'):]}"] = val
        else:
            raise ValueError(f"unexpected inception key {key!r}")
    return out


def load_inception(weights_path: str | None = None, dtype=torch.float32,
                   device=None, seed: int = 0
                   ) -> Tuple[Callable[[np.ndarray], np.ndarray],
                              InceptionV3]:
    """-> (feature_fn: uint8 batch -> (B, 2048) numpy features, the net).

    Without weights the net is random (``loader.init_weights`` from
    ``seed``): for shape and contract checks only; FID numbers need the
    ``pt_inception`` file.  The features are computed with TF32 off."""
    from celebbasis_tpu_torch.loader import init_weights, resolve_device
    from celebbasis_tpu_torch.utils.pt_io import load_pt

    dev = resolve_device(device)
    with torch.device(dev):
        net = InceptionV3(dtype=dtype)
    net.requires_grad_(False).eval()
    if weights_path:
        state = load_pt(weights_path)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        net.load_state_dict(convert_inception(state), strict=True)
    else:
        init_weights(net, torch.Generator(device=dev).manual_seed(seed))

    def feature_fn(batch_uint8: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), no_tf32():
            return net(preprocess(batch_uint8, device=dev)).cpu().numpy()

    return feature_fn, net
