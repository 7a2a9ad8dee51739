"""MetaIdNet: face image -> basis coefficients -> identity text embedding.

Counterpart of ``celebbasis_tpu/core/meta_net.py``:

* frozen IResNet id features (computed under ``torch.no_grad()``: the only
  trainable part is the MLP);
* StyleVectorizer MLP: depth 1 is a single EqualLinear (weight scaled by
  ``lr_mul`` at use time) + LeakyReLU 0.2; deeper layers are pre-LayerNorm
  residual EqualLinears;
* reshape to (N, es, heads, inner), L2-normalise over the coefficient axis,
  then project on the celeb basis: ``z = einsum(coeff, P) + mean``;
* several faces per sample arrive as (N, k, H, W, 3) and fold into the batch
  axis.

Faces are channels-last ``(N, H, W, 3)`` in [-1, 1] (FFHQ crop); they are
first mapped to the ArcFace crop by ``ops.warp``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.models.iresnet import IResNet, IResNetConfig
from celebbasis_tpu_torch.ops.basic import LayerNorm, l2_normalize
from celebbasis_tpu_torch.ops.warp import (INSIGHTFACE_TRANS_MATRIX,
                                           batched_affine_warp_resize)


@dataclass(frozen=True)
class MetaNetConfig:
    fr_dim: int = 512            # face-recognition feature dim
    inner_dim: int = 512         # basis coefficient count (n_components)
    num_es: int = 2              # num_embeds_per_token
    heads: int = 1
    mlp_depth: int = 1
    lr_mul: float = 1.0
    token_dim: int = 768
    use_rm_mlp: bool = False     # ablation: direct per-id coefficient table
    num_ids: int = 10
    face_size: int = 112
    iresnet: IResNetConfig = IResNetConfig.r100()

    @staticmethod
    def tiny() -> "MetaNetConfig":
        return MetaNetConfig(fr_dim=64, inner_dim=16, token_dim=32,
                             face_size=32, iresnet=IResNetConfig.tiny())


class EqualLinear(nn.Module):
    """y = leaky_relu_0.2(x @ (W*lr_mul)^T + b*lr_mul); W ~ N(0,1) init,
    stored ``(out, in)``.  Optional pre-LayerNorm."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 pre_norm: bool = False):
        super().__init__()
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        if pre_norm:
            self.norm = LayerNorm(in_dim)

    def forward(self, x):
        if hasattr(self, "norm"):
            x = self.norm(x)
        y = F.linear(x, self.weight * self.lr_mul, self.bias * self.lr_mul)
        return F.leaky_relu(y, negative_slope=0.2)


class StyleVectorizer(nn.Module):
    """depth 1: EqualLinear(in -> out); depth > 1 adds residual pre-norm
    layers."""

    def __init__(self, in_dim: int, out_dim: int, depth: int = 1,
                 lr_mul: float = 1.0):
        super().__init__()
        self.depth = depth
        self.layer_0 = EqualLinear(in_dim, out_dim, lr_mul)
        for i in range(1, depth):
            setattr(self, f"layer_{i}",
                    EqualLinear(out_dim, out_dim, lr_mul, pre_norm=True))

    def forward(self, x):
        x = self.layer_0(x)
        for i in range(1, self.depth):
            x = x + getattr(self, f"layer_{i}")(x)
        return x


_TRANS_MATRIX: dict = {}


def _trans_matrix(device) -> torch.Tensor:
    """``INSIGHTFACE_TRANS_MATRIX`` on `device`, copied there once: a copy
    from the host inside a captured CUDA graph is refused."""
    key = str(torch.device(device))
    m = _TRANS_MATRIX.get(key)
    if m is None:
        with torch.inference_mode(False):
            m = _TRANS_MATRIX[key] = INSIGHTFACE_TRANS_MATRIX.to(device)
    return m


class MetaIdNet(nn.Module):
    """Returns (z, coeff): z (N, es*heads, token_dim) identity embeddings,
    coeff (N, es, heads, inner_dim) normalised basis coefficients."""

    def __init__(self, cfg: MetaNetConfig,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.fr_net = IResNet(cfg.iresnet, dtype)
        self.mlp = StyleVectorizer(cfg.fr_dim,
                                   cfg.inner_dim * cfg.num_es * cfg.heads,
                                   cfg.mlp_depth, cfg.lr_mul)
        if cfg.use_rm_mlp:
            self.coef_table = nn.Parameter(torch.randn(
                cfg.num_ids, cfg.num_es, cfg.heads, cfg.inner_dim))

    def trainable_parameters(self):
        """What personalisation trains: the MLP (and the coefficient table of
        the ablation); the face-recognition net stays frozen."""
        params = list(self.mlp.parameters())
        if self.cfg.use_rm_mlp:
            params.append(self.coef_table)
        return params

    @torch.no_grad()
    def face_features(self, faces: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) FFHQ-cropped faces in [-1, 1] -> (N, fr_dim) unit
        vectors.  Frozen: no graph is kept."""
        s = self.cfg.face_size
        warped = batched_affine_warp_resize(
            faces, _trans_matrix(faces.device), (s, s))
        return l2_normalize(self.fr_net(warped), axis=-1)

    def coefficients(self, faces: torch.Tensor,
                     id_idx: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_rm_mlp:
            return self.coef_table[id_idx]
        return self.coefficients_from_features(self.face_features(faces))

    def coefficients_from_features(self, v: torch.Tensor) -> torch.Tensor:
        """(N, fr_dim) frozen id features -> normalised coefficients; split
        out so that the frozen forward can be cached across steps."""
        cfg = self.cfg
        x = self.mlp(v).reshape(-1, cfg.num_es, cfg.heads, cfg.inner_dim)
        return l2_normalize(x, axis=-1)

    def _project(self, coeff: torch.Tensor, celeb_basis: torch.Tensor):
        cfg = self.cfg
        mean, pca = celeb_basis[:, 0], celeb_basis[:, 1:]
        z = torch.einsum("behk,ekc->behc", coeff, pca.to(coeff.dtype)) \
            + mean[None, :, None, :]
        return z.reshape(z.shape[0], cfg.num_es * cfg.heads, cfg.token_dim)

    def z_from_features(self, v: torch.Tensor, celeb_basis: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cached-feature equivalent of forward: (N, fr_dim) -> (z, coeff)."""
        coeff = self.coefficients_from_features(v)
        return self._project(coeff, celeb_basis), coeff

    def forward(self, faces: torch.Tensor, id_idx: torch.Tensor,
                celeb_basis: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """celeb_basis: (es, 1+inner, token_dim). -> (z, coeff)."""
        coeff = self.coefficients(faces, id_idx)
        return self._project(coeff, celeb_basis), coeff

    def multi_faces(self, faces_multi: torch.Tensor, ids_multi: torch.Tensor,
                    celeb_basis: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """faces_multi: (N, k, H, W, 3), ids: (N, k) ->
        z (N, k, es*h, token_dim), coeff (N, k, es, h, inner)."""
        N, k = faces_multi.shape[:2]
        flat = faces_multi.reshape((N * k,) + faces_multi.shape[2:])
        z, coeff = self(flat, ids_multi.reshape(-1), celeb_basis)
        return (z.reshape(N, k, *z.shape[1:]),
                coeff.reshape(N, k, *coeff.shape[1:]))
