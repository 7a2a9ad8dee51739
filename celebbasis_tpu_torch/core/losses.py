"""Identity-loss heads: the InfoNCE contrastive loss and its g-net.

Counterpart of the contrastive part of ``celebbasis_tpu/core/losses.py``
(enabled by ``loss_type: 'contra'``).  The margin-softmax heads and the EMA
helpers of that module are off the training path and not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.ops.basic import l2_normalize


class ContrastiveGNet(nn.Module):
    """relu -> linear projection g-net; (N, in_dim) -> (N, meta_dim)."""

    def __init__(self, in_dim: int, meta_dim: int = 768):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, meta_dim)

    def forward(self, x):
        return self.Dense_0(F.relu(x))


def info_nce_loss(z_feats: torch.Tensor,
                  temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE over one example's (id_cnt, D) projected metas: positives are
    ``id_cnt // 2`` apart (the second augmentation block)."""
    k = z_feats.shape[0]
    zn = l2_normalize(z_feats)
    eye = torch.eye(k, dtype=torch.bool, device=z_feats.device)
    cos = torch.where(eye, torch.full_like(zn[:1, :1], -9e15),
                      zn @ zn.T) / temperature
    pos = torch.roll(eye, k // 2, dims=0)
    nll = -cos[pos] + torch.logsumexp(cos, dim=-1)
    return nll.mean()


def contrastive_loss(gnet: ContrastiveGNet, metas: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """metas: (N, id_cnt, D) -> scalar InfoNCE through the g-net.

    As in the reference (and the JAX package), whose per-example loop
    overwrites its result, only the LAST example's InfoNCE reaches the loss.
    """
    N, k, D = metas.shape
    z = gnet(metas.reshape(N * k, D)).reshape(N, k, -1)
    return info_nce_loss(z[-1], temperature)
