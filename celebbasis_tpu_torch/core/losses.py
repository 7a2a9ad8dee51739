"""Identity-loss heads: margin softmax family, InfoNCE contrastive, EMA.

Counterpart of ``celebbasis_tpu/core/losses.py``:

* ``MarginHead`` -- the reference's five margin-classification heads
  (softmax, CosFace, ArcFace and their adaptive variants), present but
  disabled in the reference (``use_header=False``), and
  ``margin_cross_entropy``;
* ``ContrastiveGNet`` / ``contrastive_loss`` -- InfoNCE over per-id meta
  embeddings through a trainable g-net, enabled by ``loss_type: 'contra'``;
* ``EmaState`` / ``ema_init`` / ``ema_update`` -- the ``LitEma``-style
  exponential moving average of a tree of tensors (dicts, lists and tuples
  of tensors), off by default in the reference; ``ema_update_`` is the same
  update in place and on the device, which a captured train step runs (the
  legacy trainer's EMA).

Margin math runs in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.ops.basic import l2_normalize


# -- margin softmax family ---------------------------------------------------

class MarginHead(nn.Module):
    """Normalised-weight classification head giving margin-adjusted logits.

    ``kind``: 'softmax' (plain ``W x + b``), 'cosface' (target ``cos - m``),
    'arcface' (``cos(theta + m)`` with the easy-margin / ``theta > pi - m``
    guard), 'am_cosface' (``cos - m + k (theta - a)``) and 'am_arcface'
    (``cos(theta + m - k (theta - a))``).  Rows labelled -1 take no margin
    (the reference's PartialFC convention).  ``weight`` is
    ``(num_classes, dim)`` like the flax parameter, so weights carry across
    as they are.
    """

    def __init__(self, num_classes: int, dim: int, kind: str = "am_cosface",
                 m: float = 0.35, s: float = 64.0, a: float = 0.0,
                 k: float = 0.0, easy_margin: bool = False):
        super().__init__()
        if kind not in ("softmax", "cosface", "arcface", "am_cosface",
                        "am_arcface"):
            raise ValueError(f"unknown margin head {kind!r}")
        self.num_classes, self.kind = num_classes, kind
        self.m, self.s, self.a, self.k = m, s, a, k
        self.easy_margin = easy_margin
        self.weight = nn.Parameter(torch.randn(num_classes, dim) * 0.01)
        if kind == "softmax":
            self.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, feats: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.kind == "softmax":
            return feats @ self.weight.T + self.bias
        x = l2_normalize(feats.float())
        cos = (x @ l2_normalize(self.weight.float()).T).clamp(-1.0, 1.0)
        if labels is None:
            return self.s * cos
        valid = labels >= 0                            # PartialFC -1 rows
        onehot = F.one_hot(labels.clamp_min(0), self.num_classes).float()
        onehot = onehot * valid[:, None]
        theta_t = torch.arccos((cos * onehot).sum(-1).clamp(-1.0, 1.0))
        m = self.m
        if self.kind == "cosface":
            target = cos - m
        elif self.kind == "am_cosface":
            target = cos - m + (self.k * (theta_t - self.a))[:, None]
        elif self.kind == "arcface":
            sin = torch.sqrt((1.0 - cos ** 2).clamp(0.0, 1.0))
            phi = cos * math.cos(m) - sin * math.sin(m)
            if self.easy_margin:
                target = torch.where(cos > 0, phi, cos)
            else:
                target = torch.where(cos > math.cos(math.pi - m), phi,
                                     cos - math.sin(math.pi - m) * m)
        else:                                           # am_arcface
            m_eff = m - self.k * (theta_t - self.a)
            target = torch.cos(torch.arccos(cos) + m_eff[..., None])
        return self.s * torch.where(onehot > 0, target, cos)


def margin_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


# -- contrastive --------------------------------------------------------------


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


# -- EMA (LitEma) -------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


class EmaState(NamedTuple):
    params: object
    decay: float
    num_updates: torch.Tensor


def ema_init(params, decay: float = 0.9999,
             use_num_updates: bool = True) -> EmaState:
    """A detached copy of ``params`` (a tree of tensors) and a step count
    (-1 turns the early-step decay ramp off)."""
    return EmaState(_tree_map(lambda p: p.detach().clone(), params), decay,
                    torch.tensor(0 if use_num_updates else -1,
                                 dtype=torch.int32))


def ema_update(state: EmaState, new_params) -> EmaState:
    """One LitEma step: decay ``min(decay, (1 + n) / (10 + n))`` while the
    count runs, ``decay`` otherwise; a new state (:func:`ema_update_` on a
    copy)."""
    out = EmaState(_tree_map(lambda e: e.clone(), state.params), state.decay,
                   state.num_updates.clone())
    ema_update_(out, new_params)
    return out


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


@torch.no_grad()
def ema_update_(state: EmaState, new_params) -> None:
    """:func:`ema_update` in place: ``state``'s copies and its count are
    written where they lie and nothing is read back to the host, so that a
    captured train step can run it (the count then on the card too)."""
    n = state.num_updates
    live = n >= 0
    n.copy_(torch.where(live, n + 1, n))
    ramp = (1.0 + n) / (10.0 + n)
    ema, new = _leaves(state.params), _leaves(new_params)
    decay = torch.where(live, ramp.clamp(max=state.decay),
                        torch.full_like(ramp, state.decay)).to(ema[0].device)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - decay))
