"""GSSL PIPNet: curriculum self-training for landmark detection.

Counterpart of ``celebbasis_tpu/align/pipnet_gssl.py`` (the reference's
``lib/networks_gssl.py``, ``functions_gssl.py``, ``data_utils_gssl.py`` and
``train_gssl.py``): a PIPNet whose *shared* score head is applied at three
resolutions (full, /2, /4), trained on labeled rows and on unlabeled rows
that carry a pseudo score target at one resolution, with per-sample masks
choosing which branches learn.  Each round of the curriculum re-estimates
the pseudo-labels with the current net and trains a fresh net
(cls3 -> cls2 -> std -> std -> std).

Task types are a ``(B,)`` integer tensor; targets and masks are built on the
device for the whole batch, whatever its mix of tasks.  The trainer's
parameters are a ``pipnet_train.leaf_state`` (BatchNorm statistics trained
too, as in the JAX package).  A round's initial state comes from the
caller (``init_states``) or from a seeded ``torch.Generator``: the JAX
package's per-round ``jax.random`` keys cannot be reproduced here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from celebbasis_tpu_torch.align.pipnet import (PIPNet, PIPNetConfig,
                                               decode_landmarks,
                                               meanface_indices)
from celebbasis_tpu_torch.align.pipnet_train import (PIPTrainConfig, _at,
                                                     _rows, apply_update,
                                                     forward_neighbors,
                                                     gen_targets, leaf_state,
                                                     make_optimizer)
from celebbasis_tpu_torch.ops.basic import to_nchw, to_nhwc
from celebbasis_tpu_torch.utils.precision import no_tf32

# task-type codes (data_utils_gssl.py, the order of its elif chain)
TASK_STD, TASK_CLS1, TASK_CLS2, TASK_CLS3 = 0, 1, 2, 3
TASK_IDS = {"std": TASK_STD, "cls1": TASK_CLS1,
            "cls2": TASK_CLS2, "cls3": TASK_CLS3}


class PIPNetGSSL(PIPNet):
    """Pip_resnet18 for GSSL: the five PIP heads plus the *same* score conv
    applied after one and two 2x2 max-pools -> ``(cls1, cls2, cls3, x, y,
    nb_x, nb_y)``, channels-last.  ``PIPNet``'s parameter names, so
    ``convert_pipnet``, ``export_pipnet`` and ``from_jax_params`` carry it.
    Stride 32 only: the reference's GSSL net has no stride layers."""

    def __init__(self, cfg: PIPNetConfig):
        if cfg.net_stride != 32:
            raise ValueError(
                "PIPNetGSSL is stride-32 only (the reference GSSL net has no "
                f"stride layers); got net_stride={cfg.net_stride}")
        super().__init__(cfg)

    def forward(self, x: torch.Tensor):
        h = self.backbone(to_nchw(x.float()))
        h2 = F.max_pool2d(h, 2, 2)
        h3 = F.max_pool2d(h2, 2, 2)
        outs = (self.cls(h), self.cls(h2), self.cls(h3), self.x(h),
                self.y(h), self.nb_x(h), self.nb_y(h))
        return tuple(to_nhwc(o) for o in outs)


def _cls_map(landmarks: torch.Tensor, g: int) -> torch.Tensor:
    """(B, L, 2) normalised landmarks -> (B, g, g, L) one-hot cell maps."""
    mu = torch.clamp(torch.floor(landmarks.float() * g), 0, g - 1).long()
    cell = (F.one_hot(mu[..., 1], g)[:, :, :, None]
            * F.one_hot(mu[..., 0], g)[:, :, None, :]).float()
    return cell.permute(0, 2, 3, 1)


def gen_targets_gssl(landmarks: torch.Tensor, nb_idx: torch.Tensor,
                     grid: int, task: torch.Tensor):
    """Targets and per-sample branch masks of a mixed-task batch.  Every
    target is computed; the masks zero what a task does not train: 'std'
    rows train the full-resolution map and the offsets, 'cls1' the full map,
    'cls2' the /2 map, 'cls3' the /4 map.  -> (seven targets, four masks
    (m1, m2, m3, mreg), each (B,))."""
    maps1, tx, ty, tnx, tny = gen_targets(landmarks, nb_idx, grid)
    maps2 = _cls_map(landmarks, grid // 2)
    maps3 = _cls_map(landmarks, grid // 4)
    t = task.long()
    m1 = ((t == TASK_STD) | (t == TASK_CLS1)).float()
    m2 = (t == TASK_CLS2).float()
    m3 = (t == TASK_CLS3).float()
    mreg = (t == TASK_STD).float()
    return (maps1, maps2, maps3, tx, ty, tnx, tny), (m1, m2, m3, mreg)


def gssl_loss(outputs, targets, masks, num_nb: int, cls_w: float = 10.0,
              reg_w: float = 1.0):
    """compute_loss_pip of the GSSL stack: sums divided by the count of
    unmasked entries (the masked score maps of all three resolutions
    together; L1 on the offsets at the label map's cell, per unmasked
    row).  A branch with no unmasked rows gives exactly 0.
    -> (total, parts)."""
    o1, o2, o3, ox, oy, onbx, onby = outputs
    t1, t2, t3, tx, ty, tnx, tny = targets
    m1, m2, m3, mreg = masks
    g, L = o1.shape[1], o1.shape[-1]

    def sq(o, t, m):
        d = (o.float() - t) * m[:, None, None, None]
        return (d * d).sum()

    num = sq(o1, t1, m1) + sq(o2, t2, m2) + sq(o3, t3, m3)
    den = (m1.sum() * (L * g * g) + m2.sum() * (L * (g // 2) ** 2)
           + m3.sum() * (L * (g // 4) ** 2))
    loss_map = num / torch.clamp(den, min=1.0)

    ids = torch.argmax(_rows(t1, L), dim=1)
    ids_nb = ids.repeat_interleave(num_nb)
    mrow = mreg.repeat_interleave(L)              # sample-major, as _rows
    mrow_nb = mreg.repeat_interleave(L * num_nb)

    def l1(o, t, m):
        return ((torch.abs(o.float() - t) * m).sum()
                / torch.clamp(m.sum(), min=1.0))

    C = L * num_nb
    loss_x = l1(_at(ox, L, ids), _at(tx, L, ids), mrow)
    loss_y = l1(_at(oy, L, ids), _at(ty, L, ids), mrow)
    loss_nb_x = l1(_at(onbx, C, ids_nb), _at(tnx, C, ids_nb), mrow_nb)
    loss_nb_y = l1(_at(onby, C, ids_nb), _at(tny, C, ids_nb), mrow_nb)
    total = (cls_w * loss_map
             + reg_w * (loss_x + loss_y + loss_nb_x + loss_nb_y))
    return total, {"map": loss_map, "x": loss_x, "y": loss_y,
                   "nb_x": loss_nb_x, "nb_y": loss_nb_y}


def make_gssl_train_step(model: PIPNetGSSL, optimizer, nb_idx: np.ndarray,
                         cfg: PIPTrainConfig):
    """-> ``step(state, images, landmarks, task) -> (total, parts)``, one
    ``pipnet_train.apply_update`` with ``gssl_loss``; ``task`` is a (B,)
    integer tensor."""
    nb = torch.as_tensor(np.asarray(nb_idx), dtype=torch.long)

    def step(state, images, landmarks, task):
        targets, masks = gen_targets_gssl(landmarks, nb.to(landmarks.device),
                                          cfg.grid, task)
        return apply_update(model, optimizer, state, images, lambda out:
                            gssl_loss(out, targets, masks, cfg.num_nb,
                                      cfg.cls_loss_weight,
                                      cfg.reg_loss_weight))

    return step


def gssl_decode(outputs, cfg: PIPNetConfig, ri1: torch.Tensor,
                ri2: torch.Tensor) -> torch.Tensor:
    """The GSSL head tuple -> (B, L, 2) neighbour-merged landmarks (the
    full-resolution score map drives the decode)."""
    c1, _c2, _c3, ox, oy, nbx, nby = outputs
    return decode_landmarks((c1, ox, oy, nbx, nby), cfg, ri1, ri2)


def _iter_batches(n: int, batch_size: int, rng: np.random.Generator):
    """Shuffled, drop-last batch indices (the reference's DataLoader with
    shuffle=True, drop_last=True)."""
    order = rng.permutation(n)
    for i in range(0, n - batch_size + 1, batch_size):
        yield order[i:i + batch_size]


def random_init_state(cfg: PIPNetConfig, seed: int) -> Dict[str,
                                                           torch.Tensor]:
    """``PIPNetGSSL(cfg)``'s state drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` (``loader.init_weights``), the
    same on every device."""
    from celebbasis_tpu_torch.loader import init_weights
    net = PIPNetGSSL(cfg)
    return init_weights(net, torch.Generator().manual_seed(seed)
                        ).state_dict()


def gssl_self_train(net_cfg: PIPNetConfig, train_cfg: PIPTrainConfig,
                    meanface: np.ndarray,
                    labeled: Tuple[np.ndarray, np.ndarray],
                    unlabeled_images: np.ndarray,
                    *, task_list: Sequence[str] = ("cls3", "cls2", "std",
                                                   "std", "std"),
                    init_states: Optional[Sequence[Dict]] = None,
                    augment_fn=None, seed: int = 0, verbose: bool = True,
                    device=None) -> Dict:
    """The GSSL curriculum on arrays.

    ``labeled`` = (images (N, S, S, 3) normalised channels-last, landmarks
    (N, L, 2)); ``unlabeled_images`` = (M, S, S, 3).  A fresh net first
    trains ``num_epochs`` on the labeled rows as 'std' (the warmup, so that
    the first pseudo-labels come from a trained net).  Then for each round
    ``ti``: pseudo-label the clean unlabeled images with the current net
    (neighbour-merged decode), tagged ``task_list[ti]``; start a fresh net
    and optimizer; train ``num_epochs`` on the labeled 'std' rows plus the
    pseudo rows.  Batch order comes from one ``np.random.default_rng(seed)``
    shared by all rounds; the optimizer is plain Adam (no weight decay,
    whatever ``pretrained``).

    ``init_states[i]``: the initial state dict of training round i (0 the
    warmup, i the i-th curriculum round); default ``random_init_state(
    net_cfg, seed + 100 + i)``.  ``augment_fn(round_idx, epoch_idx, lms) ->
    (images, lms)``: a per-epoch augmentation of the rows [labeled;
    unlabeled] (labeled only in round 0), ``lms`` holding the current
    pseudo-labels.  -> {"params", "init_history": warmup epoch losses,
    "history": per-round epoch losses, "step_s": seconds of each step}."""
    from celebbasis_tpu_torch.loader import resolve_device
    device = resolve_device(device)
    model = PIPNetGSSL(net_cfg).to(device)
    nb_idx = forward_neighbors(meanface, train_cfg.num_nb)
    ri1, ri2, _ = meanface_indices(meanface, train_cfg.num_nb)
    ri1 = torch.from_numpy(ri1).to(device)
    ri2 = torch.from_numpy(ri2).to(device)
    host = np.random.default_rng(seed)
    as_dev = lambda a, dtype=torch.float32: torch.from_numpy(
        np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    imgs_l, lms_l = labeled
    n_l, n_u = len(imgs_l), len(unlabeled_images)
    bs = train_cfg.batch_size
    if n_l < bs:
        raise ValueError(
            f"need >= batch_size={bs} labeled rows (got {n_l}): the "
            "drop-last loader would yield zero batches")
    step_s = []

    def train_round(rnd, images, lms, task):
        """A fresh net and optimizer, num_epochs over (images, lms, task)."""
        params = leaf_state(init_states[rnd] if init_states is not None
                            else random_init_state(net_cfg, seed + 100 + rnd),
                            device)
        optimizer = make_optimizer(
            dataclasses.replace(train_cfg, pretrained=True),
            max(len(images) // bs, 1), params.values())
        step = make_gssl_train_step(model, optimizer, nb_idx, train_cfg)
        hist = []
        for epoch in range(train_cfg.num_epochs):
            if augment_fn is not None:
                ep_images, ep_lms = augment_fn(rnd, epoch, lms)
                if len(ep_images) != len(images):
                    raise ValueError(f"augment_fn gave {len(ep_images)} "
                                     f"rows for {len(images)}")
            else:
                ep_images, ep_lms = images, lms
            total, n = 0.0, 0
            for idx in _iter_batches(len(images), bs, host):
                t0 = time.perf_counter()
                loss, _ = step(params, as_dev(ep_images[idx]),
                               as_dev(ep_lms[idx]),
                               as_dev(task[idx], torch.long))
                total += float(loss)
                step_s.append(time.perf_counter() - t0)
                n += 1
            hist.append(total / max(n, 1))
        return params, hist

    def pseudo_label(params):
        if not n_u:
            return np.zeros((0,) + lms_l.shape[1:], np.float32)
        out = []
        with torch.no_grad(), no_tf32():
            for i in range(0, n_u, bs):
                x = as_dev(unlabeled_images[i:i + bs])
                out.append(gssl_decode(functional_call(model, params, (x,)),
                                       net_cfg, ri1, ri2).cpu().numpy())
        return np.concatenate(out)

    params, init_hist = train_round(
        0, imgs_l, lms_l, np.full((n_l,), TASK_STD, np.int32))
    if verbose:
        print(f"[gssl] init (std, labeled only): "
              f"loss {init_hist[0]:.4f} -> {init_hist[-1]:.4f}")
    history = []
    for ti, task_type in enumerate(task_list):
        pseudo = pseudo_label(params)
        images = np.concatenate([imgs_l, unlabeled_images]) if n_u else imgs_l
        lms = np.concatenate([lms_l, pseudo]) if n_u else lms_l
        task = np.concatenate([np.full((n_l,), TASK_STD, np.int32),
                               np.full((n_u,), TASK_IDS[task_type],
                                       np.int32)])
        params, round_hist = train_round(ti + 1, images, lms, task)
        history.append(round_hist)
        if verbose:
            print(f"[gssl] round {ti} ({task_type}): "
                  f"loss {round_hist[0]:.4f} -> {round_hist[-1]:.4f}")
    return {"params": params, "history": history, "init_history": init_hist,
            "step_s": step_s}
