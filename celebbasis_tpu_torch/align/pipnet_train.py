"""PIPNet landmark trainer (W0's training side).

Counterpart of ``celebbasis_tpu/align/pipnet_train.py`` (the reference's
``lib/train.py``, ``lib/functions.py`` compute_loss_pip / train_model and
``lib/data_utils.py`` gen_target_pip and augmentations):

* ``gen_targets``: the five PIP target maps built on the device from
  ``(B, L, 2)`` landmarks, channels-last like the heads;
* ``pip_loss``: MSE over the score map plus L1 on the offsets gathered at
  the *label* map's cell, channel order ``l * num_nb + j``;
* ``augment``: the reference's translate / occlusion / flip / rotate / blur
  chain, grayscale and ImageNet normalisation on the host, drawing from an
  ``np.random.Generator`` in the JAX package's order (the same pixels and
  targets for the same generator);
* ``make_optimizer``: Adam with the reference's MultiStepLR as a factor per
  update (``decay_steps`` epochs times ``steps_per_epoch``), and coupled L2
  of 5e-4 when the backbone is not pretrained;
* ``make_train_step`` / ``fit_pipnet``: the step and the loop, and the
  reference's ``epoch%d.pth`` files.

The trained state is one dict of leaf tensors (``leaf_state``), run through
the net with ``torch.func.functional_call``.  Like the JAX trainer, which
takes gradients over the whole flax tree, it trains **every** leaf, the
frozen BatchNorm statistics (``FrozenBN.mean`` / ``var``) included; the
reference instead runs BatchNorm on batch statistics.  Checkpoints are
written in the reference's key layout (``utils.bridge_align.export_pipnet``),
which ``convert_pipnet`` and ``cli/align.py --pipnet_ckpt`` read.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from celebbasis_tpu_torch.align.pipnet import (IMAGENET_MEAN, IMAGENET_STD,
                                               PIPNet, PIPNetConfig)
from celebbasis_tpu_torch.utils.precision import no_tf32

# WFLW left/right symmetry permutation (public dataset metadata; the
# reference hardcodes it in train.py for random_flip)
WFLW_POINTS_FLIP = (
    32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17, 16, 15,
    14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 46, 45, 44, 43, 42,
    50, 49, 48, 47, 37, 36, 35, 34, 33, 41, 40, 39, 38, 51, 52, 53, 54, 59,
    58, 57, 56, 55, 72, 71, 70, 69, 68, 75, 74, 73, 64, 63, 62, 61, 60, 67,
    66, 65, 82, 81, 80, 79, 78, 77, 76, 87, 86, 85, 84, 83, 92, 91, 90, 89,
    88, 95, 94, 93, 97, 96)

# 300W / 68-point symmetry permutation (train_gssl.py, 1-based there)
POINTS_FLIP_68 = (
    16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 26, 25, 24,
    23, 22, 21, 20, 19, 18, 17, 27, 28, 29, 30, 35, 34, 33, 32, 31, 45, 44,
    43, 42, 47, 46, 39, 38, 37, 36, 41, 40, 54, 53, 52, 51, 50, 49, 48, 59,
    58, 57, 56, 55, 64, 63, 62, 61, 60, 67, 66, 65)

Maps = Tuple[torch.Tensor, ...]


@dataclass(frozen=True)
class PIPTrainConfig:
    """The reference's ``Config`` (lib/tools.py) training fields."""
    num_lms: int = 98
    num_nb: int = 10
    input_size: int = 256
    net_stride: int = 32
    batch_size: int = 16
    init_lr: float = 1e-4
    num_epochs: int = 60
    decay_steps: Tuple[int, ...] = (30, 50)
    decay_gamma: float = 0.1
    cls_loss_weight: float = 10.0
    reg_loss_weight: float = 1.0
    pretrained: bool = True          # False adds Adam weight_decay 5e-4
    rotate_max_deg: float = 30.0

    @property
    def grid(self) -> int:
        return self.input_size // self.net_stride


def forward_neighbors(meanface: np.ndarray, num_nb: int) -> np.ndarray:
    """(L, 2) mean face -> (L, num_nb) indices of each landmark's nearest
    mean-face neighbours, the ones its neighbour heads predict."""
    dists = ((meanface[:, None] - meanface[None]) ** 2).sum(-1)
    return np.argsort(dists, axis=1)[:, 1:1 + num_nb].astype(np.int32)


# -- targets and loss (on the device) -----------------------------------------

def gen_targets(landmarks: torch.Tensor, nb_idx: torch.Tensor,
                grid: int) -> Maps:
    """(B, L, 2) normalised landmarks -> the five target maps (score, x, y,
    nb_x, nb_y), each ``(B, g, g, C)``: the score map is 1 at landmark l's
    floor cell (clipped to the grid), x / y hold the shift inside that cell,
    and the neighbour maps hold, at the same cell, the offsets to l's
    ``num_nb`` mean-face neighbours (channel ``l * num_nb + j``)."""
    B, L, _ = landmarks.shape
    g, num_nb = grid, nb_idx.shape[1]
    f = landmarks.float() * g
    mu = torch.clamp(torch.floor(f), 0, g - 1)                  # (B, L, 2)
    mux, muy = mu[..., 0], mu[..., 1]
    cell = (F.one_hot(muy.long(), g)[:, :, :, None]
            * F.one_hot(mux.long(), g)[:, :, None, :]).float()
    maps = cell.permute(0, 2, 3, 1)                             # (B, g, g, L)
    shift = f - mu
    tx = maps * shift[..., 0][:, None, None, :]
    ty = maps * shift[..., 1][:, None, None, :]
    nbf = f[:, nb_idx.long()]                                   # (B, L, nb, 2)
    nsx = nbf[..., 0] - mux[..., None]
    nsy = nbf[..., 1] - muy[..., None]
    tnx = (maps[..., None] * nsx[:, None, None]).reshape(B, g, g, L * num_nb)
    tny = (maps[..., None] * nsy[:, None, None]).reshape(B, g, g, L * num_nb)
    return maps, tx, ty, tnx, tny


def _rows(a: torch.Tensor, C: int) -> torch.Tensor:
    """(B, g, g, C) -> (B * C, g * g), the reference's channel order."""
    B, g = a.shape[0], a.shape[1]
    return a.permute(0, 3, 1, 2).reshape(B * C, g * g)


def _at(a: torch.Tensor, C: int, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(_rows(a, C), 1, idx[:, None])[:, 0]


def pip_loss(outputs: Maps, targets: Maps, num_nb: int, cls_w: float = 10.0,
             reg_w: float = 1.0):
    """compute_loss_pip with the reference's criteria: MSE over the whole
    score map, L1 on the x / y / neighbour offsets at the label map's cell
    of each (sample, landmark).  -> (total, parts)."""
    ocls, ox, oy, onbx, onby = outputs
    tcls, tx, ty, tnbx, tnby = targets
    L = ocls.shape[-1]
    ids = torch.argmax(_rows(tcls, L), dim=1)                   # (B * L,)
    ids_nb = ids.repeat_interleave(num_nb)
    l1 = lambda a, b: torch.mean(torch.abs(a.float() - b))
    loss_map = torch.mean((ocls.float() - tcls) ** 2)
    loss_x = l1(_at(ox, L, ids), _at(tx, L, ids))
    loss_y = l1(_at(oy, L, ids), _at(ty, L, ids))
    C = L * num_nb
    loss_nb_x = l1(_at(onbx, C, ids_nb), _at(tnbx, C, ids_nb))
    loss_nb_y = l1(_at(onby, C, ids_nb), _at(tnby, C, ids_nb))
    total = (cls_w * loss_map
             + reg_w * (loss_x + loss_y + loss_nb_x + loss_nb_y))
    return total, {"map": loss_map, "x": loss_x, "y": loss_y,
                   "nb_x": loss_nb_x, "nb_y": loss_nb_y}


# -- host augmentations ---------------------------------------------------------

def augment(img, target: np.ndarray, rng: np.random.Generator,
            points_flip: Optional[np.ndarray] = None,
            rotate_max_deg: float = 30.0):
    """PIL image + (2L,) normalised target -> (normalised float32 (S, S, 3)
    array, target).

    The reference's per-sample chain, translate -> occlusion -> flip ->
    rotate -> blur (each at p 0.5, blur at 0.3), then grayscale at 0.2 and
    the ImageNet normalisation, with every draw taken from ``rng``.  Square
    inputs (the reference reads ``image.size`` as (h, w))."""
    from PIL import Image, ImageFilter
    size = img.size[0]
    target = np.asarray(target, np.float32).copy()
    if rng.random() > 0.5:                                      # translate
        c = int((rng.random() - 0.5) * 60)
        f = int((rng.random() - 0.5) * 60)
        img = img.transform(img.size, Image.AFFINE, (1, 0, c, 0, 1, f))
        t = target.reshape(-1, 2)
        t[:, 0] -= c / size
        t[:, 1] -= f / size
        target = np.clip(t.flatten(), 0, 1)
    if rng.random() > 0.5:                                      # occlusion
        # the reference works in BGR there, so its three colour draws land
        # on channels B, G, R in that order
        a = np.array(img, np.uint8)
        oh = int(size * 0.4 * rng.random())
        ow = int(size * 0.4 * rng.random())
        ox = int((size - ow - 10) * rng.random())
        oy = int((size - oh - 10) * rng.random())
        for ch in (2, 1, 0):
            a[oy:oy + oh, ox:ox + ow, ch] = int(rng.random() * 255)
        img = Image.fromarray(a)
    if points_flip is not None and rng.random() > 0.5:          # flip
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        t = target.reshape(-1, 2)[np.asarray(points_flip)]
        t[:, 0] = 1 - t[:, 0]
        target = t.flatten()
    if rng.random() > 0.5:                                      # rotate
        theta = rng.uniform(-np.radians(rotate_max_deg),
                            np.radians(rotate_max_deg))
        img = img.rotate(np.degrees(theta))
        ctr = np.tile([0.5, 0.5], len(target) // 2)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array(((c, -s), (s, c)), np.float32)
        target = ((target - ctr).reshape(-1, 2) @ rot).flatten() + ctr
    if rng.random() > 0.7:                                      # blur
        img = img.filter(ImageFilter.GaussianBlur(rng.random() * 5))
    if rng.random() < 0.2:                                      # grayscale
        img = img.convert("L").convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr, target


# -- optimisation ---------------------------------------------------------------

def leaf_state(state: Mapping[str, torch.Tensor],
               device=None) -> Dict[str, torch.Tensor]:
    """A net's state dict -> the trainer's parameters: float32 copies on
    ``device`` that require grad, every leaf (BatchNorm statistics too)."""
    return {k: v.detach().to(device=device, dtype=torch.float32, copy=True)
            .requires_grad_(True) for k, v in state.items()}


def lr_factor(cfg: PIPTrainConfig, steps_per_epoch: int
              ) -> Callable[[int], float]:
    """Update k's factor on ``init_lr``: ``decay_gamma`` once per boundary
    ``e * steps_per_epoch`` (e in ``decay_steps``) that k has reached."""
    bounds = [e * steps_per_epoch for e in cfg.decay_steps]

    def factor(k: int) -> float:
        out = 1.0
        for b in bounds:
            if k >= b:
                out *= cfg.decay_gamma
        return out
    return factor


def make_optimizer(cfg: PIPTrainConfig, steps_per_epoch: int, params):
    """Adam(init_lr) over ``params`` (weight decay 5e-4, added to the
    gradient, when ``cfg.pretrained`` is False) and a ``LambdaLR`` stepped
    once per update.  -> (optimizer, scheduler)."""
    opt = torch.optim.Adam(list(params), lr=cfg.init_lr,
                           weight_decay=0.0 if cfg.pretrained else 5e-4)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lr_factor(cfg, steps_per_epoch))


def apply_update(model, optimizer, state: Dict[str, torch.Tensor],
                 images: torch.Tensor, loss_fn):
    """One training update: ``loss_fn(outputs) -> (total, parts)`` on the
    net's outputs for ``state``, gradients of every leaf (left in each
    leaf's ``.grad``), then one step of ``optimizer = (Adam, LambdaLR)`` in
    place; fp32 throughout, TF32 off.  -> (total, parts), detached."""
    opt, sched = optimizer
    opt.zero_grad(set_to_none=True)
    with no_tf32():
        total, parts = loss_fn(functional_call(model, state, (images,)))
        total.backward()
    opt.step()
    sched.step()
    return total.detach(), {k: v.detach() for k, v in parts.items()}


def make_train_step(model: PIPNet, optimizer, nb_idx: np.ndarray,
                    cfg: PIPTrainConfig):
    """-> ``step(state, images, landmarks) -> (total, parts)``, one
    ``apply_update`` with ``pip_loss``.  Images are ``(B, S, S, 3)``
    normalised floats, landmarks ``(B, L, 2)``, both on the state's
    device."""
    nb = torch.as_tensor(np.asarray(nb_idx), dtype=torch.long)

    def step(state, images, landmarks):
        targets = gen_targets(landmarks, nb.to(landmarks.device), cfg.grid)
        return apply_update(model, optimizer, state, images, lambda out:
                            pip_loss(out, targets, cfg.num_nb,
                                     cfg.cls_loss_weight,
                                     cfg.reg_loss_weight))

    return step


def fit_pipnet(model: PIPNet, params: Dict[str, torch.Tensor], batches_fn,
               cfg: PIPTrainConfig, meanface: np.ndarray,
               steps_per_epoch: int, save_dir: Optional[str] = None,
               save_interval: Optional[int] = None,
               verbose: bool = True) -> Dict:
    """The train loop: ``batches_fn(epoch)`` yields ``(images (B, S, S, 3)
    normalised float32, landmarks (B, L, 2))`` numpy pairs; ``params`` is a
    ``leaf_state`` on the device the steps run on, trained in place.
    ``epoch%d.pth`` files are written at the reference's cadence
    (``epoch > 0 and epoch % (save_interval - 1) == 0``; save_interval
    defaults to num_epochs).  -> {"params", "history": mean loss per epoch,
    "step_s": seconds of each step, to a sync}."""
    device = next(iter(params.values())).device
    nb_idx = forward_neighbors(meanface, cfg.num_nb)
    optimizer = make_optimizer(cfg, steps_per_epoch, params.values())
    step = make_train_step(model, optimizer, nb_idx, cfg)
    save_interval = save_interval or cfg.num_epochs
    history, step_s = [], []
    for epoch in range(cfg.num_epochs):
        epoch_loss, n = 0.0, 0
        for images, landmarks in batches_fn(epoch):
            t0 = time.perf_counter()
            total, _parts = step(
                params, torch.from_numpy(np.asarray(images, np.float32)
                                         ).to(device),
                torch.from_numpy(np.asarray(landmarks, np.float32)
                                 ).to(device))
            epoch_loss += float(total)
            step_s.append(time.perf_counter() - t0)
            n += 1
        epoch_loss /= max(n, 1)
        history.append(epoch_loss)
        if verbose:
            print(f"[pipnet-train] epoch {epoch}/{cfg.num_epochs - 1} "
                  f"loss {epoch_loss:.6f}")
        if (save_dir is not None and epoch > 0
                and epoch % (save_interval - 1) == 0):
            save_checkpoint(params, model.cfg, save_dir, epoch)
    return {"params": params, "history": history, "step_s": step_s}


def save_checkpoint(params: Mapping[str, torch.Tensor], cfg: PIPNetConfig,
                    save_dir: str, epoch: int) -> str:
    """``<save_dir>/epoch<epoch>.pth`` in the reference's key layout (what
    its ``torch.save(net.state_dict())`` holds).  -> the path."""
    from celebbasis_tpu_torch.utils.bridge_align import export_pipnet
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"epoch{epoch}.pth")
    torch.save(export_pipnet(params, cfg), path)
    return path
