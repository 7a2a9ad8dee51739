"""LR schedules: the reference's LambdaWarmUpCosine family.

Counterpart of ``celebbasis_tpu/train/lr_schedule.py`` (the reference's
``ldm/lr_scheduler.py``).  Each function takes ``base_lr`` and returns
``fn(step) -> base_lr * multiplier``; with ``base_lr = 1.0`` (what the
registry passes, as the reference does) ``fn`` is a multiplier for
``torch.optim.lr_scheduler.LambdaLR``.  The values equal the JAX functions'.

``lambda_linear_traceable`` is the JAX package's in-graph twin of
``lambda_linear`` (float32 arithmetic, as ``jnp`` computes it); here it is
a host function of the same float32 arithmetic, so the two packages give
the same rates bit for bit.  A captured train step reads its rate from a
device tensor: ``set_lr`` writes the rate of the next step into each
param group between steps (``fill_`` where the rate is a tensor).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def warmup_cosine(base_lr: float, warm_up_steps: int, lr_min: float,
                  lr_max: float, lr_start: float, max_decay_steps: int):
    """LambdaWarmUpCosineScheduler: linear warmup then cosine to lr_min."""
    def fn(step):
        step = np.minimum(step, max_decay_steps)
        warm = lr_start + step * (lr_max - lr_start) / max(warm_up_steps, 1)
        t = (step - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1)
        t = np.clip(t, 0.0, 1.0)
        cos = lr_min + 0.5 * (lr_max - lr_min) * (1 + np.cos(t * np.pi))
        return base_lr * np.where(step < warm_up_steps, warm, cos)
    return fn


def _cycle_of(bounds: np.ndarray, step) -> int:
    """The reference's ``find_in_interval``: the boundary step itself still
    belongs to the earlier cycle (``n <= cl``)."""
    cyc = int(np.searchsorted(bounds, step, side="left"))
    return min(cyc, len(bounds) - 1)


def warmup_cosine_cycles(base_lr: float, warm_up_steps: Sequence[int],
                         f_min: Sequence[float], f_max: Sequence[float],
                         f_start: Sequence[float],
                         cycle_lengths: Sequence[int]):
    """LambdaWarmUpCosineScheduler2: repeated warmup + cosine cycles."""
    bounds = np.cumsum(cycle_lengths)

    def fn(step):
        cyc = _cycle_of(bounds, step)
        start = bounds[cyc - 1] if cyc > 0 else 0
        s = step - start
        if s < warm_up_steps[cyc]:
            mult = (f_start[cyc] + s * (f_max[cyc] - f_start[cyc])
                    / max(warm_up_steps[cyc], 1))
        else:
            t = (s - warm_up_steps[cyc]) / max(
                cycle_lengths[cyc] - warm_up_steps[cyc], 1)
            t = min(t, 1.0)
            mult = f_min[cyc] + 0.5 * (f_max[cyc] - f_min[cyc]) * (
                1 + np.cos(t * np.pi))
        return base_lr * mult
    return fn


def lambda_linear(base_lr: float, warm_up_steps: Sequence[int],
                  f_min: Sequence[float], f_max: Sequence[float],
                  f_start: Sequence[float], cycle_lengths: Sequence[int]):
    """LambdaLinearScheduler: per-cycle linear warmup, then linear decay
    f_max -> f_min across the rest of the cycle (the scheduler every
    ``txt2img-1p4B-*`` config names)."""
    bounds = np.cumsum(cycle_lengths)

    def fn(step):
        cyc = _cycle_of(bounds, step)
        start = bounds[cyc - 1] if cyc > 0 else 0
        s = step - start
        if s < warm_up_steps[cyc]:
            mult = (f_start[cyc] + s * (f_max[cyc] - f_start[cyc])
                    / max(warm_up_steps[cyc], 1))
        else:
            mult = f_min[cyc] + (f_max[cyc] - f_min[cyc]) \
                * (cycle_lengths[cyc] - s) / cycle_lengths[cyc]
        return base_lr * mult
    return fn


def lambda_linear_traceable(base_lr: float, warm_up_steps: Sequence[int],
                            f_min: Sequence[float], f_max: Sequence[float],
                            f_start: Sequence[float],
                            cycle_lengths: Sequence[int]):
    """:func:`lambda_linear` in float32 arithmetic, the JAX twin's: what the
    legacy trainer's AdamW runs at."""
    f32 = np.float32
    bounds = np.cumsum(cycle_lengths).astype(f32)
    wu, fmn, fmx, fst, cl = (np.asarray(a, f32) for a in (
        warm_up_steps, f_min, f_max, f_start, cycle_lengths))

    def fn(step):
        step = f32(step)
        cyc = int(np.clip(np.searchsorted(bounds, step, side="left"), 0,
                          len(cycle_lengths) - 1))
        start = bounds[max(cyc - 1, 0)] if cyc > 0 else f32(0.0)
        s = step - start
        if s < wu[cyc]:
            mult = fst[cyc] + s * (fmx[cyc] - fst[cyc]) \
                / np.maximum(wu[cyc], f32(1))
        else:
            mult = fmn[cyc] + (fmx[cyc] - fmn[cyc]) * (cl[cyc] - s) / cl[cyc]
        return f32(base_lr) * mult
    return fn


def adamw_with_schedule(params, schedule_fn: Callable[[int], float],
                        capturable: bool = False) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` at the schedule's step-0 rate, with torch's
    default decay 1e-2 (the legacy trainer's).  ``capturable`` (a step that
    a CUDA graph captures) holds the rate as a tensor on the parameters'
    device.  Advance it with :func:`set_lr` after each step, or wrap it in
    ``LambdaLR``."""
    params = list(params)
    lr = float(schedule_fn(0))
    if capturable:
        lr = torch.tensor(lr, device=params[0].device)
    return torch.optim.AdamW(params, lr=lr, weight_decay=1e-2,
                             capturable=capturable)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every param group's rate to ``lr``, written into the tensor in place
    where the group's rate is one (a captured step reads it there)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
