"""DDPM forward process + training losses as pure functions.

Counterpart of ``celebbasis_tpu/diffusion/ddpm.py``:

* ``q_sample``: x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps;
* ``eps_mse_loss``: eps-parameterised MSE with the (constant, zero-init)
  per-timestep logvar weighting kept configurable; net effect mean-MSE;
* the x0/eps conversion.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from celebbasis_tpu_torch.diffusion.schedules import NoiseSchedule


class ScheduleArrays(NamedTuple):
    """Schedule constants as float32 tensors on one device."""
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor

    @staticmethod
    def from_schedule(s: NoiseSchedule, device="cpu") -> "ScheduleArrays":
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(device)
        return ScheduleArrays(
            f32(s.sqrt_alphas_cumprod),
            f32(s.sqrt_one_minus_alphas_cumprod),
            f32(s.sqrt_recip_alphas_cumprod),
            f32(s.sqrt_recipm1_alphas_cumprod),
        )


def _gather(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] broadcast to an ndim-rank tensor."""
    out = a[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(sched: ScheduleArrays, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    return (_gather(sched.sqrt_alphas_cumprod, t, x0.ndim) * x0
            + _gather(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim) * noise)


def predict_x0_from_eps(sched: ScheduleArrays, x_t: torch.Tensor,
                        t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return (_gather(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _gather(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)


def eps_mse_loss(eps_pred: torch.Tensor, eps: torch.Tensor,
                 t: torch.Tensor | None = None,
                 logvar: torch.Tensor | None = None,
                 l_simple_weight: float = 1.0):
    """Training loss. Returns (scalar, log-dict)."""
    per_ex = ((eps_pred.float() - eps) ** 2).mean(
        dim=tuple(range(1, eps.ndim)))
    loss_simple = per_ex.mean()
    if logvar is not None and t is not None:
        lv = logvar[t]
        loss = (per_ex / torch.exp(lv) + lv).mean()
    else:
        loss = loss_simple
    loss = l_simple_weight * loss
    return loss, {"loss_simple": loss_simple, "loss": loss}
