"""DDIM sampler: a Python loop over precomputed step constants.

Counterpart of ``guided_eps``, ``ddim_step`` and ``ddim_sample`` of
``celebbasis_tpu/diffusion/sampler.py`` (a Python loop takes the place of
``lax.scan``).  ``plms_sample``, ``ddpm_sample`` and ``stochastic_encode``
are not ported yet.

Classifier-free guidance follows the reference: batch-double
``[uncond; cond]`` (uncond rows first), one UNet call,
``e = e_u + scale * (e_c - e_u)``.  The update is the DDIM step, deterministic
at eta = 0.

Randomness: one ``torch.Generator`` per sample row.  Row i's noise (initial
latents and any eta > 0 step noise) depends only on generator i, so a
sample's result is independent of whatever it is batched with: the property
a continuous batcher needs for reproducible results.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from celebbasis_tpu_torch.diffusion.schedules import DDIMSchedule

# eps_model(x, t, context) -> eps; shapes (B,H,W,4), (B,), (B,L,D)
EpsModel = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class SamplerConfig(NamedTuple):
    guidance_scale: float = 7.5
    eta: float = 0.0
    temperature: float = 1.0


def guided_eps(eps_model: EpsModel, x, t, cond, uncond, scale):
    """Classifier-free guidance with a single batched UNet call."""
    B = x.shape[0]
    e = eps_model(torch.cat([x, x]), torch.cat([t, t]),
                  torch.cat([uncond, cond]))
    e_u, e_c = e[:B], e[B:]
    return e_u + scale * (e_c - e_u)


def ddim_step(x, eps, a_t, a_prev, sqrt_oma, sigma, noise):
    """One DDIM update; the step constants are Python floats."""
    pred_x0 = (x - sqrt_oma * eps) / a_t ** 0.5
    dir_xt = max(1.0 - a_prev - sigma ** 2, 0.0) ** 0.5 * eps
    return a_prev ** 0.5 * pred_x0 + dir_xt + sigma * noise, pred_x0


def batched_normal(generators: Sequence[torch.Generator], shape,
                   device) -> torch.Tensor:
    """(B, *shape[1:]) standard normal, row i drawn from generator i alone."""
    if len(generators) != shape[0]:
        raise ValueError(f"need one generator per row: {len(generators)} "
                         f"generators for batch {shape[0]}")
    rows = [torch.randn(tuple(shape[1:]), generator=g, device=g.device,
                        dtype=torch.float32).to(device) for g in generators]
    return torch.stack(rows)


def ddim_sample(eps_model: EpsModel, ddim: DDIMSchedule, *,
                generators: Sequence[torch.Generator] | None, shape,
                cond: torch.Tensor, uncond: torch.Tensor | None = None,
                cfg: SamplerConfig = SamplerConfig(),
                x_T: torch.Tensor | None = None) -> torch.Tensor:
    """Run the full DDIM chain; returns final latents (B, H, W, C), float32.

    ``generators``: one per sample row; may be None when ``x_T`` is given and
    eta is 0 (nothing is drawn then).
    """
    device = cond.device
    x = (batched_normal(generators, shape, device) if x_T is None
         else x_T.to(device=device, dtype=torch.float32))
    use_cfg = uncond is not None and cfg.guidance_scale != 1.0
    # float32 constants like the JAX sampler's, as Python floats: no
    # host-device traffic inside the loop
    f32 = lambda a: [float(v) for v in a.astype("float32")]
    steps = zip(ddim.timesteps[::-1].tolist(), f32(ddim.alphas[::-1]),
                f32(ddim.alphas_prev[::-1]),
                f32(ddim.sqrt_one_minus_alphas[::-1]), f32(ddim.sigmas[::-1]))
    for t, a_t, a_prev, sqrt_oma, sigma in steps:
        tb = torch.full((shape[0],), t, dtype=torch.int64, device=device)
        if use_cfg:
            eps = guided_eps(eps_model, x, tb, cond, uncond,
                             cfg.guidance_scale)
        else:
            eps = eps_model(x, tb, cond)
        noise = 0.0
        if sigma > 0.0:
            noise = batched_normal(generators, shape,
                                   device) * cfg.temperature
        x, _ = ddim_step(x, eps, a_t, a_prev, sqrt_oma, sigma, noise)
    return x
