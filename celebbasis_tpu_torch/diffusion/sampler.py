"""DDIM, PLMS and DDPM samplers: Python loops over precomputed step
constants.

Counterpart of ``celebbasis_tpu/diffusion/sampler.py`` (``guided_eps``,
``ddim_step``, ``ddim_sample``, ``plms_sample``, ``ddpm_sample``,
``stochastic_encode``); a Python loop takes the place of ``lax.scan``, and
PLMS keeps its eps history in a Python list in place of a fixed-shape carry.

Classifier-free guidance follows the reference: batch-double
``[uncond; cond]`` (uncond rows first), one UNet call,
``e = e_u + scale * (e_c - e_u)``.  The DDIM update is deterministic at
eta = 0; PLMS combines up to four eps in the Adams-Bashforth manner; DDPM is
the full ancestral chain.

Randomness: one ``torch.Generator`` per sample row.  Row i's noise (initial
latents and any eta > 0 step noise) depends only on generator i, so a
sample's result is independent of whatever it is batched with: the property
a continuous batcher needs for reproducible results.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from celebbasis_tpu_torch.diffusion.schedules import (DDIMSchedule,
                                                      NoiseSchedule)

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


def sample_seed(seed: int, sample_idx: int) -> int:
    """The generator seed of sample ``sample_idx`` of a request (or of image
    ``sample_idx`` of a CLI run) started from ``seed``."""
    return ((int(seed) & 0xFFFFFFFF) << 20) ^ int(sample_idx)


def _f32(a) -> list:
    """A host array as Python floats rounded to float32, like the JAX
    sampler's step constants: no host-device traffic inside the loop."""
    return [float(v) for v in np.asarray(a, np.float32)]


def step_constants(ddim: DDIMSchedule):
    """Per-step (t, a_t, a_prev, sqrt(1 - a_t), sigma) in descending time."""
    return list(zip(ddim.timesteps[::-1].tolist(), _f32(ddim.alphas[::-1]),
                    _f32(ddim.alphas_prev[::-1]),
                    _f32(ddim.sqrt_one_minus_alphas[::-1]),
                    _f32(ddim.sigmas[::-1])))


def _start_latents(generators, shape, device, x_T):
    return (batched_normal(generators, shape, device) if x_T is None
            else x_T.to(device=device, dtype=torch.float32))


def _eps_fn(eps_model: EpsModel, cond, uncond, cfg: SamplerConfig, batch):
    """t (a Python int) and x -> eps, guided where the config asks for it."""
    use_cfg = uncond is not None and cfg.guidance_scale != 1.0

    def eps(x, t):
        tb = torch.full((batch,), t, dtype=torch.int64, device=x.device)
        if use_cfg:
            return guided_eps(eps_model, x, tb, cond, uncond,
                              cfg.guidance_scale)
        return eps_model(x, tb, cond)

    return eps


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
    x = _start_latents(generators, shape, device, x_T)
    eps_fn = _eps_fn(eps_model, cond, uncond, cfg, shape[0])
    for t, a_t, a_prev, sqrt_oma, sigma in step_constants(ddim):
        eps = eps_fn(x, t)
        noise = 0.0
        if sigma > 0.0:
            noise = batched_normal(generators, shape,
                                   device) * cfg.temperature
        x, _ = ddim_step(x, eps, a_t, a_prev, sqrt_oma, sigma, noise)
    return x


def plms_sample(eps_model: EpsModel, ddim: DDIMSchedule, *,
                generators: Sequence[torch.Generator] | None, shape,
                cond: torch.Tensor, uncond: torch.Tensor | None = None,
                cfg: SamplerConfig = SamplerConfig(),
                x_T: torch.Tensor | None = None) -> torch.Tensor:
    """PLMS (pseudo linear multi-step); returns final latents, float32.

    The eps history is a list of the last three eps, newest first; its
    length picks the order.  The first step evaluates eps twice (at t, and
    at the next timestep on the provisional x_prev), so a chain makes
    ``num_steps + 1`` (guided) UNet calls.  Nothing is drawn when ``x_T`` is
    given (``generators`` may be None then); eta is not used.
    """
    device = cond.device
    x = _start_latents(generators, shape, device, x_T)
    eps_fn = _eps_fn(eps_model, cond, uncond, cfg, shape[0])
    steps = step_constants(ddim)
    t_next = [s[0] for s in steps[1:]] + [0]
    old_eps: list[torch.Tensor] = []
    for (t, a_t, a_prev, sqrt_oma, _), t_n in zip(steps, t_next):
        eps = eps_fn(x, t)
        if not old_eps:
            x_prev, _ = ddim_step(x, eps, a_t, a_prev, sqrt_oma, 0.0, 0.0)
            eps_prime = (eps + eps_fn(x_prev, t_n)) / 2
        elif len(old_eps) == 1:
            eps_prime = (3 * eps - old_eps[0]) / 2
        elif len(old_eps) == 2:
            eps_prime = (23 * eps - 16 * old_eps[0] + 5 * old_eps[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * old_eps[0] + 37 * old_eps[1]
                         - 9 * old_eps[2]) / 24
        x, _ = ddim_step(x, eps_prime, a_t, a_prev, sqrt_oma, 0.0, 0.0)
        old_eps = [eps] + old_eps[:2]
    return x


def ddpm_sample(eps_model: EpsModel, sched: NoiseSchedule, *,
                generators: Sequence[torch.Generator] | None, shape,
                cond: torch.Tensor, uncond: torch.Tensor | None = None,
                cfg: SamplerConfig = SamplerConfig(),
                x_T: torch.Tensor | None = None,
                clip_denoised: bool = True, return_x0_every: int = 0):
    """Full-chain ancestral DDPM sampling over a ``NoiseSchedule``: T
    posterior steps ``x_{t-1} ~ N(c1 x0 + c2 x_t, sigma_t^2)`` from the eps
    prediction, with optional x0 clipping and no noise at t = 0.

    Step noise is ``batched_normal(generators) * cfg.temperature``; it is
    not drawn at temperature 0.  With ``return_x0_every=k`` returns
    ``(x, x0s)``, x0s the x0 prediction at the end of every k steps (and of
    the last step), stacked.
    """
    T = sched.num_timesteps
    c1, c2 = _f32(sched.posterior_mean_coef1), _f32(sched.posterior_mean_coef2)
    sigma = _f32(np.exp(0.5 * np.asarray(sched.posterior_log_variance_clipped,
                                         np.float32)))
    sr = _f32(sched.sqrt_recip_alphas_cumprod)
    srm1 = _f32(sched.sqrt_recipm1_alphas_cumprod)
    device = cond.device
    x = _start_latents(generators, shape, device, x_T)
    eps_fn = _eps_fn(eps_model, cond, uncond, cfg, shape[0])
    snaps = []
    for i, t in enumerate(range(T - 1, -1, -1)):
        eps = eps_fn(x, t)
        x0 = sr[t] * x - srm1[t] * eps
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        x = c1[t] * x0 + c2[t] * x
        if t > 0 and cfg.temperature != 0.0:
            x = x + sigma[t] * (batched_normal(generators, shape, device)
                                * cfg.temperature)
        if return_x0_every > 0 and ((i + 1) % return_x0_every == 0
                                    or i == T - 1):
            snaps.append(x0)
    if return_x0_every <= 0:
        return x
    return x, torch.stack(snaps)


def stochastic_encode(x0: torch.Tensor, ddim_index: int, ddim: DDIMSchedule,
                      generators: Sequence[torch.Generator] | None = None,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
    """img2img forward noising to DDIM index ``ddim_index``:
    ``sqrt(a) x0 + sqrt(1 - a) noise``, a = alpha_cumprod there.  The noise
    is drawn row by row from ``generators`` unless it is given."""
    a = _f32(ddim.alphas[ddim_index:ddim_index + 1])[0]
    if noise is None:
        noise = batched_normal(generators, x0.shape, x0.device)
    return a ** 0.5 * x0 + (1.0 - a) ** 0.5 * noise
