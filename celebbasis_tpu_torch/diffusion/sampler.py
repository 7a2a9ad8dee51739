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
a continuous batcher needs for reproducible results.  The DDIM and PLMS
chains draw everything before their first step (``x_T``, then
``step_noise``: each generator gives x_T first and then the steps' noise in
order, as a chain that drew at each step would), or take the draws as
tensors; the chain itself draws nothing, so that it can be captured in a
CUDA graph (``pipeline.py``).  The 1,000-step DDPM chain (``DDPMChain``) is
captured a segment at a time and draws each segment's noise just before
the segment runs.
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
    """t (a Python int, or a 0-d int64 tensor on x's device) and x -> eps,
    guided where the config asks for it."""
    use_cfg = uncond is not None and cfg.guidance_scale != 1.0

    def eps(x, t):
        tb = (t.expand(batch) if isinstance(t, torch.Tensor) else
              torch.full((batch,), t, dtype=torch.int64, device=x.device))
        if use_cfg:
            return guided_eps(eps_model, x, tb, cond, uncond,
                              cfg.guidance_scale)
        return eps_model(x, tb, cond)

    return eps


def step_noise(generators: Sequence[torch.Generator] | None,
               ddim: DDIMSchedule, shape, device) -> torch.Tensor | None:
    """The DDIM chain's step noise, drawn before the chain: (S', B, ...)
    standard normals for the S' steps whose sigma is above 0 (every step at
    eta > 0, none at eta 0), in the chain's order, row i from generator i;
    None when no step draws."""
    n = sum(1 for *_, sigma in step_constants(ddim) if sigma > 0.0)
    if n == 0:
        return None
    return torch.stack([batched_normal(generators, shape, device)
                        for _ in range(n)])


def ddim_sample(eps_model: EpsModel, ddim: DDIMSchedule, *,
                generators: Sequence[torch.Generator] | None, shape,
                cond: torch.Tensor, uncond: torch.Tensor | None = None,
                cfg: SamplerConfig = SamplerConfig(),
                x_T: torch.Tensor | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """Run the full DDIM chain; returns final latents (B, H, W, C), float32.

    ``x_T`` and ``noise`` (``step_noise``'s draws) are drawn from
    ``generators``, one per sample row, unless they are given; the chain
    then draws nothing.  ``generators`` may be None when both are given (or
    ``x_T`` is given at eta 0).
    """
    device = cond.device
    x = _start_latents(generators, shape, device, x_T)
    steps = step_constants(ddim)
    if noise is None:
        noise = step_noise(generators, ddim, shape, device)
    eps_fn = _eps_fn(eps_model, cond, uncond, cfg, shape[0])
    drawn = 0
    for t, a_t, a_prev, sqrt_oma, sigma in steps:
        eps = eps_fn(x, t)
        z = 0.0
        if sigma > 0.0:
            z = noise[drawn] * cfg.temperature
            drawn += 1
        x, _ = ddim_step(x, eps, a_t, a_prev, sqrt_oma, sigma, z)
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


DDPM_SEGMENT = 20   # guided steps a captured segment of the DDPM chain


class DDPMChain:
    """The full-chain ancestral DDPM sampler over a ``NoiseSchedule``: T
    posterior steps ``x_{t-1} ~ N(c1 x0 + c2 x_t, sigma_t^2)`` from the eps
    prediction, with optional x0 clipping and no noise at t = 0.

    The chain runs as segments of DDPM_SEGMENT guided steps, each one call
    of a captured function (``utils.graphs``): on a card one graph of
    DDPM_SEGMENT steps is captured at the first call and replayed
    T/DDPM_SEGMENT times, with a second graph for the tail where
    DDPM_SEGMENT does not divide T (the JAX package's segmented
    ``lax.scan``).  A segment takes
    its steps' timesteps and constants as device tensors, so every full
    segment has one signature.  Step noise is ``batched_normal(generators)
    * cfg.temperature`` at every step but the last (none at temperature 0);
    each segment's noise is drawn just before its call, in the order a
    chain drawing at each step would take it.  ``eager`` runs the same
    segments uncaptured.
    """

    def __init__(self, eps_model: EpsModel, sched: NoiseSchedule,
                 cfg: SamplerConfig = SamplerConfig(),
                 clip_denoised: bool = True):
        from celebbasis_tpu_torch.utils import graphs
        self.eps_model, self.cfg = eps_model, cfg
        self.clip_denoised = clip_denoised
        self.T = sched.num_timesteps
        self._ts = np.arange(self.T - 1, -1, -1)
        log_var = np.asarray(sched.posterior_log_variance_clipped, np.float32)
        # per step in chain order: sqrt(1/a), sqrt(1/a - 1), c1, c2, sigma
        self._consts = np.stack([
            np.asarray(a, np.float32)[self._ts] for a in (
                sched.sqrt_recip_alphas_cumprod,
                sched.sqrt_recipm1_alphas_cumprod,
                sched.posterior_mean_coef1, sched.posterior_mean_coef2,
                np.exp(0.5 * log_var))], axis=1)
        self.segment = graphs.Captured(self._segment)

    def _segment(self, x, cond, uncond, ts, consts, noise):
        """len(ts) steps from x -> (x, the steps' x0 predictions
        stacked)."""
        eps_fn = _eps_fn(self.eps_model, cond, uncond, self.cfg, x.shape[0])
        x0s = []
        for j in range(ts.shape[0]):
            sr, srm1, c1, c2, sigma = consts[j]
            eps = eps_fn(x, ts[j])
            x0 = sr * x - srm1 * eps
            if self.clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            x = c1 * x0 + c2 * x
            if noise is not None:       # zeros at t = 0: x + 0 is x
                x = x + sigma * (noise[j] * self.cfg.temperature)
            x0s.append(x0)
        return x, torch.stack(x0s)

    def __call__(self, **kw):
        """``(generators=..., shape=..., cond=..., uncond=None, x_T=None,
        return_x0_every=0)`` -> x, or ``(x, x0s)`` with
        ``return_x0_every=k``: x0s the x0 prediction at the end of every k
        steps (and of the last step), stacked."""
        return self._run(self.segment, **kw)

    def eager(self, **kw):
        """The same chain with its segments uncaptured (comparisons)."""
        return self._run(self.segment.eager, **kw)

    def _run(self, segment, *, generators, shape, cond, uncond=None,
             x_T=None, return_x0_every: int = 0):
        device = cond.device
        x = _start_latents(generators, shape, device, x_T)
        ts = torch.from_numpy(self._ts).to(device)
        consts = torch.from_numpy(self._consts).to(device)
        snaps = []
        for s in range(0, self.T, DDPM_SEGMENT):
            e = min(s + DDPM_SEGMENT, self.T)
            noise = None
            if self.cfg.temperature != 0.0:
                noise = torch.stack([
                    batched_normal(generators, shape, device) if t > 0
                    else torch.zeros(shape, device=device)
                    for t in self._ts[s:e]])
            x, x0s = segment(x, cond, uncond, ts[s:e], consts[s:e], noise)
            snaps += [x0s[i - s] for i in range(s, e)
                      if return_x0_every > 0 and (
                          (i + 1) % return_x0_every == 0 or i == self.T - 1)]
        if return_x0_every <= 0:
            return x
        return x, torch.stack(snaps)


def ddpm_sample(eps_model: EpsModel, sched: NoiseSchedule, *,
                generators: Sequence[torch.Generator] | None, shape,
                cond: torch.Tensor, uncond: torch.Tensor | None = None,
                cfg: SamplerConfig = SamplerConfig(),
                x_T: torch.Tensor | None = None,
                clip_denoised: bool = True, return_x0_every: int = 0):
    """One run of a :class:`DDPMChain` made for it (a caller that samples
    more than once keeps the chain, and so its graphs).  With
    ``return_x0_every=k`` returns ``(x, x0s)``, x0s the x0 prediction at
    the end of every k steps (and of the last step), stacked."""
    return DDPMChain(eps_model, sched, cfg, clip_denoised)(
        generators=generators, shape=shape, cond=cond, uncond=uncond,
        x_T=x_T, return_x0_every=return_x0_every)


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
