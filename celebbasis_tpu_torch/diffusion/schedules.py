"""Diffusion noise schedules and DDIM timestep subsets (host-side numpy).

The port's own copy of ``celebbasis_tpu/diffusion/schedules.py`` (the port
imports nothing of the JAX package); the arrays are equal bit for bit.

* linear beta schedule with sqrt-space interpolation:
  ``betas = linspace(sqrt(b0), sqrt(bT), T)**2`` with b0=0.00085, bT=0.0120,
  T=1000;
* uniform DDIM subset ``arange(0, T, T//S) + 1``;
* DDIM sigmas/alphas.

Everything here is tiny (length-1000 vectors) and precomputed once on the
host; the device sees only per-step constants.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed DDPM schedule arrays (float64 on host, cast at use site)."""
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)


def make_beta_schedule(schedule: str = "linear", n_timestep: int = 1000,
                       linear_start: float = 0.00085,
                       linear_end: float = 0.0120,
                       cosine_s: float = 8e-3) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


def make_schedule(schedule: str = "linear", n_timestep: int = 1000,
                  linear_start: float = 0.00085,
                  linear_end: float = 0.0120,
                  v_posterior: float = 0.0) -> NoiseSchedule:
    """Full DDPM schedule."""
    betas = make_beta_schedule(schedule, n_timestep, linear_start, linear_end)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    posterior_variance = ((1 - v_posterior) * betas * (1 - acp_prev) / (1 - acp)
                          + v_posterior * betas)
    return NoiseSchedule(
        betas=betas,
        alphas_cumprod=acp,
        alphas_cumprod_prev=acp_prev,
        sqrt_alphas_cumprod=np.sqrt(acp),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
        posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
        posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
    )


def ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int = 1000,
                   method: str = "uniform") -> np.ndarray:
    """Ascending DDPM-step indices used by DDIM: subset + 1."""
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        steps = np.arange(0, num_ddim_steps) * c
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8),
                             num_ddim_steps) ** 2).astype(int)
    else:
        raise ValueError(f"unknown discretization {method!r}")
    return steps + 1


@dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-index constants (ascending index order)."""
    timesteps: np.ndarray       # (S,) DDPM step fed to the UNet
    alphas: np.ndarray          # (S,) alpha_cumprod at those steps
    alphas_prev: np.ndarray     # (S,)
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


def make_ddim_schedule(sched: NoiseSchedule, num_steps: int, eta: float = 0.0,
                       method: str = "uniform") -> DDIMSchedule:
    ts = ddim_timesteps(num_steps, sched.num_timesteps, method)
    alphas = sched.alphas_cumprod[ts]
    alphas_prev = np.concatenate([[sched.alphas_cumprod[0]], alphas[:-1]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return DDIMSchedule(
        timesteps=ts,
        alphas=alphas,
        alphas_prev=alphas_prev,
        sqrt_one_minus_alphas=np.sqrt(1.0 - alphas),
        sigmas=sigmas,
    )
