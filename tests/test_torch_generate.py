"""PyTorch port, diffusion samplers beyond DDIM: a PLMS chain (all four
orders), the ancestral DDPM chain (with and without x0 snapshots) and
``stochastic_encode`` against the JAX sampler.

The eps model on both sides is the tiny UNet with carried-over weights, as in
``test_torch_sampler.py``; x_T is given and the DDPM temperature is 0, so
neither side draws.  fp32 on the CPU.  Latents agree within 1e-4 of their
rms (the UNet's 1e-4 per call, carried through the chain).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.diffusion import sampler as jsampler
from celebbasis_tpu.diffusion import schedules as jsched
from celebbasis_tpu.models import unet as junet
from celebbasis_tpu_torch.diffusion import sampler as tsampler
from celebbasis_tpu_torch.diffusion import schedules as tsched
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import np_tree, random_params, t

SCALE = 10.0


@pytest.fixture(scope="module")
def eps_pair():
    jm = junet.UNetModel(junet.UNetConfig.tiny(), jnp.float32)
    params = random_params(jm.init, jax.random.key(1),
                           jnp.zeros((1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                           seed=4)
    tm = tunet.UNetModel(tunet.UNetConfig.tiny(), torch.float32)
    bridge.load_jax_params(tm, np_tree(params))
    tm.requires_grad_(False).eval()
    apply = jax.jit(jm.apply)
    calls = []

    def counted(x, ts, c):
        calls.append(x.shape[0])
        return tm(x, ts, c)

    return (lambda x, ts, c: apply(params, x, ts, c)), counted, calls


def _inputs(B=2, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, 8, 8, 4)).astype(np.float32),
            r.standard_normal((B, 77, 64)).astype(np.float32),
            r.standard_normal((B, 77, 64)).astype(np.float32))


def _close(got, ref):
    rms = float(np.sqrt(np.mean(np.square(ref))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * rms)


def test_plms_chain_matches_jax(eps_pair):
    """Six steps: first order (two eps calls), then second, third and three
    fourth-order steps; num_steps + 1 guided UNet calls."""
    jeps, teps, calls = eps_pair
    x_T, cond, uncond = _inputs(seed=3)
    steps = 6
    jd = jsched.make_ddim_schedule(jsched.make_schedule(), steps)
    td = tsched.make_ddim_schedule(tsched.make_schedule(), steps)
    ref = np.asarray(jsampler.plms_sample(
        jeps, jd, rng=jax.random.key(0), shape=x_T.shape,
        cond=jnp.asarray(cond), uncond=jnp.asarray(uncond),
        cfg=jsampler.SamplerConfig(guidance_scale=SCALE),
        x_T=jnp.asarray(x_T)))
    calls.clear()
    got = tsampler.plms_sample(
        teps, td, generators=None, shape=x_T.shape, cond=t(cond),
        uncond=t(uncond), cfg=tsampler.SamplerConfig(guidance_scale=SCALE),
        x_T=t(x_T))
    assert calls == [4] * (steps + 1)        # [uncond; cond] rows each call
    assert got.dtype == torch.float32
    assert np.abs(ref - x_T).max() > 0.1
    _close(got.numpy(), ref)
    # the multi-step combination matters: DDIM on the same eps differs
    ddim = tsampler.ddim_sample(
        teps, td, generators=None, shape=x_T.shape, cond=t(cond),
        uncond=t(uncond), cfg=tsampler.SamplerConfig(guidance_scale=SCALE),
        x_T=t(x_T)).numpy()
    assert np.abs(ddim - ref).max() > 1e-2


def test_plms_draws_start_latents_per_row(eps_pair):
    _, teps, _ = eps_pair
    _, cond, uncond = _inputs(seed=4)
    td = tsched.make_ddim_schedule(tsched.make_schedule(), 2)
    gens = lambda *s: [torch.Generator().manual_seed(v) for v in s]
    run = lambda g: tsampler.plms_sample(
        teps, td, generators=g, shape=(2, 8, 8, 4), cond=t(cond),
        uncond=t(uncond), cfg=tsampler.SamplerConfig(guidance_scale=3.0))
    a, b = run(gens(5, 6)), run(gens(5, 7))
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-5)
    assert np.abs(a[1].numpy() - b[1].numpy()).max() > 1e-2


def test_ddpm_chain_matches_jax(eps_pair):
    """A 12-step schedule, CFG, x0 clipping; one JAX run with snapshots
    every 4 steps holds both port variants."""
    jeps, teps, calls = eps_pair
    x_T, cond, uncond = _inputs(seed=5)
    T, k = 12, 4
    ref_x, ref_snaps = jsampler.ddpm_sample(
        jeps, jsched.make_schedule(n_timestep=T), rng=jax.random.key(0),
        shape=x_T.shape, cond=jnp.asarray(cond), uncond=jnp.asarray(uncond),
        cfg=jsampler.SamplerConfig(guidance_scale=SCALE, temperature=0.0),
        x_T=jnp.asarray(x_T), return_x0_every=k)
    ref_x, ref_snaps = np.asarray(ref_x), np.asarray(ref_snaps)
    sched = tsched.make_schedule(n_timestep=T)
    kw = dict(generators=None, shape=x_T.shape, cond=t(cond),
              uncond=t(uncond), x_T=t(x_T),
              cfg=tsampler.SamplerConfig(guidance_scale=SCALE,
                                         temperature=0.0))
    calls.clear()
    got = tsampler.ddpm_sample(teps, sched, **kw)
    assert len(calls) == T
    got_x, got_snaps = tsampler.ddpm_sample(teps, sched, return_x0_every=k,
                                            **kw)
    assert ref_snaps.shape == tuple(got_snaps.shape) == (T // k,) + x_T.shape
    assert np.abs(ref_x - x_T).max() > 0.1
    _close(got.numpy(), ref_x)
    _close(got_x.numpy(), ref_x)
    _close(got_snaps.numpy(), ref_snaps)
    assert got_snaps.abs().max() <= 1.0      # x0 is clipped
    np.testing.assert_array_equal(got_snaps[-1].numpy(), got_x.numpy())


def test_ddpm_step_noise_per_row(eps_pair):
    _, teps, _ = eps_pair
    _, cond, _ = _inputs(seed=6)
    sched = tsched.make_schedule(n_timestep=3)
    gens = lambda *s: [torch.Generator().manual_seed(v) for v in s]
    run = lambda g, temp: tsampler.ddpm_sample(
        teps, sched, generators=g, shape=(2, 8, 8, 4), cond=t(cond),
        cfg=tsampler.SamplerConfig(temperature=temp))
    a, b = run(gens(1, 2), 1.0), run(gens(1, 3), 1.0)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-5)
    assert np.abs(a[1].numpy() - b[1].numpy()).max() > 1e-2
    # the temperature scales the step noise: 0 removes it
    cold = run(gens(1, 2), 0.0)
    assert np.abs(cold[0].numpy() - a[0].numpy()).max() > 1e-3


def test_stochastic_encode_matches_jax_and_is_per_row():
    r = np.random.default_rng(7)
    x0 = r.standard_normal((2, 4, 4, 4)).astype(np.float32)
    jd = jsched.make_ddim_schedule(jsched.make_schedule(), 10)
    td = tsched.make_ddim_schedule(tsched.make_schedule(), 10)
    key = jax.random.key(3)
    noise = np.asarray(jax.random.normal(key, x0.shape))
    for idx in (0, 4, 9):
        ref = np.asarray(jsampler.stochastic_encode(jnp.asarray(x0), idx, jd,
                                                    key))
        got = tsampler.stochastic_encode(t(x0), idx, td, noise=t(noise))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    gens = lambda *s: [torch.Generator().manual_seed(v) for v in s]
    a = tsampler.stochastic_encode(t(x0), 5, td, gens(1, 2))
    b = tsampler.stochastic_encode(t(x0), 5, td, gens(1, 3))
    alone = tsampler.stochastic_encode(t(x0[:1]), 5, td, gens(1))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[0].numpy(), alone[0].numpy())
    assert np.abs(a[1].numpy() - b[1].numpy()).max() > 1e-2
