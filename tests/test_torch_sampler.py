"""PyTorch port, diffusion: schedules bit for bit, a 5-step DDIM chain with
classifier-free guidance against the JAX sampler, and row independence.

The eps model on both sides is the tiny UNet with carried-over weights; x_T
is given, so no random numbers are drawn.  fp32 on the CPU; 1e-4 on the final
latents (the UNet's 1e-4 per step, contracted by the DDIM update).
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
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_noise_schedule_bit_for_bit(kind):
    a = jsched.make_schedule(kind, 1000)
    b = tsched.make_schedule(kind, 1000)
    for name in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("steps,eta,method", [(50, 0.0, "uniform"),
                                              (5, 0.3, "uniform"),
                                              (20, 0.0, "quad")])
def test_ddim_schedule_bit_for_bit(steps, eta, method):
    a = jsched.make_ddim_schedule(jsched.make_schedule(), steps, eta, method)
    b = tsched.make_ddim_schedule(tsched.make_schedule(), steps, eta, method)
    for name in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert b.num_steps == steps


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
    apply = jax.jit(jm.apply)     # one compile; eager dispatch is slower
    return (lambda x, ts, c: apply(params, x, ts, c)), tm


def _inputs(B=2, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, 8, 8, 4)).astype(np.float32),
            r.standard_normal((B, 77, 64)).astype(np.float32),
            r.standard_normal((B, 77, 64)).astype(np.float32))


def test_guided_eps_uncond_rows_first(eps_pair):
    jeps, teps = eps_pair
    x, cond, uncond = _inputs()
    ts = np.array([300, 300], np.int32)
    ref = np.asarray(jsampler.guided_eps(
        jeps, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(cond),
        jnp.asarray(uncond), 10.0))
    got = tsampler.guided_eps(teps, t(x), t(ts).long(), t(cond), t(uncond),
                              10.0).numpy()
    # 1e-3: the guidance scale multiplies the UNet's 1e-4 by 10
    np.testing.assert_allclose(got, ref, atol=1e-3)
    swapped = tsampler.guided_eps(teps, t(x), t(ts).long(), t(uncond),
                                  t(cond), 10.0).numpy()
    assert np.abs(swapped - ref).max() > 1e-2


def test_ddim_step():
    r = np.random.default_rng(5)
    x, eps, noise = (r.standard_normal((2, 4, 4, 4)).astype(np.float32)
                     for _ in range(3))
    args = (np.float32(0.5), np.float32(0.7), np.float32(0.5 ** 0.5),
            np.float32(0.1))
    jx, jx0 = jsampler.ddim_step(jnp.asarray(x), jnp.asarray(eps), *args,
                                 jnp.asarray(noise))
    tx, tx0 = tsampler.ddim_step(t(x), t(eps), *map(float, args), t(noise))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-6)


def test_five_step_cfg_chain_matches_jax(eps_pair):
    jeps, teps = eps_pair
    x_T, cond, uncond = _inputs(seed=6)
    cfg = dict(guidance_scale=5.0, eta=0.0)
    jd = jsched.make_ddim_schedule(jsched.make_schedule(), 5)
    td = tsched.make_ddim_schedule(tsched.make_schedule(), 5)
    ref = np.asarray(jsampler.ddim_sample(
        jeps, jd, rng=jax.random.key(0), shape=x_T.shape,
        cond=jnp.asarray(cond), uncond=jnp.asarray(uncond),
        cfg=jsampler.SamplerConfig(**cfg), x_T=jnp.asarray(x_T)))
    got = tsampler.ddim_sample(
        teps, td, generators=None, shape=x_T.shape, cond=t(cond),
        uncond=t(uncond), cfg=tsampler.SamplerConfig(**cfg), x_T=t(x_T))
    assert got.dtype == torch.float32
    assert np.abs(ref - x_T).max() > 0.1           # the chain moved
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_row_is_independent_of_cobatched_rows(eps_pair, eta):
    """Row 0 with its own generator gives the same latents whatever row 1
    is, both for the initial draw and for eta > 0 step noise."""
    _, teps = eps_pair
    _, cond, uncond = _inputs(seed=7)
    td = tsched.make_ddim_schedule(tsched.make_schedule(), 3, eta)
    cfg = tsampler.SamplerConfig(guidance_scale=3.0, eta=eta)
    gens = lambda *seeds: [torch.Generator().manual_seed(s) for s in seeds]
    run = lambda g, c: tsampler.ddim_sample(
        teps, td, generators=g, shape=(2, 8, 8, 4), cond=c, uncond=t(uncond),
        cfg=cfg)
    a = run(gens(11, 22), t(cond))
    other = t(cond).clone()
    other[1] = other[1].flip(0)
    b = run(gens(11, 33), other)
    # 1e-5, not 0: a BLAS call on another batch may block its sums otherwise
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-5)
    assert np.abs(a[1].numpy() - b[1].numpy()).max() > 1e-2
    with pytest.raises(ValueError):
        run(gens(1), t(cond))
