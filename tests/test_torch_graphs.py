"""PyTorch port: what the captured paths (``utils/graphs.py``) rest on, on
the CPU.

* ``core.manager.momentum_update`` without a host sync, against the JAX
  ``lax.scan`` on a repeated id and a masked entry; the whole training
  injection runs on the ``meta`` device, where any read of a value on the
  host raises;
* the DDIM chain with its draws taken before the chain (``step_noise``)
  equal, bit for bit, to a chain that draws at each step in the per-row
  order it replaces, at eta > 0; the DDPM chain in captured segments, each
  segment's noise drawn before it, equal to the per-step chain it
  replaces, snapshots included;
* the train step's draws (``draw_step_noise``) equal to those the loss would
  take from the same generator;
* AdamW's state and the gradients allocated up front (``allocate_state``)
  give the step the lazily made state gives, bit for bit;
* on CPU tensors a captured function runs eagerly and builds no graph.

fp32 on the CPU.  Everything here is exact (``torch.equal``) except the
comparison with JAX (1e-6: the same float32 arithmetic in two frameworks).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.core import manager as jmgr
from celebbasis_tpu_torch.core import manager as tmgr
from celebbasis_tpu_torch.diffusion import sampler as tsampler
from celebbasis_tpu_torch.diffusion import schedules as tsched
from celebbasis_tpu_torch.train import step as tstep
from celebbasis_tpu_torch.utils import bridge, graphs

from _torch_port_helpers import t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

KW = dict(placeholder_token_ids=(500, 501, 502), max_ids=4, num_es=2, heads=1,
          inner_dim=8, token_dim=16, momentum=0.9)


def _manager_inputs(seed=3):
    r = np.random.default_rng(seed)
    emb = r.standard_normal((4, 2, 16)).astype(np.float32)
    coeff = r.standard_normal((4, 2, 1, 8)).astype(np.float32)
    z = r.standard_normal((6, 2, 16)).astype(np.float32)
    c = r.standard_normal((6, 2, 1, 8)).astype(np.float32)
    # id 2 three times (compounding), id 0 once; entries 1 and 4 masked
    ids = np.array([2, 3, 2, 0, 2, 1])
    valid = np.array([True, False, True, True, False, True])
    return emb, coeff, z, c, ids, valid


def test_momentum_update_sync_free_matches_jax():
    emb, coeff, z, c, ids, valid = _manager_inputs()
    ref = jmgr.momentum_update(
        jmgr.ManagerConfig(**KW), jmgr.ManagerState(jnp.asarray(emb),
                                                     jnp.asarray(coeff)),
        jnp.asarray(z), jnp.asarray(c), jnp.asarray(ids), jnp.asarray(valid))
    cfg = tmgr.ManagerConfig(**KW)
    got = tmgr.momentum_update(cfg, tmgr.ManagerState(t(emb), t(coeff)),
                               t(z), t(c), t(ids).long(), t(valid))
    for a, b in zip(bridge.manager_state_to_numpy(got), ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    m = 0.9
    want = m * (m * emb[2] + (1 - m) * z[0]) + (1 - m) * z[2]
    np.testing.assert_allclose(got.id_embeddings[2].numpy(), want, atol=1e-6)
    assert np.array_equal(got.id_embeddings[3].numpy(), emb[3])  # masked

    # on the meta device every host read (.item(), .tolist(), a Python if
    # on a tensor) raises: the update and the injection need none
    meta = lambda a: t(a).to("meta")
    state = tmgr.ManagerState(meta(emb), meta(coeff))
    out = tmgr.momentum_update(cfg, state, meta(z), meta(c),
                               meta(ids).long(), meta(valid))
    assert out.id_embeddings.device.type == "meta"
    tokens = torch.zeros((3, 12), dtype=torch.int64, device="meta")
    new_embeds, new_state = tmgr.train_inject(
        cfg, state, tokens, torch.zeros((3, 12, 16), device="meta"),
        meta(z.reshape(3, 2, 2, 16)), meta(c.reshape(3, 2, 2, 1, 8)),
        meta(ids.reshape(3, 2)).long(),
        torch.ones(3, dtype=torch.int64, device="meta"))
    assert new_embeds.shape == (3, 12, 16)
    assert new_state.id_coefficients.shape == (4, 2, 1, 8)


def _toy_eps(x, ts, cond):
    """A deterministic stand-in for the UNet: depends on x, t and cond."""
    return 0.3 * x + 1e-3 * ts.float()[:, None, None, None] \
        + cond.mean(dim=(1, 2))[:, None, None, None]


def _per_step_chain(generators, ddim, shape, cond, uncond, cfg):
    """The chain as it drew before: x_T, then each step's noise drawn at
    that step, row i from generator i."""
    x = tsampler.batched_normal(generators, shape, cond.device)
    eps_fn = tsampler._eps_fn(_toy_eps, cond, uncond, cfg, shape[0])
    for ts, a_t, a_prev, sqrt_oma, sigma in tsampler.step_constants(ddim):
        eps = eps_fn(x, ts)
        noise = 0.0
        if sigma > 0.0:
            noise = tsampler.batched_normal(generators, shape,
                                            cond.device) * cfg.temperature
        x, _ = tsampler.ddim_step(x, eps, a_t, a_prev, sqrt_oma, sigma,
                                  noise)
    return x


def test_ddim_predrawn_noise_equals_per_step_draws():
    for eta, temperature in ((0.5, 1.0), (1.0, 0.7)):
        _check_predrawn_chain(eta, temperature)


def _check_predrawn_chain(eta, temperature):
    ddim = tsched.make_ddim_schedule(tsched.make_schedule(), 6, eta)
    shape = (2, 4, 4, 4)
    r = np.random.default_rng(1)
    cond = t(r.standard_normal((2, 5, 8)).astype(np.float32))
    uncond = t(r.standard_normal((2, 5, 8)).astype(np.float32))
    cfg = tsampler.SamplerConfig(guidance_scale=3.0, eta=eta,
                                 temperature=temperature)
    gens = lambda: [torch.Generator().manual_seed(s) for s in (7, 8)]
    ref = _per_step_chain(gens(), ddim, shape, cond, uncond, cfg)
    kw = dict(shape=shape, cond=cond, uncond=uncond, cfg=cfg)
    got = tsampler.ddim_sample(_toy_eps, ddim, generators=gens(), **kw)
    assert torch.equal(got, ref)
    # the draws passed in as tensors: the chain itself draws nothing
    g = gens()
    x_T = tsampler.batched_normal(g, shape, "cpu")
    noise = tsampler.step_noise(g, ddim, shape, "cpu")
    assert noise.shape == (6,) + shape
    given = tsampler.ddim_sample(_toy_eps, ddim, generators=None, x_T=x_T,
                                 noise=noise, **kw)
    assert torch.equal(given, ref)
    # a row's result depends on its own generator only
    alone = tsampler.ddim_sample(
        _toy_eps, ddim, generators=gens()[1:], shape=(1,) + shape[1:],
        cond=cond[1:], uncond=uncond[1:], cfg=cfg)
    assert torch.equal(alone[0], ref[1])
    at_zero = tsched.make_ddim_schedule(tsched.make_schedule(), 6, 0.0)
    assert tsampler.step_noise(gens(), at_zero, shape, "cpu") is None


def _per_step_ddpm(generators, sched, shape, cond, uncond, cfg, every):
    """The DDPM chain as it ran before its segments: Python-float constants,
    each step's noise drawn at that step, row i from generator i."""
    f32 = lambda a: [float(v) for v in np.asarray(a, np.float32)]
    c1, c2 = f32(sched.posterior_mean_coef1), f32(sched.posterior_mean_coef2)
    sigma = f32(np.exp(0.5 * np.asarray(sched.posterior_log_variance_clipped,
                                        np.float32)))
    sr = f32(sched.sqrt_recip_alphas_cumprod)
    srm1 = f32(sched.sqrt_recipm1_alphas_cumprod)
    T = sched.num_timesteps
    x = tsampler.batched_normal(generators, shape, cond.device)
    eps_fn = tsampler._eps_fn(_toy_eps, cond, uncond, cfg, shape[0])
    snaps = []
    for i, ts in enumerate(range(T - 1, -1, -1)):
        eps = eps_fn(x, ts)
        x0 = (sr[ts] * x - srm1[ts] * eps).clamp(-1.0, 1.0)
        x = c1[ts] * x0 + c2[ts] * x
        if ts > 0 and cfg.temperature != 0.0:
            x = x + sigma[ts] * (tsampler.batched_normal(
                generators, shape, cond.device) * cfg.temperature)
        if (i + 1) % every == 0 or i == T - 1:
            snaps.append(x0)
    return x, torch.stack(snaps)


@pytest.mark.parametrize("temperature", [1.0, 0.7, 0.0])
def test_ddpm_segments_equal_per_step_draws(temperature):
    """A 45-step chain in segments of 20 (two full segments and a tail of
    5) with each segment's noise drawn before it, and its snapshots every
    15 steps across the segments' bounds, equal the per-step chain bit for
    bit; the steps' timesteps and constants reach a segment as tensors, so
    the full segments share one signature."""
    assert tsampler.DDPM_SEGMENT == 20
    sched = tsched.make_schedule(n_timestep=45)
    shape = (2, 4, 4, 4)
    r = np.random.default_rng(2)
    cond = t(r.standard_normal((2, 5, 8)).astype(np.float32))
    uncond = t(r.standard_normal((2, 5, 8)).astype(np.float32))
    cfg = tsampler.SamplerConfig(guidance_scale=3.0, temperature=temperature)
    gens = lambda: [torch.Generator().manual_seed(s) for s in (7, 8)]
    ref_x, ref_snaps = _per_step_ddpm(gens(), sched, shape, cond, uncond,
                                      cfg, 15)
    chain = tsampler.DDPMChain(_toy_eps, sched, cfg)
    seen = []
    real = chain.segment.eager
    chain.segment.eager = lambda *a: seen.append(a[3:5]) or real(*a)
    kw = dict(shape=shape, cond=cond, uncond=uncond, return_x0_every=15)
    x, snaps = chain(generators=gens(), **kw)
    assert torch.equal(x, ref_x) and torch.equal(snaps, ref_snaps)
    assert snaps.shape == (3,) + shape
    assert [tuple(c.shape) for ts, c in seen] == [(20, 5), (20, 5), (5, 5)]
    assert [ts.tolist() for ts, _ in seen][-1] == [4, 3, 2, 1, 0]
    assert all(ts.dtype == torch.int64 for ts, _ in seen)
    assert chain.segment.capture_s == {}       # CPU: no graph
    chain.segment.eager = real
    eager_x = chain.eager(generators=gens(), **kw)[0]
    plain = tsampler.ddpm_sample(_toy_eps, sched, generators=gens(),
                                 shape=shape, cond=cond, uncond=uncond,
                                 cfg=cfg)
    assert torch.equal(eager_x, ref_x) and torch.equal(plain, ref_x)


def test_step_draws_follow_the_loss_order():
    """``draw_step_noise`` takes posterior noise, t and eps from the
    generator in the order the loss took them, and keeps given draws."""
    pipe = types.SimpleNamespace(cfg=types.SimpleNamespace(
        scale_factor=0.18215, timesteps=1000))
    sched = tstep.ddpm.ScheduleArrays.from_schedule(
        tsched.make_schedule(), "cpu")
    shape = (2, 4, 4, 4)
    r = np.random.default_rng(2)
    mean = t(r.standard_normal(shape).astype(np.float32))
    logvar = t(r.standard_normal(shape).astype(np.float32) * 0.1)
    ref = tstep.noisy_latents(pipe, sched, {}, torch.Generator().manual_seed(
        5), mean, logvar)
    drawn = tstep.draw_step_noise({}, torch.Generator().manual_seed(5), shape,
                                  1000, "cpu")
    got = tstep.noisy_latents(pipe, sched, drawn, None, mean, logvar)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    given = {"override_t": torch.tensor([3, 4])}
    kept = tstep.draw_step_noise(given, torch.Generator().manual_seed(5),
                                 shape, 1000, "cpu")
    assert kept["override_t"] is given["override_t"]
    assert set(kept) == {"override_znoise", "override_t", "override_noise"}


@pytest.mark.parametrize("accumulate", [1, 3])
def test_allocated_state_steps_like_lazy_state(accumulate):
    """AdamW (and the accumulation wrapper) from state allocated up front
    and gradients zeroed in place, against the lazily made state and
    gradients set to None: the same parameters, bit for bit."""
    r = np.random.default_rng(4)
    w0 = t(r.standard_normal((5, 3)).astype(np.float32))
    grads = [t(r.standard_normal((5, 3)).astype(np.float32))
             for _ in range(2 * accumulate)]

    def run(allocate):
        w = torch.nn.Parameter(w0.clone())
        opt = tstep.make_optimizer({"meta": [w]}, lr=0.1,
                                   accumulate=accumulate)
        if allocate:
            tstep.allocate_state(getattr(opt, "inner", opt))
        for g in grads:
            opt.zero_grad(set_to_none=not allocate)
            (w * g).sum().backward()
            opt.step()
        return w.detach(), tstep.written_in_place(opt)

    lazy, _ = run(False)
    allocated, written = run(True)
    assert torch.equal(allocated, lazy)
    # parameter, gradient, step, two moments (+ the accumulator and count)
    assert len(written) == 5 + 2 * (accumulate > 1)


def test_cpu_call_runs_eagerly_and_builds_no_graph():
    calls = []

    def fn(x, pair, scale):
        calls.append(scale)
        return {"y": x * scale + pair[0] - pair[1]}

    captured = graphs.Captured(fn)
    x, pair = torch.arange(4.0), (torch.ones(4), torch.full((4,), 2.0))
    out = captured(x, pair, 3.0)
    assert torch.equal(out["y"], fn(x, pair, 3.0)["y"])
    assert calls == [3.0, 3.0] and captured.eager is fn
    assert captured.capture_s == {} and captured.launches_per_replay() == {}
    with pytest.raises(ValueError, match="one CUDA device"):
        graphs.Captured(fn)(x.to("meta"), pair, 1.0)
