"""PyTorch port, the noisy-latent classifier and its trunk, and the UNet's
dropout, against the JAX package on the CPU at tiny size (float32, random
weights on every leaf carried across by ``bridge.from_jax_params``):

* ``EncoderUNetModel`` with the ``'adaptive'``, ``'attention'``
  (``AttentionPool2d``), ``'spatial'`` and ``'spatial_v2'`` heads: logits
  within 1e-4 of the largest;
* ``NoisyLatentClassifier`` (``'attention'`` head, so ``AttentionPool2d``)
  one train step from ``t_override`` / ``noise_override``: loss 1e-5
  (relative), top-1 / top-k accuracies equal, gradients within 1e-4 of each
  leaf's largest entry and the parameters after AdamW within 2e-2 lr
  (``assert_trained_grads_close`` / ``assert_adamw_close`` of
  ``_torch_port_helpers``: leaves of rounding noise and entries whose
  gradient nears Adam's eps apart); the noise sweep's levels and keys, a
  level of its eval step equal to the shared step there; the draws taken
  before the step (t, then the q-noise) in the generator's order;
* dropout: ``p = 0`` in training mode and ``p > 0`` in ``eval()`` give the
  JAX UNet's output (whose dropout is deterministic); at ``p > 0`` in
  training mode one seed gives the same masks twice, another seed others,
  and the kept share of a large tensor is within 3 sigma of 1 - p.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celebbasis_tpu.models import unet as junet
from celebbasis_tpu.train import classifier as jclf
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.train import classifier as tclf
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (assert_adamw_close,  # noqa: F401
                                 assert_trained_grads_close,
                                 compiled_optimizer, np_tree,
                                 one_blas_thread, random_params)

KEY = jax.random.key(0)
SIDE, CLASSES = 8, 5


def _trunk_cfgs():
    """A one-level trunk of 64 channels whose one AttentionBlock is the
    middle block's (a JAX compile of two levels takes twice as long)."""
    kw = dict(in_channels=4, out_channels=CLASSES, model_channels=64,
              channel_mult=(1,), num_res_blocks=1,
              attention_resolutions=(), num_head_channels=16,
              use_spatial_transformer=False)
    return junet.UNetConfig(**kw), tunet.UNetConfig(**kw)


def _close(got, ref, rel=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(got - ref).max()) <= rel * scale


def test_encoder_unet_pools_match_jax():
    jcfg, tcfg = _trunk_cfgs()
    r = np.random.default_rng(0)
    x = r.standard_normal((2, SIDE, SIDE, 4)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    for seed, pool in enumerate(("adaptive", "attention", "spatial",
                                 "spatial_v2")):
        jm = junet.EncoderUNetModel(jcfg, image_size=SIDE, pool=pool,
                                    dtype=jnp.float32)
        params = random_params(jm.init, KEY, jnp.asarray(x), jnp.asarray(t),
                               seed=seed)
        ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t))
        tm = tunet.EncoderUNetModel(tcfg, image_size=SIDE, pool=pool,
                                    dtype=torch.float32)
        tm.load_state_dict(bridge.from_jax_params(np_tree(params)),
                           strict=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.from_numpy(t).long())
        assert got.dtype == torch.float32
        _close(got.numpy(), ref)


def test_classifier_step_matches_jax(monkeypatch):
    jcfg, tcfg = _trunk_cfgs()
    kw = dict(num_classes=CLASSES, image_size=SIDE, pool="attention",
              timesteps=100)
    jc = jclf.NoisyLatentClassifier(jclf.ClassifierConfig(
        unet=dataclasses.replace(jcfg, in_channels=4, out_channels=4), **kw),
        dtype=jnp.float32)
    tc = tclf.NoisyLatentClassifier(tclf.ClassifierConfig(
        unet=dataclasses.replace(tcfg, in_channels=4, out_channels=4), **kw),
        dtype=torch.float32, device="cpu")
    params = random_params(jc.init, KEY, seed=7)
    tc.model.load_state_dict(bridge.from_jax_params(np_tree(params)),
                             strict=True)
    assert isinstance(tc.model.attn_pool, tunet.AttentionPool2d)
    r = np.random.default_rng(1)
    z = r.standard_normal((4, SIDE, SIDE, 4)).astype(np.float32)
    labels = np.array([0, 3, 4, 1], np.int32)
    t = np.array([0, 10, 50, 99], np.int32)
    noise = r.standard_normal(z.shape).astype(np.float32)
    lr = 1e-3

    state = tc.init_state(lr=lr)
    before = {n: p.detach().clone() for n, p in tc.model.named_parameters()}
    state, log = tc.train_step(state, torch.from_numpy(z),
                               torch.from_numpy(labels).long(),
                               t_override=torch.from_numpy(t),
                               noise_override=torch.from_numpy(noise))
    grads = {n: p.grad for n, p in tc.model.named_parameters()}

    # the JAX trainer's optimizer, compiled
    make = jc.make_optimizer
    monkeypatch.setattr(jc, "make_optimizer",
                        lambda *a, **k: compiled_optimizer(make(*a, **k)))
    monkeypatch.setattr(optax, "apply_updates", jax.jit(optax.apply_updates))
    jstate = jc.init_state(params, lr=lr)
    args = (jnp.asarray(z), jnp.asarray(labels), jax.random.key(1),
            jnp.asarray(t), jnp.asarray(noise))
    jloss, jlog, jgrads = jc._train_step(params, jstate["opt"], 0, *args)
    jstate, jlog2 = jc.train_step(jstate, *args)
    assert abs(float(log["train/loss"]) - float(jloss)) \
        <= 1e-5 * abs(float(jloss))
    for k in ("acc@1", "acc@5"):
        assert float(log[f"train/{k}"]) == float(jlog[k]), k
        assert float(jlog2[f"train/{k}"]) == float(jlog[k])
    jgrads = bridge.from_jax_params(np_tree(jgrads))
    assert_trained_grads_close(grads, jgrads)
    now = dict(tc.model.named_parameters())
    moved = max(float((now[n].detach() - before[n]).abs().max()) for n in now)
    assert 0.5 * lr < moved <= 1.1 * lr      # lr (1 + decay |p|) at most
    assert_adamw_close(now, bridge.from_jax_params(np_tree(
        jstate["params"])), lr, jgrads)

    sweep = tc.validate_noise_sweep(torch.from_numpy(z),
                                    torch.from_numpy(labels).long(),
                                    torch.Generator().manual_seed(0),
                                    log_every_t=40)
    assert sorted(sweep) == [0, 40, 80]
    assert all(set(v) == {"loss", "acc@1", "acc@5"} for v in sweep.values())
    assert all(0.0 <= v["acc@1"] <= v["acc@5"] <= 1.0 for v in sweep.values())
    # the sweep's eval step takes its level as a tensor: the shared step at
    # that level, from the sweep's one noise draw
    tz, tl = torch.from_numpy(z), torch.from_numpy(labels).long()
    q = torch.randn(z.shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, at80 = tc.shared(tz, tl, torch.full((4,), 80), q)
    assert {k: float(v) for k, v in at80.items()} == sweep[80]
    assert tc.eval_step.capture_s == {} == state["graph"].capture_s  # CPU

    # the draws, taken before the step: t first, then the q-noise
    g = torch.Generator().manual_seed(3)
    want_t = torch.randint(0, 100, (4,), generator=g)
    want_noise = torch.randn(z.shape, generator=g)
    got_t, got_noise = tc.draw_t_noise(tz, torch.Generator().manual_seed(3))
    assert torch.equal(got_t, want_t) and torch.equal(got_noise, want_noise)


def test_dropout():
    tiny, ttiny = (dataclasses.replace(c, out_channels=4)
                   for c in _trunk_cfgs())
    jcfg = dataclasses.replace(tiny, dropout=0.3)
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    jm = junet.UNetModel(jcfg, jnp.float32)
    params = random_params(jm.init, KEY, x, t, None, seed=2)
    ref = jax.jit(jm.apply)(params, x, t, None)
    args = (torch.from_numpy(x), torch.from_numpy(t).long(), None)
    state = bridge.from_jax_params(np_tree(params))

    def port(p):
        m = tunet.UNetModel(dataclasses.replace(ttiny, dropout=p),
                            torch.float32)
        m.load_state_dict(state, strict=True)
        return m

    off = port(0.0).train()
    with torch.no_grad():
        _close(off(*args).numpy(), ref)        # no generator needed at p 0
    on = port(0.3)
    with torch.no_grad():
        _close(on.eval()(*args).numpy(), ref)
    on.train()
    with pytest.raises(ValueError, match="generator"):
        on(*args)
    outs = []
    for seed in (11, 11, 12):
        tunet.set_dropout_generator(on, torch.Generator().manual_seed(seed))
        outs.append(on(*args).detach())
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert not torch.allclose(outs[0], torch.from_numpy(np.array(ref)))
    assert tunet.dropout_generators(on) == [on.down_0_res_0.generator]
    with torch.no_grad():             # no grad: off in training mode too
        _close(on(*args).numpy(), ref)

    p, n = 0.3, 200_000
    h = torch.ones(n)
    kept = tunet.dropout(h, p, torch.Generator().manual_seed(0))
    share = float((kept != 0).float().mean())
    assert abs(share - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    assert torch.allclose(kept[kept != 0], torch.full((1,), 1 / (1 - p)))
