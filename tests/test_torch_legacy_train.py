"""PyTorch port, the legacy LDM family's training step against the JAX
package on the CPU at tiny size (float32, random weights on every leaf,
carried across by ``bridge.from_jax_params``):

* ``cli/train_legacy.make_legacy_trainer`` on ``configs/tiny_legacy_bert.yaml``
  with ``cond_stage_trainable: true`` and a ``LambdaLinearScheduler``: three
  steps with EMA (BERT cut to one layer and the UNet to one level, for the
  JAX compile's sake; the port's step takes the images
  and encodes them inside, the JAX step takes the latents, here the port's
  encode of the same images, which ``test_torch_legacy_models`` holds to
  the JAX encode).  The JAX trainer draws
  t and eps itself: its module's ``jax`` is swapped for a shim whose
  ``random`` returns the port's draws of the step (keyed by the step's key),
  and its ``optax.adamw`` for one chained behind ``stash_grads``, so that one
  compiled step gives the raw gradients too.  Each step's loss within 1e-5
  (relative); the UNet's and BERT's gradients of the first step within 1e-4
  of each leaf's largest entry (a leaf whose gradient is rounding noise on
  both sides -- a conv bias that the next GroupNorm, one channel a group at
  32 channels, cancels -- below 1e-6 of the largest gradient of all); the
  parameters after each AdamW update at
  the schedule's rate, and the EMA copies, within 2e-2 of the rate per step
  taken (where the first step's gradient is below 1e-6, 100 x Adam's eps,
  under 5 % of the entries, within 2 x the rate per step: there Adam's
  update turns on the gradient's rounding);
* ``LegacyLDM.make_train_step`` on a concat config with the l1 loss
  (``override_t`` / ``override_noise``; the UNet cut to one level as above):
  loss, UNet gradients and the parameters after one AdamW update, to the
  same limits.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from celebbasis_tpu import legacy as jlegacy
from celebbasis_tpu.cli import train_legacy as jtrain
from celebbasis_tpu.core.losses import ema_init, ema_update
from celebbasis_tpu_torch import legacy as tlegacy
from celebbasis_tpu_torch.cli import train_legacy as ttrain
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (assert_adamw_close,  # noqa: F401
                                 assert_trained_grads_close, np_tree,
                                 one_blas_thread, random_params,
                                 stash_grads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2


def _cfg(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        return yaml.safe_load(f)


def _one_level(mp):
    """The config's UNet cut to one level of 64 channels (two a GroupNorm
    group) whose only attention is the middle block's: the JAX compile of a
    train step over two levels takes twice as long."""
    mp["unet_config"]["params"].update(model_channels=64, channel_mult=[1],
                                       attention_resolutions=[4])


def _both(cfg, seed=0):
    jl = jlegacy.build_legacy_ldm(cfg, dtype=jnp.float32)
    params = random_params(jl.init_params, jax.random.key(0), seed=seed)
    tl = tlegacy.build_legacy_ldm(cfg, dtype=torch.float32, device="cpu")
    tl.load_state_dict(bridge.from_jax_params(np_tree(params)), strict=True)
    return jl, params, tl


def _named(prefix, module):
    return {f"{prefix}.{n}": p for n, p in module.named_parameters()}


def test_legacy_trainer_bert_trainable_three_steps_with_ema(monkeypatch):
    cfg = _cfg("tiny_legacy_bert.yaml")
    mp = cfg["model"]["params"]
    mp["cond_stage_trainable"] = True
    mp["cond_stage_config"]["params"]["n_layer"] = 1
    _one_level(mp)
    mp["scheduler_config"] = {
        "target": "ldm.lr_scheduler.LambdaLinearScheduler",
        "params": {"warm_up_steps": [2], "cycle_lengths": [10],
                   "f_start": [0.5], "f_max": [1.0], "f_min": [0.1],
                   "verbosity_interval": 0}}
    jl, params, tl = _both(cfg, seed=3)
    r = np.random.default_rng(0)
    images = r.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    caps = ["a photo number 1", "a red car"]

    # the port: three steps from its own draws
    ema = ttrain.make_ema(tl.unet)
    tr = ttrain.make_legacy_trainer(tl, cfg, B, ema=ema,
                                    generator=torch.Generator().manual_seed(5))
    assert tr.cond_trainable
    ids = tl.conditioning_input(caps)
    x = torch.from_numpy(images)
    z_shape = tr.latent_shape(x)
    gen = torch.Generator().manual_seed(9)
    ts, ns = [], []
    for _ in range(3):
        t, n = tl.draw_t_noise(torch.empty(z_shape), gen)
        ts.append(t)
        ns.append(n)
    rates = [float(tr.schedule(k)) for k in range(3)]
    losses, grads = [], None
    for k in range(3):
        losses.append(float(tr.step(x, ids, t=ts[k], noise=ns[k])))
        assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(tr.schedule(k + 1)))
        if k == 0:
            grads = {n: p.grad.clone() for n, p in {
                **_named("unet", tl.unet),
                **_named("cond_stage", tl.cond_stage)}.items()}
            after1 = {n: p.detach().clone() for n, p in {
                **_named("unet", tl.unet),
                **_named("cond_stage", tl.cond_stage)}.items()}

    # the JAX trainer, handed the same draws
    t_tab = jnp.asarray(np.stack([t.numpy() for t in ts]).astype(np.int32))
    n_tab = jnp.asarray(np.stack([n.numpy() for n in ns]))
    pick = lambda key, tab: tab[jax.random.key_data(key)[-1]]
    shim = types.SimpleNamespace(
        jit=jax.jit, value_and_grad=jax.value_and_grad,
        random=types.SimpleNamespace(
            split=lambda k: (k, k),
            randint=lambda k, shape, lo, hi: pick(k, t_tab),
            normal=lambda k, shape: pick(k, n_tab)))
    oshim = types.SimpleNamespace(
        adamw=lambda *a, **kw: optax.chain(stash_grads(),
                                           optax.adamw(*a, **kw)),
        apply_updates=optax.apply_updates)
    monkeypatch.setattr(jtrain, "jax", shim)
    monkeypatch.setattr(jtrain, "optax", oshim)
    step, init_opt, cond_trainable = jtrain.make_legacy_trainer(jl, cfg, B)
    assert cond_trainable
    opt = jax.jit(init_opt)(params)
    jema = ema_init(params["unet"])
    with torch.no_grad():
        z = jnp.asarray(tl.encode_first_stage(x).numpy())
    jids = jnp.asarray(ids.numpy().astype(np.int32))
    for k in range(3):
        params, opt, loss = step(params, opt, z, jids, jax.random.key(k))
        jema = jax.jit(ema_update)(jema, params["unet"])
        assert abs(losses[k] - float(loss)) <= 1e-5 * abs(float(loss)), k
        if k == 0:
            jgrads = bridge.from_jax_params(np_tree(opt[0]))
            assert_trained_grads_close(grads, jgrads)
            assert_adamw_close(after1, bridge.from_jax_params(np_tree(
                {"unet": params["unet"], "cond_stage":
                 params["cond_stage"]})), rates[0], jgrads)
    lr_max = max(rates)
    now = {**_named("unet", tl.unet), **_named("cond_stage", tl.cond_stage)}
    assert_adamw_close(now, bridge.from_jax_params(np_tree(
        {"unet": params["unet"], "cond_stage": params["cond_stage"]})),
        lr_max, jgrads, steps=3)
    assert int(ema.num_updates) == int(jema.num_updates) == 3
    unet_grads = {k[5:]: v for k, v in jgrads.items()
                  if k.startswith("unet.")}
    assert_adamw_close(ema.params, bridge.from_jax_params(np_tree(
        jema.params)), lr_max, unet_grads, steps=3)


def test_make_train_step_concat_l1():
    cfg = _cfg("tiny_legacy.yaml")
    mp = cfg["model"]["params"]
    mp["loss_type"] = "l1"
    mp["conditioning_key"] = "concat"
    mp["cond_stage_config"] = {"target": "torch.nn.Identity"}
    mp["unet_config"]["params"]["in_channels"] = 6
    _one_level(mp)
    jl, params, tl = _both(cfg, seed=4)
    assert (jl.cond_kind, jl.cond_mode, tl.cond_mode) == \
        ("identity", "concat", "concat")
    r = np.random.default_rng(1)
    z = r.standard_normal((B, 16, 16, 3)).astype(np.float32)
    ctx = r.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    t = np.array([5, 51], np.int32)
    noise = r.standard_normal((B, 16, 16, 3)).astype(np.float32)
    lr = 1e-3

    opt = torch.optim.AdamW(tl.unet.parameters(), lr=lr, weight_decay=1e-2)
    tstep = tl.make_train_step(opt)
    loss = float(tstep(torch.from_numpy(z), torch.from_numpy(ctx),
                       override_t=torch.from_numpy(t).long(),
                       override_noise=torch.from_numpy(noise)))
    grads = {n: p.grad.clone() for n, p in _named("unet", tl.unet).items()}

    tx = optax.chain(stash_grads(), optax.adamw(lr, weight_decay=1e-2))
    jstep = jax.jit(jl.make_train_step(tx))
    new, jopt, jloss = jstep(params, tx.init(params["unet"]),
                             jnp.asarray(z), jnp.asarray(ctx),
                             jax.random.key(0), jnp.asarray(t),
                             jnp.asarray(noise))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    jgrads = bridge.from_jax_params(np_tree({"unet": jopt[0]}))
    assert_trained_grads_close(grads, jgrads)
    assert_adamw_close(_named("unet", tl.unet), bridge.from_jax_params(
        np_tree({"unet": new["unet"]})), lr, jgrads)
