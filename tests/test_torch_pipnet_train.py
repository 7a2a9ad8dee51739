"""PyTorch port, the PIPNet trainer (``align/pipnet_train.py``) against the
JAX package's, on the CPU at the tiny configuration (12 landmarks, 3
neighbours, 64x64, stride 32):

* ``gen_targets`` equal to JAX's, landmarks at 0 and 1 and outside [0, 1]
  included; ``pip_loss`` within 1e-6 (relative) of JAX's;
* ``augment`` bit for bit over seeds that take every branch;
* one train step from one random state (every leaf random, BatchNorm
  statistics included): loss and parts within 1e-5 (relative), the gradient
  of every leaf (``mean`` / ``var`` included) within 1e-4 of that leaf's
  largest entry, the parameters after Adam within 2e-2 * lr at every entry
  and 1e-4 * lr on average;
* the learning rate of every update around each schedule boundary equal to
  optax's piecewise-constant schedule, and 16 Adam updates with the
  ``from_scratch`` weight decay (coupled L2) and without it within 1e-4 * lr
  of optax's;
* the ``epoch%d.pth`` that ``fit_pipnet`` writes read back through the
  port's and the JAX package's ``convert_pipnet`` equals the trained state.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from celebbasis_tpu.align import pipnet as jpip
from celebbasis_tpu.align import pipnet_train as jpt
from celebbasis_tpu.utils import bridge_align as jba
from celebbasis_tpu_torch.align import pipnet as tpip
from celebbasis_tpu_torch.align import pipnet_train as tpt
from celebbasis_tpu_torch.utils import bridge, bridge_align

from _torch_port_helpers import (assert_adam_step_close, assert_grads_close,
                                 compiled_optimizer, np_tree, random_params,
                                 stash_grads)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

JCFG = jpip.PIPNetConfig.tiny()
TCFG = tpip.PIPNetConfig(**JCFG.__dict__)
B = 3


def _train_cfg(mod, **kw):
    return mod.PIPTrainConfig(num_lms=JCFG.num_lms, num_nb=JCFG.num_nb,
                              input_size=JCFG.input_size,
                              net_stride=JCFG.net_stride, batch_size=B, **kw)


def _landmarks(seed, n=B, L=JCFG.num_lms):
    """(n, L, 2) landmarks in [-0.05, 1.05], a few exactly at 0 and 1."""
    lms = np.random.default_rng(seed).uniform(-0.05, 1.05, (n, L, 2))
    lms[0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.5]]
    return lms.astype(np.float32)


def _nb_idx(seed=1):
    mf = np.random.default_rng(seed).uniform(0.1, 0.9, (JCFG.num_lms, 2))
    return tpt.forward_neighbors(mf, JCFG.num_nb), mf.astype(np.float32)


def test_gen_targets_and_loss_equal_jax():
    nb_idx, _ = _nb_idx()
    np.testing.assert_array_equal(
        nb_idx, jpt.forward_neighbors(_nb_idx()[1].astype(np.float64),
                                      JCFG.num_nb))
    for g in (2, 4, 7):
        lms = _landmarks(g)
        ref = jpt.gen_targets(jnp.asarray(lms), jnp.asarray(nb_idx), g)
        got = tpt.gen_targets(torch.from_numpy(lms),
                              torch.from_numpy(nb_idx), g)
        for r, o in zip(ref, got):
            assert tuple(o.shape) == r.shape
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # the loss on random heads against those targets
    g, L, nb = 4, JCFG.num_lms, JCFG.num_nb
    rng = np.random.default_rng(3)
    outputs = [rng.standard_normal((B, g, g, C)).astype(np.float32)
               for C in (L, L, L, L * nb, L * nb)]
    targets = [np.array(t) for t in jpt.gen_targets(
        jnp.asarray(_landmarks(4)), jnp.asarray(nb_idx), g)]
    jt, jparts = jpt.pip_loss([jnp.asarray(o) for o in outputs],
                              [jnp.asarray(t) for t in targets], nb)
    tt, tparts = tpt.pip_loss([torch.from_numpy(o) for o in outputs],
                              [torch.from_numpy(t) for t in targets], nb)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-6, err_msg=k)


def _branches(seed, flip):
    """Which of translate, occlusion, flip, rotate, blur and grayscale the
    chain takes for a seed: its gates replayed on the same generator."""
    r = np.random.default_rng(seed)
    took = []
    for name, draws in (("translate", 2), ("occlusion", 7)):
        took.append(r.random() > 0.5)
        r.random(draws) if took[-1] else None
    took.append(flip and r.random() > 0.5)
    took.append(r.random() > 0.5)
    r.uniform() if took[-1] else None
    took.append(r.random() > 0.7)
    r.random() if took[-1] else None
    took.append(r.random() < 0.2)
    return np.array(took)


def test_augment_bit_for_bit():
    L, size = 98, 64
    base = np.random.default_rng(5).integers(0, 256, (size, size, 3),
                                             np.uint8)
    target = np.random.default_rng(6).uniform(0.05, 0.95, 2 * L
                                              ).astype(np.float32)
    flip = np.asarray(tpt.WFLW_POINTS_FLIP, np.int32)
    taken = []
    for seed in range(40):
        points_flip = flip if seed % 4 else None
        ref = jpt.augment(Image.fromarray(base), target.copy(),
                          np.random.default_rng(seed),
                          points_flip=points_flip)
        got = tpt.augment(Image.fromarray(base), target.copy(),
                          np.random.default_rng(seed),
                          points_flip=points_flip)
        for r, o in zip(ref, got):
            assert o.dtype == r.dtype
            np.testing.assert_array_equal(o, r)
        taken.append(_branches(seed, points_flip is not None))
    taken = np.array(taken)
    assert taken.any(0).all() and (~taken).any(0).all(), taken.sum(0)


@pytest.fixture(scope="module")
def one_step():
    """One random state (every leaf random), a batch, and the JAX side's
    loss, gradients and parameters after one ``make_train_step`` update at
    lr 1e-3."""
    model = jpip.PIPNet(JCFG)
    S = JCFG.input_size
    params = random_params(model.init, jax.random.key(0),
                           jnp.zeros((1, S, S, 3)), seed=7)
    images = np.random.default_rng(8).standard_normal(
        (B, S, S, 3)).astype(np.float32)
    lms, (nb_idx, meanface) = _landmarks(9), _nb_idx()
    cfg = _train_cfg(jpt, init_lr=1e-3)

    opt = optax.chain(stash_grads(), jpt.make_optimizer(cfg, 5))
    new, state, total, parts = jpt.make_train_step(model, opt, nb_idx, cfg)(
        jax.device_put(params), jax.jit(opt.init)(params),
        jnp.asarray(images), jnp.asarray(lms))
    return dict(params=params, images=images, lms=lms, nb_idx=nb_idx,
                meanface=meanface, total=float(total),
                parts={k: float(v) for k, v in parts.items()},
                grads=bridge.from_jax_params(np_tree(state[0])),
                new=bridge.from_jax_params(np_tree(new)))


def test_one_train_step_matches_jax(one_step):
    tcfg = _train_cfg(tpt, init_lr=1e-3)
    state = tpt.leaf_state(bridge.from_jax_params(np_tree(one_step["params"])))
    before = {k: v.detach().clone() for k, v in state.items()}
    step = tpt.make_train_step(
        tpip.PIPNet(TCFG), tpt.make_optimizer(tcfg, 5, state.values()),
        one_step["nb_idx"], tcfg)
    total, parts = step(state, torch.from_numpy(one_step["images"]),
                        torch.from_numpy(one_step["lms"]))
    np.testing.assert_allclose(float(total), one_step["total"], rtol=1e-5)
    for k, v in one_step["parts"].items():
        np.testing.assert_allclose(float(parts[k]), v, rtol=1e-5, err_msg=k)
    ref = one_step["grads"]
    # FrozenBN's statistics are leaves of the tree and get gradients
    assert any(k.endswith(".mean") for k in ref)
    assert any(k.endswith(".var") for k in ref)
    assert_grads_close({k: v.grad for k, v in state.items()}, ref)
    assert_adam_step_close(state, before, one_step["new"], tcfg.init_lr)


def test_schedule_and_weight_decay_equal_optax():
    spe, decay = 3, (2, 4)                     # boundaries at updates 6, 12
    for pretrained in (True, False):
        tcfg = _train_cfg(tpt, decay_steps=decay, pretrained=pretrained,
                          init_lr=1e-2)
        jcfg = _train_cfg(jpt, decay_steps=decay, pretrained=pretrained,
                          init_lr=1e-2)
        sched = optax.piecewise_constant_schedule(
            jcfg.init_lr, {e * spe: jcfg.decay_gamma for e in decay})
        rng = np.random.default_rng(int(pretrained))
        p0 = rng.standard_normal(64).astype(np.float32)
        grads = rng.standard_normal((16, 64)).astype(np.float32)
        jopt = compiled_optimizer(jpt.make_optimizer(jcfg, spe))
        jp, jstate = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
        tp = torch.tensor(p0, requires_grad=True)
        opt, lr_sched = tpt.make_optimizer(tcfg, spe, [tp])
        for k in range(16):
            # update k runs at the rate optax's schedule gives count k; the
            # parameters (|p| < 4) may differ by a few float32 ulps of
            # rounding per update: 1e-4 * lr is 4-8 ulps
            assert opt.param_groups[0]["lr"] == pytest.approx(
                float(sched(k)), rel=1e-6), k
            upd, jstate = jopt.update(jnp.asarray(grads[k]), jstate, jp)
            jp = jp + upd
            tp.grad = torch.from_numpy(grads[k])
            opt.step()
            lr_sched.step()
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                       rtol=0, atol=1e-4 * tcfg.init_lr)


def test_fit_writes_a_checkpoint_the_readers_take(tmp_path, one_step):
    tcfg = _train_cfg(tpt, num_epochs=2, init_lr=1e-3)
    state = tpt.leaf_state(bridge.from_jax_params(np_tree(one_step["params"])))
    batch = (one_step["images"], np.clip(one_step["lms"], 0, 1))
    out = tpt.fit_pipnet(tpip.PIPNet(TCFG), state, lambda epoch: [batch],
                         tcfg, one_step["meanface"],
                         steps_per_epoch=1, save_dir=str(tmp_path),
                         save_interval=2, verbose=False)
    assert len(out["history"]) == 2 and len(out["step_s"]) == 2
    assert os.listdir(tmp_path) == ["epoch1.pth"]
    saved = torch.load(str(tmp_path / "epoch1.pth"), weights_only=True)
    pairs = bridge_align.pipnet_pairs(TCFG)
    n_bn = sum(kind == "bn" for kind, _, _ in pairs)
    assert sorted(saved) == sorted(
        list(bridge_align.reference_layout(state, pairs))
        + [f"{src}.num_batches_tracked" for kind, _, src in pairs
           if kind == "bn"])
    assert n_bn and all(int(saved[f"{src}.num_batches_tracked"]) == 0
                        for kind, _, src in pairs if kind == "bn")
    got = bridge_align.convert_pipnet(saved, TCFG)
    theirs = bridge.from_jax_params(jba.convert_pipnet(
        {k: v.numpy() for k, v in saved.items()}, JCFG))
    assert sorted(got) == sorted(theirs) == sorted(state)
    for k, v in state.items():
        assert torch.equal(got[k], v.detach()), k
        assert torch.equal(theirs[k], v.detach()), k
