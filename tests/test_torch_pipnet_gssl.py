"""PyTorch port, the GSSL PIPNet (``align/pipnet_gssl.py``) against the JAX
package's, on the CPU at a tiny ResNet-18-style configuration with a
128x128 input (5 landmarks, 2 neighbours; score maps 4x4, 2x2, 1x1):

* ``PIPNetGSSL``'s seven outputs within 1e-4 of each output's largest entry;
* ``gen_targets_gssl`` equal to JAX's (targets and masks) and ``gssl_loss``
  within 1e-6 (relative), on a batch of all four tasks, an all-'std' batch
  (the /2 and /4 outputs do not count: the loss is the same, bit for bit,
  whatever they hold) and a batch without 'std' rows (the offset losses
  exactly 0);
* one GSSL step from one random state: loss within 1e-5 (relative), every
  leaf's gradient within 1e-4 of its largest entry, the parameters after
  Adam within 2e-2 * lr at every entry and 1e-4 * lr on average;
* ``gssl_self_train`` (the warmup and one curriculum round, one epoch
  each, three unlabeled rows) from the initial states of the JAX
  ``init_rngs``: loss histories within 1e-4 (relative), pseudo-labels
  within 5e-3 (the test says why).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celebbasis_tpu.align import pipnet as jpip
from celebbasis_tpu.align import pipnet_gssl as jpg
from celebbasis_tpu.align import pipnet_train as jpt
from celebbasis_tpu_torch.align import pipnet as tpip
from celebbasis_tpu_torch.align import pipnet_gssl as tpg
from celebbasis_tpu_torch.align import pipnet_train as tpt
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (assert_adam_step_close, assert_grads_close,
                                 np_tree, random_params, stash_grads)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

JCFG = jpip.PIPNetConfig(num_lms=5, num_nb=2, input_size=128,
                         layers=(1, 1, 1, 1), width=8, block="basic")
TCFG = tpip.PIPNetConfig(**JCFG.__dict__)
S, L, NB, G, B = 128, 5, 2, 4, 4
MIXED = np.array([jpg.TASK_STD, jpg.TASK_CLS1, jpg.TASK_CLS2, jpg.TASK_CLS3],
                 np.int32)
TASKS = {"mixed": MIXED, "std": np.zeros(B, np.int32),
         "no_std": np.array([1, 2, 3, 2], np.int32)}


def _train_cfg(mod, **kw):
    return mod.PIPTrainConfig(num_lms=L, num_nb=NB, input_size=S,
                              net_stride=32, **kw)


def _case(seed):
    rng = np.random.default_rng(seed)
    lms = rng.uniform(0.02, 0.98, (B, L, 2)).astype(np.float32)
    meanface = rng.uniform(0.2, 0.8, (L, 2)).astype(np.float32)
    return lms, meanface, tpt.forward_neighbors(meanface, NB)


@pytest.fixture(scope="module")
def params():
    return random_params(jpg.PIPNetGSSL(JCFG).init, jax.random.key(0),
                         jnp.zeros((1, S, S, 3)), seed=3)


def test_net_forward_agrees_with_jax(params):
    x = np.random.default_rng(1).standard_normal((2, S, S, 3)
                                                 ).astype(np.float32)
    ref = jax.jit(jpg.PIPNetGSSL(JCFG).apply)(params, jnp.asarray(x))
    net = tpg.PIPNetGSSL(TCFG)
    net.load_state_dict(bridge.from_jax_params(np_tree(params)), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(ref) == 7
    for o, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    with pytest.raises(ValueError, match="stride-32"):
        tpg.PIPNetGSSL(tpip.PIPNetConfig.resnet18(net_stride=16))


@pytest.mark.parametrize("batch", sorted(TASKS))
def test_targets_and_loss_agree_with_jax(batch):
    lms, _, nb_idx = _case(2)
    task = TASKS[batch]
    rng = np.random.default_rng(4)
    shapes = [(B, G, G, L), (B, G // 2, G // 2, L), (B, G // 4, G // 4, L),
              (B, G, G, L), (B, G, G, L), (B, G, G, L * NB),
              (B, G, G, L * NB)]
    outputs = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def jax_side(lms, nb_idx, task, outputs):
        tg, ms = jpg.gen_targets_gssl(lms, nb_idx, G, task)
        return tg, ms, jpg.gssl_loss(outputs, tg, ms, NB)
    jt, jm, (jtotal, jparts) = jax.jit(jax_side)(lms, nb_idx, task, outputs)
    tt, tm = tpg.gen_targets_gssl(torch.from_numpy(lms),
                                  torch.from_numpy(nb_idx), G,
                                  torch.from_numpy(task))
    for o, r in zip(tt + tm, jt + jm):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    total, parts = tpg.gssl_loss([torch.from_numpy(o) for o in outputs], tt,
                                 tm, NB)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-6, err_msg=k)
    if batch == "std":
        # the /2 and /4 maps of 'std' rows are masked out
        other = [torch.from_numpy(o) for o in outputs]
        other[1], other[2] = other[1] + 7.0, other[2] - 3.0
        assert torch.equal(tpg.gssl_loss(other, tt, tm, NB)[0], total)
    if batch == "no_std":
        for k in ("x", "y", "nb_x", "nb_y"):
            assert float(parts[k]) == 0.0, k


def test_one_gssl_step_matches_jax(params):
    lms, _, nb_idx = _case(5)
    x = np.random.default_rng(6).standard_normal((B, S, S, 3)
                                                 ).astype(np.float32)
    jcfg, tcfg = (_train_cfg(m, batch_size=B, init_lr=1e-3)
                  for m in (jpt, tpt))
    # the JAX step's optimizer, behind a first link that keeps the raw
    # gradients in its state: one compiled step gives both
    opt = optax.chain(stash_grads(), jpt.make_optimizer(jcfg, 3))
    jnew, jstate, jtotal, _ = jpg.make_gssl_train_step(
        jpg.PIPNetGSSL(JCFG), opt, nb_idx, jcfg)(
        jax.device_put(params), jax.jit(opt.init)(params),
        jnp.asarray(x), jnp.asarray(lms), jnp.asarray(MIXED))

    lr = tcfg.init_lr
    state = tpt.leaf_state(bridge.from_jax_params(np_tree(params)))
    before = {k: v.detach().clone() for k, v in state.items()}
    step = tpg.make_gssl_train_step(
        tpg.PIPNetGSSL(TCFG), tpt.make_optimizer(tcfg, 3, state.values()),
        nb_idx, tcfg)
    total, _ = step(state, torch.from_numpy(x), torch.from_numpy(lms),
                    torch.from_numpy(MIXED))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert_grads_close({k: v.grad for k, v in state.items()},
                       bridge.from_jax_params(np_tree(jstate[0])))
    assert_adam_step_close(state, before,
                           bridge.from_jax_params(np_tree(jnew)), lr)


def _one_init_compile(monkeypatch):
    """The JAX curriculum wraps ``model.init`` in a fresh ``jax.jit`` each
    round, and the initial states take one more: its ``jax.jit`` keeps one
    jitted function for each method of equal flax modules (dataclass
    equality), so that every init of the run shares one compile.  -> that
    ``jit``."""
    jits = {}

    def jit(fn, **kw):
        key = (getattr(fn, "__func__", fn), getattr(fn, "__self__", None),
               tuple(sorted(kw.items())))
        if key not in jits:
            jits[key] = jax.jit(fn, **kw)
        return jits[key]
    monkeypatch.setattr(jpg, "jax", types.SimpleNamespace(
        **{**vars(jax), "jit": jit}))
    return jit


def test_self_train_from_the_jax_initial_states(monkeypatch):
    """The warmup and one curriculum round ('cls3'), one epoch each, batch
    2, four labeled and three unlabeled rows, each round starting from the
    state the JAX curriculum draws from its ``init_rngs``; an identity
    ``augment_fn`` records the rows' labels, the pseudo-labels included."""
    rng = np.random.default_rng(7)
    meanface = rng.uniform(0.2, 0.8, (L, 2)).astype(np.float32)
    lms = np.clip(meanface[None] + rng.normal(0, 0.05, (4, L, 2)), 0.05,
                  0.95).astype(np.float32)
    imgs = rng.standard_normal((7, S, S, 3)).astype(np.float32)
    # keys of the counter-free generator: a flax init compiles in a third
    # of the time threefry's takes, and the JAX curriculum compiles one per
    # round
    keys = [jax.random.key(10 + i, impl="unsafe_rbg") for i in range(2)]
    init = _one_init_compile(monkeypatch)(jpg.PIPNetGSSL(JCFG).init)
    init_states = [bridge.from_jax_params(np_tree(init(
        k, jnp.zeros((1, S, S, 3))))) for k in keys]
    seen = {"jax": [], "torch": []}

    def recorder(side):
        def augment_fn(rnd, epoch, lms_now):
            seen[side].append(np.array(lms_now))
            return (imgs if rnd else imgs[:4]), lms_now
        return augment_fn

    kw = dict(task_list=("cls3",), seed=3, verbose=False)
    args = (meanface, (imgs[:4], lms), imgs[4:])
    jout = jpg.gssl_self_train(
        JCFG, _train_cfg(jpt, batch_size=2, init_lr=1e-3, num_epochs=1),
        *args, init_rngs=keys, augment_fn=recorder("jax"), **kw)
    tout = tpg.gssl_self_train(
        TCFG, _train_cfg(tpt, batch_size=2, init_lr=1e-3, num_epochs=1),
        *args, init_states=init_states, augment_fn=recorder("torch"),
        device="cpu", **kw)
    np.testing.assert_allclose(tout["init_history"], jout["init_history"],
                               rtol=1e-4)
    np.testing.assert_allclose(tout["history"], jout["history"], rtol=1e-4)
    assert len(tout["step_s"]) == 2 + 3
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    np.testing.assert_array_equal(seen["torch"][0], seen["jax"][0])
    # the pseudo-labels come from the warmup net: two Adam updates from a
    # flax init, where many deep-conv gradients are zero (dead ReLUs), and
    # an entry whose gradient is exactly 0 on one side and 1e-7 on the
    # other moves by 0.7 * lr more at the second update; the two nets part
    # by a few lr at such entries, and the pseudo-labels (about 1e-3 apart)
    # are held to 5e-3, 0.64 px of 128
    np.testing.assert_array_equal(seen["torch"][1][:4], lms)
    np.testing.assert_allclose(seen["torch"][1], seen["jax"][1], rtol=0,
                               atol=5e-3)
