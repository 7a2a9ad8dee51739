"""PyTorch port, the training slice as a whole: ``train.step`` on ``tiny()``
configs against the JAX package's ``make_loss_fn`` / ``make_train_step``.

Weights (pipeline and MetaIdNet), the celeb basis and the momentum
dictionaries are made on the JAX side and carried over; the batch and the
three random draws (posterior noise, t, eps) come from a numpy seed and go
through both sides as ``override_*``.  fp32 on the CPU.  Tolerances: loss
1e-5; gradients 1e-4 of the largest entry of the leaf (a UNet forward and
backward, summation order); the 3-step AdamW trajectory 1e-4 absolute on the
MLP weights and the momentum dictionaries (AdamW's first steps move every
weight by about lr = 1e-2 whatever the gradient's size, so this also holds
every gradient entry to the right sign).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celebbasis_tpu import pipeline as jpipe
from celebbasis_tpu.core import manager as jmgr
from celebbasis_tpu.core import meta_net as jmeta
from celebbasis_tpu.core.basis import build_celeb_basis as j_build_basis
from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from celebbasis_tpu.train import step as jstep
from celebbasis_tpu_torch import pipeline as tpipe
from celebbasis_tpu_torch.core import meta_net as tmeta
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.train import step as tstep
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import compiled_optimizer, np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

NAMES = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
         "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson",
         "Leonardo DiCaprio", "Oprah Winfrey", "Keanu Reeves", "Rihanna"]
SIZE, FACE, B, K_STEPS, LR = 32, 40, 2, 3, 1e-2
PROMPTS = ["face of sks person", "a photo of sks person and ks person"]
META = dict(inner_dim=8, token_dim=64)


def _batch(tok, seed):
    r = np.random.default_rng(seed)
    lat = SIZE // 2
    return {
        "image": r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        "tokens": np.asarray(tok(PROMPTS)),
        "faces": r.uniform(-1, 1, (B, 2, FACE, FACE, 3)).astype(np.float32),
        "ids": np.array([[0, 1], [0, 1]], np.int32),
        "num_ids": np.array([1, 2], np.int32),
        "override_znoise": r.standard_normal((B, lat, lat, 4)).astype(
            np.float32),
        "override_t": r.integers(0, 1000, (B,)).astype(np.int32),
        "override_noise": r.standard_normal((B, lat, lat, 4)).astype(
            np.float32),
    }


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: (t(v).long() if v.dtype.kind == "i" else t(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def both():
    jtok = JTokenizer.synthetic(1024)
    jp = jpipe.CelebBasisPipeline(jpipe.PipelineConfig.tiny(), jtok)
    params = random_params(
        lambda key: jp.init_params(key, image_size=SIZE), jax.random.key(0),
        seed=5)
    jbasis = j_build_basis(NAMES, jtok, jp.token_table(params), jp.cfg.basis)
    jstate = jmgr.init_state(jp.manager_cfg, jax.random.key(3))
    jnet = jmeta.MetaIdNet(dataclasses.replace(jmeta.MetaNetConfig.tiny(),
                                               **META), dtype=jnp.float32)
    batch = _batch(jtok, 11)
    meta_params = random_params(
        jnet.init, jax.random.key(1), jnp.asarray(batch["faces"][:, 0]),
        jnp.zeros((B,), jnp.int32), jnp.asarray(jbasis), seed=2)
    return dict(jp=jp, params=params, jbasis=jnp.asarray(jbasis),
                jstate=jstate, jnet=jnet, meta_params=meta_params,
                jtok=jtok, batch=batch)


def _torch_side(both):
    """A fresh port-side copy of everything (the step updates in place)."""
    tp = tpipe.CelebBasisPipeline(tpipe.PipelineConfig.tiny(),
                                  CLIPTokenizer.synthetic(1024))
    tp.load_state_dict(bridge.from_jax_params(np_tree(both["params"])),
                       strict=True)
    tp.requires_grad_(False).eval()
    tnet = tmeta.MetaIdNet(dataclasses.replace(tmeta.MetaNetConfig.tiny(),
                                               **META), dtype=torch.float32)
    bridge.load_jax_params(tnet, np_tree(both["meta_params"]))
    tnet.requires_grad_(False).eval()
    return (tp, tnet, bridge.basis_from_jax(both["jbasis"]),
            bridge.manager_state_from_jax(both["jstate"]))


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.fixture(scope="module")
def jax_reference(both):
    """Loss, MLP gradients and UNet gradients of the JAX loss (one compile:
    the unfrozen-UNet variant, whose loss and MLP gradients are those of the
    frozen one)."""
    trainable, meta_frozen = jstep.split_meta_params(both["meta_params"])
    frozen = {**both["params"], "meta_frozen": meta_frozen}
    loss_fn = jstep.make_loss_fn(both["jp"], both["jnet"], train_unet=True)
    keyed = jstep.build_trainable(trainable, unet_params=frozen["unet"])
    (loss, (mstate, logs)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            keyed, frozen, both["jstate"], both["jbasis"],
            _jb(both["batch"]), jax.random.key(0))
    return dict(loss=float(loss), mstate=mstate, logs=logs,
                meta=np_tree(grads["meta"]), unet=np_tree(grads["unet"]))


def _assert_grads_close(module_or_params, jax_tree, prefix=""):
    ref = bridge.from_jax_params(jax_tree)
    got = dict(module_or_params)
    assert set(ref) == set(got)
    # a leaf whose gradient is zero by construction (a conv bias in front of
    # a one-channel-per-group GroupNorm) holds rounding noise on both sides:
    # the floor of the scale is a thousandth of the tree's largest entry
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        g = got[name].grad
        assert g is not None, name
        scale = max(r.abs().max().item(), floor)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4 * scale,
                                   err_msg=prefix + name)


def test_loss_and_mlp_gradient_match_jax(both, jax_reference):
    tp, tnet, basis, mstate = _torch_side(both)
    trainable = tstep.build_trainable(tnet)
    loss_fn = tstep.make_loss_fn(tp, tnet)
    loss, (new_state, logs) = loss_fn(mstate, basis, _tb(both["batch"]),
                                      _gen())
    assert abs(loss.item() - jax_reference["loss"]) <= 1e-5
    assert abs(logs["loss_simple"].item()
               - float(jax_reference["logs"]["loss_simple"])) <= 1e-5
    for a, b in zip(bridge.manager_state_to_numpy(new_state),
                    jax_reference["mstate"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    loss.backward()
    _assert_grads_close(tnet.mlp.named_parameters(prefix="mlp"),
                        jax_reference["meta"])
    assert [id(p) for p in trainable["meta"]] == \
        [id(p) for p in tnet.mlp.parameters()]
    # frozen: the pipeline and the face net get no gradient at all
    for name, p in list(tp.named_parameters()) + \
            list(tnet.fr_net.named_parameters()):
        assert p.grad is None and not p.requires_grad, name


def test_train_unet_gives_unet_gradients_equal_to_jax(both, jax_reference):
    tp, tnet, basis, mstate = _torch_side(both)
    tstep.build_trainable(tnet, unet=tp.unet)
    with pytest.raises(ValueError):      # the flag must agree with the module
        tstep.make_loss_fn(tp, tnet, train_unet=False)(
            mstate, basis, _tb(both["batch"]), _gen())
    loss, _ = tstep.make_loss_fn(tp, tnet, train_unet=True)(
        mstate, basis, _tb(both["batch"]), _gen())
    assert abs(loss.item() - jax_reference["loss"]) <= 1e-5
    loss.backward()
    _assert_grads_close(tp.unet.named_parameters(), jax_reference["unet"],
                        "unet.")
    _assert_grads_close(tnet.mlp.named_parameters(prefix="mlp"),
                        jax_reference["meta"])
    assert all(p.grad is None for p in tp.vae.parameters())
    assert all(p.grad is None for p in tp.clip.parameters())


def test_three_step_adamw_trajectory_matches_jax(both):
    trainable, meta_frozen = jstep.split_meta_params(both["meta_params"])
    frozen = {**both["params"], "meta_frozen": meta_frozen}
    opt = jstep.make_optimizer(LR)
    jfn = jax.jit(jstep.make_train_step(both["jp"], both["jnet"], opt))
    jstate = jstep.init_train_state(jax.random.key(3), trainable, opt,
                                    both["jstate"])
    tp, tnet, basis, mstate = _torch_side(both)
    tr = tstep.build_trainable(tnet)
    topt = tstep.make_optimizer(tr, LR)
    tfn = tstep.make_train_step(tp, tnet, topt)
    tstate = tstep.init_train_state(_gen(), tr, topt, mstate)
    w0 = tnet.mlp.layer_0.weight.detach().clone()

    for it in range(K_STEPS):
        batch = _batch(both["jtok"], 20 + it)
        batch["ids"] = np.array([[it % 3, 1], [1, 1]], np.int32)  # a duplicate
        jstate, jlogs = jfn(jstate, frozen, both["jbasis"], _jb(batch))
        tstate, tlogs = tfn(tstate, basis, _tb(batch))
        assert abs(tlogs["loss"].item() - float(jlogs["loss"])) <= 1e-4
        jw = np.asarray(jstate.trainable["params"]["mlp"]["layer_0"]["weight"])
        tw = tnet.mlp.layer_0.weight.detach().numpy()
        np.testing.assert_allclose(tw, jw, atol=1e-4, err_msg=f"step {it}")
        for a, b in zip(bridge.manager_state_to_numpy(tstate.manager_state),
                        jstate.manager_state):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert tstate.step == K_STEPS == int(jstate.step)
    # the weights moved, by about lr a step (plus the weight decay)
    moved = (tnet.mlp.layer_0.weight.detach() - w0).abs().max().item()
    assert 0.5 * LR < moved <= K_STEPS * LR * 1.05
    np.testing.assert_allclose(
        tnet.mlp.layer_0.bias.detach().numpy(),
        np.asarray(jstate.trainable["params"]["mlp"]["layer_0"]["bias"]),
        atol=1e-4)


def test_cached_step_equals_uncached_on_the_same_draws(both):
    batch = _tb(both["batch"])
    tp, tnet, basis, mstate = _torch_side(both)
    tstep.build_trainable(tnet)
    loss_a, (state_a, _) = tstep.make_loss_fn(tp, tnet)(mstate, basis, batch,
                                                        _gen())
    loss_a.backward()
    grad_a = tnet.mlp.layer_0.weight.grad.clone()
    tnet.zero_grad()
    cache = tstep.precompute_cache(tp, tnet, [both["batch"]], n_batches=1)
    assert len(cache) == 1 and set(cache[0]) == {
        "latent_mean", "latent_logvar", "fr_feats", "tokens", "ids",
        "num_ids"}
    cached = dict(cache[0], **{k: v for k, v in batch.items()
                               if k.startswith("override_")})
    loss_b, (state_b, _) = tstep.make_cached_loss_fn(tp, tnet)(
        mstate, basis, cached, _gen())
    loss_b.backward()
    assert abs(loss_a.item() - loss_b.item()) <= 1e-6
    np.testing.assert_allclose(tnet.mlp.layer_0.weight.grad.numpy(),
                               grad_a.numpy(), atol=1e-7)
    for a, b in zip(state_a, state_b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
    # without overrides both draw from the generator, in the same order
    free = {k: v for k, v in batch.items() if not k.startswith("override_")}
    l1, _ = tstep.make_loss_fn(tp, tnet)(mstate, basis, free, _gen())
    l2, _ = tstep.make_cached_loss_fn(tp, tnet)(mstate, basis, cache[0],
                                                _gen())
    l3, _ = tstep.make_loss_fn(tp, tnet)(
        mstate, basis, free, torch.Generator().manual_seed(1))
    assert abs(l1.item() - l2.item()) <= 1e-6 and l1.item() != l3.item()


def test_eval_step_changes_nothing(both):
    tp, tnet, basis, mstate = _torch_side(both)
    tr = tstep.build_trainable(tnet)
    topt = tstep.make_optimizer(tr, LR)
    state = tstep.init_train_state(_gen(), tr, topt, mstate)
    w0 = tnet.mlp.layer_0.weight.detach().clone()
    logs = tstep.make_eval_step(tp, tnet)(state, basis, _tb(both["batch"]),
                                          _gen())
    assert set(logs) >= {"loss", "loss_simple", "loss_reg"}
    assert not logs["loss"].requires_grad and state.step == 0
    assert torch.equal(tnet.mlp.layer_0.weight, w0)
    assert state.manager_state is mstate
    with pytest.raises(ValueError):
        tstep.make_loss_fn(tp, tnet, loss_type="l3_reg")
    with pytest.raises(ValueError):
        tstep.make_loss_fn(tp, tnet, loss_type="contra")   # needs the g-net


@pytest.mark.parametrize("accumulate", [1, 3])
def test_optimizer_matches_optax(accumulate):
    """AdamW with weight decay 1e-2, a second group at model_lr, and the
    running-mean accumulation, against optax on a toy problem."""
    r = np.random.default_rng(0)
    w = {"meta": r.standard_normal((4, 3)).astype(np.float32),
         "unet": r.standard_normal((5,)).astype(np.float32)}
    jopt = compiled_optimizer(jstep.make_optimizer(LR, model_lr=3e-3,
                                                   accumulate=accumulate))
    apply_updates = jax.jit(optax.apply_updates)
    jparams = {k: jnp.asarray(v) for k, v in w.items()}
    jos = jopt.init(jparams)
    tparams = {k: [torch.nn.Parameter(t(v))] for k, v in w.items()}
    topt = tstep.make_optimizer(tparams, LR, model_lr=3e-3,
                                accumulate=accumulate)
    for it in range(7):
        g = {k: r.standard_normal(v.shape).astype(np.float32)
             for k, v in w.items()}
        upd, jos = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jos, jparams)
        jparams = apply_updates(jparams, upd)
        topt.zero_grad()
        for k in w:
            tparams[k][0].grad = t(g[k])
        topt.step()
        for k in w:
            np.testing.assert_allclose(tparams[k][0].detach().numpy(),
                                       np.asarray(jparams[k]), atol=2e-6,
                                       err_msg=f"{k} step {it}")
    with pytest.raises(ValueError):
        tstep.make_optimizer(tparams, LR)        # a UNet group without a rate


def test_contra_step_trains_the_gnet_too(both):
    tp, tnet, basis, mstate = _torch_side(both)
    gnet = tstep.init_gnet_params(tp, _gen())
    tr = tstep.build_trainable(tnet, gnet=gnet)
    assert set(tr) == {"meta", "gnet"}
    topt = tstep.make_optimizer(tr, LR)
    fn = tstep.make_train_step(tp, tnet, topt, loss_type="contra", gnet=gnet)
    batch = _tb(both["batch"])
    r = np.random.default_rng(1)
    batch["faces"] = t(r.uniform(-1, 1, (B, 4, FACE, FACE, 3)).astype(
        np.float32))                     # InfoNCE is identically 0 at k = 2
    batch["ids"] = t(np.array([[0, 1, 2, 3], [0, 1, 2, 3]])).long()
    g0 = gnet.Dense_0.weight.detach().clone()
    state = tstep.init_train_state(_gen(), tr, topt, mstate)
    state, logs = fn(state, basis, batch)
    assert logs["loss_contra"].item() > 0
    assert not torch.equal(gnet.Dense_0.weight, g0)
    # which parameters train is which require grad: the MLP and the g-net
    assert {n for n, p in tnet.named_parameters() if p.requires_grad} == \
        {"mlp.layer_0.weight", "mlp.layer_0.bias"}
