"""PyTorch port: ``core.meta_net``, ``core.losses`` and the training side of
``core.manager`` against the JAX package.

Inputs come from a numpy seed and go through both sides; MetaIdNet weights
are made on the JAX side (all leaves randomised) and carried over with the
strict bridge.  fp32 on the CPU.  Tolerances: 1e-5 on coefficients,
dictionaries and losses (elementwise math and small sums); 1e-4 on z and on
face features (a tiny IResNet and a projection on a 16-component basis).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.core import losses as jlosses
from celebbasis_tpu.core import manager as jmgr
from celebbasis_tpu.core import meta_net as jmeta
from celebbasis_tpu.utils.pt_io import load_pt
from celebbasis_tpu_torch.core import losses as tlosses
from celebbasis_tpu_torch.core import manager as tmgr
from celebbasis_tpu_torch.core import meta_net as tmeta
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (compiled, np_tree, random_params,
                                 randomize_all_leaves, t)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

L = lambda a: t(a).long()


def _meta_pair(**overrides):
    import dataclasses
    jcfg = dataclasses.replace(jmeta.MetaNetConfig.tiny(), **overrides)
    tcfg = dataclasses.replace(tmeta.MetaNetConfig.tiny(), **overrides)
    jnet = jmeta.MetaIdNet(jcfg, dtype=jnp.float32)
    r = np.random.default_rng(4)
    faces = r.uniform(-1, 1, (2, 2, 40, 40, 3)).astype(np.float32)
    basis = r.standard_normal(
        (jcfg.num_es, 1 + jcfg.inner_dim, jcfg.token_dim)).astype(np.float32)
    params = random_params(
        jnet.init, jax.random.key(0), jnp.asarray(faces[:, 0]),
        jnp.zeros((2,), jnp.int32), jnp.asarray(basis), seed=2)
    tnet = tmeta.MetaIdNet(tcfg, dtype=torch.float32)
    bridge.load_jax_params(tnet, np_tree(params))      # strict
    return jnet, params, tnet.eval(), faces, basis


@pytest.fixture(scope="module")
def meta():
    return _meta_pair()


def test_meta_configs_agree():
    import dataclasses
    for ours, ref in ((tmeta.MetaNetConfig.tiny(), jmeta.MetaNetConfig.tiny()),
                      (tmeta.MetaNetConfig(), jmeta.MetaNetConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_face_features_match_jax(meta):
    jnet, params, tnet, faces, _ = meta
    ref = np.asarray(jax.jit(lambda p, f: jnet.apply(
        p, f, method=jmeta.MetaIdNet.face_features))(
            params, jnp.asarray(faces[:, 0])))
    got = tnet.face_features(t(faces[:, 0]))
    assert not got.requires_grad
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_meta_forward_and_multi_faces_match_jax(meta):
    jnet, params, tnet, faces, basis = meta
    ids = np.array([[0, 1], [1, 0]], np.int64)
    jz, jc = jax.jit(lambda p, f, i, b: jnet.apply(
        p, f, i, b, method=jmeta.MetaIdNet.multi_faces))(
            params, jnp.asarray(faces), jnp.asarray(ids), jnp.asarray(basis))
    tz, tc = tnet.multi_faces(t(faces), L(ids), t(basis))
    assert tz.shape == (2, 2, 2, 32) and tc.shape == (2, 2, 2, 1, 16)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), atol=1e-4)
    z1, c1 = tnet(t(faces[:, 0]), L(ids[:, 0]), t(basis))
    np.testing.assert_allclose(z1.detach().numpy(), np.asarray(jz[:, 0]),
                               atol=1e-4)
    # cached-feature route equals the live one
    v = tnet.face_features(t(faces[:, 0]))
    z2, c2 = tnet.z_from_features(v, t(basis))
    np.testing.assert_allclose(z2.detach().numpy(), z1.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(c2.detach().numpy(), c1.detach().numpy(),
                               atol=1e-6)


def test_meta_gradients_reach_only_the_mlp_and_match_jax(meta):
    jnet, params, tnet, faces, basis = meta
    ids = np.array([0, 1])

    def loss(p):
        z, _ = jnet.apply(p, jnp.asarray(faces[:, 0]), jnp.asarray(ids),
                          jnp.asarray(basis))
        return (z ** 2).sum()

    jg = jax.jit(jax.grad(loss))(params)["params"]["mlp"]["layer_0"]
    tnet.zero_grad()
    for p in tnet.parameters():
        p.requires_grad_(True)
    z, _ = tnet(t(faces[:, 0]), L(ids), t(basis))
    (z ** 2).sum().backward()
    for name, p in tnet.named_parameters():
        if name.startswith("mlp."):
            assert p.grad is not None and p.grad.abs().sum() > 0, name
        else:
            assert p.grad is None, name
    scale = np.abs(np.asarray(jg["weight"])).max()
    np.testing.assert_allclose(tnet.mlp.layer_0.weight.grad.numpy(),
                               np.asarray(jg["weight"]), atol=1e-4 * scale)
    np.testing.assert_allclose(tnet.mlp.layer_0.bias.grad.numpy(),
                               np.asarray(jg["bias"]), atol=1e-4 * scale)
    tnet.requires_grad_(False)


def test_deep_style_vectorizer_matches_jax():
    """depth > 1: residual pre-LayerNorm EqualLinears, lr_mul at use time."""
    x = np.random.default_rng(9).standard_normal((5, 24)).astype(np.float32)
    jmlp = jmeta.StyleVectorizer(32, depth=3, lr_mul=0.5)
    params = randomize_all_leaves(jax.jit(jmlp.init)(jax.random.key(1),
                                                     jnp.asarray(x)), seed=3)
    tmlp = tmeta.StyleVectorizer(24, 32, depth=3, lr_mul=0.5)
    bridge.load_jax_params(tmlp, np_tree(params))      # strict
    # EqualLinear's weight is (out, in) on both sides: carried untransposed
    np.testing.assert_array_equal(
        tmlp.layer_0.weight.detach().numpy(),
        np.asarray(params["params"]["layer_0"]["weight"]))
    np.testing.assert_allclose(tmlp(t(x)).detach().numpy(),
                               np.asarray(jax.jit(jmlp.apply)(
                                   params, jnp.asarray(x))),
                               atol=1e-5)


def test_coef_table_variant_matches_jax():
    """use_rm_mlp: coefficients come from a per-id table, no face forward
    (the JAX tree then holds the table alone)."""
    import dataclasses
    over = dict(use_rm_mlp=True, num_ids=5)
    jcfg = dataclasses.replace(jmeta.MetaNetConfig.tiny(), **over)
    jnet = jmeta.MetaIdNet(jcfg, dtype=jnp.float32)
    r = np.random.default_rng(10)
    faces = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    basis = r.standard_normal((2, 17, 32)).astype(np.float32)
    ids = np.array([3, 1])
    params = jax.jit(jnet.init)(jax.random.key(2), jnp.asarray(faces),
                                jnp.asarray(ids), jnp.asarray(basis))
    assert set(params["params"]) == {"coef_table"}
    tnet = tmeta.MetaIdNet(dataclasses.replace(tmeta.MetaNetConfig.tiny(),
                                               **over), dtype=torch.float32)
    res = tnet.load_state_dict(bridge.from_jax_params(np_tree(params)),
                               strict=False)
    assert res.unexpected_keys == []
    assert all(k.startswith(("fr_net.", "mlp.")) for k in res.missing_keys)
    jz, jc = jax.jit(jnet.apply)(params, jnp.asarray(faces),
                                 jnp.asarray(ids), jnp.asarray(basis))
    tz, tc = tnet(t(faces), L(ids), t(basis))
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), atol=1e-4)
    trainable = {id(p) for p in tnet.trainable_parameters()}
    assert all((id(p) in trainable) == n.startswith(("mlp.", "coef_table"))
               for n, p in tnet.named_parameters())
    plain = tmeta.MetaIdNet(tmeta.MetaNetConfig.tiny(), dtype=torch.float32)
    assert "coef_table" not in dict(plain.named_parameters())


# -- manager, training side ---------------------------------------------------

KW = dict(placeholder_token_ids=(500, 501, 502), max_ids=4, num_es=2, heads=1,
          inner_dim=8, token_dim=16, momentum=0.9)


def _states(seed=0):
    jstate = jmgr.init_state(jmgr.ManagerConfig(**KW), jax.random.key(seed))
    return jstate, bridge.manager_state_from_jax(jstate)


def _preds(B, k, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, k, 2, 16)).astype(np.float32),
            r.standard_normal((B, k, 2, 1, 8)).astype(np.float32))


def test_momentum_update_with_duplicate_ids_matches_jax():
    jcfg, tcfg = jmgr.ManagerConfig(**KW), tmgr.ManagerConfig(**KW)
    jstate, tstate = _states()
    z, c = _preds(1, 4, 1)
    ids = np.array([1, 3, 1, 2])           # id 1 twice: the update compounds
    valid = np.array([True, True, True, False])
    ref = jmgr.momentum_update(jcfg, jstate, jnp.asarray(z[0]),
                               jnp.asarray(c[0]), jnp.asarray(ids),
                               jnp.asarray(valid))
    before = [x.clone() for x in tstate]
    got = tmgr.momentum_update(tcfg, tstate, t(z[0]), t(c[0]), L(ids),
                               t(valid))
    for a, b in zip(bridge.manager_state_to_numpy(got), ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    for a, b in zip(tstate, before):          # the input state is untouched
        assert torch.equal(a, b)
    m = 0.9
    expect = m * (m * before[0][1] + (1 - m) * t(z[0, 0])) + (1 - m) * t(z[0, 2])
    np.testing.assert_allclose(got.id_embeddings[1].numpy(), expect.numpy(),
                               atol=1e-6)
    assert torch.equal(got.id_embeddings[2], before[0][2])   # masked out
    assert torch.equal(got.id_embeddings[0], before[0][0])   # not in the batch


def test_train_inject_matches_jax():
    jcfg, tcfg = jmgr.ManagerConfig(**KW), tmgr.ManagerConfig(**KW)
    jstate, tstate = _states(1)
    B, k, Lq = 2, 3, 12
    z, c = _preds(B, k, 2)
    r = np.random.default_rng(3)
    tokens = r.integers(1, 400, (B, Lq))
    tokens[0, 2], tokens[0, 5], tokens[1, 3] = 500, 501, 500
    embeds = r.standard_normal((B, Lq, 16)).astype(np.float32)
    ids = np.array([[2, 2, 0], [1, 0, 0]])     # id 2 twice in row 0
    num_ids = np.array([2, 1])
    jout, jnew = compiled(jmgr.train_inject)(
        jcfg, jstate, jnp.asarray(tokens, jnp.int32), jnp.asarray(embeds),
        jnp.asarray(z), jnp.asarray(c), jnp.asarray(ids, jnp.int32),
        jnp.asarray(num_ids, jnp.int32))
    zt = t(z).requires_grad_(True)
    tout, tnew = tmgr.train_inject(tcfg, tstate, L(tokens), t(embeds), zt,
                                   t(c), L(ids), L(num_ids))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    for a, b in zip(bridge.manager_state_to_numpy(tnew), jnew):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    assert tout.requires_grad and not tnew.id_embeddings.requires_grad
    tout.sum().backward()                      # the prediction is live
    assert zt.grad.abs().sum() > 0


@pytest.mark.parametrize("loss_type", ["none", "l1_reg", "l2_reg", "cosine",
                                       "contra"])
def test_id_neg_loss_matches_jax(loss_type):
    B, k = 2, 4
    z, c = _preds(B, k, 5)
    gnet = gparams = tgnet = None
    if loss_type == "contra":
        gnet = jlosses.ContrastiveGNet(meta_dim=16)
        gparams = randomize_all_leaves(
            jax.jit(gnet.init)(jax.random.key(0), jnp.zeros((1, 32))), seed=6)
        tgnet = tlosses.ContrastiveGNet(32, meta_dim=16)
        bridge.load_jax_params(tgnet, np_tree(gparams))
    jl, jlogs = compiled(jmgr.id_neg_loss)(loss_type, jnp.asarray(z),
                                           jnp.asarray(c), gnet, gparams)
    tl, tlogs = tmgr.id_neg_loss(loss_type, t(z), t(c), tgnet)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-9)
    assert set(tlogs) == set(jlogs)
    for key in jlogs:
        np.testing.assert_allclose(tlogs[key].detach().numpy(),
                                   np.asarray(jlogs[key]), rtol=1e-5,
                                   atol=1e-9)
    if loss_type == "contra":
        assert tl.item() > 1e-4


def test_loss_helpers_match_jax_and_reject_unknown_types():
    assert tmgr.VALID_LOSS_TYPES == jmgr.VALID_LOSS_TYPES
    z, c = _preds(3, 4, 7)
    np.testing.assert_allclose(
        tmgr.cosine_id_loss(t(z[:, 0]), [t(z[:, 1]), t(z[:, 2])],
                            t(z[:, 3])).numpy(),
        np.asarray(jmgr.cosine_id_loss(jnp.asarray(z[:, 0]),
                                       [jnp.asarray(z[:, 1]),
                                        jnp.asarray(z[:, 2])],
                                       jnp.asarray(z[:, 3]))), rtol=1e-5)
    feats = np.random.default_rng(8).standard_normal((6, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        tlosses.info_nce_loss(t(feats)).numpy(),
        np.asarray(jax.jit(jlosses.info_nce_loss)(jnp.asarray(feats))),
        rtol=1e-5)
    with pytest.raises(ValueError):
        tmgr.id_neg_loss("l3_reg", t(z), t(c))
    with pytest.raises(ValueError):
        tmgr.id_neg_loss("contra", t(z), t(c))          # no g-net
    with pytest.raises(ValueError):
        tmgr.coefficient_reg_loss("l1_reg", t(c))       # rank 5, not 4


# -- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize("mode,fp16", [("coefficient", False),
                                       ("coefficient", True),
                                       ("embedding", False)])
def test_checkpoint_written_by_the_port_is_read_by_jax(tmp_path, mode, fp16):
    kw = dict(KW, test_mode=mode, save_fp16=fp16)
    jcfg, tcfg = jmgr.ManagerConfig(**kw), tmgr.ManagerConfig(**kw)
    _, tstate = _states(2)
    path = str(tmp_path / "embeddings_gs-3.pt")
    tmgr.save_checkpoint(tcfg, tstate, path)
    key = "id_coefficients" if mode == "coefficient" else "id_embeddings"
    raw = load_pt(path)                     # the JAX package's torch-free reader
    assert list(raw) == [key] and len(raw[key]) == 4
    assert np.asarray(raw[key][0]).dtype == (np.float16 if fp16
                                             else np.float32)
    jstate = jmgr.load_checkpoint(jcfg, path)
    field = 1 if mode == "coefficient" else 0
    np.testing.assert_allclose(np.asarray(jstate[field]),
                               tstate[field].numpy(),
                               atol=2e-3 if fp16 else 0)
    back = tmgr.load_checkpoint(tcfg, path)
    np.testing.assert_allclose(back[field].numpy(), tstate[field].numpy(),
                               atol=2e-3 if fp16 else 0)


@pytest.mark.parametrize("mode", ["coefficient", "embedding"])
def test_checkpoint_written_by_jax_is_read_by_the_port(tmp_path, mode):
    kw = dict(KW, test_mode=mode)
    jcfg, tcfg = jmgr.ManagerConfig(**kw), tmgr.ManagerConfig(**kw)
    jstate, _ = _states(3)
    path = str(tmp_path / "embeddings_gs-800.pt")
    jmgr.save_checkpoint(jcfg, jstate, path)
    got = tmgr.load_checkpoint(tcfg, path)
    field = 1 if mode == "coefficient" else 0
    np.testing.assert_array_equal(got[field].numpy(),
                                  np.asarray(jstate[field]))


def test_checkpoint_image_mode_saves_the_meta_net(tmp_path, meta):
    tnet = meta[2]
    tcfg = tmgr.ManagerConfig(**dict(KW, test_mode="image"))
    _, tstate = _states(4)
    path = str(tmp_path / "embeddings_gs-1.pt")
    with pytest.raises(ValueError):
        tmgr.save_checkpoint(tcfg, tstate, path)
    tmgr.save_checkpoint(tcfg, tstate, path, meta_net=tnet)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"meta_id_net"}
    assert set(raw["meta_id_net"]) == set(tnet.state_dict())
    assert torch.equal(raw["meta_id_net"]["mlp.layer_0.weight"],
                       tnet.mlp.layer_0.weight)
