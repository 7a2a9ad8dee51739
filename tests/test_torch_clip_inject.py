"""PyTorch port: CLIP text encoder, identity injection and the manager's
inference side against the JAX package, on the CPU at the tiny config.

Weights are taken from the JAX module's init and carried over with
``from_jax_params``; inputs come from numpy generators.  fp32; 1e-5 unless
stated (summation order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.core import injection as jinj
from celebbasis_tpu.core import manager as jmgr
from celebbasis_tpu.models import clip_text as jclip
from celebbasis_tpu_torch.core import injection as tinj
from celebbasis_tpu_torch.core import manager as tmgr
from celebbasis_tpu_torch.models import clip_text as tclip
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (manifest_shapes, module_shapes, np_tree,
                                 randomize_zero_leaves, t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, REPS = 77, 16, 2
PH = [900, 901, 902]


@pytest.fixture(scope="module")
def clip_pair():
    cfg = jclip.CLIPTextConfig.tiny()
    jm = jclip.CLIPTextEncoder(cfg, jnp.float32)
    ids = jnp.zeros((1, cfg.max_length), jnp.int32)
    params = randomize_zero_leaves(jm.init(jax.random.key(0), ids), seed=1)
    tm = tclip.CLIPTextEncoder(tclip.CLIPTextConfig.tiny(), torch.float32)
    bridge.load_jax_params(tm, np_tree(params))
    return jm, params, tm.eval()


def test_clip_token_embed_and_encode(clip_pair):
    jm, params, tm = clip_pair
    r = np.random.default_rng(0)
    ids = r.integers(0, 1024, (3, 77)).astype(np.int32)
    je = jm.apply(params, jnp.asarray(ids),
                  method=jclip.CLIPTextEncoder.token_embed)
    te = tm.token_embed(t(ids).long())
    np.testing.assert_array_equal(te.detach().numpy(), np.asarray(je))
    emb = r.standard_normal((3, 77, 64)).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(emb),
                              method=jclip.CLIPTextEncoder.encode))
    with torch.no_grad():
        got = tm.encode(t(emb)).numpy()
        full = tm(t(ids).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(
        full, np.asarray(jm.apply(params, jnp.asarray(ids))), atol=1e-5)


def test_clip_sd_v1_shapes_match_manifest():
    with open(os.path.join(REPO, "manifests", "sd-v1-4.json")) as f:
        keys = json.load(f)["keys"]
    with torch.device("meta"):
        m = tclip.CLIPTextEncoder(tclip.CLIPTextConfig.sd_v1())
    assert all(p.is_meta for p in m.parameters())
    assert module_shapes(m) == manifest_shapes(keys, ["cond_stage_model."])


def _case(name):
    """tokens (L,), num_active for the injection cases."""
    tok = np.full(L, 1023, np.int64)
    tok[0] = 1022
    body = {
        "one": [5, 6, 900, 7, 8],
        "two": [5, 900, 6, 901, 7],
        "repeated": [900, 5, 900, 6, 901, 900],
        "inactive_second": [5, 900, 6, 901, 7],
        "truncate": list(range(10, 10 + 70)) + [900, 3, 901, 4, 5],
        "none": [5, 6, 7],
    }[name]
    tok[1:1 + len(body)] = body
    return tok, {"inactive_second": 1}.get(name, 3)


@pytest.mark.parametrize("name", ["one", "two", "repeated", "inactive_second",
                                  "truncate", "none"])
def test_inject_matches_jax_and_numpy_oracle(name):
    tok, num_active = _case(name)
    r = np.random.default_rng(3)
    emb = r.standard_normal((L, D)).astype(np.float32)
    idv = r.standard_normal((len(PH) * REPS, D)).astype(np.float32)
    oracle = tinj.inject_reference_numpy(tok, emb, idv, PH, num_active, REPS)
    np.testing.assert_array_equal(
        oracle, jinj.inject_reference_numpy(tok, emb, idv, PH, num_active,
                                            REPS))
    ref = np.asarray(jinj.inject_batch(
        jnp.asarray(tok[None], jnp.int32), jnp.asarray(emb[None]),
        jnp.asarray(idv[None]), jnp.asarray(PH, jnp.int32),
        jnp.asarray([num_active], jnp.int32), REPS))[0]
    got = tinj.inject_batch(t(tok[None]), t(emb[None]), t(idv[None]),
                            torch.tensor(PH), torch.tensor([num_active]),
                            REPS)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, oracle)
    one, slot = tinj.inject_embeddings(t(tok), t(emb), t(idv),
                                       torch.tensor(PH),
                                       torch.tensor(num_active), REPS)
    np.testing.assert_array_equal(one.numpy(), oracle)
    assert ((slot >= 0).numpy() == (got != _shifted_only(tok, emb, num_active)
                                    ).any(-1)).all()


def _shifted_only(tok, emb, num_active):
    """The shift without the overwrite: the oracle with an id bank that
    repeats what the shift alone leaves there cannot be built directly, so
    mark injected rows with NaN and let them compare unequal."""
    nan_bank = np.full((len(PH) * REPS, D), np.nan, np.float32)
    return tinj.inject_reference_numpy(tok, emb, nan_bank, PH, num_active,
                                       REPS)


def test_inject_batch_rows_are_independent():
    r = np.random.default_rng(4)
    toks = np.stack([_case(n)[0] for n in ("one", "two", "none")])
    nact = np.array([3, 3, 0])
    emb = r.standard_normal((3, L, D)).astype(np.float32)
    idv = r.standard_normal((3, len(PH) * REPS, D)).astype(np.float32)
    got = tinj.inject_batch(t(toks), t(emb), t(idv), torch.tensor(PH),
                            t(nact), REPS).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], tinj.inject_reference_numpy(toks[i], emb[i], idv[i], PH,
                                                int(nact[i]), REPS))


def _manager_inputs(mode):
    jcfg = jmgr.ManagerConfig(placeholder_token_ids=tuple(PH), max_ids=4,
                              num_es=2, heads=1, inner_dim=8, token_dim=D,
                              test_mode=mode)
    tcfg = tmgr.ManagerConfig(placeholder_token_ids=tuple(PH), max_ids=4,
                              num_es=2, heads=1, inner_dim=8, token_dim=D,
                              test_mode=mode)
    r = np.random.default_rng(5)
    emb_state = r.standard_normal((4, 2, D)).astype(np.float32)
    coeff = r.standard_normal((4, 2, 1, 8)).astype(np.float32)
    basis = r.standard_normal((2, 9, D)).astype(np.float32)
    return jcfg, tcfg, emb_state, coeff, basis, r


def test_reconstruct_z():
    jcfg, tcfg, _, coeff, basis, _ = _manager_inputs("coefficient")
    ref = np.asarray(jmgr.reconstruct_z(jcfg, jnp.asarray(coeff),
                                        jnp.asarray(basis)))
    got = tmgr.reconstruct_z(tcfg, t(coeff), t(basis)).numpy()
    assert got.shape == (4, 2, D)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("mode", ["coefficient", "embedding", "image"])
def test_test_inject_modes(mode):
    jcfg, tcfg, emb_state, coeff, basis, r = _manager_inputs(mode)
    toks = np.stack([_case("two")[0], _case("one")[0]])
    embeds = r.standard_normal((2, L, D)).astype(np.float32)
    ids = np.array([[1, 3, 0], [2, 0, 0]], np.int32)
    num_ids = np.array([2, 1], np.int32)
    pred_z = r.standard_normal((2, 3, 2, D)).astype(np.float32)
    jstate = jmgr.ManagerState(jnp.asarray(emb_state), jnp.asarray(coeff))
    tstate = bridge.manager_state_from_jax(jstate)
    ref = np.asarray(jmgr.test_inject(
        jcfg, jstate, jnp.asarray(basis), jnp.asarray(toks, jnp.int32),
        jnp.asarray(embeds), jnp.asarray(ids), jnp.asarray(num_ids),
        pred_z=jnp.asarray(pred_z) if mode == "image" else None))
    got = tmgr.test_inject(
        tcfg, tstate, bridge.basis_from_jax(basis), t(toks), t(embeds),
        t(ids).long(), t(num_ids).long(),
        pred_z=t(pred_z) if mode == "image" else None).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got - embeds).max() > 0.1        # something was injected


def test_manager_checkpoint_roundtrip(tmp_path):
    _, tcfg, emb_state, coeff, _, _ = _manager_inputs("coefficient")
    path = str(tmp_path / "embeddings.pt")
    torch.save({"id_coefficients": [t(c) for c in coeff]}, path)
    state = tmgr.load_checkpoint(tcfg, path)
    np.testing.assert_array_equal(state.id_coefficients.numpy(), coeff)
    assert state.id_embeddings.shape == (4, 2, D)
    g = torch.Generator().manual_seed(0)
    s0 = tmgr.init_state(tcfg, g, init_embedding=t(emb_state[0, 0]))
    assert s0.id_embeddings.shape == (4, 2, D)
    np.testing.assert_array_equal(s0.id_embeddings[3, 1].numpy(),
                                  emb_state[0, 0])
