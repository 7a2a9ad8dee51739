"""PyTorch port, the x-transformers library in full generality
(``models/xtransformer.py``, ``utils/bridge_xt.py``) against the JAX
package's, with one set of random weights carried across
(``bridge_xt.from_jax_params``): the default wrapper with a mask, logits
and the TI hook; the norms and residual gating; the attention extras,
causal and position-infused attention; cross attention and the layer
plans; the wrapper's memory tokens, embedding projection, tied logits, mems
and attention maps; and ``convert_xtransformer`` on a reference-layout state
dict against the JAX converter, bit for bit.

fp32 on the CPU; each output within 1e-4 of the reference's largest entry.
The JAX side runs un-jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from celebbasis_tpu.models import xtransformer as jxt
from celebbasis_tpu.utils.bridge_xt import convert_xtransformer as jconvert
from celebbasis_tpu_torch.models import xtransformer as txt
from celebbasis_tpu_torch.utils.bridge_xt import (convert_xtransformer,
                                                  from_jax_params)

from _torch_port_helpers import np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

DIM, DEPTH, HEADS, DH, VOCAB, SEQ = 32, 2, 2, 8, 53, 12
R = np.random.default_rng(0)
IDS = R.integers(0, VOCAB, (2, SEQ))
CTX = R.standard_normal((2, 7, DIM)).astype(np.float32)


def _close(got, ref, rel=1e-4):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 1e-3
    assert np.abs(got - ref).max() <= rel * scale


def _models(wkw=None, seed=0, context=False, **kw):
    """-> (JAX module, params, port module) for one knob combination."""
    wkw = dict(num_tokens=VOCAB, max_seq_len=SEQ, **(wkw or {}))
    cfg = dict(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH, **kw)
    jm = jxt.XTransformerWrapper(jxt.XTWrapperConfig(**wkw),
                                 jxt.XTConfig(**cfg))
    ctx = jnp.asarray(CTX) if context else None
    params = random_params(lambda k, i: jm.init(k, i, context=ctx),
                           jax.random.key(0), jnp.asarray(IDS), seed=seed)
    tm = txt.XTransformerWrapper(txt.XTWrapperConfig(**wkw),
                                 txt.XTConfig(**cfg))
    tm.load_state_dict(from_jax_params(np_tree(params)), strict=True)
    return jm, params, tm.eval()


def _check(jm, params, tm, **call):
    """Same call on both sides (arrays given as numpy)."""
    jcall = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in call.items()}
    tcall = {k: t(v) if isinstance(v, np.ndarray) else v
             for k, v in call.items()}
    ref = jm.apply(params, jnp.asarray(IDS), **jcall)
    with torch.no_grad():
        got = tm(t(IDS).long(), **tcall)
    if isinstance(ref, tuple):
        _close(got[0], ref[0])
        assert len(got[1]) == len(ref[1])
        for g, r in zip(got[1], ref[1]):
            _close(g, r)
    else:
        _close(got, ref)


def test_default_wrapper_mask_logits_and_ti_hook():
    jm, params, tm = _models()
    mask = np.ones((2, SEQ), bool)
    mask[0, 8:] = False
    _check(jm, params, tm, mask=mask)
    vec = R.standard_normal(DIM).astype(np.float32)
    tok = int(IDS[0, 3])
    ref = jm.apply(params, jnp.asarray(IDS), return_embeddings=True,
                   inject=lambda i, e: jnp.where((i == tok)[..., None], vec,
                                                 e))
    with torch.no_grad():
        got = tm(t(IDS).long(), return_embeddings=True,
                 inject=lambda i, e: torch.where((i == tok)[..., None],
                                                 t(vec), e))
        plain = tm(t(IDS).long(), return_embeddings=True)
    _close(got, ref)
    assert (got - plain).abs().max() > 1e-3


def test_norms_and_residual_gating():
    for i, kw in enumerate((dict(use_scalenorm=True), dict(use_rmsnorm=True),
                            dict(use_rezero=True), dict(pre_norm=False),
                            dict(gate_residual=True))):
        _check(*_models(seed=i, **kw), return_embeddings=True)


def test_attention_extras_causal_and_position_infused():
    for i, kw in enumerate((
            dict(talking_heads=True, sparse_topk=5, num_mem_kv=3,
                 on_attn=True),
            dict(residual_attn=True), dict(causal=True),
            dict(position_infused_attn=True))):
        _check(*_models(seed=i, **kw), return_embeddings=True)


def test_cross_attention_and_layer_plans():
    cmask = np.ones((2, 7), bool)
    cmask[:, 5:] = False
    for i, kw in enumerate((dict(cross_attend=True, cross_residual_attn=True),
                            dict(cross_attend=True, only_cross=True))):
        _check(*_models(seed=i, context=True, **kw), return_embeddings=True,
               context=CTX, context_mask=cmask)
    for i, kw in enumerate((dict(sandwich_coef=1),
                            dict(custom_layers=("a", "f", "f")),
                            dict(par_ratio=2), dict(macaron=True),
                            dict(ff_glu=True))):
        jm, params, tm = _models(seed=10 + i, **kw)
        assert tm.cfg.layer_types == jm.cfg.layer_types
        _check(jm, params, tm, return_embeddings=True)
    for depth, kw in ((3, {}), (3, dict(cross_attend=True)),
                      (3, dict(sandwich_coef=2)), (3, dict(par_ratio=3))):
        assert txt.compute_layer_types(depth, **kw) == \
            jxt.compute_layer_types(depth, **kw)


def test_wrapper_memory_tokens_tied_logits_mems_and_maps():
    mask = np.ones((2, SEQ), bool)
    mask[1, 9:] = False
    _check(*_models(dict(num_memory_tokens=2, emb_dim=24), seed=1),
           mask=mask)
    _check(*_models(dict(tie_embedding=True), seed=2))
    jm, params, tm = _models(dict(max_mem_len=5), seed=3)
    mems = [R.standard_normal((2, 4, DIM)).astype(np.float32)
            for _ in range(DEPTH)]
    ref = jm.apply(params, jnp.asarray(IDS), return_embeddings=True,
                   mems=[jnp.asarray(m) for m in mems], return_mems=True)
    with torch.no_grad():
        got = tm(t(IDS).long(), return_embeddings=True,
                 mems=[t(m) for m in mems], return_mems=True)
    _close(got[0], ref[0])
    assert [tuple(m.shape) for m in got[1]] == [(2, 5, DIM)] * DEPTH
    for g, r in zip(got[1], ref[1]):
        _close(g, r)
    _check(jm, params, tm, return_embeddings=True, return_attn=True)


def _reference_state(params, wcfg, cfg):
    """The reference ``TransformerWrapper``'s state dict of a flax tree."""
    p = np_tree(params)["params"]
    out = {"token_emb.weight": p["token_emb"]}

    def lin(key, node):
        out[f"{key}.weight"] = node["kernel"].T
        if "bias" in node:
            out[f"{key}.bias"] = node["bias"]

    def norm(key, node):
        out[f"{key}.weight"] = node["LayerNorm_0"]["scale"]
        out[f"{key}.bias"] = node["LayerNorm_0"]["bias"]

    if "pos_emb" in p:
        out["pos_emb.emb.weight"] = p["pos_emb"]
    if "project_emb" in p:
        lin("project_emb", p["project_emb"])
    if "memory_tokens" in p:
        out["memory_tokens"] = p["memory_tokens"]
    norm("norm", p["norm"])
    if "to_logits" in p:
        lin("to_logits", p["to_logits"])
    layers = p["attn_layers"]
    for ind, lt in enumerate(cfg.layer_types):
        t_, n = f"attn_layers.layers.{ind}", f"layers_{ind}"
        if not cfg.use_rezero:
            node = layers[f"{n}_norm"]
            if "g" in node:
                out[f"{t_}.0.g"] = node["g"]
            else:
                norm(f"{t_}.0", node)
        blk = f"{t_}.1"
        if lt in ("a", "c"):
            if cfg.use_rezero:
                out[f"{blk}.g"] = layers[f"{n}_rezero_g"]
                blk += ".fn"
            a = layers[f"{n}_attn"]
            for q in ("to_q", "to_k", "to_v"):
                lin(f"{blk}.{q}", a[q])
            lin(f"{blk}.to_out.0" if cfg.on_attn else f"{blk}.to_out",
                a["to_out"])
            for q in ("pre_softmax_proj", "post_softmax_proj", "mem_k",
                      "mem_v"):
                if q in a:
                    out[f"{blk}.{q}"] = a[q]
        else:
            blk += ".fn" if cfg.macaron else ""
            ff = layers[f"{n}_ff"]
            if cfg.ff_glu:
                lin(f"{blk}.net.0.proj", ff["proj"])
            else:
                lin(f"{blk}.net.0.0", ff["fc1"])
            lin(f"{blk}.net.2", ff["fc2"])
        if cfg.gate_residual:
            for q in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                out[f"{t_}.2.gru.{q}"] = layers[f"{n}_gru"][q]
    return out


def test_convert_xtransformer_matches_the_jax_converter():
    for i, (wkw, kw) in enumerate((
            ({}, {}),
            (dict(num_memory_tokens=2, emb_dim=24), dict(use_rezero=True)),
            (dict(tie_embedding=True), dict(
                use_rmsnorm=True, talking_heads=True, num_mem_kv=2,
                on_attn=True, gate_residual=True, ff_glu=True)),
            ({}, dict(macaron=True, use_scalenorm=True)))):
        jm, params, tm = _models(wkw, seed=20 + i, **kw)
        state = _reference_state(params, jm.wcfg, jm.cfg)
        got = convert_xtransformer(
            {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
            tm.wcfg, tm.cfg)
        want = from_jax_params(np_tree(jconvert(state, jm.wcfg,
                                                        jm.cfg)))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        tm.load_state_dict(got, strict=True)
