"""PyTorch port, the legacy latent-diffusion family's modules against the
JAX package's, with one set of random weights carried across
(``bridge.from_jax_params``): the BERT tokenizer (ids bit for bit), the BERT
text encoder with and without the textual-inversion hook, ``ClassEmbedder``,
the UNet's ``AttentionBlock`` (interleaved qkv), FiLM and resampling
``ResBlock``s, the legacy UNet with ``num_head_channels``, the ldm encoder /
decoder with ``double_z=False``, ``attn_resolutions`` and
``attn_type='none'``, the VQ first stage, and ``SpatialRescaler``.

fp32 on the CPU; each output within 1e-4 of the reference's largest entry.
VQ indices may differ only where the two codes' distances lie within 1e-5
relative of each other.  The JAX side runs un-jitted (no compile).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from celebbasis_tpu.models import bert_text as jbert
from celebbasis_tpu.models import cond_stages as jcond
from celebbasis_tpu.models import unet as junet
from celebbasis_tpu.models import vae as jvae
from celebbasis_tpu.models import vq as jvq
from celebbasis_tpu.text import bert_tokenizer as jtok
from celebbasis_tpu_torch.models import bert_text as tbert
from celebbasis_tpu_torch.models import cond_stages as tcond
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.models import vae as tvae
from celebbasis_tpu_torch.models import vq as tvq
from celebbasis_tpu_torch.ops.basic import to_nchw, to_nhwc
from celebbasis_tpu_torch.text import bert_tokenizer as ttok
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import compiled, np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

KEY = jax.random.key(0)


def _close(got, ref, rel=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 1e-3                     # not an all-zero output
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (err, scale)


def _pair(jmod, tmod, *init_args, seed=0):
    params = random_params(jmod.init, KEY, *init_args, seed=seed)
    bridge.load_jax_params(tmod, np_tree(params))
    return params, tmod.eval()


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_bert_tokenizer_text_encoder_and_class_embedder(tmp_path):
    prompts = ["a painting of a * monster playing guitar",
               "Héllo, wörld!  unrelated photographs", "", "x " * 100]
    a, b = jtok.BERTTokenizer.synthetic(), ttok.BERTTokenizer.synthetic()
    np.testing.assert_array_equal(a(prompts), b(prompts))
    assert a.tokenize("*") == b.tokenize("*")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a",
                                "photo", "##graph", "##s", "un", "##related",
                                "of", ",", "!", "hello", "world"]) + "\n")
    a = jtok.default_bert_tokenizer(str(vocab))
    b = ttok.default_bert_tokenizer(str(vocab))
    np.testing.assert_array_equal(a(prompts), b(prompts))
    assert b.decode(b(prompts[1])[0]) == a.decode(a(prompts[1])[0])

    cfg = jbert.BERTTextConfig.tiny()
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 77))
    ids[:, 5] = 7                                   # the placeholder's rows
    params, tm = _pair(jbert.BERTTextEncoder(cfg, jnp.float32),
                       tbert.BERTTextEncoder(tbert.BERTTextConfig.tiny(),
                                             torch.float32),
                       jnp.zeros((1, 77), jnp.int32), seed=1)
    jm = jbert.BERTTextEncoder(cfg, jnp.float32)
    vec = _x((cfg.dim,), 2)
    j_inject = lambda i, e: jnp.where((i == 7)[..., None], vec, e)
    t_inject = lambda i, e: torch.where((i == 7)[..., None], t(vec), e)
    apply = compiled(jm.apply)
    with torch.no_grad():
        for jx, tx in ((None, None), (j_inject, t_inject)):
            ref = apply(params, jnp.asarray(ids, jnp.int32), jx)
            _close(tm(t(ids).long(), tx), ref)
        plain = tm(t(ids).long())
        injected = tm(t(ids).long(), t_inject)
    assert (plain - injected).abs().max() > 1e-3    # the hook took effect

    jc = jbert.ClassEmbedder(n_classes=11, embed_dim=16)
    params, tc = _pair(jc, tbert.ClassEmbedder(11, 16),
                       jnp.zeros((1,), jnp.int32), seed=3)
    labels = np.array([0, 10, 3])
    with torch.no_grad():
        got = tc(t(labels).long())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.apply(params, jnp.asarray(labels))))
    assert got.shape == (3, 1, 16)


def test_attention_block_and_legacy_resblocks():
    x = _x((2, 8, 8, 64), 4)
    # 4 heads of 16: a wrong split of the [head][q|k|v][dh] channels keeps
    # every shape; random weights show it
    params, tm = _pair(junet.AttentionBlock(4, jnp.float32),
                       tunet.AttentionBlock(64, 4, torch.float32),
                       jnp.zeros((1, 8, 8, 64)), seed=5)
    ref = jax.jit(junet.AttentionBlock(4, jnp.float32).apply)(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = to_nhwc(tm(to_nchw(t(x))))
    _close(got - t(x), np.asarray(ref) - x)       # the attention branch
    emb = _x((2, 96), 6)
    for out_ch, flags in ((128, dict(scale_shift=True)),
                          (64, dict(scale_shift=True, down=True)),
                          (64, dict(up=True)), (64, dict(down=True))):
        jm = junet.ResBlock(out_ch, jnp.float32, 0.0, **flags)
        params, tm = _pair(jm, tunet.ResBlock(64, out_ch, 96, torch.float32,
                                              **flags),
                           jnp.zeros((1, 8, 8, 64)), jnp.zeros((1, 96)),
                           seed=out_ch)
        ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(emb))
        with torch.no_grad():
            got = to_nhwc(tm(to_nchw(t(x)), t(emb)))
        _close(got, ref)


def test_legacy_unet_num_head_channels():
    """AttentionBlock everywhere, heads from num_head_channels (4 and 8 a
    level), FiLM conditioning and residual resampling; no context."""
    kw = dict(in_channels=3, out_channels=3, model_channels=32,
              attention_resolutions=(1, 2), num_res_blocks=1,
              channel_mult=(1, 2), num_heads=-1, num_head_channels=8,
              use_spatial_transformer=False, use_scale_shift_norm=True,
              resblock_updown=True)
    jm = junet.UNetModel(junet.UNetConfig(**kw), jnp.float32)
    tm = tunet.UNetModel(tunet.UNetConfig(**kw), torch.float32)
    assert tm.down_0_attn_0.heads == 4 and tm.mid_attn.heads == 8
    params, tm = _pair(jm, tm, jnp.zeros((1, 8, 8, 3)),
                       jnp.zeros((1,), jnp.int32), None, seed=7)
    x, ts = _x((2, 8, 8, 3), 8), np.array([3, 900], np.int32)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ts), None)
    with torch.no_grad():
        _close(tm(t(x), t(ts).long()), ref)


def test_ldm_backbone_legacy_knobs():
    """The ldm encoder and decoder with double_z=False: in-level attention
    at 8x8 (level 1 of a 16x16 input), or no attention block at all."""
    x, z = _x((2, 16, 16, 3), 9), _x((2, 8, 8, 3), 10)
    for kw, jcls, tcls, inp in (
            (dict(attn_resolutions=(8,)), jvae.Encoder, tvae.Encoder, x),
            (dict(attn_resolutions=(8,)), jvae.Decoder, tvae.Decoder, z),
            (dict(attn_type="none"), jvae.Encoder, tvae.Encoder, x),
            (dict(attn_type="none"), jvae.Decoder, tvae.Decoder, z)):
        cfg = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
                   embed_dim=3, double_z=False, resolution=16, **kw)
        jcfg, tcfg = jvae.VAEConfig(**cfg), tvae.VAEConfig(**cfg)
        tm = tcls(tcfg, torch.float32)
        names = {n for n, _ in tm.named_modules()}
        assert ("down_1_attn_0" in names or "up_1_attn_1" in names) == \
            bool(kw.get("attn_resolutions"))
        assert ("mid_attn" in names) == ("attn_type" not in kw)
        params, tm = _pair(jcls(jcfg, jnp.float32), tm,
                           jnp.zeros((1,) + inp.shape[1:]), seed=11)
        ref = jax.jit(jcls(jcfg, jnp.float32).apply)(params,
                                                     jnp.asarray(inp))
        with torch.no_grad():
            _close(to_nhwc(tm(to_nchw(t(inp)))), ref)


def test_vq_encode_quantize_decode():
    cfg = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
               embed_dim=3, double_z=False, resolution=16,
               attn_resolutions=(8,))
    jm = jvq.VQModelInterface(jvae.VAEConfig(**cfg), n_embed=64,
                              dtype=jnp.float32)
    params, tm = _pair(jm, tvq.VQModelInterface(
        tvae.VAEConfig(**cfg), n_embed=64, dtype=torch.float32),
        jnp.zeros((1, 16, 16, 3)), seed=12)
    x = np.tanh(_x((2, 16, 16, 3), 13))
    h_ref = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, method="encode"))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        h = tm.encode(t(x))
    _close(h, h_ref)
    # the quantizer on the same latents (the JAX encoder's)
    zq_ref, loss_ref, idx_ref = jax.jit(lambda p, z: jm.apply(
        p, z, method=lambda m, v: m.quantize(v)))(params, jnp.asarray(h_ref))
    with torch.no_grad():
        zq, loss, idx = tm.quantize(t(h_ref))
        d = tm.quantize.distances(t(h_ref))
    idx_ref = np.asarray(idx_ref).reshape(-1)
    flips = np.flatnonzero(idx.reshape(-1).numpy() != idx_ref)
    rows = torch.from_numpy(flips)
    gap = (d[rows, idx.reshape(-1)[rows]]
           - d[rows, torch.from_numpy(idx_ref[flips])]).abs()
    assert (gap <= 1e-5 * d[rows].abs().max(1).values).all(), (flips, gap)
    assert len(flips) <= 0.01 * idx_ref.size
    if len(flips) == 0:
        _close(zq, zq_ref)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    # decode quantizes first, or not
    for force in (False, True):
        ref = jax.jit(lambda p, h, f=force: jm.apply(
            p, h, f, method="decode"))(params, jnp.asarray(h_ref))
        with torch.no_grad():
            _close(tm.decode(t(h_ref), force_not_quantize=force), ref)


def test_spatial_rescaler():
    seg = _x((2, 16, 16, 5), 14)
    for kw in (dict(n_stages=2, out_channels=3, bias=True),
               dict(n_stages=1, method="nearest")):
        jm = jcond.SpatialRescaler(**kw)
        tm = tcond.SpatialRescaler(in_channels=5, **kw)
        if "out_channels" in kw:
            params, tm = _pair(jm, tm, jnp.zeros((1, 16, 16, 5)), seed=15)
        else:
            params = {}
        ref = jax.jit(jm.apply)(params, jnp.asarray(seg))
        with torch.no_grad():
            _close(tm(t(seg)), ref)
