"""PyTorch port, the legacy family's weight carriers: the port's
``convert_vq``, ``convert_bert_text`` and ``convert_unet`` (``AttentionBlock``
and residual resampling) read one synthetic CompVis-layout state dict to the
tensors the JAX package's converters read it to (carried over by
``from_jax_params``), bit for bit; ``from_jax_params`` covers a whole
``LegacyLDM`` params tree; ``legacy.load_reference_checkpoint`` reads a
``.ckpt`` of every part and uses every key; ``get_learned_conditioning`` and
``calibrate_scale`` agree with the JAX ``LegacyLDM``'s.

The synthetic state dicts come from random flax trees through the JAX
package's exporters (``export_unet``, ``export_vq``, ``export_bert_text``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from celebbasis_tpu import legacy as jlegacy
from celebbasis_tpu.models import bert_text as jbert
from celebbasis_tpu.models import unet as junet
from celebbasis_tpu.models import vae as jvae
from celebbasis_tpu.models import vq as jvq
from celebbasis_tpu.utils import bridge as jbridge
from celebbasis_tpu_torch import legacy as tlegacy
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.models import vae as tvae
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import np_tree, random_params
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.key(0)


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _assert_same(got, jax_tree):
    want = bridge.from_jax_params(np_tree(jax_tree))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_vq_matches_the_jax_converter():
    for kw in (dict(attn_resolutions=(8,)), dict(attn_type="none")):
        cfg = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
                   embed_dim=3, double_z=False, resolution=16, **kw)
        jm = jvq.VQModelInterface(jvae.VAEConfig(**cfg), n_embed=32,
                                  dtype=jnp.float32)
        params = random_params(jm.init, KEY, jnp.zeros((1, 16, 16, 3)),
                               seed=1)
        arch = dict(ch_mult=cfg["ch_mult"], num_res_blocks=1,
                    attn_resolutions=kw.get("attn_resolutions", ()),
                    resolution=16, attn_type=kw.get("attn_type", "vanilla"))
        state = {f"first_stage_model.{k}": v for k, v in
                 jbridge.export_vq(np_tree(params), **arch).items()}
        used = set()
        got = bridge.convert_vq(_torch_state(state), tvae.VAEConfig(**cfg),
                                used=used)
        _assert_same(got, jbridge.convert_vq(state, **arch))
        assert used == set(state)
        assert "quantize.weight" in got


def test_convert_bert_text_matches_the_jax_converter():
    cfg = jbert.BERTTextConfig(vocab_size=97, dim=48, depth=2)
    jm = jbert.BERTTextEncoder(cfg, jnp.float32)
    params = random_params(jm.init, KEY, jnp.zeros((1, 77), jnp.int32),
                           seed=2)
    state = jbridge.export_bert_text(np_tree(params), depth=2)
    state["cond_stage_model.transformer.to_logits.weight"] = np.zeros(
        (97, 48), np.float32)                  # not read: embeddings only
    used = set()
    got = bridge.convert_bert_text(_torch_state(state), depth=2, used=used)
    _assert_same(got, jbridge.convert_bert_text(state, depth=2))
    assert set(state) - used == {
        "cond_stage_model.transformer.to_logits.weight"}


def test_convert_unet_attention_block_and_updown_matches_the_jax_converter():
    kw = dict(in_channels=3, out_channels=3, model_channels=32,
              attention_resolutions=(1, 2), num_res_blocks=1,
              channel_mult=(1, 2), num_heads=-1, num_head_channels=8,
              use_spatial_transformer=False, use_scale_shift_norm=True,
              resblock_updown=True)
    jcfg = junet.UNetConfig(**kw)
    jm = junet.UNetModel(jcfg, jnp.float32)
    params = random_params(jm.init, KEY, jnp.zeros((1, 8, 8, 3)),
                           jnp.zeros((1,), jnp.int32), None, seed=3)
    state = jbridge.export_unet(np_tree(params), jcfg)
    assert state["model.diffusion_model.middle_block.1.qkv.weight"].ndim == 3
    used = set()
    got = bridge.convert_unet(_torch_state(state), tunet.UNetConfig(**kw),
                              used=used)
    _assert_same(got, jbridge.convert_unet(state, jcfg))
    assert used == set(state)


def test_legacy_ldm_tree_and_reference_checkpoint(tmp_path):
    """A whole tiny BERT-conditioned LegacyLDM: the JAX params tree loads
    strictly into the port's module, and a CompVis ``.ckpt`` of the same
    weights reads back to the same state with every key used."""
    with open(os.path.join(REPO, "configs", "tiny_legacy_bert.yaml")) as f:
        cfg = yaml.safe_load(f)
    jl = jlegacy.build_legacy_ldm(cfg, dtype=jnp.float32)
    params = random_params(jl.init_params, KEY, seed=4)
    tl = tlegacy.build_legacy_ldm(cfg, dtype=torch.float32)
    tl.load_state_dict(bridge.from_jax_params(np_tree(params)), strict=True)
    ucfg, vcfg = jl.unet.cfg, jl.first_stage.cfg
    state = dict(jbridge.export_unet(np_tree(params["unet"]), ucfg))
    state.update({f"first_stage_model.{k}": v for k, v in jbridge.export_vae(
        np_tree(params["first_stage"]), vcfg.ch_mult,
        vcfg.num_res_blocks).items()})
    state.update(jbridge.export_bert_text(np_tree(params["cond_stage"]),
                                          depth=jl.cond_stage.cfg.depth))
    path = str(tmp_path / "model.ckpt")
    torch.save({"state_dict": _torch_state(state)}, path)
    fresh = tlegacy.build_legacy_ldm(cfg, dtype=torch.float32)
    assert tlegacy.load_reference_checkpoint(fresh, path) == []
    want = tl.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_learned_conditioning_kinds_and_calibrate_scale(monkeypatch):
    """get_learned_conditioning on both sides for the cond stages the CLI
    tests do not reach (SpatialRescaler, Identity, ClassEmbedder,
    FrozenCLIPEmbedder: its ViT-L/14 text tower narrowed to 2 layers of 64
    on both sides, the vocabulary kept), and scale_by_std's calibration,
    with one set of random weights."""
    from celebbasis_tpu.models import clip_text as jclip
    from celebbasis_tpu_torch.models import clip_text as tclip
    for mod in (jclip, tclip):
        narrow = mod.CLIPTextConfig(width=64, layers=2, heads=4, mlp_dim=128)
        monkeypatch.setattr(mod.CLIPTextConfig, "sd_v1",
                            staticmethod(lambda n=narrow: n))
    with open(os.path.join(REPO, "configs", "tiny_legacy.yaml")) as f:
        base = yaml.safe_load(f)
    r = np.random.default_rng(5)
    cases = (
        ({"target": "ldm.modules.encoders.modules.SpatialRescaler",
          "params": {"n_stages": 1, "in_channels": 5, "out_channels": 3}},
         "concat", r.standard_normal((2, 32, 32, 5)).astype(np.float32)),
        ({"target": "torch.nn.Identity"}, "concat",
         r.standard_normal((2, 16, 16, 3)).astype(np.float32)),
        ({"target": "ldm.modules.encoders.modules.ClassEmbedder",
          "params": {"n_classes": 7, "embed_dim": 16}}, "crossattn",
         np.array([0, 6])),
        ({"target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder"},
         "crossattn", ["a photo of a cat", ""]))
    for i, (cond, mode, batch) in enumerate(cases):
        cfg = yaml.safe_load(yaml.safe_dump(base))
        cfg["model"]["params"].update(cond_stage_config=cond,
                                      conditioning_key=mode,
                                      scale_by_std=True)
        jl = jlegacy.build_legacy_ldm(cfg, dtype=jnp.float32)
        params = random_params(jl.init_params, KEY, seed=10 + i)
        tl = tlegacy.build_legacy_ldm(cfg, dtype=torch.float32)
        tl.load_state_dict(bridge.from_jax_params(np_tree(params)),
                           strict=True)
        assert tl.cond_kind == jl.cond_kind and tl.cond_mode == mode
        ref = np.asarray(jl.get_learned_conditioning(params, batch))
        with torch.no_grad():
            got = tl.get_learned_conditioning(batch).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), cond
    images = np.tanh(r.standard_normal((2, 32, 32, 3))).astype(np.float32)
    jl.calibrate_scale(params, jnp.asarray(images))
    tl.calibrate_scale(torch.from_numpy(images))
    np.testing.assert_allclose(tl.scale_factor, jl.scale_factor, rtol=1e-4)
    assert tl.scale_factor != 1.0
