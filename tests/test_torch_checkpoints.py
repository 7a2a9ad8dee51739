"""PyTorch port: the pretrained-checkpoint readers (``utils/bridge.py``
``convert_*``, ``load_sd_checkpoint``, ``load_iresnet_checkpoint``), the
restricted ``utils/pt_io.load_pt`` and ``loader.assemble(sd_ckpt=...,
fr_ckpt=...)``.

At tiny size the port's readers give exactly (tolerance 0: a change of
layout only) the state dict of the JAX package's ``convert_*`` followed by
``from_jax_params``.  The CompVis UNet and VAE dicts come from random tiny
flax params through the JAX ``export_unet`` / ``export_vae``; the HF CLIP
text and insightface IResNet dicts, which have no JAX export, are built here
from the key pattern the converters read.  At SD width, on the ``meta``
device, every key of ``manifests/sd-v1-4.json`` and ``cosface_r100.json``
lands on the port's modules with its shape.
"""
import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.models import unet as junet
from celebbasis_tpu.models import vae as jvae
from celebbasis_tpu.utils import bridge as jbridge
from celebbasis_tpu.utils.config import load_run_spec as jload_run_spec
from celebbasis_tpu_torch.loader import assemble
from celebbasis_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                   CLIPTextEncoder)
from celebbasis_tpu_torch.models.iresnet import IResNet, IResNetConfig
from celebbasis_tpu_torch.models.unet import UNetConfig, UNetModel
from celebbasis_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from celebbasis_tpu_torch.utils import bridge, pt_io
from celebbasis_tpu_torch.utils.config import load_run_spec

from _torch_port_helpers import hf_clip_state, np_tree, random_params
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny.yaml")
CLIP_PREFIX = "cond_stage_model.transformer."


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _assert_same(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == torch.float32, k
        assert torch.equal(ours[k], ref[k]), k


def _jax_then_bridge(params):
    return bridge.from_jax_params(np_tree(params))


@pytest.fixture(scope="module")
def compvis():
    """The tiny config's UNet and VAE as CompVis state dicts (numpy), made by
    the JAX package's exporters from random flax params."""
    jspec = jload_run_spec([TINY])
    um = junet.UNetModel(jspec.unet, jnp.float32)
    uparams = random_params(um.init, jax.random.key(0),
                            jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 77, jspec.unet.context_dim)), seed=1)
    vm = jvae.AutoencoderKL(jspec.vae, jnp.float32)
    vparams = random_params(vm.init, jax.random.key(0),
                            jnp.zeros((1, 16, 16, 3)), jax.random.key(1),
                            seed=2)
    unet = jbridge.export_unet(np_tree(uparams), jspec.unet)
    vae = {f"first_stage_model.{k}": v for k, v in jbridge.export_vae(
        np_tree(vparams), jspec.vae.ch_mult,
        jspec.vae.num_res_blocks).items()}
    return jspec, unet, vae


def insightface_state(cfg: IResNetConfig, seed=0, dtype=np.float16):
    """An insightface ``iresnet`` state dict (fp16 like the CosFace file),
    with ``num_batches_tracked`` counters."""
    r = np.random.default_rng(seed)
    out = {}

    def conv(name, o, i, k):
        out[name + ".weight"] = r.standard_normal((o, i, k, k),
                                                  dtype=np.float32) * 0.1

    def bn(name, c):
        out.update({name + ".weight": r.uniform(0.5, 1.5, c),
                    name + ".bias": r.standard_normal(c) * 0.1,
                    name + ".running_mean": r.standard_normal(c) * 0.1,
                    name + ".running_var": r.uniform(0.5, 1.5, c)})
        out[name + ".num_batches_tracked"] = np.array(7)

    b = cfg.base
    conv("conv1", b, 3, 3)
    bn("bn1", b)
    out["prelu.weight"] = r.uniform(0.1, 0.4, b)
    cur, size = b, cfg.input_size
    for li, n in enumerate(cfg.layers):
        planes = b * 2 ** li
        for bi in range(n):
            s = f"layer{li + 1}.{bi}"
            bn(f"{s}.bn1", cur)
            conv(f"{s}.conv1", planes, cur, 3)
            bn(f"{s}.bn2", planes)
            out[f"{s}.prelu.weight"] = r.uniform(0.1, 0.4, planes)
            conv(f"{s}.conv2", planes, planes, 3)
            bn(f"{s}.bn3", planes)
            if bi == 0:
                conv(f"{s}.downsample.0", planes, cur, 1)
                bn(f"{s}.downsample.1", planes)
            cur = planes
        size = (size + 1) // 2
    bn("bn2", cur)
    out["fc.weight"] = r.standard_normal((cfg.feat_dim, cur * size * size),
                                         dtype=np.float32)
    out["fc.bias"] = r.standard_normal(cfg.feat_dim)
    bn("features", cfg.feat_dim)
    return {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in out.items()}


def test_unet_and_vae_readers_match_jax(compvis):
    jspec, unet, vae = compvis
    spec = load_run_spec([TINY])
    _assert_same(bridge.convert_unet(_torch(unet), spec.unet),
                 _jax_then_bridge(jbridge.convert_unet(unet, jspec.unet)))
    _assert_same(bridge.convert_vae(_torch(vae), spec.vae),
                 _jax_then_bridge(jbridge.convert_vae(
                     vae, jspec.vae.ch_mult, jspec.vae.num_res_blocks)))


@pytest.mark.parametrize("text_model", [True, False])
def test_clip_reader_matches_jax(text_model):
    cfg = CLIPTextConfig.tiny()
    state = hf_clip_state(cfg, text_model=text_model)
    used = set()
    ours = bridge.convert_clip_text(_torch(state), cfg.layers, used=used)
    _assert_same(ours, _jax_then_bridge(
        jbridge.convert_clip_text(state, cfg.layers)))
    assert set(state) - used == {
        CLIP_PREFIX + ("text_model." if text_model else "")
        + "embeddings.position_ids"}
    CLIPTextEncoder(cfg).load_state_dict(ours, strict=True)


def test_iresnet_reader_matches_jax_and_casts_fp16():
    cfg = IResNetConfig.tiny()
    state = insightface_state(cfg)
    used = set()
    ours = bridge.convert_iresnet(_torch(state), cfg.layers, used=used)
    # the JAX reader is handed float32, as its loader does
    ref = _jax_then_bridge(jbridge.convert_iresnet(
        {k: np.asarray(v, np.float32) for k, v in state.items()}, cfg.layers))
    _assert_same(ours, ref)
    assert sorted(set(state) - used) == sorted(
        k for k in state if k.endswith("num_batches_tracked"))
    # fc's input axis was reordered from (C, H, W) to (H, W, C)
    C, side = cfg.base * 8, 2
    fc = torch.from_numpy(state["fc.weight"].astype(np.float32))
    assert torch.equal(ours["fc.weight"][:, 1 * side * C + 0 * C + 3],
                       fc[:, 3 * side * side + 1 * side + 0])
    IResNet(cfg, dtype=torch.float32).load_state_dict(ours, strict=True)


def test_a_missing_key_or_a_wrong_shape_raises(compvis):
    _, unet, _ = compvis
    spec = load_run_spec([TINY])
    state = _torch(unet)
    del state["model.diffusion_model.out.2.weight"]
    with pytest.raises(KeyError, match="out.2.weight"):
        bridge.convert_unet(state, spec.unet)
    state = _torch(unet)
    state["model.diffusion_model.time_embed.0.weight"] = torch.zeros(3, 3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        UNetModel(spec.unet).load_state_dict(
            bridge.convert_unet(state, spec.unet), strict=True)


class _Marker:
    """Removes ``path`` if it is ever unpickled by running the pickle."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (os.remove, (self.path,))


def test_lightning_ckpt_loads_through_assemble(compvis, tmp_path):
    """A Lightning-style ``.ckpt``: ``state_dict`` beside callback objects of
    a class that cannot be imported at load time and an object whose pickle
    would run code; DDPM buffers and ``model_ema.*`` are reported unused.
    The fp16 backbone loads into the face net as float32."""
    _, unet, vae = compvis
    spec = load_run_spec([TINY])
    r = np.random.default_rng(3)
    extras = {"betas": r.uniform(size=1000), "alphas_cumprod":
              r.uniform(size=1000), "logvar": np.zeros(1000),
              "model_ema.decay": np.array(0.9999),
              "model_ema.num_updates": np.array(5, np.int64),
              "model_ema.diffusion_modelout2weight": r.standard_normal(4)}
    state = {**unet, **vae, **hf_clip_state(spec.clip, seed=4), **extras}
    mod = types.ModuleType("lightning_stand_in")
    cls = type("ModelCheckpoint", (), {"__module__": mod.__name__})
    mod.ModelCheckpoint = cls
    marker = tmp_path / "marker"
    marker.write_text("")
    sys.modules[mod.__name__] = mod
    try:
        ckpt = {"state_dict": _torch(state), "global_step": 470000,
                "callbacks": {cls: {"best_model_score": None}},
                "hyper_parameters": cls(), "trap": _Marker(str(marker))}
        torch.save(ckpt, tmp_path / "sd.ckpt")
    finally:
        del sys.modules[mod.__name__]
    with pytest.raises(pickle.UnpicklingError):       # what torch refuses
        torch.load(tmp_path / "sd.ckpt", weights_only=True)

    raw = pt_io.load_pt(str(tmp_path / "sd.ckpt"))
    assert marker.exists() and raw["global_step"] == 470000
    assert isinstance(raw["trap"], pt_io.Stub)
    (key,) = raw["callbacks"]
    assert key.__name__ == "ModelCheckpoint"
    assert "lightning_stand_in" not in sys.modules

    face_cfg = IResNetConfig.r100()
    torch.save(_torch(insightface_state(face_cfg, seed=5)),
               tmp_path / "backbone.pth")
    asm = assemble(spec, sd_ckpt=str(tmp_path / "sd.ckpt"),
                   fr_ckpt=str(tmp_path / "backbone.pth"), device="cpu",
                   dtype=torch.float32, cache_dir=None)
    assert asm.unused_keys["sd"] == sorted(
        list(extras) + [CLIP_PREFIX + "text_model.embeddings.position_ids"])
    assert all(k.endswith("num_batches_tracked")
               for k in asm.unused_keys["fr"])
    pipe = asm.pipeline
    assert torch.equal(pipe.unet.conv_in.weight, torch.from_numpy(
        unet["model.diffusion_model.input_blocks.0.0.weight"]))
    assert torch.equal(pipe.vae.decoder.conv_out.bias, torch.from_numpy(
        vae["first_stage_model.decoder.conv_out.bias"]))
    table = state[CLIP_PREFIX + "text_model.embeddings.token_embedding.weight"]
    np.testing.assert_array_equal(pipe.token_table(), table)
    stem = asm.meta_net.fr_net.stem_conv.weight
    assert stem.dtype == torch.float32 and torch.equal(
        stem, torch.load(tmp_path / "backbone.pth")["conv1.weight"].float())


def test_every_manifest_key_lands_at_sd_width():
    """On the ``meta`` device: each key of the SD v1.4 and CosFace R100
    manifests is used, and the converted dicts fill the SD-width modules
    with the manifests' shapes."""
    def meta_state(name):
        with open(os.path.join(REPO, "manifests", name)) as f:
            keys = json.load(f)["keys"]
        return {k: torch.empty(s, device="meta") for k, s in keys.items()}

    def fills(module, sd):
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == want

    sd_state = meta_state("sd-v1-4.json")
    used = set()
    with torch.device("meta"):
        fills(UNetModel(UNetConfig.sd_v1()),
              bridge.convert_unet(sd_state, used=used))
        fills(AutoencoderKL(VAEConfig.sd_v1()),
              bridge.convert_vae(sd_state, used=used))
        fills(CLIPTextEncoder(CLIPTextConfig.sd_v1()),
              bridge.convert_clip_text(sd_state, used=used))
    assert used == set(sd_state) and len(used) == 1130

    fr_state = meta_state("cosface_r100.json")
    used = set()
    with torch.device("meta"):
        fills(IResNet(IResNetConfig.r100()),
              bridge.convert_iresnet(fr_state, used=used))
    assert set(fr_state) - used == {k for k in fr_state
                                    if k.endswith("num_batches_tracked")}

