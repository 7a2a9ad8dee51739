"""PyTorch port, the evaluation's networks against the JAX package, fp32 on
the CPU, with one set of weights made on the JAX side (``random_params``, or
the JAX ``convert_*`` of a numpy state dict in the torch layout) and carried
over.

* ``CLIPVisionEncoder`` and ``CLIPTextTower`` (tiny), ``SphereNet`` (tiny,
  through ``convert_sphere``: its fc reorders the torch file's channel-major
  flatten), ``InceptionV3`` pool3 (full width from a state dict of
  ``manifests/fid_inception.json``'s shapes, at a 75x75 input, the least
  the net takes) and ``IdentityEvaluator``'s embeddings and scores agree to
  1e-4 of the largest output (summation order over up to 2048 terms a
  layer); the identity scorer's captured forward (warp and net) runs as it
  is on the CPU, bit for bit, and builds no graph;
* the CLIP readers (OpenAI and HuggingFace layouts), the image
  preprocessing and the Inception resize are exactly equal (numpy on both
  sides, or a change of layout only); the bicubic weight matrices agree
  with ``F.interpolate(mode="bicubic")`` to 1e-5;
* the ``frechet_distance`` / ``_sqrtm_psd`` / ``activation_statistics``
  copies agree to 1e-6;
* every key of ``manifests/{clip_vit_b32,sphere20,fid_inception}.json`` is
  read onto the full-size modules on the ``meta`` device, with its shape.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from celebbasis_tpu.eval import evaluators as jev
from celebbasis_tpu.eval import fid as jfid
from celebbasis_tpu.eval import inception as jinc
from celebbasis_tpu.eval import sphere as jsphere
from celebbasis_tpu.models import clip_text as jclip_text
from celebbasis_tpu.models import clip_vit as jvit
from celebbasis_tpu_torch.eval import evaluators as tev
from celebbasis_tpu_torch.eval import fid as tfid
from celebbasis_tpu_torch.eval import inception as tinc
from celebbasis_tpu_torch.eval import sphere as tsphere
from celebbasis_tpu_torch.models import clip_vit as tvit
from celebbasis_tpu_torch.models.clip_text import CLIPTextConfig
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import hf_clip_state, np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4


def _close(got, ref, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _manifest(name):
    with open(os.path.join(REPO, "manifests", name)) as f:
        return json.load(f)["keys"]


def _torch_layout_state(shapes, seed):
    """Random float32 values for torch-layout keys: He-scaled conv and fc
    weights, BatchNorm statistics and affine near their neutral values,
    PReLU slopes of 0.25 +- 0.1."""
    r = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.array(0, np.int64)
        elif len(s) >= 2:
            out[k] = r.standard_normal(s) * (2.0 / np.prod(s[1:])) ** 0.5
        elif k.endswith("running_var"):
            out[k] = r.uniform(0.5, 1.5, s)
        elif "prelu" in k or k.endswith(".1.weight"):
            out[k] = r.uniform(0.15, 0.35, s)
        elif k.endswith("weight"):
            out[k] = r.uniform(0.8, 1.2, s)
        else:
            out[k] = r.standard_normal(s) * 0.1
        out[k] = np.asarray(out[k], np.float32 if out[k].dtype.kind == "f"
                            else out[k].dtype)
    return out


def test_clip_towers_match_jax():
    vcfg = tvit.CLIPVisionConfig.tiny()
    jvis = jvit.CLIPVisionEncoder(jvit.CLIPVisionConfig.tiny())
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    vp = random_params(jvis.init, jax.random.key(0), jnp.asarray(x), seed=1)
    vis = tvit.CLIPVisionEncoder(vcfg)
    bridge.load_jax_params(vis, np_tree(vp))
    with torch.no_grad():
        _close(vis(t(x)), jax.jit(jvis.apply)(vp, jnp.asarray(x)))

    jtxt = jvit.CLIPTextTower(jclip_text.CLIPTextConfig.tiny(),
                              proj_dim=vcfg.proj_dim)
    tok = CLIPTokenizer.synthetic(1024)
    ids = np.asarray(tok(["a photo of a face", "two people on a beach"]))
    tp = random_params(jtxt.init, jax.random.key(0), jnp.asarray(ids), seed=2)
    txt = tvit.CLIPTextTower(CLIPTextConfig.tiny(), proj_dim=vcfg.proj_dim)
    bridge.load_jax_params(txt, np_tree(tp))
    with torch.no_grad():
        _close(txt(t(ids).long()), jax.jit(jtxt.apply)(tp, jnp.asarray(ids)))


def _openai_state(vcfg, tcfg, seed):
    """An OpenAI-layout CLIP state dict (fused in_proj, ``visual.*``)."""
    r = np.random.default_rng(seed)
    W, T = vcfg.width, tcfg.width
    tokens = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    shapes = {"visual.conv1.weight": (W, 3, vcfg.patch_size,
                                      vcfg.patch_size),
              "visual.class_embedding": (W,),
              "visual.positional_embedding": (tokens, W),
              "visual.proj": (W, vcfg.proj_dim),
              "token_embedding.weight": (tcfg.vocab_size, T),
              "positional_embedding": (tcfg.max_length, T),
              "text_projection": (T, vcfg.proj_dim), "logit_scale": ()}
    for pre, w, n in (("visual.", W, vcfg.layers), ("", T, tcfg.layers)):
        for name in ("ln_pre", "ln_post") if pre else ("ln_final",):
            shapes[f"{pre}{name}.weight"] = shapes[f"{pre}{name}.bias"] = (w,)
        hidden = 4 * w if pre else tcfg.mlp_dim
        for i in range(n):
            s = f"{pre}transformer.resblocks.{i}."
            for ln in ("ln_1", "ln_2"):
                shapes[s + ln + ".weight"] = shapes[s + ln + ".bias"] = (w,)
            shapes.update({
                s + "attn.in_proj_weight": (3 * w, w),
                s + "attn.in_proj_bias": (3 * w,),
                s + "attn.out_proj.weight": (w, w),
                s + "attn.out_proj.bias": (w,),
                s + "mlp.c_fc.weight": (hidden, w),
                s + "mlp.c_fc.bias": (hidden,),
                s + "mlp.c_proj.weight": (w, hidden),
                s + "mlp.c_proj.bias": (w,)})
    return {k: r.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _hf_state(vcfg, tcfg, seed):
    """A HuggingFace ``CLIPModel`` state dict of the same sizes."""
    r = np.random.default_rng(seed)
    W = vcfg.width
    tokens = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    v = "vision_model."
    shapes = {v + "embeddings.patch_embedding.weight":
              (W, 3, vcfg.patch_size, vcfg.patch_size),
              v + "embeddings.class_embedding": (W,),
              v + "embeddings.position_embedding.weight": (tokens, W),
              "visual_projection.weight": (vcfg.proj_dim, W),
              "text_projection.weight": (vcfg.proj_dim, tcfg.width)}
    for name in ("pre_layrnorm", "post_layernorm"):
        shapes[f"{v}{name}.weight"] = shapes[f"{v}{name}.bias"] = (W,)
    for i in range(vcfg.layers):
        s = f"{v}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            shapes[s + ln + ".weight"] = shapes[s + ln + ".bias"] = (W,)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[s + f"self_attn.{p}.weight"] = (W, W)
            shapes[s + f"self_attn.{p}.bias"] = (W,)
        shapes.update({s + "mlp.fc1.weight": (4 * W, W),
                       s + "mlp.fc1.bias": (4 * W,),
                       s + "mlp.fc2.weight": (W, 4 * W),
                       s + "mlp.fc2.bias": (W,)})
    out = {k: r.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    out.update(hf_clip_state(tcfg, seed=seed + 1, prefix=""))
    return out


def test_clip_readers_and_preprocessing_equal_jax():
    vcfg, tcfg = tvit.CLIPVisionConfig.tiny(), CLIPTextConfig.tiny()
    jv, jt = jvit.CLIPVisionConfig.tiny(), jclip_text.CLIPTextConfig.tiny()
    for make, ours, theirs in (
            (_openai_state, tvit.convert_openai_clip,
             jvit.convert_openai_clip),
            (_hf_state, tvit.convert_hf_clip, jvit.convert_hf_clip)):
        state = make(vcfg, tcfg, seed=3)
        used = set()
        got = ours(state, vcfg, tcfg, used=used)
        assert set(state) - used <= {"logit_scale",
                                     "text_model.embeddings.position_ids"}
        for g, ref, module in zip(got, theirs(state, jv, jt), (
                tvit.CLIPVisionEncoder(vcfg),
                tvit.CLIPTextTower(tcfg, proj_dim=vcfg.proj_dim))):
            ref = bridge.from_jax_params(np_tree(ref))
            assert sorted(g) == sorted(ref)
            for k in ref:
                assert torch.equal(g[k], ref[k]), k
            module.load_state_dict(g, strict=True)

    r = np.random.default_rng(4)
    for hw in ((40, 56), (56, 40), (32, 32)):
        imgs = r.uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
        np.testing.assert_array_equal(tvit.preprocess_images(imgs, 32),
                                      jvit.preprocess_images(imgs, 32))
    x = r.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    ref = F.interpolate(t(x).permute(0, 3, 1, 2), size=(32, 44),
                        mode="bicubic", align_corners=False)
    np.testing.assert_allclose(tvit.bicubic_resize_torch(x, (32, 44)),
                               ref.permute(0, 2, 3, 1).numpy(), atol=1e-5)


def test_sphere_matches_jax():
    cfg = tsphere.SphereConfig.tiny()
    jnet = jsphere.SphereNet(jsphere.SphereConfig.tiny())
    x = np.random.default_rng(5).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    shapes = {f"module.{k}": tuple(v.shape) for k, v in
              _torch_sphere_shapes(cfg).items()}
    state = _torch_layout_state(shapes, seed=6)
    jparams = jsphere.convert_sphere(state, jsphere.SphereConfig.tiny())
    net = tsphere.SphereNet(cfg)
    used = set()
    net.load_state_dict(tsphere.convert_sphere(state, cfg, used=used),
                        strict=True)
    assert used == {k[7:] for k in state}
    np.testing.assert_array_equal(
        net.fc.weight.detach().numpy(), jparams["params"]["fc"]["kernel"].T)
    with torch.no_grad():
        _close(net(t(x)), jnet.apply(jparams, jnp.asarray(x)))


def _torch_sphere_shapes(cfg):
    """The torch sphere net's keys (``nn.Sequential`` stages) and shapes."""
    out, cin, size = {}, 3, cfg.input_size
    for li, (n, c) in enumerate(zip(cfg.layers, cfg.filters), start=1):
        out[f"layer{li}.0.weight"] = torch.empty(c, cin, 3, 3)
        out[f"layer{li}.0.bias"] = torch.empty(c)
        out[f"layer{li}.1.weight"] = torch.empty(c)
        for b in range(n):
            s = f"layer{li}.{2 + b}."
            for j in (1, 2):
                out[f"{s}conv{j}.weight"] = torch.empty(c, c, 3, 3)
                out[f"{s}prelu{j}.weight"] = torch.empty(c)
        cin, size = c, (size + 1) // 2
    out["fc.weight"] = torch.empty(cfg.feat_dim, cin * size * size)
    out["fc.bias"] = torch.empty(cfg.feat_dim)
    return out


def test_inception_pool3_matches_jax():
    keys = _manifest("fid_inception.json")
    state = _torch_layout_state(keys, seed=7)
    variables = jinc.convert_inception(state)
    net = tinc.InceptionV3().eval()
    net.load_state_dict(tinc.convert_inception(state), strict=True)
    r = np.random.default_rng(8)
    u8 = r.integers(0, 256, (2, 60, 90, 3), dtype=np.uint8)
    x = tinc.preprocess(u8, size=75)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jinc.preprocess(
        u8, size=75)))
    with torch.no_grad():
        got = net(x)
    ref = jax.jit(jinc.InceptionV3().apply)(variables,
                                            jnp.asarray(x.numpy()))
    assert got.shape == (2, tinc.POOL3_DIM) and np.abs(ref).max() > 1e-3
    _close(got, ref)


def test_identity_evaluator_matches_jax():
    cfg = tsphere.SphereConfig.tiny()
    jcfg = jsphere.SphereConfig.tiny()
    state = _torch_layout_state({k: tuple(v.shape) for k, v in
                                 _torch_sphere_shapes(cfg).items()}, seed=9)
    jeval = jev.IdentityEvaluator(jsphere.convert_sphere(state, jcfg),
                                  cfg=jcfg, img_size=64, face_size=32)
    teval = tev.IdentityEvaluator(tsphere.convert_sphere(state, cfg),
                                  cfg=cfg, img_size=64, face_size=32,
                                  device="cpu")
    r = np.random.default_rng(10)
    crops = r.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    got = teval.embed_crops(crops)
    _close(got, jeval.embed_crops(crops))
    # the captured forward runs as it is on CPU tensors: no graph
    with torch.no_grad():
        plain = teval._embed_fn(torch.from_numpy(crops)).numpy()
    np.testing.assert_array_equal(got, plain)
    assert teval._embed.capture_s == {}
    src, gen = crops[:1], r.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    got, ref = teval.start_calc(src, gen), jeval.start_calc(src, gen)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_fid_copies_match_jax():
    r = np.random.default_rng(11)
    a = r.standard_normal((20, 8)).astype(np.float64)
    b = (r.standard_normal((30, 8)) * 1.5 + 0.3).astype(np.float64)
    sa, sb = tfid.activation_statistics(a), tfid.activation_statistics(b)
    for got, ref in zip(sa + sb, jfid.activation_statistics(a)
                        + jfid.activation_statistics(b)):
        np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(tfid.frechet_distance(*sa, *sb),
                               jfid.frechet_distance(*sa, *sb), atol=1e-6)
    # a rank-deficient covariance (fewer samples than dimensions)
    low = tfid.activation_statistics(a[:4])
    np.testing.assert_allclose(tfid.frechet_distance(*low, *sb),
                               jfid.frechet_distance(*low, *sb), atol=1e-6)
    np.testing.assert_allclose(tfid._sqrtm_psd(sb[1]),
                               jfid._sqrtm_psd(sb[1]), atol=1e-6)
    assert abs(tfid.frechet_distance(*sa, *sa)) < 1e-6


def test_every_manifest_key_lands_on_the_meta_device():
    def meta(name):
        return {k: torch.empty(s, device="meta")
                for k, s in _manifest(name).items()}

    def fills(module, sd):
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in module.state_dict().items()}

    state, used = meta("clip_vit_b32.json"), set()
    vcfg = tvit.CLIPVisionConfig.vit_b32()
    vision, text = tvit.convert_hf_clip(state, vcfg, tvit.text_config_b32(),
                                        used=used)
    with torch.device("meta"):
        fills(tvit.CLIPVisionEncoder(vcfg), vision)
        fills(tvit.CLIPTextTower(tvit.text_config_b32()), text)
    assert set(state) - used == {"logit_scale"}

    state, used = meta("sphere20.json"), set()
    with torch.device("meta"):
        fills(tsphere.SphereNet(tsphere.SphereConfig.sphere20()),
              tsphere.convert_sphere(state, used=used))
    assert used == set(state)

    state = meta("fid_inception.json")
    with torch.device("meta"):
        fills(tinc.InceptionV3(), tinc.convert_inception(state))
    assert len(state) == 564
