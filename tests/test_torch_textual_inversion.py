"""PyTorch port, the textual-inversion baseline and the rest of the losses
against the JAX package, on the CPU:

* ``init_ti_params`` (the numpy draw), ``placeholder_token_ids``,
  ``ti_inject`` and ``embedding_reg_loss``: exactly equal;
* TI checkpoints both ways (the port's file read by the JAX reader and by
  ``torch.load(weights_only=True)``, the JAX file by the port), the merge's
  collision error and rename, and ``cli/merge.py``;
* ``PersonalizedBase`` items bit for bit from one seed;
* the five ``MarginHead`` kinds and ``margin_cross_entropy`` (to 1e-5 of
  the logits' scale, fp32 arccos / cos differ by a few ulps between the two
  libraries), and the EMA helpers (to 1e-6);
* ``make_txt2img_ti_fn`` at tiny size with DDIM and with PLMS: float images
  within 1e-3 and uint8 pixels within one level, the limits of
  ``test_torch_pipeline.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from celebbasis_tpu.core import losses as jlosses
from celebbasis_tpu.core import textual_inversion as jti
from celebbasis_tpu.data import personalized as jpers
from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from celebbasis_tpu_torch.cli import merge
from celebbasis_tpu_torch.core import losses as tlosses
from celebbasis_tpu_torch.core import textual_inversion as tti
from celebbasis_tpu_torch.data import personalized as tpers
from celebbasis_tpu_torch.pipeline import finish_images
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (compiled, np_tree, random_params, t,
                                 tiny_pipelines)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

NAMES = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
         "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson"]
SIZE, B = 32, 2
TI_CFG = dict(placeholder_strings=("*", "sks"), num_vectors_per_token=2,
              token_dim=64)
PROMPTS = ["a photo of a * person", "sks and * at the beach, *"]


def test_init_inject_and_reg_loss_equal_jax():
    jtok, tok = JTokenizer.synthetic(1024), CLIPTokenizer.synthetic(1024)
    jcfg, cfg = jti.TIConfig(**TI_CFG), tti.TIConfig(**TI_CFG)
    table = np.random.default_rng(0).standard_normal((1024, 64)).astype(
        np.float32)
    for words in ([], ["face"], ["face", "person"]):
        ref = np.asarray(jti.init_ti_params(jcfg, jtok, table, words))
        got = tti.init_ti_params(cfg, tok, table, words)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    ph = tti.placeholder_token_ids(cfg, tok)
    assert ph == jti.placeholder_token_ids(jcfg, jtok)
    tokens = np.asarray(tok(PROMPTS))
    embeds = table[tokens]
    ref = jti.ti_inject(jcfg, jnp.asarray(got.numpy()),
                        jnp.asarray(ph, jnp.int32), jnp.asarray(tokens),
                        jnp.asarray(embeds))
    out = tti.ti_inject(cfg, got, torch.tensor(ph), t(tokens).long(),
                        t(embeds))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not np.array_equal(out.numpy(), embeds)      # something injected
    init = got + 0.125
    np.testing.assert_array_equal(
        tti.embedding_reg_loss(got, init).numpy(),
        np.asarray(jti.embedding_reg_loss(jnp.asarray(got.numpy()),
                                          jnp.asarray(init.numpy()))))


def test_checkpoints_both_ways_and_merge(tmp_path):
    cfg = tti.TIConfig(**TI_CFG)
    r = np.random.default_rng(1)
    vecs = r.standard_normal((2, 2, 64)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    tti.save_ti_checkpoint(cfg, torch.from_numpy(vecs), [7, 9], ours)
    jti.save_ti_checkpoint(jti.TIConfig(**TI_CFG), jnp.asarray(vecs[::-1]),
                           [7, 9], theirs)
    plain = torch.load(ours, weights_only=True)
    assert {k: int(v) for k, v in plain["string_to_token"].items()} == \
        {"*": 7, "sks": 9}
    for reader in (jti.load_ti_checkpoint, tti.load_ti_checkpoint):
        back = reader(ours)
        np.testing.assert_array_equal(back["*"], vecs[0])
        np.testing.assert_array_equal(back["sks"], vecs[1])
    back = tti.load_ti_checkpoint(theirs)
    np.testing.assert_array_equal(back["*"], vecs[1])

    with pytest.raises(ValueError, match="collision"):
        tti.merge_ti_checkpoints([ours, theirs])
    with pytest.raises(ValueError, match="collision"):
        merge.main(["--manager_ckpts", ours, theirs, "--output_path",
                    str(tmp_path / "m.pt")])
    out = str(tmp_path / "merged.pt")
    merged = merge.main(["--manager_ckpts", ours, theirs, "--output_path",
                         out, "--rename", f"{theirs}:*=@",
                         f"{theirs}:sks=ks"])
    assert sorted(merged) == ["*", "@", "ks", "sks"]
    ref = jti.merge_ti_checkpoints([ours, theirs], {f"{theirs}:*": "@",
                                                    f"{theirs}:sks": "ks"})
    for reader in (jti.load_ti_checkpoint, tti.load_ti_checkpoint):
        back = reader(out)
        assert sorted(back) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(back[k], ref[k])
    assert set(torch.load(out, weights_only=True)["string_to_param"]) == \
        set(ref)


def test_personalized_items_bit_equal(tmp_path):
    r = np.random.default_rng(2)
    for i, (h, w) in enumerate([(40, 56), (48, 48), (60, 36)]):
        Image.fromarray(r.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    for kw in ({}, {"center_crop": True, "coarse_class_text": "person"},
               {"style": True, "flip_p": 0.9, "seed": 5}):
        ref = jpers.PersonalizedBase(jpers.PersonalizedConfig(
            str(tmp_path), image_size=24, repeats=2, **kw))
        got = tpers.PersonalizedBase(tpers.PersonalizedConfig(
            str(tmp_path), image_size=24, repeats=2, **kw))
        assert len(got) == len(ref) == 6
        for i in range(len(got)):
            a, b = got[i], ref[i]
            assert a["caption"] == b["caption"]
            assert a["image"].dtype == np.float32
            np.testing.assert_array_equal(a["image"], b["image"])
    assert tpers.STYLE_TEMPLATES == jpers.STYLE_TEMPLATES


def test_margin_heads_and_ema_match_jax():
    r = np.random.default_rng(3)
    x = r.standard_normal((5, 16)).astype(np.float32)
    labels = np.array([0, 3, -1, 7, 2])
    for kind, kw in (("softmax", {}), ("cosface", {}),
                     ("arcface", {"m": 0.5}),
                     ("arcface", {"m": 0.5, "easy_margin": True}),
                     ("am_cosface", {"a": 1.2, "k": 0.1}),
                     ("am_arcface", {"a": 1.2, "k": 0.1})):
        jhead = jlosses.MarginHead(num_classes=8, kind=kind, s=16.0, **kw)
        params = random_params(jhead.init, jax.random.key(0),
                               jnp.asarray(x), jnp.asarray(labels), seed=4)
        head = tlosses.MarginHead(8, 16, kind=kind, s=16.0, **kw)
        bridge.load_jax_params(head, np_tree(params))
        apply = compiled(jhead.apply)
        for lab in (labels, None):
            ref = np.asarray(apply(
                params, jnp.asarray(x),
                None if lab is None else jnp.asarray(lab)))
            got = head(t(x), None if lab is None else t(lab).long())
            np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * 16.0, err_msg=kind)
        ok = np.maximum(labels, 0)
        np.testing.assert_allclose(
            tlosses.margin_cross_entropy(t(ref), t(ok).long()).numpy(),
            np.asarray(jlosses.margin_cross_entropy(jnp.asarray(ref),
                                                    jnp.asarray(ok))),
            rtol=1e-6)

    tree = {"w": r.standard_normal((4, 3)).astype(np.float32),
            "b": [r.standard_normal(3).astype(np.float32)]}
    for use_n in (True, False):
        js = jlosses.ema_init(jax.tree.map(jnp.asarray, tree), 0.99, use_n)
        ts = tlosses.ema_init({"w": t(tree["w"]), "b": [t(tree["b"][0])]},
                              0.99, use_n)
        for step in range(3):
            new = jax.tree.map(lambda a: a * (step + 2.0) - 1.0, tree)
            js = jlosses.ema_update(js, jax.tree.map(jnp.asarray, new))
            ts = tlosses.ema_update(ts, {"w": t(new["w"]),
                                         "b": [t(new["b"][0])]})
            assert int(ts.num_updates) == int(js.num_updates)
            np.testing.assert_allclose(ts.params["w"].numpy(),
                                       np.asarray(js.params["w"]), atol=1e-6)
            np.testing.assert_allclose(ts.params["b"][0].numpy(),
                                       np.asarray(js.params["b"][0]),
                                       atol=1e-6)


@pytest.fixture(scope="module")
def both():
    d = tiny_pipelines(SIZE, NAMES)
    cfg, jcfg = tti.TIConfig(**TI_CFG), jti.TIConfig(**TI_CFG)
    vecs = np.random.default_rng(6).standard_normal((2, 2, 64)).astype(
        np.float32)
    d.update(cfg=cfg, jcfg=jcfg, vecs=vecs,
             ph=tti.placeholder_token_ids(cfg, d["tok"]))
    return d


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_ti_txt2img_matches_jax(both, sampler):
    steps = 2 if sampler == "ddim" else 4      # PLMS: orders 1 to 4
    tok = both["tok"]
    tokens, uncond = tok(PROMPTS), tok([""] * B)
    key = jax.random.key(8)
    lat = SIZE // both["tp"].latent_factor
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                       (B, lat, lat, 4)))
    jfn = both["jp"].make_txt2img_ti_fn(
        both["jcfg"], both["ph"], num_steps=steps, guidance_scale=7.5,
        image_size=SIZE, sampler=sampler, output="float")
    ref = np.asarray(jfn(both["params"], jnp.asarray(both["vecs"]),
                         jnp.asarray(tokens), jnp.asarray(uncond), key))

    def got(output, vecs=both["vecs"]):
        fn = both["tp"].make_txt2img_ti_fn(
            both["cfg"], both["ph"], num_steps=steps, guidance_scale=7.5,
            image_size=SIZE, sampler=sampler, output=output)
        return fn(t(vecs), t(tokens).long(), t(uncond).long(), None,
                  x_T=t(x_T))

    img = got("float")
    assert tuple(img.shape) == (B, SIZE, SIZE, 3) and ref.std() > 0.05
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-3)
    u8 = finish_images(img, "uint8").numpy().astype(int)
    ref_u8 = np.clip((np.clip(ref, -1, 1) + 1) * 127.5, 0, 255).astype(int)
    assert np.abs(u8 - ref_u8).max() <= 1
    # the vectors drive the image
    other = got("float", both["vecs"] * -1.0)
    assert np.abs(other.numpy() - img.numpy()).max() > 1e-2
