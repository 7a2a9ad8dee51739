"""PyTorch port, the slice as a whole: tiny prompt -> pixels with identity
injection against the JAX pipeline.

Weights, the celeb basis and the manager state are made on the JAX side and
carried over (not rebuilt); x_T is given; 4 DDIM steps, guidance 10, fp32 on
the CPU.  Float images agree within 1e-3 (four CFG UNet steps and a VAE
decode, each ~1e-4, with the guidance scale amplifying the difference of two
UNet rows), uint8 pixels within one level (truncation at a level boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu import pipeline as jpipe
from celebbasis_tpu.core import manager as jmgr
from celebbasis_tpu.core.basis import build_celeb_basis as j_build_basis
from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from celebbasis_tpu_torch import pipeline as tpipe
from celebbasis_tpu_torch.core.basis import build_celeb_basis, reconstruct
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import compiled, np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

NAMES = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
         "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson",
         "Leonardo DiCaprio", "Oprah Winfrey", "Keanu Reeves", "Rihanna"]
SIZE, STEPS, B = 32, 4, 2
PROMPTS = ["a photo of a sks person", "a ks person and a sks person, smiling"]


@pytest.fixture(scope="module")
def both():
    jtok = JTokenizer.synthetic(1024)
    jp = jpipe.CelebBasisPipeline(jpipe.PipelineConfig.tiny(), jtok)
    params = random_params(
        lambda key: jp.init_params(key, image_size=SIZE), jax.random.key(0),
        seed=5)
    jbasis = j_build_basis(NAMES, jtok, jp.token_table(params), jp.cfg.basis)
    jstate = jmgr.init_state(jp.manager_cfg, jax.random.key(3))

    ttok = CLIPTokenizer.synthetic(1024)
    tp = tpipe.CelebBasisPipeline(tpipe.PipelineConfig.tiny(), ttok)
    tp.load_state_dict(bridge.from_jax_params(np_tree(params)), strict=True)
    tp.requires_grad_(False).eval()
    return dict(jp=jp, params=params, jbasis=jnp.asarray(jbasis),
                jstate=jstate, jtok=jtok, tp=tp, ttok=ttok,
                tbasis=bridge.basis_from_jax(jbasis),
                tstate=bridge.manager_state_from_jax(jstate))


def _requests(tok, k):
    tokens = tok(PROMPTS)
    uncond = tok([""] * B)
    ids = np.array([[1, 0] + [0] * (k - 2), [2, 3] + [0] * (k - 2)], np.int32)
    num_ids = np.array([1, 2], np.int32)
    x_T = np.random.default_rng(9).standard_normal(
        (B, SIZE // 2, SIZE // 2, 4)).astype(np.float32)
    return tokens, uncond, ids, num_ids, x_T


def test_tokenizers_and_configs_agree(both):
    assert both["jp"].manager_cfg.placeholder_token_ids == \
        both["tp"].manager_cfg.placeholder_token_ids
    np.testing.assert_array_equal(both["jtok"](PROMPTS), both["ttok"](PROMPTS))
    assert both["tp"].latent_factor == both["jp"].latent_factor == 2
    np.testing.assert_array_equal(both["tp"].token_table(),
                                  both["jp"].token_table(both["params"]))


def test_basis_construction_matches_jax(both):
    table = both["tp"].token_table()
    ours = build_celeb_basis(NAMES, both["ttok"], table,
                             both["tp"].cfg.basis)
    assert ours.shape == (2, 9, 64)
    np.testing.assert_array_equal(ours, np.asarray(both["jbasis"]))
    coeff = np.random.default_rng(0).standard_normal((2, 1, 8)).astype(
        np.float32)
    assert reconstruct(coeff, ours).shape == (2, 64)


def test_conditioning_with_injection_matches_jax(both):
    k = len(both["tp"].manager_cfg.placeholder_token_ids)
    tokens, _, ids, num_ids, _ = _requests(both["ttok"], k)
    ref = np.asarray(compiled(both["jp"].conditioning)(
        both["params"], jnp.asarray(tokens), both["jstate"], both["jbasis"],
        jnp.asarray(ids), jnp.asarray(num_ids)))
    with torch.no_grad():
        got = both["tp"].conditioning(
            t(tokens).long(), both["tstate"], both["tbasis"], t(ids).long(),
            t(num_ids).long()).numpy()
        plain = both["tp"].conditioning(t(tokens).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got - plain).max() > 1e-2     # the injection changed it


@pytest.mark.parametrize("output", ["float", "uint8"])
def test_tiny_txt2img_matches_jax(both, output):
    k = len(both["tp"].manager_cfg.placeholder_token_ids)
    tokens, uncond, ids, num_ids, x_T = _requests(both["ttok"], k)
    jfn = both["jp"].make_txt2img_fn(num_steps=STEPS, guidance_scale=10.0,
                                     image_size=SIZE, output=output)
    ref = np.asarray(jfn(both["params"], both["jstate"], both["jbasis"],
                         jnp.asarray(tokens), jnp.asarray(uncond),
                         jnp.asarray(ids), jnp.asarray(num_ids),
                         jax.random.key(0), jnp.asarray(x_T)))
    tfn = both["tp"].make_txt2img_fn(num_steps=STEPS, guidance_scale=10.0,
                                     image_size=SIZE, output=output)
    got = tfn(both["tstate"], both["tbasis"], t(tokens).long(),
              t(uncond).long(), t(ids).long(), t(num_ids).long(), None,
              x_T=t(x_T))
    assert tuple(got.shape) == (B, SIZE, SIZE, 3) == ref.shape
    if output == "float":
        assert got.dtype == torch.float32 and ref.std() > 0.05
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    else:
        assert got.dtype == torch.uint8 and ref.dtype == np.uint8
        assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
        assert ref.std() > 5


def test_finish_images_truncates_toward_zero():
    x = np.array([-1.5, -1.0, -0.999, 0.0, 0.004, 0.999, 1.0, 2.0],
                 np.float32)
    ref = np.asarray(jpipe.finish_images(jnp.asarray(x), "uint8"))
    got = tpipe.finish_images(t(x), "uint8").numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [0, 0, 0, 127, 128, 254, 255, 255]
    np.testing.assert_array_equal(
        tpipe.finish_images(t(x), "float").numpy(),
        np.asarray(jpipe.finish_images(jnp.asarray(x), "float")))
    with pytest.raises(ValueError):
        tpipe.finish_images(t(x), "png")
