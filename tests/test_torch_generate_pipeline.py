"""PyTorch port, the generation functions of the pipeline against the JAX
package: live-face txt2img (``make_txt2img_faces_fn``: MetaIdNet on the
crops, image-mode injection, DDIM) and PLMS txt2img
(``make_txt2img_fn(sampler="plms")``).

Weights, the basis and the face net are made on the JAX side and carried
over; the JAX faces function draws its start latents from its key, so the
test rebuilds them with ``ddim_sample``'s key split and passes them to the
port as ``x_T``.  fp32 on the CPU, 32x32, k = 2 faces.  Float images agree
within 1e-3 and uint8 pixels within one level, the limits of
``test_torch_pipeline.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.core import meta_net as jmeta
from celebbasis_tpu_torch.core import meta_net as tmeta
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import np_tree, random_params, t, tiny_pipelines
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

NAMES = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
         "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson",
         "Leonardo DiCaprio", "Oprah Winfrey", "Keanu Reeves", "Rihanna"]
SIZE, B, K = 32, 2, 2
PROMPTS = ["a photo of a sks person", "a ks person and a sks person, smiling"]
L = lambda a: t(a).long()


@pytest.fixture(scope="module")
def both():
    d = tiny_pipelines(SIZE, NAMES)
    # a face net whose projection fits the tiny pipeline's basis and CLIP
    jcfg = dataclasses.replace(jmeta.MetaNetConfig.tiny(), inner_dim=8,
                               token_dim=64)
    tcfg = dataclasses.replace(tmeta.MetaNetConfig.tiny(), inner_dim=8,
                               token_dim=64)
    jnet = jmeta.MetaIdNet(jcfg, dtype=jnp.float32)
    r = np.random.default_rng(11)
    faces = r.uniform(-1, 1, (B, K, SIZE, SIZE, 3)).astype(np.float32)
    d["meta_params"] = random_params(
        jnet.init, jax.random.key(0), jnp.asarray(faces[:, 0]),
        jnp.zeros((B,), jnp.int32), d["jbasis"], seed=2)
    tnet = tmeta.MetaIdNet(tcfg, dtype=torch.float32)
    bridge.load_jax_params(tnet, np_tree(d["meta_params"]))
    d.update(jnet=jnet, tnet=tnet.requires_grad_(False).eval(), faces=faces)
    return d


def _u8(img):
    """The JAX package's uint8 finishing of a float image, in numpy."""
    return np.clip((np.clip(img, -1, 1) + 1.0) * 127.5, 0, 255).astype(
        np.uint8)


def _agree(both, make_ref, make_got):
    ref = make_ref()
    got = make_got("float")
    assert tuple(got.shape) == (B, SIZE, SIZE, 3) == ref.shape
    assert got.dtype == torch.float32 and ref.std() > 0.05
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    u8 = make_got("uint8")
    assert u8.dtype == torch.uint8
    assert np.abs(u8.numpy().astype(int) - _u8(ref).astype(int)).max() <= 1
    return got


def test_tiny_faces_txt2img_matches_jax(both):
    tok, steps = both["tok"], 2
    tokens, uncond = tok(PROMPTS), tok([""] * B)
    ids = np.tile(np.arange(K), (B, 1))
    num_ids = np.array([2, 1])
    key = jax.random.key(4)
    lat = SIZE // both["tp"].latent_factor
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                       (B, lat, lat, 4)))

    def ref():
        jfn = both["jp"].make_txt2img_faces_fn(
            both["jnet"], num_steps=steps, guidance_scale=10.0,
            image_size=SIZE, output="float")
        return np.asarray(jfn(
            both["params"], both["meta_params"], both["jbasis"],
            jnp.asarray(tokens), jnp.asarray(uncond),
            jnp.asarray(both["faces"]), jnp.asarray(ids, jnp.int32),
            jnp.asarray(num_ids, jnp.int32), key))

    def got(output, faces=both["faces"]):
        fn = both["tp"].make_txt2img_faces_fn(
            both["tnet"], num_steps=steps, guidance_scale=10.0,
            image_size=SIZE, output=output)
        return fn(both["tbasis"], L(tokens), L(uncond), t(faces), L(ids),
                  L(num_ids), None, x_T=t(x_T))

    img = _agree(both, ref, got)
    # the faces drive the identity: other crops give another image
    other = got("float", both["faces"][:, ::-1].copy())
    assert np.abs(other.numpy() - img.numpy()).max() > 1e-2


def test_tiny_plms_txt2img_matches_jax(both):
    tok, steps = both["tok"], 5
    k = len(both["tp"].manager_cfg.placeholder_token_ids)
    tokens, uncond = tok(PROMPTS), tok([""] * B)
    ids = np.array([[1, 0] + [0] * (k - 2), [2, 3] + [0] * (k - 2)])
    num_ids = np.array([1, 2])
    x_T = np.random.default_rng(9).standard_normal(
        (B, SIZE // 2, SIZE // 2, 4)).astype(np.float32)

    def ref():
        jfn = both["jp"].make_txt2img_fn(num_steps=steps, guidance_scale=10.0,
                                         image_size=SIZE, sampler="plms",
                                         output="float")
        return np.asarray(jfn(
            both["params"], both["jstate"], both["jbasis"],
            jnp.asarray(tokens), jnp.asarray(uncond),
            jnp.asarray(ids, jnp.int32), jnp.asarray(num_ids, jnp.int32),
            jax.random.key(0), jnp.asarray(x_T)))

    def got(output, sampler="plms"):
        fn = both["tp"].make_txt2img_fn(num_steps=steps, guidance_scale=10.0,
                                        image_size=SIZE, sampler=sampler,
                                        output=output)
        return fn(both["tstate"], both["tbasis"], L(tokens), L(uncond),
                  L(ids), L(num_ids), None, x_T=t(x_T))

    img = _agree(both, ref, got)
    assert np.abs(got("float", "ddim").numpy() - img.numpy()).max() > 1e-2
    with pytest.raises(ValueError, match="sampler"):
        both["tp"].make_txt2img_fn(sampler="euler")
