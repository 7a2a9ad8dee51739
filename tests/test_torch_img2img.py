"""PyTorch port, ``cli/img2img.make_img2img_fn`` against the JAX package's:
stochastic encode to strength 0.5 of a 4-step DDIM chain, then 2 guided DDIM
steps, with and without an inpainting mask.

Weights, basis and manager state are made on the JAX side and carried over;
the oracle hooks ``override_z0`` / ``override_noise`` pass the latents and
the encode noise to both sides.  fp32 on the CPU, 32x32.  Float images agree
within 1e-3 and uint8 pixels within one level (``test_torch_pipeline.py``'s
limits).  The port's own draws (VAE posterior and encode noise, one
generator per row) are checked for row independence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.cli import img2img as jimg2img
from celebbasis_tpu_torch.cli import img2img as timg2img

from _torch_port_helpers import t, tiny_pipelines
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

NAMES = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
         "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson",
         "Leonardo DiCaprio", "Oprah Winfrey", "Keanu Reeves", "Rihanna"]
SIZE, B, STEPS = 32, 2, 4
L = lambda a: t(a).long()


@pytest.fixture(scope="module")
def both():
    d = tiny_pipelines(SIZE, NAMES)
    tok = d["tok"]
    k = len(d["tp"].manager_cfg.placeholder_token_ids)
    r = np.random.default_rng(12)
    lat = SIZE // d["tp"].latent_factor
    mask = np.zeros((1, lat, lat, 1), np.float32)
    mask[:, :, lat // 2:] = 1.0
    d.update(
        tokens=tok(["a photo of a sks person", "a ks person, smiling"]),
        uncond=tok([""] * B),
        ids=np.array([[1, 0] + [0] * (k - 2), [2, 3] + [0] * (k - 2)]),
        num_ids=np.array([1, 2]),
        init=r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        z0=r.standard_normal((B, lat, lat, 4)).astype(np.float32),
        noise=r.standard_normal((B, lat, lat, 4)).astype(np.float32),
        mask=mask)
    return d


def _port(both, output, mask, strength=0.5, generators=None, z0=True):
    fn = timg2img.make_img2img_fn(both["tp"], STEPS, strength, 10.0, SIZE,
                                  output=output)
    return fn(both["tstate"], both["tbasis"], t(both["init"]),
              None if mask is None else t(mask), L(both["tokens"]),
              L(both["uncond"]), L(both["ids"]), L(both["num_ids"]),
              generators, override_z0=t(both["z0"]) if z0 else None,
              override_noise=None if generators else t(both["noise"]))


@pytest.mark.parametrize("masked", [False, True])
def test_tiny_img2img_matches_jax(both, masked):
    mask = both["mask"] if masked else None
    jfn = jimg2img.make_img2img_fn(both["jp"], STEPS, 0.5, 10.0, SIZE,
                                   output="float")
    ref = np.asarray(jfn(
        both["params"], both["jstate"], both["jbasis"],
        jnp.asarray(both["init"]), None if mask is None else jnp.asarray(mask),
        jnp.asarray(both["tokens"]), jnp.asarray(both["uncond"]),
        jnp.asarray(both["ids"], jnp.int32),
        jnp.asarray(both["num_ids"], jnp.int32), jax.random.key(0),
        override_z0=jnp.asarray(both["z0"]),
        override_noise=jnp.asarray(both["noise"])))
    got = _port(both, "float", mask)
    assert tuple(got.shape) == (B, SIZE, SIZE, 3) == ref.shape
    assert got.dtype == torch.float32 and ref.std() > 0.05
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    u8 = _port(both, "uint8", mask).numpy().astype(int)
    ref_u8 = np.clip((np.clip(ref, -1, 1) + 1) * 127.5, 0, 255).astype(
        np.uint8)
    assert np.abs(u8 - ref_u8.astype(int)).max() <= 1
    if masked:   # the known half comes back from z0 alone
        plain = _port(both, "float", None).numpy()
        assert np.abs(plain - got.numpy()).max() > 1e-2


def test_full_strength_is_txt2img_from_the_noise(both):
    """Strength 1.0 starts from pure noise and runs the whole chain: the
    txt2img DDIM chain from x_T = the encode noise."""
    got = _port(both, "float", None, strength=1.0).numpy()
    fn = both["tp"].make_txt2img_fn(num_steps=STEPS, guidance_scale=10.0,
                                    image_size=SIZE)
    ref = fn(both["tstate"], both["tbasis"], L(both["tokens"]),
             L(both["uncond"]), L(both["ids"]), L(both["num_ids"]), None,
             x_T=t(both["noise"])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_encode_draws_per_row(both):
    gens = lambda *s: [torch.Generator().manual_seed(v) for v in s]
    a = _port(both, "float", None, generators=gens(1, 2), z0=False).numpy()
    b = _port(both, "float", None, generators=gens(1, 3), z0=False).numpy()
    np.testing.assert_allclose(a[0], b[0], atol=1e-5)
    assert np.abs(a[1] - b[1]).max() > 1e-2
