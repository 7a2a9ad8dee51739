"""PyTorch port, VAE: tiny decode (and encode) against the JAX module with
carried-over weights, and the sd_v1 decoder's parameter shapes against the
SD v1.4 checkpoint manifest.

fp32 on the CPU; 1e-4 (summation order inside convs through ~8 blocks).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.models import vae as jvae
from celebbasis_tpu_torch.models import vae as tvae
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (manifest_shapes, module_shapes, np_tree,
                                 random_params, t)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    jm = jvae.AutoencoderKL(jvae.VAEConfig.tiny(), jnp.float32)
    rng = jax.random.key(0)
    params = random_params(jm.init, rng, jnp.zeros((1, 16, 16, 3)), rng,
                           seed=3)
    tm = tvae.AutoencoderKL(tvae.VAEConfig.tiny(), torch.float32)
    bridge.load_jax_params(tm, np_tree(params))
    return jm, params, tm.eval()


def test_tiny_decode_matches_jax(pair):
    jm, params, tm = pair
    z = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(z),
                              method=jvae.AutoencoderKL.decode))
    with torch.no_grad():
        got = tm.decode(t(z))
    assert got.shape == (2, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_tiny_encode_matches_jax(pair):
    """The encoder's stride-2 stage pads (0,1,0,1) and runs a VALID conv."""
    jm, params, tm = pair
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    jmean, jlogvar = jm.apply(params, jnp.asarray(x),
                              method=jvae.AutoencoderKL.encode)
    with torch.no_grad():
        mean, logvar = tm.encode(t(x))
    assert mean.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), atol=1e-4)


def test_strict_load_needs_every_leaf(pair):
    _, params, _ = pair
    tree = np_tree(params)
    decoder_only = {"params": {k: v for k, v in tree["params"].items()
                               if k != "encoder"}}
    with pytest.raises(RuntimeError, match="Missing key"):
        bridge.load_jax_params(
            tvae.AutoencoderKL(tvae.VAEConfig.tiny(), torch.float32),
            decoder_only)


def test_sd_v1_decoder_shapes_match_manifest():
    with open(os.path.join(REPO, "manifests", "sd-v1-4.json")) as f:
        keys = json.load(f)["keys"]
    with torch.device("meta"):
        m = tvae.AutoencoderKL(tvae.VAEConfig.sd_v1())
    assert all(p.is_meta for p in m.parameters())
    ours = sorted(module_shapes(m.decoder) + module_shapes(m.post_quant_conv))
    theirs = manifest_shapes(keys, ["first_stage_model.decoder.",
                                    "first_stage_model.post_quant_conv."])
    assert ours == theirs
    enc = sorted(module_shapes(m.encoder) + module_shapes(m.quant_conv))
    assert enc == manifest_shapes(keys, ["first_stage_model.encoder.",
                                         "first_stage_model.quant_conv."])


def test_legacy_knobs_raise():
    """The legacy first-stage knobs build their blocks (their parity:
    tests/test_torch_legacy_models.py); a VQ stage refuses double_z."""
    from celebbasis_tpu_torch.models.vq import VQModel
    with torch.device("meta"):
        m = tvae.AutoencoderKL(tvae.VAEConfig(
            ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16,
            attn_resolutions=(16,), double_z=False), torch.float32)
        none = tvae.Encoder(tvae.VAEConfig(ch=32, ch_mult=(1, 2),
                                           num_res_blocks=1,
                                           attn_type="none"), torch.float32)
        with pytest.raises(ValueError, match="double_z"):
            VQModel(tvae.VAEConfig(), n_embed=8)
    assert hasattr(m.encoder, "down_0_attn_0")
    assert hasattr(m.decoder, "up_0_attn_1")
    assert not hasattr(m.encoder, "down_1_attn_0")
    assert m.encoder.conv_out.out_channels == 4      # one moment
    assert not hasattr(none, "mid_attn")
