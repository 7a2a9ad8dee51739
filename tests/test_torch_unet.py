"""PyTorch port, UNet: tiny eps prediction against the JAX module with
carried-over weights; strictness of the weight carrier; parameter shapes of
the sd_v1 module against the SD v1.4 checkpoint manifest.

fp32 on the CPU; 1e-4 on the eps output (summation order inside convs and
matmuls through ~10 blocks).
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.models import unet as junet
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (manifest_shapes, module_shapes, np_tree,
                                 random_params, t)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    jm = junet.UNetModel(junet.UNetConfig.tiny(), jnp.float32)
    x = jnp.zeros((1, 8, 8, 4))
    params = random_params(jm.init, jax.random.key(0), x,
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                           seed=2)                   # zero-convs take part
    tm = tunet.UNetModel(tunet.UNetConfig.tiny(), torch.float32)
    bridge.load_jax_params(tm, np_tree(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("size", [8, 16])
def test_tiny_eps_matches_jax(pair, size):
    jm, params, tm = pair
    r = np.random.default_rng(size)
    x = r.standard_normal((3, size, size, 4)).astype(np.float32)
    ts = np.array([1, 500, 981], np.int32)
    ctx = r.standard_normal((3, 77, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                       jnp.asarray(ts), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm(t(x), t(ts).long(), t(ctx))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert np.abs(ref).max() > 0.05          # not the all-zero init output
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_bf16_compute_tracks_fp32_like_the_jax_module(pair):
    """bf16 compute over fp32 storage (flax's dtype / param_dtype split):
    rounding happens at other places in the two frameworks, so the two bf16
    results are compared through their distance to the fp32 reference.  The
    port may be at most 1.5x as far from it as the JAX bf16 module is, and the
    two bf16 results agree within 0.1 on outputs of std ~0.5."""
    jm, params, _ = pair
    jm16 = junet.UNetModel(junet.UNetConfig.tiny(), jnp.bfloat16)
    tm16 = tunet.UNetModel(tunet.UNetConfig.tiny(), torch.bfloat16)
    bridge.load_jax_params(tm16, np_tree(params))
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 16, 16, 4)).astype(np.float32)
    ts = np.array([1, 500, 981], np.int32)
    ctx = r.standard_normal((3, 77, 64)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    ref32 = np.asarray(jax.jit(jm.apply)(params, *args))
    ref16 = np.asarray(jax.jit(jm16.apply)(params, *args))
    with torch.no_grad():
        got16 = tm16.eval()(t(x), t(ts).long(), t(ctx)).numpy()
    jax_err = np.abs(ref16 - ref32).mean()
    port_err = np.abs(got16 - ref32).mean()
    assert 0 < port_err <= 1.5 * jax_err, (port_err, jax_err)
    assert np.abs(got16 - ref16).max() < 0.1


def test_returns_fp32_under_bf16_compute():
    tm = tunet.UNetModel(tunet.UNetConfig.tiny(), torch.bfloat16)
    with torch.no_grad():
        out = tm(torch.zeros(1, 8, 8, 4), torch.zeros(1, dtype=torch.long),
                 torch.zeros(1, 77, 64))
    assert out.dtype == torch.float32 and out.shape == (1, 8, 8, 4)


def test_from_jax_params_is_strict(pair):
    _, params, _ = pair
    tree = np_tree(params)
    fresh = lambda: tunet.UNetModel(tunet.UNetConfig.tiny(), torch.float32)
    sd = bridge.from_jax_params(tree)
    assert set(sd) == set(fresh().state_dict())
    # conv HWIO -> OIHW, dense (in, out) -> (out, in)
    assert sd["conv_in.weight"].shape == (32, 4, 3, 3)
    assert sd["time_fc1.weight"].shape == (128, 32)
    assert sd["down_0_res_0.conv2.weight"].shape == (32, 32, 3, 3)
    assert "down_0_attn_0.block_0.norm3.weight" in sd

    missing = copy.deepcopy(tree)
    del missing["params"]["mid_res_0"]["conv1"]
    with pytest.raises(RuntimeError, match="Missing key"):
        bridge.load_jax_params(fresh(), missing)
    extra = copy.deepcopy(tree)
    extra["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        bridge.load_jax_params(fresh(), extra)
    unknown = copy.deepcopy(tree)
    unknown["params"]["mid_res_0"]["conv1"]["gamma"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        bridge.from_jax_params(unknown)
    wrong = copy.deepcopy(tree)
    wrong["params"]["conv_in"]["kernel"] = np.zeros((3, 3, 4, 31), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        bridge.load_jax_params(fresh(), wrong)


def test_sd_v1_shapes_match_manifest():
    with open(os.path.join(REPO, "manifests", "sd-v1-4.json")) as f:
        keys = json.load(f)["keys"]
    with torch.device("meta"):
        m = tunet.UNetModel(tunet.UNetConfig.sd_v1())
    assert all(p.is_meta for p in m.parameters())    # nothing allocated
    ours = module_shapes(m)
    theirs = manifest_shapes(keys, ["model.diffusion_model."])
    assert len(ours) == len(theirs) == 686
    assert ours == theirs


def test_legacy_knobs_raise():
    """``dropout`` builds (its checks: tests/test_torch_classifier.py); what
    still raises is a training step with both remat and dropout.  The
    legacy-LDM knobs build their blocks (their parity:
    tests/test_torch_legacy_models.py)."""
    tiny = tunet.UNetConfig.tiny()
    drop = tunet.UNetModel(tunet.UNetConfig(
        **{**tiny.__dict__, "dropout": 0.1, "remat": True}), torch.float32)
    assert drop.down_0_res_0.p_drop == 0.1
    x = torch.zeros(1, 8, 8, 4)
    t = torch.zeros(1, dtype=torch.long)
    ctx = torch.zeros(1, 77, tiny.context_dim)
    with pytest.raises(NotImplementedError, match="remat with dropout"):
        drop(x, t, ctx)
    cfg = tunet.UNetConfig(
        model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
        attention_resolutions=(2,), use_spatial_transformer=False,
        num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True)
    with torch.device("meta"):
        m = tunet.UNetModel(cfg, torch.float32)
    assert isinstance(m.mid_attn, tunet.AttentionBlock)
    assert m.mid_attn.heads == 4 and m.down_1_attn_0.heads == 4
    assert m.mid_res_0.emb_proj.out_features == 2 * 64
    assert m.down_0_downsample.down and m.up_1_upsample.up
