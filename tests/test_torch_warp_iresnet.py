"""PyTorch port: ``ops.warp`` and ``models.iresnet`` against the JAX package.

Inputs come from a numpy seed and go through both sides; weights are made on
the JAX side (every leaf randomised, so that BatchNorm statistics and PReLU
slopes take part) and carried over with ``bridge.load_jax_params`` (strict).
Tolerances: warp 1e-5 (the same taps and weights, float32); IResNet tiny fp32
1e-4 on features of unit scale (four conv blocks, summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.models import iresnet as jres
from celebbasis_tpu.ops import warp as jwarp
from celebbasis_tpu_torch.models import iresnet as tres
from celebbasis_tpu_torch.ops import warp as twarp
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import compiled, np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jax(align_corners):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((9, 11, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (5, 7, 2)).astype(np.float32)  # some outside
    ref = np.asarray(compiled(jwarp.grid_sample_bilinear)(
        jnp.asarray(img), jnp.asarray(grid), align_corners))
    got = twarp.grid_sample_bilinear(t(img), t(grid), align_corners)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # and the port's function is F.grid_sample with zero padding
    lib = torch.nn.functional.grid_sample(
        t(img).permute(2, 0, 1)[None], t(grid)[None], mode="bilinear",
        padding_mode="zeros", align_corners=align_corners)[0].permute(1, 2, 0)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_affine_warp_resize_matches_jax(fused):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((32, 32, 3)).astype(np.float32)
    M = np.asarray(jwarp.INSIGHTFACE_TRANS_MATRIX)
    np.testing.assert_array_equal(twarp.INSIGHTFACE_TRANS_MATRIX.numpy(), M)
    ref = np.asarray(jax.jit(
        lambda i, m: jwarp.affine_warp_resize(i, m, (12, 12), fused=fused))(
        jnp.asarray(img), jnp.asarray(M)))
    got = twarp.affine_warp_resize(t(img), t(M), (12, 12), fused=fused)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_affine_warp_and_resize_match_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((17, 23, 2)).astype(np.float32)
    M = np.array([[0.9, 0.1, 0.05], [-0.1, 1.1, -0.02]], np.float32)
    np.testing.assert_allclose(
        twarp.affine_warp(t(img), t(M)).numpy(),
        np.asarray(jax.jit(jwarp.affine_warp)(jnp.asarray(img),
                                              jnp.asarray(M))),
        atol=1e-5)
    np.testing.assert_allclose(
        twarp.bilinear_resize_align_corners(t(img), (8, 10)).numpy(),
        np.asarray(jax.jit(lambda i: jwarp.bilinear_resize_align_corners(
            i, (8, 10)))(jnp.asarray(img))), atol=1e-5)


@pytest.mark.parametrize("per_image", [False, True])
def test_batched_affine_warp_resize_matches_jax(per_image):
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((3, 20, 20, 3)).astype(np.float32)
    M = np.asarray(jwarp.INSIGHTFACE_TRANS_MATRIX)
    if per_image:
        M = M[None] + rng.standard_normal((3, 2, 3)).astype(np.float32) * 0.05
    ref = np.asarray(jax.jit(
        lambda i, m: jwarp.batched_affine_warp_resize(i, m, (8, 8)))(
        jnp.asarray(imgs), jnp.asarray(M)))
    got = twarp.batched_affine_warp_resize(t(imgs), t(M), (8, 8))
    assert got.shape == (3, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_iresnet_configs_agree():
    for name in ("r100", "r50", "r18", "tiny"):
        ours = getattr(tres.IResNetConfig, name)()
        ref = getattr(jres.IResNetConfig, name)()
        assert (ours.layers, ours.feat_dim, ours.base, ours.input_size) == \
            (ref.layers, ref.feat_dim, ref.base, ref.input_size)


@pytest.fixture(scope="module")
def tiny_nets():
    cfg = jres.IResNetConfig.tiny()
    jnet = jres.IResNet(cfg, dtype=jnp.float32)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    params = random_params(jnet.init, jax.random.key(0), jnp.asarray(x),
                           seed=1)
    tnet = tres.IResNet(tres.IResNetConfig.tiny(), dtype=torch.float32)
    bridge.load_jax_params(tnet, np_tree(params))     # strict
    return jnet, params, tnet.eval(), x


def test_iresnet_tiny_matches_jax(tiny_nets):
    jnet, params, tnet, x = tiny_nets
    ref = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(t(x))
    assert got.shape == (2, 64) and got.dtype == torch.float32
    assert np.abs(ref).mean() > 0.05
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_iresnet_state_is_parameters_and_buffers(tiny_nets):
    """FrozenBN: scale and bias are parameters, the running statistics are
    buffers; both travel in the state_dict the bridge fills."""
    tnet = tiny_nets[2]
    bn = tnet.stem_bn
    assert {n for n, _ in bn.named_parameters()} == {"weight", "bias"}
    assert {n for n, _ in bn.named_buffers()} == {"mean", "var"}
    assert "layer2_block0.down_bn.var" in tnet.state_dict()


def test_iresnet_bf16_compute_tracks_fp32(tiny_nets):
    """bf16 compute (the default) stays near the fp32 features, as the JAX
    module's bf16 does: cosine above 0.99."""
    jnet, params, tnet, x = tiny_nets
    t16 = tres.IResNet(tres.IResNetConfig.tiny(), dtype=torch.bfloat16)
    t16.load_state_dict(tnet.state_dict())
    with torch.no_grad():
        a, b = tnet(t(x)), t16(t(x))
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert b.dtype == torch.float32 and cos.min().item() > 0.99


def test_bridge_refuses_unknown_leaves():
    with pytest.raises(KeyError):
        bridge.from_jax_params({"params": {"x": {"gamma": np.zeros(3)}}})
