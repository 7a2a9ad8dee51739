"""PyTorch port, ops: each plain op against its JAX counterpart on the CPU.

Inputs are made from a seed with numpy and handed to both.  fp32 throughout;
tolerances 1e-5 unless stated (different summation order and transcendental
implementations between XLA's CPU backend and ATen).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.ops import attention as jattn
from celebbasis_tpu.ops import basic as jbasic
from celebbasis_tpu.ops import geglu as jgeglu
from celebbasis_tpu.ops.resize import upsample2x_nearest as j_upsample
from celebbasis_tpu_torch.ops import attention as tattn
from celebbasis_tpu_torch.ops import basic as tbasic
from celebbasis_tpu_torch.ops import geglu as tgeglu
from celebbasis_tpu_torch.ops.resize import (upsample2x_nearest,
                                             upsample2x_nearest_nchw)

from _torch_port_helpers import t


def rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    ts = np.array([0, 1, 500.5, 981], np.float32)
    ref = np.asarray(jbasic.timestep_embedding(jnp.asarray(ts), dim))
    got = tbasic.timestep_embedding(t(ts), dim).numpy()
    # 1e-4: one fp32 ulp of an argument near 1e3 is 6e-5, and the two
    # libraries' exp() give frequencies that differ by an ulp
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert got.shape == (4, dim)


def test_quick_gelu():
    x = rng().standard_normal((5, 7)).astype(np.float32) * 3
    np.testing.assert_allclose(tbasic.quick_gelu(t(x)).numpy(),
                               np.asarray(jbasic.quick_gelu(jnp.asarray(x))),
                               atol=1e-6)


def test_group_norm_eps_and_layout():
    r = rng(1)
    x = r.standard_normal((2, 6, 5, 64)).astype(np.float32) * 1e-2  # eps shows
    scale = r.standard_normal(64).astype(np.float32)
    bias = r.standard_normal(64).astype(np.float32)
    params = {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}
    ref = np.asarray(jbasic.GroupNorm().apply(params, jnp.asarray(x)))
    gn = tbasic.GroupNorm(64)
    gn.load_state_dict({"weight": t(scale), "bias": t(bias)})
    got = tbasic.to_nhwc(gn(tbasic.to_nchw(t(x)))).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # torch's default eps (1e-5) would be visibly off at this input scale
    off = torch.nn.functional.group_norm(
        tbasic.to_nchw(t(x)), 32, t(scale), t(bias), 1e-5)
    assert np.abs(tbasic.to_nhwc(off).numpy() - ref).max() > 1e-3


def test_group_norm_keeps_dtype_bf16():
    x = t(rng(2).standard_normal((1, 32, 4, 4)).astype(np.float32))
    gn = tbasic.GroupNorm(32)
    assert gn(x.bfloat16()).dtype == torch.bfloat16


def test_layer_norm():
    r = rng(3)
    x = r.standard_normal((2, 9, 48)).astype(np.float32)
    scale = r.standard_normal(48).astype(np.float32)
    bias = r.standard_normal(48).astype(np.float32)
    params = {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}}
    ref = np.asarray(jbasic.LayerNorm().apply(params, jnp.asarray(x)))
    ln = tbasic.LayerNorm(48)
    ln.load_state_dict({"weight": t(scale), "bias": t(bias)})
    np.testing.assert_allclose(ln(t(x)).detach().numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_norms_bf16_input_fp32_affine_round_once(norm):
    """bf16 activations with float32 scale and bias drawn away from 1 and 0
    (what the train step feeds the frozen UNet's norms): the port's norm is
    the JAX one -- float32 statistics and affine, one rounding to bf16 --
    within one bf16 unit at every element.  Parameters rounded to bf16
    before the affine move elements by more."""
    r = rng(7)
    x = r.standard_normal((2, 8, 8, 64)).astype(np.float32)
    scale = (1 + 0.2 * r.standard_normal(64)).astype(np.float32)
    bias = (0.1 * r.standard_normal(64)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if norm == "group":
        jmod, mod = jbasic.GroupNorm(), tbasic.GroupNorm(64)
        run = lambda v: tbasic.to_nhwc(mod(tbasic.to_nchw(v)))
    else:
        jmod, mod = jbasic.LayerNorm(), tbasic.LayerNorm(64)
        run = mod
    name = type(jmod).__name__ + "_0"
    ref = jmod.apply({"params": {name: {"scale": scale, "bias": bias}}}, xb)
    mod.load_state_dict({"weight": t(scale), "bias": t(bias)})
    xt = t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = run(xt)
    assert got.dtype == torch.bfloat16
    ref = t(np.asarray(ref.astype(jnp.float32)))
    assert tbasic.bf16_ulps(got, ref).max().item() <= 1.0
    # the check sees parameters rounded to bf16
    f = torch.nn.functional
    if norm == "group":
        rounded = tbasic.to_nhwc(f.group_norm(
            tbasic.to_nchw(xt.float()), 32, t(scale).bfloat16().float(),
            t(bias).bfloat16().float(), 1e-6))
    else:
        rounded = f.layer_norm(xt.float(), (64,), t(scale).bfloat16().float(),
                               t(bias).bfloat16().float(), 1e-5)
    assert tbasic.bf16_ulps(rounded.bfloat16(), ref).max().item() > 1.0


def test_l2_normalize():
    x = rng(4).standard_normal((3, 10)).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(
        tbasic.l2_normalize(t(x)).numpy(),
        np.asarray(jbasic.l2_normalize(jnp.asarray(x))), atol=1e-6)


def test_upsample2x_nearest():
    x = rng(5).standard_normal((2, 3, 4, 5)).astype(np.float32)
    ref = np.asarray(j_upsample(jnp.asarray(x)))
    np.testing.assert_array_equal(upsample2x_nearest(t(x)).numpy(), ref)
    got = upsample2x_nearest_nchw(t(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def _geglu_inputs(C=16):
    r = rng(6)
    f = lambda *s: (r.standard_normal(s) * 0.3).astype(np.float32)
    return dict(x=f(2, 5, C) * 3, ln_scale=1 + f(C), ln_bias=f(C),
                w1=f(C, 8 * C), b1=f(8 * C), w2=f(4 * C, C), b2=f(C))


def test_geglu_block_tanh_gelu_fast_variance_ln():
    a = _geglu_inputs()
    order = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")
    ref = np.asarray(jgeglu.geglu_block(*(jnp.asarray(a[k]) for k in order),
                                        impl="xla"))
    got = tgeglu.geglu_block(*(t(a[k]) for k in order), impl="xla").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the exact (erf) GELU is a different function: the port must not use it
    h = torch.nn.functional.linear(
        tgeglu.ln_xla(t(a["x"]), t(a["ln_scale"]), t(a["ln_bias"])),
        t(a["w1"]).T, t(a["b1"]))
    hh, gate = h.chunk(2, -1)
    erf = t(a["x"]) + (hh * torch.nn.functional.gelu(gate)) @ t(a["w2"]) \
        + t(a["b2"])
    assert np.abs(erf.numpy() - ref).max() > 1e-4


def test_geglu_ffn_and_impl_guard():
    a = _geglu_inputs()
    order = ("x", "w1", "b1", "w2", "b2")
    ref = np.asarray(jgeglu.geglu_ffn(*(jnp.asarray(a[k]) for k in order),
                                      impl="xla"))
    got = tgeglu.geglu_ffn(*(t(a[k]) for k in order)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the JAX package's route names do not carry over: the kernel route is
    # "cuda", and any other name raises
    with pytest.raises(ValueError, match="cuda"):
        tgeglu.geglu_ffn(*(t(a[k]) for k in order), impl="pallas")


def test_causal_mask():
    ref = np.asarray(jattn.causal_mask(7))
    got = tattn.causal_mask(7).numpy()
    assert got.shape == (1, 1, 7, 7)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,masked", [
    ((2, 10, 10, 4, 8), False), ((2, 10, 10, 4, 8), True),
    ((1, 33, 77, 8, 40), False),
    ((1, 16, 16, 1, 512), False), ((1, 16, 16, 1, 512), True)])
def test_attention_plain_route(shape, masked):
    B, N, M, H, D = shape
    r = rng(7)
    q = r.standard_normal((B, N, H * D)).astype(np.float32)
    k = r.standard_normal((B, M, H * D)).astype(np.float32)
    v = r.standard_normal((B, M, H * D)).astype(np.float32)
    jm = jattn.causal_mask(N) if masked else None
    tm = tattn.causal_mask(N) if masked else None
    ref = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), num_heads=H, mask=jm,
                                     impl="xla"))
    got = tattn.attention(t(q), t(k), t(v), num_heads=H, mask=tm,
                          impl="xla").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_attention_routing_on_cpu_tensors():
    """On CPU tensors the default route is the plain core, and the kernel
    route's wrapper takes its plain version: all three agree."""
    r = rng(8)
    q, k, v = (t(r.standard_normal((1, 12, 32)).astype(np.float32))
               for _ in range(3))
    a = tattn.attention(q, k, v, num_heads=4)
    b = tattn.attention(q, k, v, num_heads=4, impl="cuda")
    c = tattn.attention(q, k, v, num_heads=4, impl="xla")
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=0)
    np.testing.assert_allclose(b.numpy(), c.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, num_heads=4, impl="pallas")
    with pytest.raises(ValueError):
        tattn.set_default_impl("math")


def test_dense_and_conv_compute_dtype():
    """Storage and compute types are independent, as with flax's
    param_dtype/dtype."""
    d = tbasic.Dense(8, 4, dtype=torch.bfloat16)
    assert d.weight.dtype == torch.float32
    assert d(torch.ones(2, 8)).dtype == torch.bfloat16
    c = tbasic.Conv(4, 6, 3, dtype=torch.float32).to(torch.bfloat16)
    y = c(torch.ones(1, 4, 5, 5))
    assert y.dtype == torch.float32 and y.shape == (1, 6, 5, 5)
    z = tbasic.ZeroConv(4, 6, 3)
    assert not z.weight.any() and not z.bias.any()
