"""PyTorch port, GEGLU: the kernel route (``impl="cuda"``) against the JAX
package's fused route (``impl="pallas"``, the Pallas kernels in interpret
mode) on the CPU.

On CPU tensors the kernel route runs the kernels' plain versions
(``geglu_block_plain``, ``geglu_ffn_plain``) and differentiates through the
same ``torch.autograd.Function`` that wraps the kernels on a card, so these
cases hold the plain versions' arithmetic and the backward's recomputation
to the JAX ``custom_vjp``.  The kernels themselves are held to the plain
versions on the card (chip_smoke.py, the ``cuda`` cases of
test_torch_cuda_kernels.py).

Tolerances: fp32 2e-5 (summation order); bf16 one bf16 unit in the last
place of the value plus 2**-5 of the outputs' rms (the two sides round the
LN output and the gated rows y to bf16 at the same places, but fp32 sums in
another order put a few of those roundings on the other side of a
boundary); gradients and the tiny UNet 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from celebbasis_tpu.models import unet as junet
from celebbasis_tpu.ops import geglu as jgeglu
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.ops import geglu as tgeglu
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

ORDER = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")


@pytest.fixture(autouse=True)
def _routes(monkeypatch):
    """Pallas in interpret mode; both packages' route switches restored."""
    monkeypatch.setattr(jgeglu.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jgeglu, "_DEFAULT_IMPL", jgeglu._DEFAULT_IMPL)
    monkeypatch.setattr(tgeglu, "_DEFAULT_IMPL", tgeglu._DEFAULT_IMPL)


def _inputs(rows, C, inner, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return dict(x=f(rows, C), ln_scale=1 + 0.1 * f(C), ln_bias=0.1 * f(C),
                w1=f(C, 2 * inner) * C ** -0.5, b1=0.05 * f(2 * inner),
                w2=f(inner, C) * inner ** -0.5, b2=0.05 * f(C))


def _bf16_limit(ref):
    """One bf16 ulp of each value plus 2**-5 of the rms."""
    a = np.abs(ref)
    ulp = np.exp2(np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7)
    return ulp + 2.0 ** -5 * np.sqrt(np.mean(ref ** 2))


SHAPES = [(40, 128, 512), (100, 64, 256)]


@pytest.mark.parametrize("block", [True, False], ids=["block", "ffn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,C,inner", SHAPES)
def test_plain_versions_match_the_pallas_kernels(rows, C, inner, dtype,
                                                 block):
    a = _inputs(rows, C, inner, seed=rows)
    names = ORDER if block else ("x", "w1", "b1", "w2", "b2")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jargs = [jnp.asarray(a[k], jdt if k == "x" else jnp.float32)
             for k in names]
    jfn = jgeglu.geglu_block if block else jgeglu.geglu_ffn
    ref = np.asarray(jfn(*jargs, impl="pallas").astype(jnp.float32))
    targs = [t(np.asarray(jargs[0].astype(jnp.float32)), getattr(
        torch, dtype))] + [t(a[k]) for k in names[1:]]
    plain = tgeglu.geglu_block_plain if block else tgeglu.geglu_ffn_plain
    before = tgeglu.launch_counts()
    routed = (tgeglu.geglu_block if block else tgeglu.geglu_ffn)(
        *targs, impl="cuda")
    assert tgeglu.launch_counts() == before      # CPU: the plain version
    got = plain(*targs)
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, C)
    assert torch.equal(routed, got)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    else:
        assert (np.abs(got - ref) <= _bf16_limit(ref)).all(), \
            np.abs(got - ref).max()


def test_gradients_of_all_inputs_match_the_jax_custom_vjp():
    a = _inputs(32, 64, 256, seed=5)
    jargs = [jnp.asarray(a[k]) for k in ORDER]
    jgrads = jax.jit(jax.grad(
        lambda *v: jnp.sum(jgeglu.geglu_block(*v, impl="pallas") ** 2),
        argnums=tuple(range(7))))(*jargs)
    leaves = [t(a[k]).requires_grad_(True) for k in ORDER]
    out = tgeglu.geglu_block(*leaves, impl="cuda")
    out.square().sum().backward()
    for name, leaf, ref in zip(ORDER, leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    # only the inputs that ask for a gradient get one: the frozen UNet
    # passes x alone
    x = t(a["x"]).requires_grad_(True)
    w1 = t(a["w1"])
    tgeglu.geglu_ffn(x, w1, t(a["b1"]), t(a["w2"]), t(a["b2"]),
                     impl="cuda").sum().backward()
    assert x.grad is not None and w1.grad is None


def test_route_resolution():
    assert tgeglu.resolved_impl() == "xla"      # opt-in, as in the JAX package
    assert tgeglu.resolved_impl("cuda") == "xla"
    tgeglu.set_default_impl("cuda")
    assert tgeglu.resolved_impl("cpu") == "cuda"
    tgeglu.set_default_impl(None)
    assert tgeglu.resolved_impl() == "xla"
    for bad in ("pallas", "triton"):
        with pytest.raises(ValueError, match="cuda"):
            tgeglu.set_default_impl(bad)
    tgeglu._DEFAULT_IMPL = "pallas"              # as CELEBBASIS_GEGLU=pallas
    with pytest.raises(ValueError, match="cuda"):
        tgeglu.resolved_impl()


def test_module_weights_reach_the_kernel_without_a_copy():
    """FeedForwardGEGLU hands over transposed views of its nn.Linear
    weights; in the compute type they already have the layout the kernel
    reads (the reduction axis contiguous, 16-byte rows), so nothing is
    copied per call."""
    ff = tunet.FeedForwardGEGLU(64, torch.bfloat16).to(torch.bfloat16)
    for w in (ff.proj_in.weight.t(), ff.proj_out.weight.t()):
        got = tgeglu._kernel_layout(w, torch.bfloat16)
        assert got.data_ptr() == w.data_ptr() and got.stride() == w.stride()
    jax_layout = torch.zeros(64, 512, dtype=torch.bfloat16)
    moved = tgeglu._kernel_layout(jax_layout, torch.bfloat16)
    assert moved.stride(0) == 1 and torch.equal(moved, jax_layout)


def test_tiny_unet_with_the_fused_route_matches_jax(monkeypatch):
    """The slice as a whole: the tiny UNet's eps with every FF sub-block on
    the fused route, JAX (Pallas, interpret mode) against the port."""
    jm = junet.UNetModel(junet.UNetConfig.tiny(), jnp.float32)
    size = 8
    params = random_params(jm.init, jax.random.key(0),
                           jnp.zeros((1, size, size, 4)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                           seed=2)
    tm = tunet.UNetModel(tunet.UNetConfig.tiny(), torch.float32).eval()
    bridge.load_jax_params(tm, np_tree(params))
    r = np.random.default_rng(size)
    x = r.standard_normal((3, size, size, 4)).astype(np.float32)
    ts = np.array([1, 500, 981], np.int32)
    ctx = r.standard_normal((3, 77, 64)).astype(np.float32)
    jgeglu._DEFAULT_IMPL = "pallas"
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                       jnp.asarray(ts), jnp.asarray(ctx)))
    tgeglu.set_default_impl("cuda")
    calls = []
    forward = tgeglu._forward
    monkeypatch.setattr(tgeglu, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    with torch.no_grad():
        got = tm(t(x), t(ts).long(), t(ctx))
    n_blocks = sum(isinstance(m, tunet.FeedForwardGEGLU)
                   for m in tm.modules())
    assert len(calls) == n_blocks > 0        # every FF sub-block took it
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
