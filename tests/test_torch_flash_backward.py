"""PyTorch port, flash-attention backward: the plain versions of the
logsumexp-saving forward and of the backward against the Pallas kernels run
in interpret mode (as tests/test_flash_attention.py runs them on the CPU).

Inputs come from a numpy seed and go through both sides.  fp32 throughout;
tolerance 1e-5 on lse, dq, dk, dv (both sides do fp32 products; they differ by
the order of summation and by the Pallas kernels' tiled online softmax).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import celebbasis_tpu.ops.flash_attention as jfa
from celebbasis_tpu_torch.ops import flash_attention as tfa

from _torch_port_helpers import t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


# (B, H, N, M, D)
SHAPES = [
    (1, 2, 64, 64, 40),      # SD self-attention head dim
    (2, 2, 100, 77, 64),     # ragged queries, the 77-token context
    (1, 2, 72, 130, 32),     # ragged queries and keys, several key tiles
    (1, 1, 128, 77, 160),    # deep-level head dim against the context
]


def _inputs(shape, seed):
    B, H, N, M, D = shape
    r = np.random.default_rng(seed)
    mk = lambda L: r.standard_normal((B, H, L, D)).astype(np.float32)
    return mk(N), mk(M), mk(M), mk(N)     # q, k, v, dO


def _jax_vjp(q, k, v, do, packed, H):
    """(o, dq, dk, dv) of the Pallas route, per-head (B, H, L, D) arrays."""
    if packed:
        pack = lambda x: x.transpose(0, 2, 1, 3).reshape(
            x.shape[0], x.shape[2], -1)
        unpack = lambda x: np.asarray(x).reshape(
            x.shape[0], x.shape[1], H, -1).transpose(0, 2, 1, 3)
        f = lambda a, b, c: jfa.flash_attention_nhd(a, b, c, H, block_q=64,
                                                    block_k=128)
        o, vjp = jax.vjp(f, *(jnp.asarray(pack(x)) for x in (q, k, v)))
        grads = vjp(jnp.asarray(pack(do)))
        return (unpack(o),) + tuple(unpack(g) for g in grads)
    f = lambda a, b, c: jfa.flash_attention(a, b, c, block_q=64, block_k=128)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(o),) + tuple(np.asarray(g)
                                    for g in vjp(jnp.asarray(do)))


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_plain_matches_pallas_stats(shape):
    q, k, v, _ = _inputs(shape, 0)
    B, H, N, M, D = shape
    ref_o, (_, _, _, lse) = jfa._forward(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), 64, 128,
                                         with_stats=True)
    ref_lse = np.asarray(lse)[:, :N, 0].reshape(B, H, N)
    o, got = tfa.flash_attention_lse_plain(t(q), t(k), t(v))
    assert got.shape == (B, H, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_lse, atol=TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=TOL)
    # the wrapper on CPU tensors, both layouts, is this plain version
    o2, lse2 = tfa.flash_attention_lse(tfa._merge(t(q)), tfa._merge(t(k)),
                                       tfa._merge(t(v)), H)
    np.testing.assert_array_equal(lse2.numpy(), got.numpy())
    np.testing.assert_array_equal(tfa._split(o2, H).numpy(), o.numpy())


@pytest.mark.parametrize("packed", [False, True], ids=["bhnd", "nhd"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_matches_pallas_kernels(shape, packed):
    q, k, v, do = _inputs(shape, 1)
    H = shape[1]
    _, *ref = _jax_vjp(q, k, v, do, packed, H)
    tq, tk, tv, tdo = t(q), t(k), t(v), t(do)
    if packed:
        pq, pk, pv, pdo = (tfa._merge(x) for x in (tq, tk, tv, tdo))
        o, lse = tfa.flash_attention_lse(pq, pk, pv, H)
        got = tfa.flash_attention_bwd(pq, pk, pv, o, lse, pdo, H)
        got = [tfa._split(g, H) for g in got]
    else:
        o, lse = tfa.flash_attention_lse_plain(tq, tk, tv)
        got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_backward_plain_matches_autograd(shape):
    """The backward written out against autograd through the plain forward
    (which is what a CPU caller differentiates)."""
    q, k, v, do = (t(x) for x in _inputs(shape, 2))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention(*leaves), leaves, do)
    o, lse = tfa.flash_attention_lse_plain(q, k, v)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL)


def test_differentiable_entries_match_jax_grad():
    """Both public entries under autograd on the CPU against jax.grad of a
    scalar loss through the Pallas route."""
    shape = (2, 2, 40, 77, 40)
    q, k, v, w = _inputs(shape, 3)
    H = shape[1]
    loss_j = lambda a, b, c: jnp.sum(
        jfa.flash_attention(a, b, c, block_q=64, block_k=128) * w)
    ref = jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in (q, k, v)))
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    (tfa.flash_attention(*leaves) * t(w)).sum().backward()
    for g, r in zip(leaves, ref):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), atol=TOL)
    packed = [tfa._merge(t(x)).requires_grad_(True) for x in (q, k, v)]
    (tfa.flash_attention_nhd(*packed, H) * tfa._merge(t(w))).sum().backward()
    for g, r in zip(packed, ref):
        np.testing.assert_allclose(tfa._split(g.grad, H).numpy(),
                                   np.asarray(r), atol=TOL)


def test_unrequested_gradients_are_none_and_counters_stay_zero():
    q, k, v, do = (t(x) for x in _inputs((1, 2, 16, 8, 8), 4))
    o, lse = tfa.flash_attention_lse(q, k, v)
    tfa.reset_launch_count()
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, need_dq=False)
    assert dq is None and dk is not None and dv is not None
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, need_dkv=False)
    assert dq is not None and dk is None and dv is None
    assert tfa.launch_counts() == {"flash_attention_nhd": 0,
                                   "flash_attention": 0, "fwd_lse": 0,
                                   "dq": 0, "dkv": 0}
    assert tfa.reduce_launch_count() == 0


def test_scaled_bf16_gradient_limit_between_two_right_backwards():
    """bf16 inputs: the Pallas backward (fp32 products on bf16 values) and
    the port's plain backward are both right; their gradients lie within the
    limit that scales with the values (row-wise), and a dv that is 10 % off
    or a dq without its final scale lies far outside."""
    shape = (1, 2, 64, 256, 40)
    q, k, v, do = _inputs(shape, 5)
    q = q * 3.0                                  # a peaked softmax: hot keys
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    f = lambda a, b, c: jfa.flash_attention(a, b, c, block_q=64, block_k=128)
    o_j, vjp = jax.vjp(f, bf(q), bf(k), bf(v))
    ref = [t(np.asarray(g, np.float32)) for g in vjp(bf(do))]
    tq, tk, tv, tdo = (t(x).bfloat16() for x in (q, k, v, do))
    _, lse = tfa.flash_attention_lse_plain(tq, tk, tv)
    # on the same rounded o: delta = rowsum(dO * O) feels o's last bit
    o = t(np.asarray(o_j, np.float32)).bfloat16()
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    for g, r in zip(got, ref):
        assert tfa.bf16_grad_error_ratio(g, r) <= 1.0
        assert tfa.bf16_grad_error_ratio(g, g) == 0.0
    assert tfa.bf16_grad_error_ratio(got[2] * 0.9, ref[2]) > 2.0
    assert tfa.bf16_grad_error_ratio(got[0] * 40 ** 0.5, ref[0]) > 10.0
    # a flat tensor: the row-wise limit is the tensor-wise one
    flat = torch.ones(4, 8)
    assert tfa.bf16_grad_error_ratio(flat * 1.01, flat) == \
        pytest.approx(tfa.bf16_error_ratio(flat * 1.01, flat))
