"""PyTorch port, int8 matmul: ``ops/quant.py`` against the JAX package's
``celebbasis_tpu/ops/quant.py`` on the CPU, the Pallas kernel in interpret
mode.

The whole computation is exact arithmetic up to the roundings its definition
names (IEEE division, round half to even, an exact integer product, two fp32
products in a fixed order), so the two sides are held to equality bit for
bit.  On CPU tensors ``int8_matmul`` is its plain version; the kernel itself
is held to the same version on the card (chip_smoke.py and the ``cuda``
cases of test_torch_cuda_kernels.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from celebbasis_tpu.ops import quant as jquant
from celebbasis_tpu_torch.ops import quant as tquant

from _torch_port_helpers import t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def test_quantize_per_channel_equals_jax():
    r = np.random.default_rng(0)
    w = (r.standard_normal((96, 40)) * 0.3).astype(np.float32)
    w[:, 3] = 0.0                       # an all-zero channel: the 1e-8 floor
    w[5, 7] = 2.5 * np.abs(w[:, 7]).max()   # a round-half case nearby
    for axis in (1, 0):
        jq, js = jquant.quantize_per_channel(jnp.asarray(w), axis=axis)
        q, s = tquant.quantize_per_channel(t(w), axis=axis)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# (136, 2600, 200): K beyond what the kernel keeps resident (its streamed
# mode), M and N ragged at its 128-row and 128-column tiles
@pytest.mark.parametrize("shape", [(128, 256, 128), (100, 300, 77),
                                   (136, 2600, 200)])
def test_int8_matmul_plain_equals_jax_kernel(shape):
    M, K, N = shape
    r = np.random.default_rng(1)
    x = r.standard_normal((M, K)).astype(np.float32)
    x[3] *= 1e-3                        # rows of very different scales
    x[4] = 0.0                          # and an all-zero row
    w = (r.standard_normal((K, N)) * 0.05).astype(np.float32)
    jq, js = jquant.quantize_per_channel(jnp.asarray(w))
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js, block_m=128,
                                        block_n=128, block_k=128))
    q, s = tquant.quantize_per_channel(t(w))
    launches = tquant.launch_counts()["int8_matmul"]
    got = tquant.int8_matmul(t(x), q, s)
    assert tquant.launch_counts()["int8_matmul"] == launches   # CPU: plain
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tquant.int8_matmul_plain(t(x), q, s).numpy(), ref)


def test_int8_matmul_plain_bf16_input():
    """bf16 activations: quantised from their fp32 values, the output
    rounded once to bf16 (the JAX kernel's ``astype(o_ref.dtype)``)."""
    r = np.random.default_rng(2)
    x = r.standard_normal((64, 128)).astype(np.float32)
    w = (r.standard_normal((128, 48)) * 0.05).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jq, js = jquant.quantize_per_channel(jnp.asarray(w))
    ref = np.asarray(jquant.int8_matmul(xb, jq, js, block_m=128,
                                        block_n=128, block_k=128)
                     .astype(jnp.float32))
    q, s = tquant.quantize_per_channel(t(w))
    got = tquant.int8_matmul(t(np.asarray(xb.astype(jnp.float32)),
                               torch.bfloat16), q, s)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("bad", ["k_mismatch", "w_float", "scale_len",
                                 "x_3d"])
def test_int8_matmul_rejects_bad_inputs(bad):
    """Shapes and types the function does not take are refused before any
    device is touched, CPU included."""
    x = torch.ones(2, 8)
    q, s = tquant.quantize_per_channel(torch.ones(8, 4))
    args = {"k_mismatch": (torch.ones(2, 6), q, s),
            "w_float": (x, q.float(), s),
            "scale_len": (x, q, s[:3]),
            "x_3d": (x[None], q, s)}[bad]
    with pytest.raises(ValueError, match="bad inputs"):
        tquant.int8_matmul(*args)


def test_quantize_dense_tree_equals_jax():
    r = np.random.default_rng(3)
    f = lambda *s: (r.standard_normal(s) * 0.1).astype(np.float32)
    tree = {"params": {
        "attn1": {"to_q": {"kernel": f(8, 16)},
                  "to_out": {"kernel": f(16, 8), "bias": f(8)}},
        "conv": {"kernel": f(3, 3, 4, 8)},          # 4-D: passes through
        "norm": {"scale": f(8), "bias": f(8)}}}
    keep = lambda p: "to_" in p
    jout, jn = jquant.quantize_dense_tree(
        {k: jnp.asarray(v) if not isinstance(v, dict) else v
         for k, v in tree.items()}, path_filter=keep)
    tt = lambda d: {k: tt(v) if isinstance(v, dict) else t(v)
                    for k, v in d.items()}
    out, n = tquant.quantize_dense_tree(tt(tree), path_filter=keep)
    assert n == jn == 2

    def flat(d, prefix=""):
        items = {}
        for k, v in d.items():
            if isinstance(v, dict):
                items.update(flat(v, f"{prefix}{k}/"))
            else:
                items[prefix + k] = np.asarray(v)
        return items

    mine, theirs = flat(out), flat(jout)
    assert sorted(mine) == sorted(theirs)
    for key, value in theirs.items():
        assert mine[key].dtype == value.dtype, key
        np.testing.assert_array_equal(mine[key], value, err_msg=key)
