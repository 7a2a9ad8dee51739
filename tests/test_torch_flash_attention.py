"""PyTorch port, flash attention: both entry points against the Pallas
kernels run in interpret mode.

On the CPU a wrapper of the port takes its kernel's plain version (and only
because the tensors lie on the CPU); the JAX side runs the real Pallas kernel
bodies through the interpreter, as tests/test_flash_attention.py does.
Tolerances: fp32 2e-5 (summation order), bf16 2e-2 on unit-scale inputs (bf16
rounding of the probabilities and of the output).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import celebbasis_tpu.ops.flash_attention as jfa
from celebbasis_tpu_torch.ops import flash_attention as tfa

from _torch_port_helpers import t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


# (B, H, N, M, D)
SHAPES = [
    (1, 2, 64, 64, 40),      # SD self-attention head dim, padded lanes
    (2, 4, 128, 77, 64),     # cross-attention, 77-token context masking
    (1, 8, 256, 256, 160),   # deep-level head dim
    (1, 1, 100, 100, 32),    # sequence lengths off every tile size
    (1, 2, 100, 77, 80),     # ragged queries and ragged keys
    (2, 2, 64, 77, 160),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(shape, dtype, seed):
    B, H, N, M, D = shape
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, N, H * D)).astype(np.float32)
    k = r.standard_normal((B, M, H * D)).astype(np.float32)
    v = r.standard_normal((B, M, H * D)).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in (q, k, v)],
            [t(a).to(td) for a in (q, k, v)])


def _heads_j(x, H):
    B, L, C = x.shape
    return x.reshape(B, L, H, C // H).transpose(0, 2, 1, 3)


def _heads_t(x, H):
    B, L, C = x.shape
    return x.reshape(B, L, H, C // H).permute(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_packed_entry_matches_pallas(shape, dtype):
    H = shape[1]
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, dtype, 0)
    ref = np.asarray(jfa.flash_attention_nhd(jq, jk, jv, H, block_q=64,
                                             block_k=128), np.float32)
    got = tfa.flash_attention_nhd(tq, tk, tv, H)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_per_head_entry_matches_pallas(shape, dtype):
    H = shape[1]
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, dtype, 1)
    ref = np.asarray(jfa.flash_attention(_heads_j(jq, H), _heads_j(jk, H),
                                         _heads_j(jv, H), block_q=64,
                                         block_k=128), np.float32)
    got = tfa.flash_attention(_heads_t(tq, H), _heads_t(tk, H),
                              _heads_t(tv, H))
    assert got.shape == ref.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dtype])


def test_entries_agree_with_each_other():
    shape = (2, 4, 50, 77, 40)
    _, (q, k, v) = _qkv(shape, "float32", 2)
    a = tfa.flash_attention_nhd(q, k, v, 4)
    b = tfa.flash_attention(_heads_t(q, 4), _heads_t(k, 4), _heads_t(v, 4))
    np.testing.assert_allclose(
        a.numpy(), b.permute(0, 2, 1, 3).reshape(a.shape).numpy(), atol=1e-6)


def test_wrapper_rejects_bad_arguments():
    q = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention_nhd(q, torch.zeros(1, 8, 16), torch.zeros(1, 8, 16), 4)
    with pytest.raises(ValueError):
        tfa.flash_attention_nhd(q, q, q, 5)          # 32 % 5 != 0
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)                 # wants 4 dims
    assert tfa.supports(40) and tfa.supports(256)
    assert not tfa.supports(512) and not tfa.supports(20)


def test_cpu_calls_launch_no_kernel_and_build_nothing(tmp_path, monkeypatch):
    from celebbasis_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "build_dir", lambda: str(tmp_path))
    tfa.reset_launch_count()
    q = torch.ones(1, 4, 16)
    tfa.flash_attention_nhd(q, q, q, 2)
    assert tfa.launch_count() == 0
    assert tfa.launch_count("flash_attention_nhd") == 0
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("shape", [(1, 2, 256, 1024, 40), (2, 2, 64, 77, 160)])
def test_scaled_bf16_limit_holds_between_two_right_kernels(shape):
    """The Pallas kernel (online softmax, its own rounding points) and the
    port's plain version are both right: their bf16 results lie within the
    limit that scales with the outputs, flat softmax (1024 keys) or not."""
    H = shape[1]
    (jq, jk, jv), (tq, tk, tv) = _qkv(shape, "bfloat16", 3)
    ref = t(np.asarray(jfa.flash_attention_nhd(jq, jk, jv, H, block_q=64,
                                               block_k=128), np.float32))
    got = tfa.flash_attention_nhd(tq, tk, tv, H)
    assert tfa.bf16_error_ratio(got, ref) <= 1.0
    assert tfa.bf16_error_ratio(got, got) == 0.0


def test_scaled_bf16_limit_catches_a_wrong_result_at_small_outputs():
    """A flat softmax over 1024 keys gives outputs of a few hundredths, where
    an absolute limit sized for unit outputs says little.  A result that
    drops the last 8 keys, or scales the logits for a head dim of 48 instead
    of 40, must fail the scaled limit by a wide margin."""
    shape = (1, 2, 256, 1024, 40)
    _, (q, k, v) = _qkv(shape, "bfloat16", 4)
    ref = tfa.flash_attention_nhd(q, k, v, 2)
    assert ref.float().square().mean().sqrt().item() < 0.06
    dropped = tfa.flash_attention_nhd(q, k[:, :-8], v[:, :-8], 2)
    rescaled = tfa.flash_attention_nhd(q * (40 / 48) ** 0.5, k, v, 2)
    for wrong in (dropped, rescaled):
        assert tfa.bf16_error_ratio(wrong, ref) > 4.0
