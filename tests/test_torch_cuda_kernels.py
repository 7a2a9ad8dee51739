"""PyTorch port: the cases that need an NVIDIA GPU (and nvcc).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's requirements:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

(``--noconftest`` because tests/conftest.py sets up JAX's virtual CPU
devices).  Without a card every case skips, inside the test.
"""
import pytest
import torch

from celebbasis_tpu_torch.ops import flash_attention as fa


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs a CUDA device and nvcc: builds the kernel and holds it against
    the plain version (chip_smoke.py does the same at the serving shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    # (dtype, absolute limit, N, M); bf16 is also held to the limit that
    # scales with the outputs (bf16_error_ratio), which is the binding one
    cases = ((torch.float32, 2e-5, 100, 77), (torch.bfloat16, 2e-2, 100, 77),
             (torch.bfloat16, 2e-2, 1100, 77),   # 64-row and 128-row tiles
             (torch.bfloat16, 2e-2, 1100, 1000))  # many K/V tiles, flat softmax
    for dtype, tol, N, M in cases:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(2, N, 3 * 40, device="cuda", generator=g).to(dtype)
        k = torch.randn(2, M, 3 * 40, device="cuda", generator=g).to(dtype)
        v = torch.randn(2, M, 3 * 40, device="cuda", generator=g).to(dtype)
        before = fa.launch_count("flash_attention_nhd")
        out = fa.flash_attention_nhd(q, k, v, 3)
        assert fa.launch_count("flash_attention_nhd") == before + 1
        ref = fa.flash_attention_nhd_plain(q, k, v, 3)
        assert (out.float() - ref.float()).abs().max().item() <= tol
        if dtype == torch.bfloat16:
            assert fa.bf16_error_ratio(out, ref) <= 1.0
