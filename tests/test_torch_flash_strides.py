"""PyTorch port, flash attention: what the wrappers hand the kernels.

The bf16 kernels read q, k, v and write o through TMA tensor maps built from
base pointers and (batch, head, row) element strides, so both entry points
must describe one buffer the same way: the packed ``(B, L, H*D)`` layout of
``flash_attention_nhd`` and the per-head ``(B, H, L, D)`` views of that
buffer that ``flash_attention`` takes.  The TMA unit also needs 16-byte base
addresses and strides that are multiples of 16 bytes, which ``_aligned``
checks.  Pure Python on CPU tensors, at the SD v1 UNet's attention shapes
(8 heads); no card.
"""
import pytest
import torch

from celebbasis_tpu_torch.ops import flash_attention as fa

H = 8
# (B, N, M, D): the eight serving shapes (batch 4) of the UNet's levels
SERVING = [(4, N, M, D) for N, D in ((4096, 40), (1024, 80), (256, 160),
                                     (64, 160)) for M in (N, 77)]


@pytest.mark.parametrize("shape", SERVING, ids=lambda s: "x".join(map(str, s)))
def test_both_layouts_hand_the_kernels_one_description(shape):
    B, N, M, D = shape
    q, o = (torch.empty(B, N, H * D, dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.empty(B, M, H * D, dtype=torch.bfloat16) for _ in range(2))
    packed = (q, k, v, o)
    heads = tuple(fa._split(x, H) for x in packed)
    assert fa._geometry(q, k, v, H) == (B, H, N, M, D)
    assert fa._geometry(*heads[:3], None) == (B, H, N, M, D)
    assert list(fa._stride_array(packed, H)) == \
        list(fa._stride_array(heads, None))
    # (batch, head, row) of the packed buffer: the head dim is contiguous
    assert fa._strides(q, H) == (N * H * D, D, H * D)
    assert all(fa._aligned(x, fa._strides(x, H)) for x in packed)


def test_aligned_refuses_what_the_tma_unit_does_not_take():
    buf = torch.empty(2, 64, H * 40 + 8, dtype=torch.bfloat16)
    ok = buf[..., :H * 40]
    assert fa._aligned(ok, fa._strides(ok, H))
    # a base 2 bytes past a 16-byte boundary
    shifted = buf[..., 1:H * 40 + 1]
    assert not fa._aligned(shifted, fa._strides(shifted, H))
    # a row stride of 44 elements (88 bytes)
    odd = torch.empty(2, 64, 44, dtype=torch.bfloat16)
    assert not fa._aligned(odd, fa._strides(odd, 1))
