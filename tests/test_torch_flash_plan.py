"""PyTorch port, flash-attention backward: how the bf16 dk/dv kernel spreads
over the card.  Pure Python, no card: ``dkv_split_plan`` is a function of the
shape and the SM count alone, pinned here at the eight training shapes of
the SD v1 UNet (batch 2, 8 heads, 132 SMs as on an H100 SXM) and a ragged
one."""
import pytest

from celebbasis_tpu_torch.ops import flash_attention as fa
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

H100_SMS = 132

# (N, M, D) -> (splits, scratch shape of each of dk's and dv's partial sums)
PLANS = {
    (4096, 4096, 40): (1, None),      # 32 key tiles x 16 heads: 512 blocks
    (4096, 77, 40): (8, (8, 2, 8, 77, 40)),
    (1024, 1024, 80): (1, None),      # 8 x 16 = 128 blocks
    (1024, 77, 80): (8, (8, 2, 8, 77, 80)),
    (256, 256, 160): (2, (2, 2, 8, 256, 160)),
    (256, 77, 160): (4, (4, 2, 8, 77, 160)),   # one split per query tile
    (64, 64, 160): (1, None),         # a single query tile
    (64, 77, 160): (1, None),
    (1100, 77, 40): (8, (8, 2, 8, 77, 40)),    # 9 query tiles over 8 splits
}


@pytest.mark.parametrize("shape", sorted(PLANS), ids=lambda s: "x".join(
    map(str, s)))
def test_dkv_split_plan_at_training_shapes(shape):
    N, M, D = shape
    assert fa.dkv_split_plan(2, 8, N, M, D, H100_SMS) == PLANS[shape]


def test_dkv_split_plan_fills_one_wave_and_never_exceeds_the_tiles():
    """The split count times the key-tile blocks stays within one wave of
    the SMs and within the query tiles, and shrinks with the SMs."""
    for (N, M, D), _ in PLANS.items():
        keys, rows = fa.dkv_tiles(D)
        blocks = 2 * 8 * -(-M // keys)
        for sms in (1, 66, 132, 264):
            splits, scratch = fa.dkv_split_plan(2, 8, N, M, D, sms)
            assert 1 <= splits <= max(1, -(-N // rows))
            assert splits == 1 or splits * blocks <= sms
            assert (scratch is None) == (splits == 1)
