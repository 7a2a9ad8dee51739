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
from celebbasis_tpu_torch.ops import geglu
from celebbasis_tpu_torch.ops import quant

# absolute limits; bf16 is also held to the limits that scale with the values
# compared (bf16_error_ratio <= 1 for outputs, bf16_grad_error_ratio <= 1 for
# gradients), which are the binding ones
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# gradients of unit-variance dO: fp32 differs by summation order only
GRAD_TOL_F32 = 5e-5
# lse: fp32 sums of exact products in both types; the bf16 kernel's
# exponentials are ex2.approx (2**-22 relative), the fp32 kernel's expf
LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _qkv(B, H, N, M, D, dtype, seed=0, packed=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda L: torch.randn(B, L, H * D, device="cuda",
                               generator=g).to(dtype)
    q, k, v, do = mk(N), mk(M), mk(M), mk(N)
    if not packed:
        q, k, v, do = (fa._split(x, H) for x in (q, k, v, do))
    return q, k, v, do


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs a CUDA device and nvcc: builds the kernel and holds it against
    the plain version (chip_smoke.py does the same at the serving shapes)."""
    _need_card()
    cases = ((torch.float32, 100, 77), (torch.bfloat16, 100, 77),
             (torch.bfloat16, 1100, 77),   # 64-row and 128-row tiles
             (torch.bfloat16, 1100, 1000))  # many K/V tiles, flat softmax
    for dtype, N, M in cases:
        q, k, v, _ = _qkv(2, 3, N, M, 40, dtype)
        before = fa.launch_count("flash_attention_nhd")
        out = fa.flash_attention_nhd(q, k, v, 3)
        assert fa.launch_count("flash_attention_nhd") == before + 1
        ref = fa.flash_attention_nhd_plain(q, k, v, 3)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
        if dtype == torch.bfloat16:
            assert fa.bf16_error_ratio(out, ref) <= 1.0


# (B, H, N, M, D): ragged tiles, M = 77, every padded width, many tiles
BWD_SHAPES = [(2, 3, 100, 77, 40), (1, 2, 200, 300, 256),
              (1, 2, 1100, 333, 40), (2, 2, 256, 256, 160),
              (2, 3, 130, 77, 80), (1, 2, 64, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_forward_on_card(dtype, packed):
    """The training forward: o equals the inference forward's bit for bit,
    lse agrees with the plain version."""
    _need_card()
    for B, H, N, M, D in BWD_SHAPES:
        q, k, v, _ = _qkv(B, H, N, M, D, dtype, packed=packed)
        heads = H if packed else None
        before = fa.launch_count("fwd_lse")
        o, lse = fa.flash_attention_lse(q, k, v, heads)
        assert fa.launch_count("fwd_lse") == before + 1
        infer = fa.flash_attention_nhd(q, k, v, H) if packed \
            else fa.flash_attention(q, k, v)
        assert torch.equal(o, infer)
        q4, k4, v4 = (fa._split(x, H) for x in (q, k, v)) if packed \
            else (q, k, v)
        _, lse_ref = fa.flash_attention_lse_plain(q4, k4, v4)
        assert lse.shape == (B, H, N) and lse.dtype == torch.float32
        assert (lse - lse_ref).abs().max().item() <= LSE_TOL[dtype]


# the 77-key training shapes, whose bf16 dk/dv splits each key tile's query
# stream over several blocks, and one whose splits take query ranges of
# different lengths
SPLIT_SHAPES = [(2, 8, 4096, 77, 40), (2, 8, 1024, 77, 80),
                (2, 8, 256, 77, 160), (2, 8, 1100, 77, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_on_card(dtype, packed):
    """dq, dk, dv of the kernels against the backward written out in plain
    PyTorch, on the kernels' own o and lse; a second run gives the same
    bits."""
    _need_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, H, N, M, D in BWD_SHAPES + SPLIT_SHAPES:
        if (B, H, N, M, D) in SPLIT_SHAPES:
            assert fa.dkv_split_plan(B, H, N, M, D, sms)[0] > 1
        q, k, v, do = _qkv(B, H, N, M, D, dtype, seed=1, packed=packed)
        heads = H if packed else None
        o, lse = fa.flash_attention_lse(q, k, v, heads)
        before = fa.launch_counts()
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, heads)
        after = fa.launch_counts()
        assert after["dq"] == before["dq"] + 1
        assert after["dkv"] == before["dkv"] + 1
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, heads)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        to4 = (lambda x: fa._split(x, H)) if packed else (lambda x: x)
        ref = fa.flash_attention_bwd_plain(to4(q), to4(k), to4(v), to4(o),
                                           lse, to4(do))
        for name, g, r, like in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
            g4 = to4(g)
            assert g.shape == like.shape and g.dtype == like.dtype
            err = (g4.float() - r.float()).abs().max().item()
            if dtype == torch.float32:
                assert err <= GRAD_TOL_F32, (name, (B, H, N, M, D), err)
            else:
                ratio = fa.bf16_grad_error_ratio(g4, r)
                assert ratio <= 1.0, (name, (B, H, N, M, D), err, ratio)


@pytest.mark.cuda
def test_autograd_route_on_card():
    """The differentiable entry: which kernels run follows needs_input_grad,
    gradients agree with autograd through the plain version, and two runs
    give the same bits."""
    _need_card()
    B, H, N, M, D = 2, 4, 300, 77, 40
    q, k, v, do = _qkv(B, H, N, M, D, torch.float32, seed=2)
    k.requires_grad_(True)
    v.requires_grad_(True)
    fa.reset_launch_count()
    out = fa.flash_attention_nhd(q, k, v, H)
    dk, dv = torch.autograd.grad(out, (k, v), do)
    assert fa.launch_counts() == {"flash_attention_nhd": 0,
                                  "flash_attention": 0, "fwd_lse": 1,
                                  "dq": 0, "dkv": 1}
    q.requires_grad_(True)
    out = fa.flash_attention_nhd(q, k, v, H)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert fa.launch_count("dq") == 1 and fa.launch_count("dkv") == 2
    assert torch.equal(grads[1], dk) and torch.equal(grads[2], dv)
    ref = torch.autograd.grad(fa.flash_attention_nhd_plain(q, k, v, H),
                              (q, k, v), do)
    for g, r in zip(grads, ref):
        assert (g - r).abs().max().item() <= GRAD_TOL_F32
    with torch.no_grad():
        fa.reset_launch_count()
        fa.flash_attention_nhd(q, k, v, H)
        assert fa.launch_count("flash_attention_nhd") == 1
        assert fa.launch_count("fwd_lse") == 0
    # per-head entry on permuted views of packed buffers, bf16
    qb, kb, vb, dob = (x.detach().to(torch.bfloat16).requires_grad_(True)
                       for x in (q, k, v, do))
    out = fa.flash_attention(*(fa._split(x, H) for x in (qb, kb, vb)))
    g1 = torch.autograd.grad(fa._merge(out), (qb, kb, vb), dob.detach())
    out = fa.flash_attention_nhd(qb, kb, vb, H)
    g2 = torch.autograd.grad(out, (qb, kb, vb), dob.detach())
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def _geglu_args(rows, C, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    inner = 4 * C
    return (rnd(rows, C).to(dtype), 1 + 0.1 * rnd(C), 0.1 * rnd(C),
            (rnd(2 * inner, C) * C ** -0.5).to(dtype).t(),
            0.05 * rnd(2 * inner),
            (rnd(C, inner) * inner ** -0.5).to(dtype).t(), 0.05 * rnd(C))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_kernels_match_plain_on_card(dtype):
    """Both GEGLU kernels against their plain versions: a ragged row count,
    every row-tile width (split and unsplit inner sweeps), and the tiny
    UNet's widths (narrower than a tile)."""
    _need_card()
    for rows, C in ((100, 320), (300, 640), (128, 1280), (4096, 320),
                    (77, 64), (40, 32)):
        x, lns, lnb, w1, b1, w2, b2 = _geglu_args(rows, C, dtype, seed=rows)
        for entry in ("geglu_block", "geglu_ffn"):
            before = geglu.launch_counts()[entry]
            if entry == "geglu_block":
                out = geglu.geglu_block(x, lns, lnb, w1, b1, w2, b2,
                                        impl="cuda")
                ref = geglu.geglu_block_plain(x, lns, lnb, w1, b1, w2, b2)
            else:
                out = geglu.geglu_ffn(x, w1, b1, w2, b2, impl="cuda")
                ref = geglu.geglu_ffn_plain(x, w1, b1, w2, b2)
            assert geglu.launch_counts()[entry] == before + 1
            assert out.shape == ref.shape and out.dtype == ref.dtype
            err = (out.float() - ref.float()).abs().max().item()
            if dtype == torch.float32:
                assert err <= 2e-5 * ref.abs().max().item(), (entry, rows, C)
            else:
                assert fa.bf16_error_ratio(out, ref) <= 1.0, (entry, rows, C)


@pytest.mark.cuda
def test_geglu_route_launches_the_kernel_and_backward_recomputes():
    """Route "cuda" on a CUDA tensor goes through the kernel (by the
    counter); gradients recompute through the plain path and agree with
    autograd through the "xla" route."""
    _need_card()
    x, lns, lnb, w1, b1, w2, b2 = _geglu_args(200, 64, torch.float32, seed=9)
    x.requires_grad_(True)
    w1.requires_grad_(True)
    geglu.reset_launch_count()
    out = geglu.geglu_block(x, lns, lnb, w1, b1, w2, b2, impl="cuda")
    assert geglu.launch_counts() == {"geglu_block": 1, "geglu_ffn": 0}
    gx, gw1 = torch.autograd.grad(out.square().sum(), (x, w1))
    assert geglu.launch_counts()["geglu_block"] == 1    # no kernel backward
    ref = geglu.geglu_block(x, lns, lnb, w1, b1, w2, b2, impl="xla")
    rx, rw1 = torch.autograd.grad(ref.square().sum(), (x, w1))
    assert (gx - rx).abs().max().item() <= 1e-4 * rx.abs().max().item()
    assert (gw1 - rw1).abs().max().item() <= 1e-4 * rw1.abs().max().item()
    geglu.set_default_impl("cuda")
    try:
        with torch.no_grad():
            geglu.geglu_ffn(x, w1, b1, w2, b2)
    finally:
        geglu.set_default_impl(None)
    assert geglu.launch_counts()["geglu_ffn"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_equals_plain_on_card(dtype):
    """Bit for bit, with the weights in the layout quantize_per_channel
    stores and in the JAX layout (copied by the wrapper), and a ragged K."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    for M, K, N in ((100, 300, 77), (1024, 640, 640), (300, 1280, 320)):
        w_q, w_s = quant.quantize_per_channel(
            torch.randn(K, N, device="cuda", generator=g))
        x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
        ref = quant.int8_matmul_plain(x, w_q, w_s)
        before = quant.launch_counts()["int8_matmul"]
        for w in (w_q, w_q.contiguous()):
            assert torch.equal(quant.int8_matmul(x, w, w_s), ref)
        assert quant.launch_counts()["int8_matmul"] == before + 2
