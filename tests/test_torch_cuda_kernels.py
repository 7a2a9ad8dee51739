"""PyTorch port: the cases that need an NVIDIA GPU (and nvcc).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's requirements:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

(``--noconftest`` because tests/conftest.py sets up JAX's virtual CPU
devices).  Without a card every case skips, inside the test.
"""
import pytest
import torch

from celebbasis_tpu_torch.ops import basic
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
    # (dtype, B, H, N, M, D)
    cases = ((torch.float32, 2, 3, 100, 77, 40),
             (torch.bfloat16, 2, 3, 100, 77, 40),
             (torch.bfloat16, 2, 3, 1100, 77, 40),   # ragged query tiles
             (torch.bfloat16, 2, 3, 1100, 1000, 40),  # many K/V tiles
             (torch.bfloat16, 1, 2, 1100, 333, 40),  # ragged both ways
             # ragged both ways on blocks of three (D = 40) and two (D = 80)
             # consumer warpgroups, the last 128-key tile part-filled
             (torch.bfloat16, 4, 8, 1100, 333, 40),
             (torch.bfloat16, 4, 8, 1100, 333, 80),
             (torch.bfloat16, 1, 2, 200, 300, 256))  # the widest head dim
    for dtype, B, H, N, M, D in cases:
        q, k, v, _ = _qkv(B, H, N, M, D, dtype)
        before = fa.launch_count("flash_attention_nhd")
        out = fa.flash_attention_nhd(q, k, v, H)
        assert fa.launch_count("flash_attention_nhd") == before + 1
        ref = fa.flash_attention_nhd_plain(q, k, v, H)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
        if dtype == torch.bfloat16:
            assert fa.bf16_error_ratio(out, ref) <= 1.0


# (B, H, N, M, D): ragged tiles (1100 x 333 both ways), M = 77, every
# padded width (200 x 300 at the widest, 256), many tiles
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
        reduces = fa.reduce_launch_count()
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, heads)
        after = fa.launch_counts()
        assert after["dq"] == before["dq"] + 1
        assert after["dkv"] == before["dkv"] + 1
        split = dtype == torch.bfloat16 \
            and fa.dkv_split_plan(B, H, N, M, D, sms)[0] > 1
        assert fa.reduce_launch_count() == reduces + split
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


def _geglu_args(rows, C, dtype, seed=0, inner=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    inner = inner or 4 * C
    return (rnd(rows, C).to(dtype), 1 + 0.1 * rnd(C), 0.1 * rnd(C),
            (rnd(2 * inner, C) * C ** -0.5).to(dtype).t(),
            0.05 * rnd(2 * inner),
            (rnd(C, inner) * inner ** -0.5).to(dtype).t(), 0.05 * rnd(C))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_kernels_match_plain_on_card(dtype):
    """Both GEGLU kernels against their plain versions: ragged row counts
    at every cluster width (one to four blocks, three at C = 768 and 960),
    split and unsplit inner sweeps, inner widths that end inside a block's
    share of the last chunk or before it (C = 640, 1280), a b1 that is not
    16-byte aligned, and the tiny UNet's widths (narrower than a tile)."""
    _need_card()
    for rows, C, inner in ((100, 320, None), (300, 640, None),
                           (128, 1280, None), (4096, 320, None),
                           (1100, 1280, None), (200, 960, None),
                           (100, 768, None), (300, 640, 1000),
                           (200, 1280, 4744), (77, 64, None),
                           (40, 32, None)):
        x, lns, lnb, w1, b1, w2, b2 = _geglu_args(rows, C, dtype, seed=rows,
                                                  inner=inner)
        if C == 768:   # b1 at an offset of 4 bytes
            b1 = torch.cat([b1.new_zeros(1), b1])[1:]
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
                assert err <= 2e-5 * ref.abs().max().item(), \
                    (entry, rows, C, inner)
            else:
                assert fa.bf16_error_ratio(out, ref) <= 1.0, \
                    (entry, rows, C, inner)
                assert geglu.bf16_mean_error(out, ref) <= 0.05, \
                    (entry, rows, C, inner)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_each_mode_equals_plain_on_card(dtype):
    """Both instantiations of a dtype -- the fused one and the streamed one
    (quantize_rows, then the product) -- bit for bit, forced at M, K and N
    off the 128-wide tiles (both modes), N odd (plain stores) and K beyond a
    resident row tile (the fused mode refuses those); the plan's own choice
    as well."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    for M, K, N in ((300, 320, 200), (1000, 512, 77), (136, 2600, 200)):
        w_q, w_s = quant.quantize_per_channel(
            torch.randn(K, N, device="cuda", generator=g))
        x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
        ref = quant.int8_matmul_plain(x, w_q, w_s)
        ran = []
        for variant in (None, "fused", "streamed"):
            if variant is not None:
                try:
                    quant._forced_plan(x.device, dtype, M, N, K, variant)
                except ValueError:
                    assert variant == "fused" and K > 320, (M, K, N, variant)
                    continue
            before = quant.launch_counts()["int8_matmul"]
            out = quant.int8_matmul(x, w_q, w_s) if variant is None \
                else quant._int8_matmul_mode(x, w_q, w_s, variant)
            assert quant.launch_counts()["int8_matmul"] == before + 1
            assert torch.equal(out, ref), (M, K, N, variant)
            ran.append(variant)
        assert "streamed" in ran and (K > 320 or "fused" in ran)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["group", "layer"])
def test_norms_bf16_input_fp32_affine_on_card(norm):
    """The norms' bf16 branch on the card with float32 parameters drawn away
    from 1 and 0: within one bf16 unit of the float32 formula rounded once
    at every element (ATen's CUDA norms take no float32 parameters with a
    bf16 input; rounding the parameters to bf16 moves elements further)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(11)
    C = 320
    F = torch.nn.functional
    if norm == "group":
        x = torch.randn(2, C, 32, 32, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        mod = basic.GroupNorm(C).cuda()
        formula = lambda: F.group_norm(x.float(), 32, mod.weight, mod.bias,
                                       mod.epsilon)
    else:
        x = torch.randn(2, 1024, C, device="cuda", generator=g).to(
            torch.bfloat16)
        mod = basic.LayerNorm(C).cuda()
        formula = lambda: F.layer_norm(x.float(), (C,), mod.weight, mod.bias,
                                       mod.epsilon)
    with torch.no_grad():
        mod.weight.copy_(1 + 0.2 * torch.randn(C, device="cuda", generator=g))
        mod.bias.copy_(0.1 * torch.randn(C, device="cuda", generator=g))
        out = mod(x)
        ref = formula().to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert basic.bf16_ulps(out, ref).max().item() <= 1.0
