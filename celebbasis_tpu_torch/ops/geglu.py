"""GEGLU feed-forward: the plain path and the fused Hopper kernels.

Counterpart of ``celebbasis_tpu/ops/geglu.py``.  Two routes (``impl``):

* ``"xla"`` -- the plain path (``geglu_xla``, ``geglu_block_xla``; the name is
  the JAX package's), the default, as it is in the JAX package;
* ``"cuda"`` -- the kernels of ``csrc/geglu.cu`` (the JAX package's
  ``"pallas"``): ``geglu_block`` computes the whole FF sub-block
  ``x + GEGLU(LN(x))`` in one kernel (Pallas ``_kernel_block``), ``geglu_ffn``
  the bare ``GEGLU(x)`` (Pallas ``_kernel``).  On a CUDA tensor the route
  launches its kernel or raises; on a CPU tensor it runs the kernel's plain
  version (``geglu_block_plain``, ``geglu_ffn_plain``).  Differentiable: the
  backward recomputes through the ``"xla"`` path under autograd, for the
  inputs that need a gradient, as the JAX ``custom_vjp`` does; only the
  inputs are kept for it, never the ``(T, 8C)`` intermediate.

``CELEBBASIS_GEGLU`` (read at import) or ``set_default_impl`` pins the route
for calls that pass no ``impl``; ``resolved_impl(device)`` says which route
they take, and the serving daemon reports it.  ``launch_counts()`` counts
kernel launches per entry point (``geglu_block``, ``geglu_ffn``) and nothing
else.

``jax.nn.gelu`` defaults to the tanh approximation, so the gate uses
``F.gelu(..., approximate="tanh")``, not the exact erf form.  Weights use the
JAX layout here, ``w1: (C, 2*inner)`` with the h half first, ``w2: (inner,
C)``: these are plain functions on tensors, and the module that owns the
parameters (``models.unet.FeedForwardGEGLU``) hands over transposed views of
its ``nn.Linear`` weights, which the kernels read in place.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from celebbasis_tpu_torch.ops import cuda_build

_IMPLS = ("xla", "cuda")
_DEFAULT_IMPL = os.environ.get("CELEBBASIS_GEGLU")

MAX_WIDTH = 1280        # C: clusters of up to four blocks of 320 columns
LN_EPS = 1e-5

_launches = {"geglu_block": 0, "geglu_ffn": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {"geglu_fwd": cuda_build.Entry(
    "geglu", "geglu_fwd",
    [_VP] * 9 + [_INT] * 6 + [_LL] * 3 + [ctypes.c_float],
    "geglu_error_string")}
LIBRARIES = ("geglu",)
# what the C entry geglu_plan reports, in its order
PLAN_KEYS = ("variant", "cluster", "partners", "rows", "threads",
             "smem_bytes", "stages", "splits", "chunk",
             "capacity", "row_tiles", "workspace_bytes")


def set_default_impl(impl: str | None) -> None:
    """Pin the route for calls that pass no ``impl``; None restores the
    default (``"xla"``)."""
    global _DEFAULT_IMPL
    _check_impl(impl, allow_none=True)
    _DEFAULT_IMPL = impl


def resolved_impl(device: torch.device | str | None = None) -> str:
    """The route that calls without ``impl`` take (the same on every
    device: the kernel route is opt-in, as in the JAX package)."""
    _check_impl(_DEFAULT_IMPL, allow_none=True)
    return _DEFAULT_IMPL or "xla"


def _check_impl(impl, allow_none=False):
    if impl in _IMPLS or (allow_none and impl is None):
        return
    raise ValueError(f"geglu impl must be one of {_IMPLS} ('cuda' is the "
                     f"kernel route, the JAX package's 'pallas'); got "
                     f"{impl!r}")


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_count() -> None:
    for entry in _launches:
        _launches[entry] = 0


# -- the "xla" route ----------------------------------------------------------

def geglu_xla(x, w1, b1, w2, b2):
    """``(h * GELU(g)) W2 + b2`` with ``[h, g] = x W1 + b1``; ``b2`` None
    leaves the product without a bias."""
    # F.linear(x, w.T, b) is x @ w + b with the bias added in the product's
    # epilogue: no separate pass over the (T, 8C) intermediate
    dt = x.dtype
    h = F.linear(x, w1.to(dt).t(), b1.to(dt))
    h, gate = h.chunk(2, dim=-1)
    h = h * F.gelu(gate, approximate="tanh")
    return F.linear(h, w2.to(dt).t(), None if b2 is None else b2.to(dt))


def ln_xla(x, scale, bias, eps: float = LN_EPS):
    """fp32 LayerNorm with flax's fast variance ``E[x^2] - mu^2``; returns
    x's type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def geglu_block_xla(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """The whole FF sub-block: x + GEGLU(LN(x))."""
    return x + geglu_xla(ln_xla(x, ln_scale, ln_bias), w1, b1, w2, b2)


# -- plain versions of the kernels --------------------------------------------

def _gated_product(u, w1, b1, w2):
    """``y W2`` in fp32 for rows u of x's type: both products accumulate in
    fp32 over operands of u's type, biases and the tanh GELU in fp32, y
    rounded to u's type before the second product (the Pallas bodies)."""
    dt = u.dtype
    inner = w2.shape[0]
    h = torch.matmul(u.float(), w1.to(dt).float()) + b1.float()
    y = (h[..., :inner] * F.gelu(h[..., inner:], approximate="tanh")).to(dt)
    return torch.matmul(y.float(), w2.to(dt).float())


def geglu_ffn_plain(x, w1, b1, w2, b2):
    """What the ``geglu_ffn`` kernel computes: ``y W2 + b2`` in fp32, one
    rounding to x's type (``b2`` None: no bias)."""
    acc = _gated_product(x, w1, b1, w2)
    return (acc if b2 is None else acc + b2.float()).to(x.dtype)


def geglu_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                      eps: float = LN_EPS):
    """What the ``geglu_block`` kernel computes: LN in fp32 rounded to x's
    type, the GEGLU products as ``geglu_ffn_plain``, then ``(x + acc) + b2``
    in fp32 with one rounding."""
    acc = _gated_product(ln_xla(x, ln_scale, ln_bias, eps), w1, b1, w2)
    return ((x.float() + acc) + b2.float()).to(x.dtype)


def bf16_mean_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Mean ``|out - ref|`` of a bf16 result in bf16 units in the last place
    of the reference, taken over all elements: ``mean|d| / (2**-8 *
    mean|ref|)``.

    ``flash_attention.bf16_error_ratio`` bounds the worst element; this one
    sees a small error that is systematic.  A kernel that rounds where its
    plain version does differs only where fp32 sums in another order cross a
    rounding boundary (a few per cent of the outputs, by one unit); an error
    of a few 1e-4 in every element -- the exact erf GELU in place of the tanh
    form -- crosses boundaries many times as often.
    """
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().mean() / (ref.abs().mean() * 2.0 ** -8)).item()


# -- kernel launch ------------------------------------------------------------

def plan(device, dtype: torch.dtype, rows: int, C: int, inner: int) -> dict:
    """How the kernel runs a call of this type and shape on `device`, as
    ``geglu_fwd`` itself decides it: the C entry ``geglu_plan`` (the one
    place the tiling is chosen), keyed by ``PLAN_KEYS``.  ``splits`` (blocks
    over the inner dimension) and ``workspace_bytes`` are what a launch
    needs from it; the rest says what runs."""
    return dict(zip(PLAN_KEYS, _plan(torch.device(device), dtype, rows, C,
                                     inner)))


@functools.lru_cache(maxsize=None)
def _plan_entry():
    fn = cuda_build.load("geglu").geglu_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [_INT] * 5 + [ctypes.POINTER(_LL)]
    return fn


@functools.lru_cache(maxsize=256)
def _plan(device, dtype, rows, C, inner) -> tuple:
    """``geglu_plan``'s numbers, asked once a device and shape: a plan
    depends on nothing else."""
    out = (_LL * len(PLAN_KEYS))()
    if _plan_entry()(_DTYPE_CODE[dtype], rows, C, inner,
                     cuda_build.sm_count(device), out) != 0:
        raise ValueError(f"geglu_plan refused dtype={dtype} rows={rows} "
                         f"C={C} inner={inner}")
    return tuple(out)


def _kernel_layout(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (K, N) weight in `dtype` whose K axis is contiguous (the transposed
    view of an nn.Linear weight is; it is read in place).  A weight in the
    JAX layout is copied into that layout, once per call."""
    w = w.to(dtype)
    aligned = w.stride(0) == 1 and (
        dtype != torch.bfloat16
        or (w.data_ptr() % 16 == 0 and w.stride(1) % 8 == 0))
    return w if aligned else w.t().contiguous().t()


def _forward_cuda(x2d, ln_scale, ln_bias, w1, b1, w2, b2):
    dt = x2d.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"geglu kernels take float32 or bfloat16 x; got {dt}")
    rows, C = x2d.shape
    inner = w2.shape[0]
    if b2 is None:              # no output bias: the kernel adds zeros
        b2 = torch.zeros(C, dtype=torch.float32, device=x2d.device)
    if w1.shape != (C, 2 * inner) or w2.shape != (inner, C) \
            or b1.shape != (2 * inner,) or b2.shape != (C,):
        raise ValueError(f"bad shapes x{tuple(x2d.shape)} w1{tuple(w1.shape)} "
                         f"b1{tuple(b1.shape)} w2{tuple(w2.shape)} "
                         f"b2{tuple(b2.shape)}")
    if C > MAX_WIDTH or (dt == torch.bfloat16 and (C % 8 or inner % 8)):
        raise ValueError(f"width C={C}, inner={inner} unsupported: the "
                         f"kernels take C <= {MAX_WIDTH}, and in bf16 C and "
                         f"inner multiples of 8")
    tensors = (w1, b1, w2, b2) + ((ln_scale, ln_bias) if ln_scale is not None
                                  else ())
    if any(t.device != x2d.device for t in tensors):
        raise ValueError("x and the weights must lie on one device")
    if x2d.stride(1) != 1:
        x2d = x2d.contiguous()
    w1c, w2c = _kernel_layout(w1, dt), _kernel_layout(w2, dt)
    vec = lambda v: v.float().contiguous()
    with_ln = ln_scale is not None
    lns, lnb = (vec(ln_scale), vec(ln_bias)) if with_ln else (None, None)
    b1f, b2f = vec(b1), vec(b2)
    if b1f.data_ptr() % 16:   # the kernel copies b1 in 16-byte units
        b1f = b1f.clone()
    out = torch.empty((rows, C), dtype=dt, device=x2d.device)
    how = dict(zip(PLAN_KEYS, _plan(x2d.device, dt, rows, C, inner)))
    # the split partial sums, then (bf16) the LN'd rows
    work = torch.empty(how["workspace_bytes"], dtype=torch.uint8,
                       device=x2d.device) if how["workspace_bytes"] else None
    ptr = lambda t: None if t is None else t.data_ptr()
    ENTRIES["geglu_fwd"](
        x2d.device, ptr(x2d), ptr(lns), ptr(lnb), ptr(w1c), ptr(b1f),
        ptr(w2c), ptr(b2f), ptr(out), ptr(work), _DTYPE_CODE[dt],
        int(with_ln), rows, C, inner, how["splits"], x2d.stride(0),
        w1c.stride(1), w2c.stride(1), LN_EPS)
    _launches["geglu_block" if with_ln else "geglu_ffn"] += 1
    return out


def _forward(x2d, ln_scale, ln_bias, w1, b1, w2, b2):
    """One forward of the kernel route, without autograd: the kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    if x2d.device.type == "cpu":
        if ln_scale is None:
            return geglu_ffn_plain(x2d, w1, b1, w2, b2)
        return geglu_block_plain(x2d, ln_scale, ln_bias, w1, b1, w2, b2)
    return _forward_cuda(x2d, ln_scale, ln_bias, w1, b1, w2, b2)


class _FusedGeglu(torch.autograd.Function):
    """The kernel route's forward; the backward recomputes through the
    ``"xla"`` path (the JAX ``custom_vjp``: ``_bwd`` and ``_block_bwd``)."""

    @staticmethod
    def forward(ctx, x2d, ln_scale, ln_bias, w1, b1, w2, b2):
        ctx.save_for_backward(x2d, ln_scale, ln_bias, w1, b1, w2, b2)
        return _forward(x2d, ln_scale, ln_bias, w1, b1, w2, b2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, needs)]
            x2d, lns, lnb, w1, b1, w2, b2 = leaves
            out = geglu_xla(x2d, w1, b1, w2, b2) if lns is None else \
                geglu_block_xla(x2d, lns, lnb, w1, b1, w2, b2)
            wanted = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if n else None for n in needs)


def _fused(x, ln_scale, ln_bias, w1, b1, w2, b2):
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    args = (x2d, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        out = _FusedGeglu.apply(*args)
    else:
        out = _forward(*args)
    return out.reshape(shape)


def geglu_block(x, ln_scale, ln_bias, w1, b1, w2, b2,
                impl: str | None = None):
    """The whole transformer-FF sub-block ``x + GEGLU(LN(x))``.  x: (..., C);
    w1: (C, 2*inner); w2: (inner, C); LN scale and bias (C,)."""
    impl = impl or resolved_impl()
    _check_impl(impl)
    if impl == "xla":
        return geglu_block_xla(x, ln_scale, ln_bias, w1, b1, w2, b2)
    return _fused(x, ln_scale, ln_bias, w1, b1, w2, b2)


def geglu_ffn(x, w1, b1, w2, b2, impl: str | None = None):
    """GEGLU feed-forward.  x: (..., C); w1: (C, 2*inner); w2: (inner, C);
    ``b2`` (C,) or None (no output bias: a tensor-parallel rank's partial
    product)."""
    impl = impl or resolved_impl()
    _check_impl(impl)
    if impl == "xla":
        return geglu_xla(x, w1, b1, w2, b2)
    return _fused(x, None, None, w1, b1, w2, b2)
