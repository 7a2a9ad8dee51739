"""Flash attention: wrappers of the hand-written Hopper kernels.

Counterpart of ``celebbasis_tpu/ops/flash_attention.py``: the two entry points
``flash_attention_nhd`` (packed ``(B, N, H*D)``, the default) and
``flash_attention`` (per-head ``(B, H, N, D)``).  Both hand the kernels the
strides of the layout they were given: no head transpose is materialised in
either, forward or backward.

Which kernel a call launches on CUDA tensors:

* nothing requires grad (or grad mode is off): the inference forward of
  ``csrc/flash_attention_fwd.cu`` (counters ``flash_attention_nhd`` /
  ``flash_attention``).  In bf16 it is a TMA-fed ``wgmma`` kernel with a
  producer warpgroup and two or three consumer warpgroups, on a persistent
  grid of one block per SM over the query tiles (the library decides the
  tiles and the grid; ``flash_attention_fwd_plan`` reports them);
* q, k or v requires grad: one ``torch.autograd.Function`` whose forward is
  the logsumexp-saving forward of the same source (counter ``fwd_lse``) and
  whose backward launches the kernels of ``csrc/flash_attention_bwd.cu``:
  ``dq`` when q needs a gradient, ``dkv`` when k or v does (counters ``dq``,
  ``dkv``), after the small ``delta = rowsum(dO * O)`` kernel of that source.
  In bf16 both are TMA-fed ``wgmma`` kernels; where the key tiles alone leave
  SMs idle, ``dkv`` splits each key tile's query stream over several blocks
  (``dkv_split_plan``) whose fp32 partial sums a second small kernel adds in
  a fixed order (counted apart: ``reduce_launch_count``).  The backward uses no atomics: the same inputs give the same
  bits.

Each kernel has its plain PyTorch version beside it
(``flash_attention_plain`` / ``flash_attention_nhd_plain``,
``flash_attention_lse_plain``, ``flash_attention_bwd_plain``).  A wrapper
takes the plain version only when the tensors lie on the CPU, where the
gradient is ordinary autograd through it.  On CUDA tensors it launches the
kernel or raises; nothing falls back.

``launch_count()`` counts kernel launches (and nothing else), per kernel and
in total, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from celebbasis_tpu_torch.ops import cuda_build

MAX_HEAD_DIM = 256      # accumulators for a 16-row warp tile fit in registers
HEAD_DIM_MULTIPLE = 8   # 16-byte rows for bf16 vector loads

_launches = {"flash_attention_nhd": 0, "flash_attention": 0,
             "fwd_lse": 0, "dq": 0, "dkv": 0}
# the dk/dv entry's second kernel, the reduction of a split query stream:
# apart from _launches, which counts one entry per kernel of the port
_reduce_launches = {"dkv_reduce": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_TAIL = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
# C entry -> (library, argument types before the stream); see the sources'
# C interfaces
_SIGNATURES = {
    "flash_attention_fwd": ("flash_attention_fwd",
                            [_VP] * 4 + [_INT] * 6 + _TAIL),
    "flash_attention_fwd_lse": ("flash_attention_fwd",
                                [_VP] * 5 + [_INT] * 6 + _TAIL),
    "flash_attention_bwd_delta": (
        "flash_attention_bwd",
        [_VP] * 3 + [_INT] * 5 + [ctypes.POINTER(ctypes.c_longlong)]),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               [_VP] * 7 + [_INT] * 6 + _TAIL),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                [_VP] * 10 + [_INT] * 7 + _TAIL),
}
ENTRIES = {name: cuda_build.Entry(library, name, argtypes,
                                  "flash_attention_error_string")
           for name, (library, argtypes) in _SIGNATURES.items()}
LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd")


def launch_count(entry: str | None = None) -> int:
    """Kernel launches since the last reset: of one counter
    (``"flash_attention_nhd"``, ``"flash_attention"``, ``"fwd_lse"``,
    ``"dq"``, ``"dkv"``), or of all."""
    return sum(_launches.values()) if entry is None else _launches[entry]


def launch_counts() -> dict:
    return dict(_launches)


def reduce_launch_count() -> int:
    """Launches of the dk/dv split reduction since the last reset: one with
    each dk/dv launch whose query stream ``dkv_split_plan`` splits."""
    return _reduce_launches["dkv_reduce"]


def reset_launch_count() -> None:
    for entry in _launches:
        _launches[entry] = 0
    _reduce_launches["dkv_reduce"] = 0


def supports(head_dim: int) -> bool:
    """Head dims the kernels take: a multiple of 8, at most 256."""
    return 0 < head_dim <= MAX_HEAD_DIM and head_dim % HEAD_DIM_MULTIPLE == 0


def bf16_error_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ``|out - ref|`` of a bf16 result in units of what rounding
    allows, element by element; at most 1 when the two agree.

    Allowed per element: ``2**-7 * |ref|``, one bf16 unit in the last place
    (the two sides may round the output to neighbouring values), plus
    ``2**-5`` of the outputs' root mean square for the rounding of the
    probabilities to bf16 before the second product: ``2**-9`` relative per
    weight on either side, which cancellation in the weighted sum turns into
    an absolute error; over millions of outputs, with rows whose softmax is
    more peaked than the mean, its largest value came to ``2**-6`` of the
    rms on an H100 at the SD v1 shapes, and the limit leaves a factor of two.
    The limit scales with what is compared: a flat softmax over thousands of
    keys gives outputs of a few hundredths, and an absolute limit sized for
    unit outputs would let any result pass there.
    """
    out, ref = out.float(), ref.float()
    allowed = ref.abs() * 2.0 ** -7 + ref.square().mean().sqrt() * 2.0 ** -5
    return ((out - ref).abs() / allowed).max().item()


def bf16_grad_error_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """``bf16_error_ratio`` for a gradient (dq, dk or dv, last dim the head
    dim): the rms term is taken over the element's own row where that is
    larger than the tensor's.

    The backward kernels round p and ds = p (dp - delta) to bf16 before their
    second products, ``2**-9`` relative per term like the forward's p, and a
    gradient row is a weighted sum with cancellation like an output row.  But
    p is normalised over keys, not over queries: a key that many queries
    attend to collects a dk / dv row many times the tensor's rms, and its
    rounding error grows with the row, not with the tensor.  Where the
    softmax is flat the two rms agree and this is ``bf16_error_ratio``.
    """
    out, ref = out.float(), ref.float()
    rms = torch.maximum(ref.square().mean(-1, keepdim=True).sqrt(),
                        ref.square().mean().sqrt())
    allowed = ref.abs() * 2.0 ** -7 + rms * 2.0 ** -5
    return ((out - ref).abs() / allowed).max().item()


# -- plain versions -----------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D), (B, H, M, D) x2 -> (B, H, N, D); fp32 logits/softmax,
    probabilities rounded to v's type before the second product."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def flash_attention_nhd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*D), (B, M, H*D) x2 -> (B, N, H*D)."""
    out = flash_attention_plain(*(_split(x, num_heads) for x in (q, k, v)))
    return _merge(out)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor):
    """The training forward, (B, H, N, D) layout: ``(o, lse)`` with
    ``lse = logsumexp(q k^T * D**-0.5)`` per query row, fp32 ``(B, H, N)``."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """The backward written out, (B, H, N, D) layout, fp32 products as in the
    Pallas bodies: ``p = exp(q k^T scale - lse)``, ``dp = dO v^T``,
    ``ds = p (dp - delta)`` with ``delta = rowsum(dO * O)``;
    ``dq = (ds k) scale``, ``dk = ds^T (q scale)``, ``dv = p^T dO``.
    Returns ``(dq, dk, dv)`` in the inputs' types.  Not written through
    autograd, so that it checks the algebra."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf * scale)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, H, L, D), a view."""
    B, L, C = x.shape
    return x.reshape(B, L, num_heads, C // num_heads).permute(0, 2, 1, 3)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) -> (B, L, H*D)."""
    B, H, L, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, L, H * D)


# -- kernel launch ------------------------------------------------------------

def _strides(t: torch.Tensor, num_heads: int | None):
    """(batch, head, row) element strides of a packed (B, L, H*D) tensor
    (`num_heads` given) or of a per-head (B, H, L, D) one (None)."""
    if num_heads is None:
        return (t.stride(0), t.stride(1), t.stride(2))
    return (t.stride(0), t.shape[2] // num_heads, t.stride(1))


def _aligned(t: torch.Tensor, strides) -> bool:
    """What the bf16 kernels' 16-byte vector loads need of a tensor."""
    return t.data_ptr() % 16 == 0 and not any(s % 8 for s in strides)


def _stride_array(tensors, num_heads):
    flat = [s for t in tensors for s in _strides(t, num_heads)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _geometry(q, k, v, num_heads):
    """Checks q, k, v of either layout; returns (B, H, N, M, D)."""
    if num_heads is None:
        if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
                or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
            raise ValueError(f"bad shapes q{tuple(q.shape)} "
                             f"k{tuple(k.shape)} v{tuple(v.shape)}")
        B, H, N, D = q.shape
        M = k.shape[2]
    else:
        if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
                or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
                or q.shape[2] % num_heads:
            raise ValueError(f"bad shapes q{tuple(q.shape)} "
                             f"k{tuple(k.shape)} v{tuple(v.shape)} "
                             f"heads={num_heads}")
        B, N, C = q.shape
        H, M, D = num_heads, k.shape[1], C // num_heads
    return B, H, N, M, D


def _check_cuda_inputs(q, k, v, num_heads, H, B, D):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of "
                        f"one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    if not supports(D):
        raise ValueError(f"head dim {D} unsupported: the kernels take a "
                         f"multiple of {HEAD_DIM_MULTIPLE} up to "
                         f"{MAX_HEAD_DIM}")
    if B * H > 65535:
        raise ValueError(f"batch*heads = {B * H} exceeds the grid limit")
    for name, t in zip("qkv", (q, k, v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous; "
                             f"got strides {t.stride()}")
        if t.dtype == torch.bfloat16 \
                and not _aligned(t, _strides(t, num_heads)):
            raise ValueError(
                f"{name}: bf16 rows must be 16-byte aligned (strides "
                f"{t.stride()}, offset {t.storage_offset()})")


def _forward_cuda(q, k, v, num_heads, with_lse: bool):
    """One forward launch; returns o, or (o, lse) with `with_lse`."""
    B, H, N, M, D = _geometry(q, k, v, num_heads)
    _check_cuda_inputs(q, k, v, num_heads, H, B, D)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = _stride_array((q, k, v, o), num_heads)
    dims = (_DTYPE_CODE[q.dtype], B, H, N, M, D, strides, D ** -0.5)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if with_lse:
        lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
        ENTRIES["flash_attention_fwd_lse"](q.device, *ptrs, lse.data_ptr(),
                                           *dims)
        _launches["fwd_lse"] += 1
        return o, lse
    ENTRIES["flash_attention_fwd"](q.device, *ptrs, *dims)
    _launches["flash_attention" if num_heads is None
              else "flash_attention_nhd"] += 1
    return o


def flash_attention_lse(q, k, v, num_heads: int | None = None):
    """The training forward on its own: ``(o, lse)``; q, k, v packed
    ``(B, L, H*D)`` with `num_heads`, per-head ``(B, H, L, D)`` without.
    ``lse`` is fp32 ``(B, H, N)`` in both layouts."""
    if q.device.type == "cpu":
        _geometry(q, k, v, num_heads)
        if num_heads is None:
            return flash_attention_lse_plain(q, k, v)
        o, lse = flash_attention_lse_plain(
            *(_split(x, num_heads) for x in (q, k, v)))
        return _merge(o), lse
    return _forward_cuda(q, k, v, num_heads, with_lse=True)


def dkv_tiles(head_dim: int):
    """(keys a block owns, query rows a streamed tile) of the bf16 dk/dv
    kernel at a head dim (``DkvShape`` in csrc/flash_attention_bwd.cu, padded
    head dims 48, 80, 160, 256): two warpgroups of 64 keys up to 80, 64 keys
    shared by both (each half of the columns) above."""
    if head_dim <= 48:
        return 128, 128
    if head_dim <= 80:
        return 128, 64
    return 64, (64 if head_dim <= 160 else 32)


def dkv_split_plan(B: int, H: int, N: int, M: int, D: int, sm_count: int):
    """How the bf16 dk/dv kernel spreads over the card: ``(splits,
    scratch_shape)``.  One block per key tile and head gives
    ``B * H * ceil(M / keys)`` blocks; where that leaves SMs idle, each key
    tile's query stream is split over `splits` blocks -- as many as fill one
    wave of `sm_count` SMs, at most one per query tile -- and each split
    writes fp32 partial dk and dv of ``scratch_shape`` (splits, B, H, M, D),
    which a second kernel adds in split order.  ``scratch_shape`` is None
    without a split.  A pure function of its arguments."""
    keys, rows = dkv_tiles(D)
    blocks = B * H * -(-M // keys)
    splits = max(1, min(-(-N // rows), sm_count // blocks))
    return splits, ((splits, B, H, M, D) if splits > 1 else None)


def _readable(t: torch.Tensor, num_heads) -> torch.Tensor:
    """A tensor autograd handed over (the incoming gradient), brought to rows
    the kernels can read: last dim contiguous, bf16 rows 16-byte aligned."""
    if t.stride(-1) != 1 or (t.dtype == torch.bfloat16 and not _aligned(
            t, _strides(t, num_heads))):
        return t.contiguous()
    return t


def flash_attention_delta(o, do, num_heads: int | None = None):
    """``delta = rowsum(dO * O)``, fp32 ``(B, H, N)``: the backward's
    prologue, a small kernel of its own on CUDA tensors."""
    if num_heads is None:
        B, H, N, D = o.shape
    else:
        B, N, C = o.shape
        H, D = num_heads, C // num_heads
    if o.device.type == "cpu":
        prod = do.float() * o.float()
        if num_heads is not None:
            prod = _split(prod, num_heads)
        return prod.sum(-1)
    do = _readable(do, num_heads)
    delta = torch.empty((B, H, N), dtype=torch.float32, device=o.device)
    ENTRIES["flash_attention_bwd_delta"](
        o.device, o.data_ptr(), do.data_ptr(), delta.data_ptr(),
        _DTYPE_CODE[o.dtype], B, H, N, D, _stride_array((o, do), num_heads))
    return delta


def flash_attention_bwd(q, k, v, o, lse, do, num_heads: int | None = None,
                        need_dq: bool = True, need_dkv: bool = True,
                        delta=None):
    """The backward on its own: ``(dq, dk, dv)`` in the layout and type of
    q, k, v; a gradient that is not asked for is None and its kernel is not
    launched.  `o` and `lse` are what ``flash_attention_lse`` returned;
    `delta` is computed here unless it is given."""
    B, H, N, M, D = _geometry(q, k, v, num_heads)
    if q.device.type == "cpu":
        args = (q, k, v, o, do)
        if num_heads is not None:
            args = tuple(_split(x, num_heads) for x in args)
        dq, dk, dv = flash_attention_bwd_plain(*args[:4], lse, args[4])
        if num_heads is not None:
            dq, dk, dv = _merge(dq), _merge(dk), _merge(dv)
        return (dq if need_dq else None, dk if need_dkv else None,
                dv if need_dkv else None)
    _check_cuda_inputs(q, k, v, num_heads, H, B, D)
    if do.dtype != q.dtype or do.shape != q.shape or o.shape != q.shape \
            or lse.shape != (B, H, N) or lse.dtype != torch.float32:
        raise ValueError(f"bad backward inputs: do {tuple(do.shape)} "
                         f"{do.dtype}, o {tuple(o.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}")
    do = _readable(do, num_heads)
    lse = lse.contiguous()
    if delta is None:
        delta = flash_attention_delta(o, do, num_heads)
    code = _DTYPE_CODE[q.dtype]
    dq = dk = dv = None
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    if need_dq:
        dq = torch.empty_like(q)   # q's strides where q is dense
        ENTRIES["flash_attention_bwd_dq"](
            q.device, *common, dq.data_ptr(), code, B, H, N, M, D,
            _stride_array((q, k, v, do, dq), num_heads), D ** -0.5)
        _launches["dq"] += 1
    if need_dkv:
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        splits, part_shape = (1, None)
        if q.dtype == torch.bfloat16:
            splits, part_shape = dkv_split_plan(B, H, N, M, D,
                                                cuda_build.sm_count(q.device))
        parts = [] if part_shape is None else [
            torch.empty(part_shape, dtype=torch.float32, device=q.device)
            for _ in range(2)]
        part_ptrs = [t.data_ptr() for t in parts] or [None, None]
        ENTRIES["flash_attention_bwd_dkv"](
            q.device, *common, dk.data_ptr(), dv.data_ptr(), *part_ptrs,
            code, B, H, N, M, D, splits,
            _stride_array((q, k, v, do, dk, dv), num_heads), D ** -0.5)
        _launches["dkv"] += 1
        if splits > 1:
            _reduce_launches["dkv_reduce"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The differentiable call on CUDA tensors, either layout."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        o, lse = _forward_cuda(q, k, v, num_heads, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads = num_heads
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, ctx.num_heads, need_dq=need_q,
            need_dkv=need_k or need_v)
        return dq, dk if need_k else None, dv if need_v else None, None


def _attend(q, k, v, num_heads):
    if q.device.type == "cpu":
        _geometry(q, k, v, num_heads)
        if num_heads is None:
            return flash_attention_plain(q, k, v)
        return flash_attention_nhd_plain(q, k, v, num_heads)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, num_heads)
    return _forward_cuda(q, k, v, num_heads, with_lse=False)


def flash_attention_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """q: (B, N, H*D); k, v: (B, M, H*D) -> (B, N, H*D), untransposed.
    Differentiable."""
    return _attend(q, k, v, num_heads)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: (B, H, N, D); k, v: (B, H, M, D) -> (B, H, N, D).  The inputs may be
    permuted views (e.g. of a packed ``(B, N, H, D)`` buffer): only the last
    dim has to be contiguous.  Differentiable."""
    return _attend(q, k, v, None)
