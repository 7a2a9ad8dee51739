"""Flash-attention forward: wrappers of the hand-written Hopper kernel.

Counterpart of ``celebbasis_tpu/ops/flash_attention.py``'s two inference
forwards: ``flash_attention_nhd`` (packed ``(B, N, H*D)``, the serving
default) and ``flash_attention`` (per-head ``(B, H, N, D)``).  Both launch the
one kernel in ``csrc/flash_attention_fwd.cu`` with the strides of the layout
they were given: no head transpose is materialised in either.

Each entry point has its plain PyTorch version beside it
(``flash_attention_nhd_plain``, ``flash_attention_plain``: the same function
with fp32 logits and softmax).  A wrapper takes the plain version only when
the tensors lie on the CPU.  On CUDA tensors it launches the kernel or
raises; nothing falls back.

Forward only: the gradient arrives with the backward kernels.

``launch_count()`` counts kernel launches (and nothing else), per entry point
and in total, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from celebbasis_tpu_torch.ops import cuda_build

MAX_HEAD_DIM = 256      # accumulators for a 16-row warp tile fit in registers
HEAD_DIM_MULTIPLE = 8   # 16-byte rows for bf16 vector loads

_launches = {"flash_attention_nhd": 0, "flash_attention": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def launch_count(entry: str | None = None) -> int:
    """Kernel launches since the last reset: of one entry point
    (``"flash_attention_nhd"`` or ``"flash_attention"``), or of both."""
    return sum(_launches.values()) if entry is None else _launches[entry]


def reset_launch_count() -> None:
    for entry in _launches:
        _launches[entry] = 0


def supports(head_dim: int) -> bool:
    """Head dims the kernel takes: a multiple of 8, at most 256."""
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
    B, N, C = q.shape
    M = k.shape[1]
    D = C // num_heads
    split = lambda x, L: x.reshape(B, L, num_heads, D).permute(0, 2, 1, 3)
    out = flash_attention_plain(split(q, N), split(k, M), split(v, M))
    return out.permute(0, 2, 1, 3).reshape(B, N, C)


# -- kernel launch ------------------------------------------------------------

def _kernel():
    global _fn
    if _fn is None:
        lib = cuda_build.load("flash_attention_fwd")
        fn = lib.flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        err = lib.flash_attention_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _fn = (fn, err)
    return _fn


def _launch(entry, q, k, v, o, B, H, N, M, D, strides):
    """strides: (batch, head, row) element strides for q, k, v, o."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of "
                        f"one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    if not supports(D):
        raise ValueError(f"head dim {D} unsupported: the kernel takes a "
                         f"multiple of {HEAD_DIM_MULTIPLE} up to "
                         f"{MAX_HEAD_DIM}")
    if B * H > 65535:
        raise ValueError(f"batch*heads = {B * H} exceeds the grid limit")
    if q.dtype == torch.bfloat16:
        for name, t, st in zip("qkvo", (q, k, v, o), strides):
            if t.data_ptr() % 16 or any(s % 8 for s in st):
                raise ValueError(
                    f"{name}: bf16 rows must be 16-byte aligned (strides "
                    f"{st}, offset {t.storage_offset()})")
    fn, err = _kernel()
    flat = [s for st in strides for s in st]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, N, M, D, *flat, D ** -0.5)
    if q.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed ({rc}): "
                           f"{err(rc).decode()}")
    _launches[entry] += 1
    return o


def _check_last_stride(**tensors):
    for name, t in tensors.items():
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous; "
                             f"got strides {t.stride()}")


def flash_attention_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """q: (B, N, H*D); k, v: (B, M, H*D) -> (B, N, H*D), untransposed."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or q.shape[2] % num_heads:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={num_heads}")
    if q.device.type == "cpu":
        return flash_attention_nhd_plain(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_last_stride(q=q, k=k, v=v)
    B, N, C = q.shape
    M, D = k.shape[1], C // num_heads
    o = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), D, t.stride(1)) for t in (q, k, v, o)]
    return _launch("flash_attention_nhd", q, k, v, o, B, num_heads, N, M, D,
                   strides)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q: (B, H, N, D); k, v: (B, H, M, D) -> (B, H, N, D).  The inputs may be
    permuted views (e.g. of a packed ``(B, N, H, D)`` buffer): only the last
    dim has to be contiguous."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_last_stride(q=q, k=k, v=v)
    B, H, N, D = q.shape
    M = k.shape[2]
    o = torch.empty((B, H, N, D), dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), t.stride(1), t.stride(2)) for t in (q, k, v, o)]
    return _launch("flash_attention", q, k, v, o, B, H, N, M, D, strides)
