"""Multi-head attention core with switchable routes (plain / CUDA kernel).

Counterpart of ``celebbasis_tpu/ops/attention.py``.  The core is a pure
function over already-projected tensors, shared by the UNet's spatial
transformers, the CLIP text encoder and the VAE's mid block.

Routes (``impl``):

* ``"cuda"`` -- the hand-written flash kernel of
  ``celebbasis_tpu_torch.ops.flash_attention`` (the JAX package's
  ``"pallas"``); the default for tensors on a CUDA device;
* ``"xla"`` -- the plain core below, fp32 logits and softmax (the name is the
  JAX package's, kept so that callers and tests read alike); the default for
  tensors on the CPU.

Both entry points of the kernel route are differentiable: a call whose q, k or
v requires grad goes through the training forward and the backward kernels, on
either layout, and a call in which nothing does stays on the inference forward.

As in the JAX package, masked attention (CLIP's causal mask) always takes the
plain core: the kernel is mask-free.  The kernel's own limit is on the head
dim: a multiple of 8 (16-byte bf16 rows) and at most 256 (a warp's output
tile has to fit in registers).  Exactly one unmasked case leaves the ``"cuda"``
route: a head dim above 256 -- the VAE's one-head d=512 mid-block attention --
takes the plain core, as it does in the JAX package (there for a VMEM rule,
here for this register rule).  Any other head dim the kernel does not take (not
a multiple of 8) raises on a CUDA tensor; nothing else is rerouted.

``CELEBBASIS_ATTN`` (read at import) or ``set_default_impl`` pins the route
for the whole process; ``resolved_impl(device)`` says which route calls
without ``impl`` take, and the serving daemon reports it at start-up and in
``/healthz``.

``CELEBBASIS_FLASH_LAYOUT=bhnd`` routes through the per-head entry point
``flash_attention`` instead of the packed ``flash_attention_nhd``; both reach
the same kernel, the per-head one through permuted views (no copy).

``attention_heads`` takes per-head ``(B, H, N, D)`` tensors, views with any
(batch, head, row) strides and a contiguous last dim, and goes to the
per-head entry on the kernel route: the legacy UNet's ``AttentionBlock``
hands it strided slices of its interleaved qkv projection that way.
"""
from __future__ import annotations

import os

import torch

from celebbasis_tpu_torch.ops import flash_attention as _flash

_IMPLS = ("xla", "cuda")
_DEFAULT_IMPL = os.environ.get("CELEBBASIS_ATTN")


def set_default_impl(impl: str | None) -> None:
    """Pin the route for calls that pass no ``impl``; None restores the
    per-device default."""
    global _DEFAULT_IMPL
    if impl is not None and impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS} or None; got {impl!r}")
    _DEFAULT_IMPL = impl


def resolved_impl(device: torch.device | str) -> str:
    """The route that calls without ``impl`` take for tensors on `device`."""
    device = torch.device(device)
    if _DEFAULT_IMPL is not None:
        if _DEFAULT_IMPL not in _IMPLS:
            raise ValueError(f"CELEBBASIS_ATTN must be one of {_IMPLS}; "
                             f"got {_DEFAULT_IMPL!r}")
        return _DEFAULT_IMPL
    return "cuda" if device.type == "cuda" else "xla"


def _split_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, L, C = x.shape
    return x.reshape(B, L, H, C // H).permute(0, 2, 1, 3)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int, mask: torch.Tensor | None = None,
              impl: str | None = None) -> torch.Tensor:
    """Multi-head attention over projected tensors.

    q: (B, N, C); k, v: (B, M, C) with C = num_heads * head_dim.
    mask: optional additive mask broadcastable to (B, heads, N, M).
    Returns (B, N, C).
    """
    impl = impl or resolved_impl(q.device)
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}; got {impl!r}")
    B, N, C = q.shape
    H = num_heads
    # the one rerouted case: head dims beyond the kernel's register budget
    use_kernel = (impl == "cuda" and mask is None
                  and C // H <= _flash.MAX_HEAD_DIM)
    if use_kernel and os.environ.get("CELEBBASIS_FLASH_LAYOUT") != "bhnd":
        return _flash.flash_attention_nhd(q, k, v, H)
    qh, kh, vh = _split_heads(q, H), _split_heads(k, H), _split_heads(v, H)
    if use_kernel:
        out = _flash.flash_attention(qh, kh, vh)
    else:
        out = _plain_attention(qh, kh, vh, mask)
    return out.permute(0, 2, 1, 3).reshape(B, N, C)


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    impl: str | None = None) -> torch.Tensor:
    """Unmasked attention over per-head tensors: q (B, H, N, D), k and v
    (B, H, M, D), any strides with a contiguous last dim -> (B, H, N, D).
    The same routes and head-dim rule as :func:`attention`."""
    impl = impl or resolved_impl(q.device)
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}; got {impl!r}")
    if impl == "cuda" and q.shape[-1] <= _flash.MAX_HEAD_DIM:
        return _flash.flash_attention(q, k, v)
    return _plain_attention(q, k, v, None)


def _plain_attention(q, k, v, mask):
    """(B, H, N, D) core: fp32 logits and softmax, probabilities rounded to
    v's type before the second product (the JAX ``_xla_attention``)."""
    scale = q.shape[-1] ** -0.5
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    return (probs.to(v.dtype) @ v).to(v.dtype)


def causal_mask(seq_len: int, dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> torch.Tensor:
    """CLIP-style additive causal mask (1, 1, N, N) with -inf above the
    diagonal."""
    mask = torch.triu(torch.full((seq_len, seq_len), float("-inf"),
                                 dtype=torch.float32, device=device),
                      diagonal=1)
    return mask[None, None].to(dtype)
