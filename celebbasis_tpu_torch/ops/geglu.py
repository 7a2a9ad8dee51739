"""GEGLU feed-forward: the plain path.

Counterpart of the functions of ``celebbasis_tpu/ops/geglu.py`` that the JAX
main path runs by default (``impl='xla'``).  The fused kernels of that file
are opt-in there and are not ported yet, so ``impl`` accepts ``"xla"`` alone.

``jax.nn.gelu`` defaults to the tanh approximation, so the gate uses
``F.gelu(..., approximate="tanh")``, not the exact erf form.  Weights use
the JAX layout here, ``w1: (C, 2*inner)``, ``w2: (inner, C)``: these are
plain functions on tensors, and the module that owns the parameters
(``models.unet.FeedForwardGEGLU``) hands them over transposed views.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _check_impl(impl):
    if impl not in (None, "xla"):
        raise NotImplementedError(
            f"geglu impl {impl!r}: only 'xla' (the plain path) exists in "
            f"the port so far")


def geglu_xla(x, w1, b1, w2, b2):
    # F.linear(x, w.T, b) is x @ w + b with the bias added in the product's
    # epilogue: no separate pass over the (T, 8C) intermediate
    dt = x.dtype
    h = F.linear(x, w1.to(dt).t(), b1.to(dt))
    h, gate = h.chunk(2, dim=-1)
    h = h * F.gelu(gate, approximate="tanh")
    return F.linear(h, w2.to(dt).t(), b2.to(dt))


def ln_xla(x, scale, bias, eps: float = 1e-5):
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


def geglu_block(x, ln_scale, ln_bias, w1, b1, w2, b2,
                impl: str | None = None):
    _check_impl(impl)
    return geglu_block_xla(x, ln_scale, ln_bias, w1, b1, w2, b2)


def geglu_ffn(x, w1, b1, w2, b2, impl: str | None = None):
    """GEGLU feed-forward.  x: (..., C); w1: (C, 2*inner); w2: (inner, C)."""
    _check_impl(impl)
    return geglu_xla(x, w1, b1, w2, b2)
