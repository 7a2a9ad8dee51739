"""Parameter-storage precision helpers (counterpart of
``celebbasis_tpu/utils/precision.py``).

For inference the frozen SD weights may be stored in bf16: that halves their
share of the device-memory traffic.  Compute is bf16 either way through each
module's ``dtype``; norms and softmax stay fp32 whatever the storage type.
bf16 keeps fp32's exponent range, so the cast cannot overflow.

Scoring is the other way round: the evaluation networks run in float32 and
``no_tf32`` keeps cuDNN's convolutions and cuBLAS's products at float32
while they score (PyTorch lets cuDNN round their inputs to TF32, a 10-bit
mantissa, by default), the counterpart of the JAX package's ``"highest"``
matmul precision in ``cli/eval_imgs.py``.
"""
from __future__ import annotations

import contextlib
from typing import Iterable

import torch
import torch.nn as nn


@contextlib.contextmanager
def no_tf32():
    """TF32 off for convolutions and matrix products while the block runs;
    the previous settings come back afterwards, also on an exception."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def cast_float_params(module: nn.Module,
                      dtype: torch.dtype = torch.bfloat16,
                      keep: Iterable[nn.Module] = ()) -> nn.Module:
    """Cast every float32 parameter and buffer of ``module`` to ``dtype``, in
    place, except those of the submodules in ``keep``; other types are left
    untouched, so a second call is a no-op."""
    kept = {id(t) for m in keep
            for t in list(m.parameters()) + list(m.buffers())}
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.dtype == torch.float32 and id(t) not in kept:
                t.data = t.data.to(dtype)
    return module
