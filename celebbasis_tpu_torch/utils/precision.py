"""Parameter-storage precision helpers (counterpart of
``celebbasis_tpu/utils/precision.py``).

For inference the frozen SD weights may be stored in bf16: that halves their
share of the device-memory traffic.  Compute is bf16 either way through each
module's ``dtype``; norms and softmax stay fp32 whatever the storage type.
bf16 keeps fp32's exponent range, so the cast cannot overflow.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def cast_float_params(module: nn.Module,
                      dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every float32 parameter and buffer of ``module`` to ``dtype``, in
    place; other types are left untouched, so a second call is a no-op."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.dtype == torch.float32:
                t.data = t.data.to(dtype)
    return module
