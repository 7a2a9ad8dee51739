"""``.pt`` files in the reference's formats, over ``torch.save`` and
``torch.load(weights_only=True)``.

The port's counterpart of ``celebbasis_tpu/utils/pt_io.py`` (which writes
the torch zip format without torch).  ``save_pt`` takes a tree of dicts,
lists and tuples whose leaves are tensors, numpy arrays or Python scalars;
numpy leaves are stored as CPU tensors, so that the file holds nothing
``weights_only`` refuses.  ``load_pt`` returns the tree with tensor leaves on
the CPU; it reads what the JAX package's ``save_pt`` writes, and the JAX
package's ``load_pt`` reads what this ``save_pt`` writes.  The manager's
checkpoints and the celeb basis go through it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_torch(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().contiguous()
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def save_pt(obj: Any, path: str) -> None:
    """Write ``obj`` (numpy or tensor leaves) as a torch ``.pt`` file."""
    torch.save(_to_torch(obj), path)


def load_pt(path: str) -> Any:
    """Read a ``.pt`` file into a tree with CPU tensor leaves; refuses
    pickled code (``weights_only=True``)."""
    return torch.load(path, map_location="cpu", weights_only=True)
