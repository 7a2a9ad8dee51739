"""Weights carried across from the JAX package's trees.

``from_jax_params(tree)`` turns a flax params tree (nested dicts of numpy
arrays; the caller hands over ``jax.tree_util.tree_map(np.asarray, params)``)
into a PyTorch ``state_dict``.  The port's modules take the attribute names
of the flax tree, so the converter is one generic walk and not a key map per
model:

* a conv kernel HWIO ``(kh, kw, in, out)`` -> OIHW ``(out, in, kh, kw)``;
* a dense kernel ``(in, out)`` -> ``(out, in)``;
* ``scale`` -> ``weight`` (norms), ``embedding`` -> ``weight`` (the token
  table); ``bias`` and ``position_embedding`` as they are;
* the extra nesting of the JAX wrappers (``GroupNorm_0`` / ``LayerNorm_0``
  under ``ops.basic``'s norms, ``Conv_0`` under ``ZeroConv``) and flax's
  top-level ``params`` collection are dropped from the path.

``load_jax_params(module, tree)`` loads with ``strict=True``: every leaf of
the tree is consumed and every parameter of the module is filled, or it
raises.  Reading the real CompVis/HF checkpoints (``load_sd_checkpoint``) is
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from celebbasis_tpu_torch.core.manager import ManagerState

_WRAPPER_LEVELS = ("GroupNorm_0", "LayerNorm_0", "Conv_0")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "position_embedding": "position_embedding"}


def _convert_leaf(path, name: str, value) -> torch.Tensor:
    arr = np.asarray(value)
    if name == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)        # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T                            # (in, out) -> (out, in)
        else:
            raise ValueError(f"{'.'.join(path)}: kernel of rank {arr.ndim}")
    return torch.from_numpy(np.array(arr))      # a writable, contiguous copy


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree -> state_dict.  A tree of several models
    (``{"unet": ..., "vae": ..., "clip": ...}``) gives keys prefixed by the
    model's name, which is what ``CelebBasisPipeline.state_dict()`` has."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                skip = key in _WRAPPER_LEVELS or key == "params"
                walk(val, path if skip else path + (key,))
                continue
            if key not in _LEAF_NAMES:
                raise KeyError(f"{'.'.join(path + (key,))}: unknown leaf "
                               f"name {key!r}")
            name = ".".join(path + (_LEAF_NAMES[key],))
            if name in out:
                raise KeyError(f"two leaves map to {name!r}")
            out[name] = _convert_leaf(path, key, val)

    walk(tree, ())
    return out


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Strict load: raises on a leaf without a parameter, a parameter without
    a leaf, or a shape that differs.  Values are cast to each parameter's
    storage type."""
    module.load_state_dict(from_jax_params(tree), strict=True)
    return module


def manager_state_from_jax(state) -> ManagerState:
    """A JAX ``ManagerState`` (any pair of array-likes in its field order)
    -> the port's."""
    emb, coeff = state
    as_t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return ManagerState(as_t(emb), as_t(coeff))


def basis_from_jax(basis) -> torch.Tensor:
    return torch.from_numpy(np.array(basis, np.float32))
