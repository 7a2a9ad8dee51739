"""Shared helpers of the tests/test_torch_*.py files: carry JAX-side arrays
into the PyTorch port (always as numpy), and make all-zero leaves of a
freshly initialised flax tree random so that zero-initialised output layers
take part in a comparison."""
import jax
import numpy as np
import torch


def np_tree(tree):
    """A flax params tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_zero_leaves(tree, seed=0, scale=0.05):
    """Replace every all-zero leaf (zero-convs, biases) by N(0, scale^2)
    draws from a numpy generator; other leaves are kept."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.dtype.kind == "f" and not a.any():
            a = (rng.standard_normal(a.shape) * scale).astype(a.dtype)
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def t(a, dtype=None):
    """numpy / jax array -> torch tensor on the CPU."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def manifest_shapes(manifest_keys, prefixes, skip_suffixes=("position_ids",)):
    """Sorted shape list of the manifest entries under any of ``prefixes``."""
    return sorted(tuple(shape) for key, shape in manifest_keys.items()
                  if key.startswith(tuple(prefixes))
                  and not key.endswith(tuple(skip_suffixes)))


def module_shapes(module):
    return sorted(tuple(p.shape) for p in module.state_dict().values())
