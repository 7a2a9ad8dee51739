"""Shared helpers of the tests/test_torch_*.py files: carry JAX-side arrays
into the PyTorch port (always as numpy), and make all-zero leaves of a
freshly initialised flax tree random so that zero-initialised output layers
take part in a comparison."""
import jax
import numpy as np
import torch

# The suite runs several worker processes on one machine.  PyTorch's intra-op
# pool would start one thread per core in each of them, and at these tiny
# sizes the threads only get in each other's way (a file took 3-10 times as
# long inside the suite as alone).
torch.set_num_threads(1)


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


def random_params(init_fn, *args, seed=0):
    """A params tree shaped like ``init_fn(*args)`` (traced abstractly with
    ``jax.eval_shape``: a flax init of even a tiny UNet takes tens of seconds
    on the CPU, its shapes two) and filled from a numpy generator, every leaf
    random so that zero-initialised layers, biases, BatchNorm statistics and
    PReLU slopes all take part: kernels N(0, 1/fan_in), token tables and
    EqualLinear weights N(0, 1), position tables N(0, 0.01^2), scales and
    slopes in [0.5, 1.5], variances in [0.5, 1.5], the rest N(0, 0.05^2)."""
    shapes = jax.eval_shape(init_fn, *args)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        name, shape = path[-1].key, leaf.shape
        normal = lambda std: rng.standard_normal(shape) * std
        if name == "kernel":
            a = normal(float(np.prod(shape[:-1])) ** -0.5)
        elif name in ("embedding", "weight", "coef_table"):
            a = normal(1.0)
        elif name == "position_embedding":
            a = normal(0.01)
        elif name in ("scale", "alpha", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = normal(0.05)
        out.append(np.asarray(a, np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def randomize_all_leaves(tree, seed=0):
    """Every leaf random: kernels get N(0, 0.01^2) added, 1-D leaves are drawn
    in ranges that keep BN variances positive, so that BatchNorm statistics,
    biases and PReLU slopes all take part in a comparison."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        a = np.asarray(leaf)
        name = path[-1].key
        if a.ndim == 1:
            if name == "var":
                a = rng.uniform(0.5, 1.5, a.shape)
            elif name in ("scale", "alpha"):
                a = rng.uniform(0.2, 1.2, a.shape)
            else:
                a = rng.standard_normal(a.shape) * 0.1
        else:
            a = a + rng.standard_normal(a.shape) * 0.01
        out.append(a.astype(np.float32))
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


def tiny_pipelines(image_size, names, seed=5):
    """The tiny pipeline on both sides with one set of random weights (made
    on the JAX side and carried over), a celeb basis built from ``names``
    and a manager state: a dict with the JAX pipeline ``jp``, its
    ``params``, ``jbasis`` and ``jstate``, and the port's ``tp``, ``tbasis``
    and ``tstate``; ``tok`` is the port's synthetic tokenizer."""
    from celebbasis_tpu import pipeline as jpipe
    from celebbasis_tpu.core import manager as jmgr
    from celebbasis_tpu.core.basis import build_celeb_basis
    from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
    from celebbasis_tpu_torch import pipeline as tpipe
    from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
    from celebbasis_tpu_torch.utils import bridge

    jtok = JTokenizer.synthetic(1024)
    jp = jpipe.CelebBasisPipeline(jpipe.PipelineConfig.tiny(), jtok)
    params = random_params(
        lambda key: jp.init_params(key, image_size=image_size),
        jax.random.key(0), seed=seed)
    jbasis = build_celeb_basis(names, jtok, jp.token_table(params),
                               jp.cfg.basis)
    cfg, rng = jp.manager_cfg, np.random.default_rng(seed)
    jstate = jmgr.ManagerState(      # drawn in numpy: no JAX compile
        jax.numpy.asarray(rng.uniform(
            size=(cfg.max_ids, cfg.reps, cfg.token_dim)).astype(np.float32)),
        jax.numpy.asarray(rng.standard_normal(
            (cfg.max_ids, cfg.num_es, cfg.heads, cfg.inner_dim)).astype(
                np.float32)))
    tok = CLIPTokenizer.synthetic(1024)
    tp = tpipe.CelebBasisPipeline(tpipe.PipelineConfig.tiny(), tok)
    tp.load_state_dict(bridge.from_jax_params(np_tree(params)), strict=True)
    tp.requires_grad_(False).eval()
    return dict(jp=jp, params=params, jbasis=jax.numpy.asarray(jbasis),
                jstate=jstate, tp=tp, tok=tok,
                tbasis=bridge.basis_from_jax(jbasis),
                tstate=bridge.manager_state_from_jax(jstate))
