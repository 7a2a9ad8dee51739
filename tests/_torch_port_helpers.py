"""Shared helpers of the tests/test_torch_*.py files: carry JAX-side arrays
into the PyTorch port (always as numpy), and make all-zero leaves of a
freshly initialised flax tree random so that zero-initialised output layers
take part in a comparison.  ``reference_layout`` (the package's writer of
reference-layout state dicts) is re-exported for the tests that write
weight files; ``stash_grads`` and the ``assert_*_close`` helpers hold one
training step against the JAX package's."""
import jax
import numpy as np
import torch

from celebbasis_tpu_torch.utils.bridge_align import reference_layout  # noqa: F401

# One thread for PyTorch (set on import) and for BLAS while a port test
# module runs; a module that imports ``one_blas_thread`` gets the latter
from _torch_threads import one_blas_thread  # noqa: F401


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


def hf_clip_state(cfg, seed=0, text_model=True,
                  prefix="cond_stage_model.transformer."):
    """An HF ``CLIPTextModel`` state dict for a ``CLIPTextConfig``, keys as
    the SD checkpoint holds them (under ``prefix``), with random float32
    values (and the int64 ``position_ids``)."""
    r = np.random.default_rng(seed)
    W, M = cfg.width, cfg.mlp_dim
    p = prefix + ("text_model." if text_model else "")
    shapes = {"embeddings.token_embedding.weight": (cfg.vocab_size, W),
              "embeddings.position_embedding.weight": (cfg.max_length, W),
              "final_layer_norm.weight": (W,), "final_layer_norm.bias": (W,)}
    for i in range(cfg.layers):
        s = f"encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            shapes[s + n + ".weight"] = shapes[s + n + ".bias"] = (W,)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[s + f"self_attn.{n}.weight"] = (W, W)
            shapes[s + f"self_attn.{n}.bias"] = (W,)
        shapes.update({s + "mlp.fc1.weight": (M, W), s + "mlp.fc1.bias": (M,),
                       s + "mlp.fc2.weight": (W, M), s + "mlp.fc2.bias": (W,)})
    out = {p + k: r.standard_normal(v).astype(np.float32)
           for k, v in shapes.items()}
    out[p + "embeddings.position_ids"] = np.arange(cfg.max_length)[None]
    return out


def tiny_sd_checkpoint(path, config, seed=0):
    """A CompVis ``sd-v1-4.ckpt``-format file for the config at ``config``
    (a YAML path): UNet and VAE from random flax params through the JAX
    package's exporters (every leaf random, output convs included), the HF
    CLIP text keys from ``hf_clip_state``.  Returns the JAX run spec."""
    from celebbasis_tpu.models import unet as junet
    from celebbasis_tpu.models import vae as jvae
    from celebbasis_tpu.utils import bridge as jbridge
    from celebbasis_tpu.utils.config import load_run_spec
    jnp = jax.numpy
    spec = load_run_spec([config])
    um = junet.UNetModel(spec.unet, jnp.float32)
    uparams = random_params(um.init, jax.random.key(0),
                            jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 77, spec.unet.context_dim)),
                            seed=seed)
    vm = jvae.AutoencoderKL(spec.vae, jnp.float32)
    vparams = random_params(vm.init, jax.random.key(0),
                            jnp.zeros((1, 16, 16, 3)), jax.random.key(1),
                            seed=seed + 1)
    state = dict(jbridge.export_unet(np_tree(uparams), spec.unet))
    state.update({f"first_stage_model.{k}": v for k, v in jbridge.export_vae(
        np_tree(vparams), spec.vae.ch_mult, spec.vae.num_res_blocks).items()})
    state.update(hf_clip_state(spec.clip, seed=seed + 2))
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in state.items()}}, path)
    return spec


def align_params(pip_cfg, seed=11, face_bias=0.5, conf_scale=0.05):
    """One set of random FaceBoxesV2 and PIPNet(``pip_cfg``, the JAX
    config) weights: the flax trees ``fb`` and ``pip``, and the port's state
    dicts ``fb_state`` and ``pip_state``.  The detector's class heads are
    scaled down and its face logits raised by ``face_bias``, so that a part
    of the anchors pass the 0.6 threshold with scores well apart and well
    below 1 (random full-size heads saturate the softmax)."""
    from celebbasis_tpu.align import faceboxes as jfb
    from celebbasis_tpu.align import pipnet as jpip
    from celebbasis_tpu_torch.utils import bridge

    fb = random_params(jfb.FaceBoxesV2().init, jax.random.key(0),
                       jax.numpy.zeros((1, 96, 128, 3)), seed=seed)
    for i in range(3):
        head = fb["params"][f"head{i}"]["conf"]
        head["kernel"] = np.asarray(head["kernel"]) * conf_scale
        bias = np.array(head["bias"])
        bias[1::2] += face_bias
        head["bias"] = bias
    S = pip_cfg.input_size
    pip = random_params(jpip.PIPNet(pip_cfg).init, jax.random.key(0),
                        jax.numpy.zeros((1, S, S, 3)), seed=seed + 1)
    return dict(fb=fb, pip=pip,
                fb_state=bridge.from_jax_params(np_tree(fb)),
                pip_state=bridge.from_jax_params(np_tree(pip)))


def write_photos(folder, n, hw=(160, 192), seed=0):
    """``n`` PNG "photos" of smooth random colour fields with noise,
    ``photo_{i}.png``; -> their paths."""
    import os

    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    r = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        coarse = r.integers(0, 256, (hw[0] // 16 + 1, hw[1] // 16 + 1, 3),
                            dtype=np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize(
            (hw[1], hw[0]), Image.BILINEAR), np.int16)
        img = np.clip(img + r.integers(-20, 21, img.shape), 0, 255)
        paths.append(os.path.join(folder, f"photo_{i}.png"))
        Image.fromarray(img.astype(np.uint8)).save(paths[-1])
    return paths


def compiled(fn):
    """``fn`` compiled with ``jax.jit``, its array arguments (positional or
    keyword; pytrees of arrays too) traced and every other argument
    (configs, method names, flags, hook functions, None) fixed per compile:
    a JAX oracle called op by op pays one compile an op and a shape,
    compiled it pays one."""
    cache = {}

    def traced(a):
        leaves = jax.tree_util.tree_leaves(a)
        return bool(leaves) and all(isinstance(x, (jax.Array, np.ndarray))
                                    for x in leaves)

    def ident(a):       # unhashable fixed arguments count by identity
        try:
            hash(a)
            return a
        except TypeError:
            return ("id", id(a))

    def call(*args, **kw):
        pos = [traced(a) for a in args]
        names = sorted(k for k, v in kw.items() if traced(v))
        fixed_args = tuple(None if d else a for a, d in zip(args, pos))
        fixed_kw = tuple(sorted((k, v) for k, v in kw.items()
                                if k not in names))
        key = (tuple(map(ident, fixed_args)),
               tuple((k, ident(v)) for k, v in fixed_kw), tuple(names),
               tuple(pos))
        run = cache.get(key)
        if run is None:
            def body(arrays, arrays_kw, fixed_args=fixed_args,
                     fixed_kw=fixed_kw):
                it = iter(arrays)
                return fn(*(next(it) if d else a
                            for a, d in zip(fixed_args, pos)),
                          **dict(fixed_kw), **arrays_kw)
            run = cache[key] = jax.jit(body)
        return run([a for a, d in zip(args, pos) if d],
                   {k: kw[k] for k in names})
    return call


def compiled_optimizer(tx):
    """An optax transformation whose ``init`` and ``update`` are compiled
    (a JAX trainer that applies its optimizer outside ``jit`` otherwise
    compiles every leaf's ops one by one)."""
    import optax
    return optax.GradientTransformation(jax.jit(tx.init), jax.jit(tx.update))


class CompiledApply:
    """A flax module whose ``apply`` runs ``compiled``; everything else is
    the module's."""

    def __init__(self, module):
        self.module, self.apply = module, compiled(module.apply)

    def __getattr__(self, name):
        return getattr(self.module, name)


def stash_grads():
    """An optax link that passes the updates on and keeps them as its
    state: chained before the JAX trainer's optimizer, the step's returned
    state holds the raw gradients, so that one compiled step gives both."""
    import optax
    return optax.GradientTransformation(
        # numpy zeros: no compile a leaf when the optimizer is set up
        lambda p: jax.tree_util.tree_map(
            lambda x: np.zeros(x.shape, x.dtype), p),
        lambda u, s, p=None: (u, u))


def assert_grads_close(got, ref, rel=1e-4):
    """Each leaf within ``rel`` of the reference leaf's largest entry."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = float(ref[k].abs().max())
        assert scale > 0, k
        err = float((got[k] - ref[k]).abs().max())
        assert err <= rel * scale, (k, err, scale)


def assert_adam_step_close(state, before, ref_new, lr):
    """Adam's first update moves each entry by lr * g / (|g| + 1e-8), about
    lr whatever the gradient, so the new parameters are held in units of
    lr: every entry within 2e-2 * lr (where |g| nears Adam's eps the update
    turns sensitive to the gradients' rounding: 4e-3 * lr at |g| = 8e-8 in
    the tiny supervised step of test_torch_pipnet_train) and the mean
    within 1e-4 * lr."""
    errs = []
    for k, new in ref_new.items():
        moved = float((state[k].detach() - before[k]).abs().max())
        assert 0.5 * lr < moved <= 1.01 * lr, k
        err = (state[k].detach() - new).abs()
        assert float(err.max()) <= 2e-2 * lr, (k, float(err.max()))
        errs.append(err.flatten())
    assert float(torch.cat(errs).mean()) <= 1e-4 * lr


def assert_trained_grads_close(got, ref, rel=1e-4, noise=1e-6):
    """``assert_grads_close`` for a trained network: a leaf whose reference
    gradient is below ``noise`` of the largest gradient of all leaves (a conv
    bias that the next GroupNorm cancels, at one channel a group) is
    rounding noise on both sides and must only be as small in the port;
    such leaves are under a tenth of all."""
    top = max(float(v.abs().max()) for v in ref.values())
    small = {k for k, v in ref.items() if float(v.abs().max()) < noise * top}
    for k in small:
        assert float(got[k].abs().max()) < noise * top, k
    assert len(small) < len(ref) // 10, sorted(small)
    assert_grads_close({k: v for k, v in got.items() if k not in small},
                       {k: v for k, v in ref.items() if k not in small}, rel)


def assert_adamw_close(got, ref, lr, grads, steps=1):
    """Parameters after AdamW against the reference's, in units of lr: every
    entry within 2e-2 * lr per step taken, where the first step's reference
    gradient resolves the update.  Adam's first update is
    lr * g / (|g| + eps): it turns on g's rounding where |g| is below 1e-6
    (100 x eps), and on its sign where |g| is below 1e-4 of its leaf's
    largest entry (the gradient checks hold g to that much; an entry whose
    gradient is zero in exact arithmetic, a key bias of an attention, is
    rounding noise on both sides) or the leaf is rounding noise (below 1e-6
    of the largest gradient: a bias that a one-channel GroupNorm cancels).
    Those entries are held within 2 * lr per step, which any two AdamW
    updates keep; the nonzero ones among them are under 5 % of all, and
    the mean over every entry stays within 1e-3 * lr per step, which
    holds them in aggregate."""
    assert sorted(got) == sorted(ref)
    top = max(float(v.abs().max()) for v in grads.values())
    n_weak = n_all = 0
    err_sum = 0.0
    for k in ref:
        g = grads[k].abs()
        leaf = float(g.max())
        weak = (g < max(1e-6, 1e-4 * leaf)) | (leaf < 1e-6 * top)
        err = (got[k].detach() - ref[k]).abs()
        strong = float((err * ~weak).max())
        assert strong <= 2e-2 * lr * steps, (k, strong, lr)
        assert float(err.max()) <= 2 * lr * steps, (k, float(err.max()), lr)
        n_weak, n_all = n_weak + int((weak & (g > 0)).sum()), n_all + g.numel()
        err_sum += float(err.sum())
    assert n_weak < 0.05 * n_all, (n_weak, n_all)
    assert err_sum / n_all <= 1e-3 * lr * steps, (err_sum / n_all, lr)
