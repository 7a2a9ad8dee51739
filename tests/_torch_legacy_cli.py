"""Shared set-up of the legacy CLI tests (``tests/test_torch_legacy_*_cli.py``):
one set of random weights written as a CompVis latent-diffusion ``.ckpt``
that both packages' CLIs read with ``--ckpt``, and the JAX CLIs run in
process at float32 with the port's draws passed in.

The JAX CLIs build their models in bf16 and draw their start latents from
``jax.random``; ``jax_cli`` runs one with ``build_legacy_ldm`` at float32,
``LegacyLDM.init_params`` skipped (every part it samples with comes from the
checkpoint) and ``ddim_sample`` handed, call by call, the start latents the
port's CLI draws for the same images (image i from ``sample_seed(--seed,
i)``).  ``port_fp32`` has the port's CLIs, bf16 as well, build theirs at
float32 in the same way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from celebbasis_tpu import legacy as jlegacy
from celebbasis_tpu.utils import bridge as jbridge
from celebbasis_tpu_torch import legacy as tlegacy
from celebbasis_tpu_torch.diffusion.sampler import batched_normal, sample_seed

from _torch_port_helpers import np_tree, random_params


def write_reference_ckpt(cfg, path, seed=0):
    """A CompVis ``.ckpt`` of random weights for the config dict ``cfg``
    (every leaf random: zero-initialised output layers take part), written
    through the JAX package's exporters; -> the JAX LegacyLDM."""
    jl = jlegacy.build_legacy_ldm(cfg, dtype=jnp.float32)
    params = np_tree(random_params(jl.init_params, jax.random.key(0),
                                   seed=seed))
    vcfg = jl.first_stage.cfg
    arch = dict(attn_resolutions=vcfg.attn_resolutions,
                resolution=vcfg.resolution, attn_type=vcfg.attn_type)
    state = dict(jbridge.export_unet(params["unet"], jl.unet.cfg))
    if jl.first_stage_kind == "vq":
        fs = jbridge.export_vq(params["first_stage"], vcfg.ch_mult,
                               vcfg.num_res_blocks, **arch)
    else:
        fs = jbridge.export_vae(params["first_stage"], vcfg.ch_mult,
                                vcfg.num_res_blocks, **arch)
    state.update({f"first_stage_model.{k}": v for k, v in fs.items()})
    if jl.cond_kind == "bert":
        state.update(jbridge.export_bert_text(params["cond_stage"],
                                              depth=jl.cond_stage.cfg.depth))
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in state.items()}}, path)
    return jl


def port_start_latents(seed, batches, latent_shape):
    """The start latents the port's CLI draws, one array per batch:
    ``batches`` the batch sizes in order."""
    out, start = [], 0
    for n in batches:
        gens = [torch.Generator().manual_seed(sample_seed(seed, start + j))
                for j in range(n)]
        out.append(batched_normal(gens, (n,) + tuple(latent_shape),
                                  "cpu").numpy())
        start += n
    return out


def port_fp32(monkeypatch):
    """The port's legacy CLIs build their models at float32 from here on."""
    monkeypatch.setattr(tlegacy, "prepare", functools.partial(
        tlegacy.prepare, precision="fp32"))


def jax_cli(monkeypatch, cli_module, argv, x_Ts):
    """Runs ``cli_module.main(argv)`` of the JAX package as the module
    docstring says; -> what it returns and the number of chains run."""
    real = jlegacy.ddim_sample
    queue = list(x_Ts)

    def ddim_sample(*args, **kw):
        kw["x_T"] = jnp.asarray(queue.pop(0))
        return real(*args, **kw)

    monkeypatch.setattr(jlegacy, "ddim_sample", ddim_sample)
    monkeypatch.setattr(jlegacy.LegacyLDM, "init_params",
                        lambda self, rng: {})
    monkeypatch.setattr(cli_module, "build_legacy_ldm", functools.partial(
        jlegacy.build_legacy_ldm, dtype=jnp.float32))
    out = cli_module.main(argv)
    return out, len(x_Ts) - len(queue)


def assert_pixels_close(got, want, levels=1):
    got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= levels
    assert want.std() > 1.0                  # not a constant image
