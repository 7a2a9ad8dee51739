"""PyTorch port, ``cli/sample_diffusion.py`` against the JAX package's CLI
on ``configs/tiny_legacy.yaml`` (unconditional, VQ first stage,
``AttentionBlock`` UNet with ``num_head_channels``): both read one CompVis
``.ckpt`` of random weights, the JAX CLI gets the port's start latents, and
the PNGs agree within one level (``_torch_legacy_cli``).  Also the port's
own: the class-conditional guided chain against the learned
``n_classes - 1`` row, the DDPM chain, and no run without ``--device`` and
without a card.
"""
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from celebbasis_tpu.cli import sample_diffusion as jcli
from celebbasis_tpu_torch import legacy as tlegacy
from celebbasis_tpu_torch.cli import sample_diffusion as tcli
from celebbasis_tpu_torch.diffusion.sampler import (SamplerConfig,
                                                    ddim_sample, sample_seed)
from celebbasis_tpu_torch.diffusion.schedules import (make_ddim_schedule,
                                                      make_schedule)
from celebbasis_tpu_torch.loader import init_weights

from _torch_legacy_cli import (assert_pixels_close, jax_cli, port_fp32,
                               port_start_latents, write_reference_ckpt)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "tiny_legacy.yaml")


def _cfg(path=CFG):
    with open(path) as f:
        return yaml.safe_load(f)


def _pngs(folder, n):
    return np.stack([np.asarray(Image.open(os.path.join(folder,
                                                        f"{i:06}.png")))
                     for i in range(n)])


def test_sample_diffusion_matches_the_jax_cli(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "model.ckpt")
    jl = write_reference_ckpt(_cfg(), ckpt, seed=1)
    common = ["--config", CFG, "--ckpt", ckpt, "-n", "3", "--batch-size",
              "2", "--custom-steps", "3", "--seed", "5"]
    port_fp32(monkeypatch)
    got = tcli.main(common + ["--logdir", str(tmp_path / "port"),
                              "--device", "cpu"])
    assert got.shape == (3, 32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(_pngs(tmp_path / "port", 3), got)
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "samples.npz")["samples"], got)
    x_Ts = port_start_latents(5, [2, 1], (jl.image_size, jl.image_size,
                                          jl.channels))
    _, chains = jax_cli(monkeypatch, jcli,
                        common + ["--logdir", str(tmp_path / "jax")], x_Ts)
    assert chains == 2
    assert_pixels_close(got, _pngs(tmp_path / "jax", 3))
    assert np.abs(got[0].astype(int) - got[1].astype(int)).max() > 0


def test_class_guidance_ddpm_and_no_card():
    """Class-conditional CFG guides against the learned n_classes - 1 row;
    the DDPM chain runs its T steps; the CLI asks for a card."""
    cfg = _cfg()
    cfg["model"]["params"].update(
        conditioning_key="crossattn",
        cond_stage_config={"target": "ldm.modules.encoders.modules."
                                     "ClassEmbedder",
                           "params": {"n_classes": 5, "embed_dim": 16}})
    cfg["model"]["params"]["unet_config"]["params"].update(
        use_spatial_transformer=True, context_dim=16, num_heads=2,
        num_head_channels=-1)
    ldm = tlegacy.build_legacy_ldm(cfg, dtype=torch.float32)
    init_weights(ldm, torch.Generator().manual_seed(3), zero_convs=False)
    ldm.requires_grad_(False).eval()
    gens = lambda: [torch.Generator().manual_seed(sample_seed(0, j))
                    for j in range(2)]
    labels = np.array([1, 3])
    fn = ldm.make_sample_fn(num_steps=3, guidance_scale=4.0)
    got = fn(labels, 2, gens())
    with torch.no_grad():
        emb = ldm.cond_stage
        z = ddim_sample(
            ldm.eps_model(), make_ddim_schedule(
                make_schedule("linear", ldm.timesteps, ldm.linear_start,
                              ldm.linear_end), 3),
            generators=gens(), shape=(2, 16, 16, 3),
            cond=emb(torch.from_numpy(labels)),
            uncond=emb(torch.full((2,), 4)),
            cfg=SamplerConfig(guidance_scale=4.0))
        want = ldm.decode_first_stage(z)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    other = ldm.make_sample_fn(num_steps=3, guidance_scale=4.0,
                               uncond_label=0)(labels, 2, gens())
    assert (other - got).abs().max() > 1e-4

    ddpm = ldm.make_sample_fn(ddim=False)(labels, 2, gens())
    assert ddpm.shape == (2, 32, 32, 3) and torch.isfinite(ddpm).all()

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(["--config", CFG])
