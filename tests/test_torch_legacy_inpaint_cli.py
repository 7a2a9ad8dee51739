"""PyTorch port, ``cli/inpaint.py`` against the JAX package's CLI on the
tiny concat configuration of ``tests/test_concat_conditioning.py`` (the
cond stage is the VQ first stage, ``attn_type: none``; the UNet sees latent
++ encoded masked image ++ mask): both read one CompVis ``.ckpt`` of random
weights, the JAX CLI gets the port's start latents, and the written images
agree within one level, with the unmasked pixels bit for bit those the
composite gives back for the source (``_torch_legacy_cli``).
"""

import numpy as np
import torch
import yaml
from PIL import Image

from celebbasis_tpu.cli import inpaint as jcli
from celebbasis_tpu_torch.cli import inpaint as tcli
from celebbasis_tpu_torch.pipeline import finish_images

from _torch_legacy_cli import (assert_pixels_close, jax_cli, port_fp32,
                               port_start_latents, write_reference_ckpt)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


def tiny_concat_cfg():
    """``_tiny_concat_cfg()`` of tests/test_concat_conditioning.py."""
    z_ch = 3
    fs = {"target": "ldm.models.autoencoder.VQModelInterface",
          "params": {"embed_dim": z_ch, "n_embed": 32,
                     "ddconfig": {"double_z": False, "z_channels": z_ch,
                                  "resolution": 32, "in_channels": 3,
                                  "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                                  "num_res_blocks": 1,
                                  "attn_resolutions": [],
                                  "attn_type": "none"}}}
    unet = {"target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
            "params": {"in_channels": z_ch + z_ch + 1, "out_channels": z_ch,
                       "model_channels": 32, "attention_resolutions": [],
                       "num_res_blocks": 1, "channel_mult": [1, 2],
                       "num_head_channels": 8}}
    return {"model": {"target": "ldm.models.diffusion.ddpm.LatentDiffusion",
                      "params": {"linear_start": 0.0015,
                                 "linear_end": 0.0195, "timesteps": 16,
                                 "image_size": 16, "channels": z_ch,
                                 "concat_mode": True, "unet_config": unet,
                                 "first_stage_config": fs,
                                 "cond_stage_config": "__is_first_stage__"}}}


def test_inpaint_matches_the_jax_cli(tmp_path, monkeypatch):
    cfg = tiny_concat_cfg()
    config = str(tmp_path / "inpaint.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    ckpt = str(tmp_path / "model.ckpt")
    jl = write_reference_ckpt(cfg, ckpt, seed=3)
    indir = tmp_path / "in"
    indir.mkdir()
    r = np.random.default_rng(0)
    masks = {}
    # one pair: the JAX CLI jits its path once and replays it for every
    # pair of one size, so only the first pair's start latents would reach
    # it
    for name, (a, b) in (("a", (8, 24)),):
        Image.fromarray(r.integers(0, 256, (32, 32, 3), np.uint8)).save(
            indir / f"{name}.png")
        m = np.zeros((32, 32), np.uint8)
        m[a:b, 4:28] = 255
        Image.fromarray(m).save(indir / f"{name}_mask.png")
        masks[name] = m > 0
    common = ["--indir", str(indir), "--config", config, "--ckpt", ckpt,
              "--steps", "3", "--seed", "4"]
    port_fp32(monkeypatch)
    got = tcli.main(common + ["--outdir", str(tmp_path / "port"),
                              "--device", "cpu"])
    x_Ts = port_start_latents(4, [1], (jl.image_size, jl.image_size,
                                          jl.channels))
    _, chains = jax_cli(monkeypatch, jcli,
                        common + ["--outdir", str(tmp_path / "jax")], x_Ts)
    assert chains == 1 and len(got) == 1
    for k, name in enumerate(masks):
        port = np.asarray(Image.open(tmp_path / "port" / f"{name}.png"))
        np.testing.assert_array_equal(port, got[k])
        # the unmasked pixels are the source's as the composite gives them
        # back (finish_images of the [-1, 1] input), on both sides
        src = finish_images(torch.from_numpy(tcli.make_batch(
            str(indir / f"{name}.png"),
            str(indir / f"{name}_mask.png"))["image"]), "uint8")[0].numpy()
        jax_px = np.asarray(Image.open(tmp_path / "jax" / f"{name}.png"))
        keep = ~masks[name]
        np.testing.assert_array_equal(port[keep], src[keep])
        np.testing.assert_array_equal(jax_px[keep], src[keep])
        assert np.abs(port[~keep].astype(int)
                      - src[~keep].astype(int)).max() > 0
        assert_pixels_close(port, jax_px)
