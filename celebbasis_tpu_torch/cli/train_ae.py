"""First-stage autoencoder training CLI (counterpart of
``celebbasis_tpu/cli/train_ae.py``): the reference's ``main.py`` fitting an
``AutoencoderKL`` or ``VQModel`` from ``configs/autoencoder/*.yaml`` (or the
first stage of a latent-diffusion YAML) with ``LPIPSWithDiscriminator`` /
``VQLPIPSWithDiscriminator``, through ``train.ae_trainer.AETrainer``: a
generator pass and a discriminator pass a batch, both eager.

    python -m celebbasis_tpu_torch.cli.train_ae \\
        --config celebbasis_tpu_torch/configs/autoencoder_kl_32x32x4.yaml \\
        --fake-data 8 --max-steps 4

``--fake-data N`` trains on N random images (no dataset needs to be on
disk); otherwise the config's ``data.params.train`` target resolves through
``utils.registry``.  ``--ckpt-every`` / ``-r`` save and resume the whole
GAN state (``train.callbacks.Resume``), ``--image-every`` writes
[inputs | reconstructions | samples] grids, ``--export-torch`` the first
stage's reference state dict.  Weights are random from ``--seed``.  The
model computes in bf16 over float32 parameters (the JAX CLI's default).
Runs on ``cuda``; ``--device cpu`` asks for the CPU on purpose.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch
import yaml

from celebbasis_tpu_torch.loader import init_weights, resolve_device
from celebbasis_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from celebbasis_tpu_torch.models.vq import VQModel
from celebbasis_tpu_torch.train.ae_loss import init_discriminator
from celebbasis_tpu_torch.train.ae_trainer import AETrainer
from celebbasis_tpu_torch.train.callbacks import Resume
from celebbasis_tpu_torch.utils.config import get
from celebbasis_tpu_torch.utils.registry import instantiate_from_config


def build_first_stage_trainer(cfg: dict, device=None, seed: int = 23):
    """autoencoder YAML -> (AETrainer, image size): the model (computing in
    bf16) and the loss on ``device`` with random weights from ``seed`` (the
    discriminator's N(0, 0.02) initialisation kept), lr = batch size x
    ``base_learning_rate`` (the reference's ``scale_lr``)."""
    mp = get(cfg, "model.params", {}) or {}
    target = get(cfg, "model.target", "")
    dd = mp.get("ddconfig", {})
    vcfg = VAEConfig(
        ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        z_channels=dd.get("z_channels", 4),
        embed_dim=mp.get("embed_dim", 4), in_ch=dd.get("in_channels", 3),
        out_ch=dd.get("out_ch", 3),
        attn_resolutions=tuple(dd.get("attn_resolutions", ()) or ()),
        double_z=dd.get("double_z", True),
        resolution=dd.get("resolution", 256),
        attn_type=dd.get("attn_type", "vanilla"))
    with torch.device(device or "cpu"):
        if target.endswith("VQModel") or target.endswith("VQModelInterface"):
            model = VQModel(vcfg, n_embed=mp["n_embed"],
                            dtype=torch.bfloat16)
        elif target.endswith("AutoencoderKL"):
            model = AutoencoderKL(vcfg, dtype=torch.bfloat16)
        else:
            raise ValueError(f"unsupported autoencoder target {target!r}")
        loss = instantiate_from_config(mp["lossconfig"])
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    init_weights(model, gen)
    init_weights(loss.lpips, gen)
    init_discriminator(loss.disc, gen)
    lr = get(cfg, "model.base_learning_rate", 4.5e-6)
    bs = get(cfg, "data.params.batch_size", 4)
    trainer = AETrainer(model, loss, learning_rate=lr * bs,
                        lr_g_factor=mp.get("lr_g_factor", 1.0))
    size = get(cfg, "data.params.train.params.size", vcfg.resolution)
    return trainer, size


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-steps", type=int, default=100)
    ap.add_argument("--image-size", type=int, default=None,
                    help="override training resolution (smoke runs)")
    ap.add_argument("--fake-data", type=int, default=0,
                    help="train on N random images (no datasets on disk)")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--logdir", default="./logs_ae")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the full GAN state every N steps")
    ap.add_argument("-r", "--resume", action="store_true",
                    help="resume from the latest saved state in logdir")
    ap.add_argument("--export-torch", default=None,
                    help="after training, write a reference-loadable .ckpt "
                         "of the first stage (state_dict layout)")
    ap.add_argument("--image-every", type=int, default=0,
                    help="save [inputs | reconstructions | samples] grids "
                         "every N steps")
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--device", type=str, default=None,
                    help="default: cuda (fails without a card); 'cpu' runs "
                         "on the CPU on purpose")
    return ap


def main(argv=None) -> Dict:
    """-> ``{"trainer", "logs" ({step: {name: value}} at the logged
    steps), "wall_s"}``."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    trainer, size = build_first_stage_trainer(cfg, device=dev,
                                              seed=args.seed)
    size = args.image_size or size
    bs = args.batch_size or get(cfg, "data.params.batch_size", 4)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    print(f"[train_ae] {'VQ' if trainer.is_vq else 'KL'} autoencoder, "
          f"{size}x{size}, batch {bs}, device {dev}")

    if args.fake_data:
        data = np.random.default_rng(0).uniform(
            -1, 1, (args.fake_data, size, size, 3)).astype(np.float32)
        batches = lambda i: data[(i * bs) % len(data):][:bs]
    else:
        ds = instantiate_from_config(get(cfg, "data.params.train"))

        def batches(i):
            idx = [(i * bs + j) % len(ds) for j in range(bs)]
            return np.stack([ds[k]["image"] for k in idx])

    os.makedirs(args.logdir, exist_ok=True)
    resume, start = None, 0
    if args.ckpt_every or args.resume:
        resume = Resume(args.logdir, every=max(args.ckpt_every, 1))
        latest = resume.latest_step() if args.resume else None
        if latest is not None:
            state = resume.restore(latest, dev)
            trainer.load_state_dict(state["trainer"])
            gen.set_state(state["generator"])
            start = latest
            print(f"[train_ae] resumed from step {latest}")

    @torch.no_grad()
    def log_images(step, x):
        """Inputs, reconstructions and decoded prior samples (the
        reference's ``log_images``)."""
        from PIL import Image
        from celebbasis_tpu_torch.models.vae import sample_posterior
        from celebbasis_tpu_torch.pipeline import finish_images
        model = trainer.model
        g = torch.Generator(device=dev).manual_seed(step)
        if trainer.is_vq:
            rec, _, _ = model(x[:4])
            z_shape = model.encode_to_prequant(x[:4]).shape
        else:
            mean, logvar = model.encode(x[:4])
            rec = model.decode(sample_posterior(g, mean, logvar))
            z_shape = mean.shape
        samples = model.decode(torch.randn(z_shape, generator=g,
                                           device=dev))
        grid = torch.cat([torch.cat(list(r.float()), dim=1)
                          for r in (x[:4], rec, samples)], dim=0)
        pixels = finish_images(grid[None], "uint8")[0].cpu().numpy()
        path = os.path.join(args.logdir, "images", f"step_{step:06}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(pixels).save(path)

    logs: Dict[int, Dict[str, float]] = {}
    metrics = open(os.path.join(args.logdir, "metrics.jsonl"), "a")
    t0 = time.time()
    for i in range(start, args.max_steps):
        x = batches(i)
        if x.shape[0] < bs:   # tail wrap
            x = np.concatenate([x, x[: bs - x.shape[0]]])
        x = torch.from_numpy(x).to(dev)
        log = trainer.train_batch(x, gen)
        if i % args.log_every == 0 or i == args.max_steps - 1:
            logs[i] = {k: float(v) for k, v in log.items()}
            row = {"step": i, "time": round(time.time() - t0, 2), **logs[i]}
            print(f"[train_ae] {json.dumps(row)}")
            metrics.write(json.dumps(row) + "\n")
            metrics.flush()
        if resume is not None and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            resume.maybe_save(i + 1, {"trainer": trainer.state_dict(),
                                      "generator": gen.get_state()})
        if args.image_every and (i + 1) % args.image_every == 0:
            log_images(i + 1, x)
    metrics.close()
    if args.export_torch:
        from celebbasis_tpu_torch.utils import bridge
        export = bridge.export_vq if trainer.is_vq else bridge.export_vae
        sd = export(trainer.model.state_dict(), trainer.model.cfg, prefix="")
        torch.save({"state_dict": sd}, args.export_torch)
        print(f"[train_ae] exported torch state_dict ({len(sd)} keys) -> "
              f"{args.export_torch}")
    wall = time.time() - t0
    print(f"[train_ae] done: {args.max_steps} steps in {wall:.1f}s")
    return {"trainer": trainer, "logs": logs, "wall_s": wall}


if __name__ == "__main__":
    main()
