"""Legacy LDM sampling CLI (counterpart of
``celebbasis_tpu/cli/sample_diffusion.py``, the reference's
``scripts/sample_diffusion.py``): load a latent-diffusion YAML, DDIM- or
DDPM-sample N images (unconditional, class-conditional or text-conditional
by the config), write PNGs and a ``samples.npz``.

Image i of a run (counted over the batches) draws from a generator seeded
from ``(--seed, i)``.  Without ``--ckpt`` the model has random weights from
``--seed``.  Runs on ``cuda``; ``--device cpu`` asks for the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.sample_diffusion \
        --config celebbasis_tpu_torch/configs/celebahq-ldm-vq-4.yaml \
        --n-samples 4 --custom-steps 50 --logdir out/
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import yaml

from celebbasis_tpu_torch import legacy
from celebbasis_tpu_torch.diffusion.sampler import sample_seed
from celebbasis_tpu_torch.pipeline import finish_images


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--logdir", default="./samples")
    ap.add_argument("-n", "--n-samples", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--custom-steps", type=int, default=50,
                    help="DDIM steps (reference custom_steps)")
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--vanilla", action="store_true",
                    help="full-chain DDPM instead of DDIM "
                         "(reference vanilla_sample)")
    ap.add_argument("--classes", type=int, nargs="*", default=None,
                    help="class labels for class-conditional configs")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="CFG guidance scale (>1 guides against the empty "
                         "prompt, or the learned uncond class for "
                         "class-conditional configs)")
    ap.add_argument("--uncond-label", type=int, default=None,
                    help="class label used as the CFG 'unconditional' "
                         "(default n_classes-1, e.g. 1000 for cin256-v2)")
    ap.add_argument("--per-class", type=int, default=0,
                    help="render each --classes label this many times and "
                         "write a classes x per-class grid")
    ap.add_argument("--prompt", default="a photograph",
                    help="prompt for text-conditional configs")
    ap.add_argument("--ckpt", default=None,
                    help="CompVis latent-diffusion .ckpt to load")
    ap.add_argument("--sr-input", default=None,
                    help="LR image for super-resolution concat configs "
                         "(resized to latent resolution, N samples)")
    ap.add_argument("--seg-input", default=None,
                    help="segmentation map (PNG of class indices) for "
                         "semantic-synthesis configs; one-hot encoded to "
                         "the SpatialRescaler's in_channels")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default=None,
                    help="default: cuda (fails without a card); 'cpu' runs "
                         "on the CPU on purpose")
    return ap


def concat_input(ldm, args) -> np.ndarray | None:
    """The concat configs' conditioning image, (1, h, w, c) float32."""
    from PIL import Image
    if args.sr_input and ldm.cond_kind == "identity":
        lr = Image.open(args.sr_input).convert("RGB").resize(
            (ldm.image_size, ldm.image_size), Image.BICUBIC)
        return np.asarray(lr, np.float32)[None] / 127.5 - 1.0
    if args.seg_input and ldm.cond_kind == "rescaler":
        res = ldm.image_size * 2 ** ldm.cond_stage.n_stages
        seg = Image.open(args.seg_input).convert("L").resize(
            (res, res), Image.NEAREST)
        n_cls = ldm.cond_stage_params.get("in_channels", 182)
        idx = np.minimum(np.asarray(seg, np.int64), n_cls - 1)
        return np.eye(n_cls, dtype=np.float32)[idx][None]
    raise SystemExit(
        "concat-conditioned config: use `python -m "
        "celebbasis_tpu_torch.cli.inpaint` for inpainting, pass --sr-input "
        "(SR) or --seg-input (semantic synthesis), or drive "
        "LegacyLDM.make_sample_fn with conditioning arrays")


def main(argv=None) -> np.ndarray:
    """Writes the images under ``--logdir`` and returns them,
    (N, H, W, 3) uint8."""
    args = build_argparser().parse_args(argv)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    ldm = legacy.prepare(cfg, ckpt=args.ckpt, seed=args.seed,
                         device=args.device)
    dev = ldm.device
    print(f"[sample_diffusion] first_stage={ldm.first_stage_kind} "
          f"cond={ldm.cond_kind} latent={ldm.image_size}^2x{ldm.channels}")
    sr_cond = concat_input(ldm, args) if ldm.cond_mode == "concat" else None

    sample = ldm.make_sample_fn(num_steps=args.custom_steps, eta=args.eta,
                                ddim=not args.vanilla,
                                guidance_scale=args.scale,
                                uncond_label=args.uncond_label)
    os.makedirs(args.logdir, exist_ok=True)
    from PIL import Image

    def gens(start, n):
        return [torch.Generator(device=dev).manual_seed(
            sample_seed(args.seed, start + j)) for j in range(n)]

    def pixels(imgs):
        return finish_images(imgs, "uint8").cpu().numpy()

    if args.per_class > 0:
        if ldm.cond_kind != "class":
            raise SystemExit("--per-class needs a class-conditional config")
        labels, n = args.classes or [0], args.per_class
        rows = []
        for li, lbl in enumerate(labels):
            row = pixels(sample(np.full((n,), lbl, np.int64), n,
                                gens(li * n, n)))
            rows.append(row)
            for j in range(n):
                Image.fromarray(row[j]).save(os.path.join(
                    args.logdir, f"class{lbl:04d}_{j:02d}.png"))
            print(f"[sample_diffusion] class {lbl}: {n} samples "
                  f"(scale {args.scale})")
        grid = np.concatenate([np.concatenate(list(r), axis=1)
                               for r in rows], axis=0)
        Image.fromarray(grid).save(os.path.join(args.logdir, "grid.png"))
        print(f"[sample_diffusion] wrote {grid.shape} grid.png to "
              f"{args.logdir}")
        return np.concatenate(rows)

    cond_batch = None
    n_done, all_imgs = 0, []
    t0 = time.time()
    while n_done < args.n_samples:
        n = min(args.batch_size, args.n_samples - n_done)
        if sr_cond is not None:
            cond_batch = np.repeat(sr_cond, n, axis=0)
        elif ldm.cond_kind == "class":
            labels = (args.classes or list(range(n)))[:n]
            cond_batch = np.asarray(labels + [0] * (n - len(labels)))
        elif ldm.cond_kind in ("bert", "clip"):
            cond_batch = [args.prompt] * n
        batch = pixels(sample(cond_batch, n, gens(n_done, n)))
        all_imgs.append(batch)
        for j in range(n):
            Image.fromarray(batch[j]).save(
                os.path.join(args.logdir, f"{n_done + j:06}.png"))
        n_done += n
        print(f"[sample_diffusion] {n_done}/{args.n_samples} "
              f"({time.time() - t0:.1f}s)")

    out = np.concatenate(all_imgs)
    np.savez(os.path.join(args.logdir, "samples.npz"), samples=out)
    with open(os.path.join(args.logdir, "sampling_config.json"), "w") as f:
        json.dump({"config": args.config, "n_samples": args.n_samples,
                   "steps": args.custom_steps, "eta": args.eta,
                   "vanilla": args.vanilla, "seed": args.seed}, f, indent=2)
    print(f"[sample_diffusion] wrote {out.shape} to {args.logdir}")
    return out


if __name__ == "__main__":
    main()
