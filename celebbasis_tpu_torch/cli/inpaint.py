"""Latent-diffusion inpainting CLI (counterpart of
``celebbasis_tpu/cli/inpaint.py``, the reference's ``scripts/inpaint.py``).

Drives a concat-conditioned inpainting model (``models/ldm/inpainting_big/
config.yaml``): for each ``example.png`` + ``example_mask.png`` pair in
``--indir``, the conditioning is the first-stage encoding of the masked
image concatenated with the mask at latent resolution, DDIM-sampled and
composited back over the unmasked pixels, which come out bit for bit.

``make_inpaint_fn`` is the whole encode -> DDIM -> decode -> composite ->
uint8 path as one function, captured as one CUDA graph per shape on a card
(``utils.graphs``); the start latents are drawn before it.  Image k of a run
draws from a generator seeded from ``(--seed, k)``.  Without ``--ckpt`` the
model has random weights from ``--seed``.  Runs on ``cuda``; ``--device
cpu`` asks for the CPU on purpose.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch
import yaml

from celebbasis_tpu_torch import legacy
from celebbasis_tpu_torch.diffusion.sampler import batched_normal, sample_seed
from celebbasis_tpu_torch.pipeline import finish_images
from celebbasis_tpu_torch.utils import graphs


def make_batch(image_path: str, mask_path: str, size: int | None = None):
    """image and mask files -> dict of float32 (1, H, W, C) arrays in
    [-1, 1]: the mask binarised at 0.5, masked_image = (1 - mask) * image
    in [0, 1], then everything * 2 - 1."""
    from PIL import Image
    img = Image.open(image_path).convert("RGB")
    msk = Image.open(mask_path).convert("L")
    if size is not None:
        img = img.resize((size, size), Image.BICUBIC)
        msk = msk.resize((size, size), Image.NEAREST)
    image = np.asarray(img, np.float32)[None] / 255.0
    mask = np.asarray(msk, np.float32)[None, ..., None] / 255.0
    mask = (mask >= 0.5).astype(np.float32)
    masked = (1.0 - mask) * image
    return {"image": image * 2 - 1, "mask": mask * 2 - 1,
            "masked_image": masked * 2 - 1}


def make_inpaint_fn(ldm, steps: int = 50):
    """-> fn(image, mask, masked_image, generators, x_T=None) -> uint8
    pixels (B, H, W, 3).  Inputs in [-1, 1], (B, H, W, C) tensors on the
    model's device; the output is composited like the reference's:
    (1 - mask) * image + mask * predicted, in [0, 1].  ``fn.eager`` is the
    same function uncaptured."""
    sample = ldm.make_sample_fn(num_steps=steps, raw_cond=True)
    shape = lambda n: (n, ldm.image_size, ldm.image_size, ldm.channels)

    def body(image, mask, masked_image, x_T):
        c = ldm.learned_conditioning(masked_image)
        f = mask.shape[1] // c.shape[1]
        cc = mask[:, ::f, ::f, :]        # nearest to latent resolution
        ctx = torch.cat([c, cc.to(c.dtype)], dim=-1)
        pred = sample.body(ctx, None, x_T, None)
        img01 = ((image + 1.0) / 2.0).clamp(0.0, 1.0)
        msk01 = ((mask + 1.0) / 2.0).clamp(0.0, 1.0)
        pred01 = ((pred + 1.0) / 2.0).clamp(0.0, 1.0)
        out = (1.0 - msk01) * img01 + msk01 * pred01
        return finish_images(out * 2.0 - 1.0, "uint8")

    def make(run):
        @torch.inference_mode()
        def fn(image, mask, masked_image, generators, x_T=None):
            x_T = (batched_normal(generators, shape(image.shape[0]),
                                  ldm.device) if x_T is None
                   else x_T.to(device=ldm.device, dtype=torch.float32))
            return run(image, mask, masked_image, x_T)
        return fn

    return graphs.entry(make, body)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--indir", required=True,
                    help="dir with image-mask pairs "
                         "(example.png + example_mask.png)")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--config",
                    default="models/ldm/inpainting_big/config.yaml")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=None,
                    help="resize inputs to this square size "
                         "(default: use file sizes, must be /8)")
    ap.add_argument("--ckpt", default=None,
                    help="CompVis latent-diffusion .ckpt to load")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default=None,
                    help="default: cuda (fails without a card); 'cpu' runs "
                         "on the CPU on purpose")
    return ap


def main(argv=None) -> list:
    """Writes one inpainted PNG per pair; -> their uint8 arrays."""
    args = build_argparser().parse_args(argv)
    masks = sorted(glob.glob(os.path.join(args.indir, "*_mask.png")))
    images = [x.replace("_mask.png", ".png") for x in masks]
    print(f"[inpaint] Found {len(masks)} inputs.")
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    ldm = legacy.prepare(cfg, ckpt=args.ckpt, seed=args.seed,
                         device=args.device)
    if ldm.cond_mode != "concat":
        raise ValueError("inpaint needs a concat-mode config")
    dev = ldm.device
    os.makedirs(args.outdir, exist_ok=True)
    run = make_inpaint_fn(ldm, steps=args.steps)
    from PIL import Image
    out = []
    for k, (image_path, mask_path) in enumerate(zip(images, masks)):
        batch = {name: torch.from_numpy(a).to(dev) for name, a in
                 make_batch(image_path, mask_path, args.size).items()}
        gen = torch.Generator(device=dev).manual_seed(
            sample_seed(args.seed, k))
        pixels = run(batch["image"], batch["mask"], batch["masked_image"],
                     [gen]).cpu().numpy()
        outpath = os.path.join(args.outdir, os.path.basename(image_path))
        Image.fromarray(pixels[0]).save(outpath)
        out.append(pixels[0])
        print(f"[inpaint] {outpath}")
    return out


if __name__ == "__main__":
    main()
