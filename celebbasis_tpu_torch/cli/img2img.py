"""img2img / inpaint CLI (counterpart of ``celebbasis_tpu/cli/img2img.py``).

VAE-encode the init image, noise it to ``strength`` of the DDIM chain
(``stochastic_encode``), denoise with CFG DDIM over the chain's first
``t_enc`` steps; with ``--mask`` each step re-blends the known region of the
forward-noised original (white mask pixels = regenerate), and once more at
the end.  Sample j draws its posterior and its noise from a generator seeded
from ``(--seed, j)``.  Runs on ``cuda``; ``--device cpu`` asks for the CPU
on purpose.  The draws come first and the rest runs as one CUDA graph on a
card (``make_img2img_fn``), the JAX CLI's ``jax.jit``.

    python -m celebbasis_tpu_torch.cli.img2img --init-img face.png \
        --prompt "a photo of a sks person" --strength 0.5
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from celebbasis_tpu_torch import loader
from celebbasis_tpu_torch.diffusion.sampler import (batched_normal,
                                                    ddim_step, guided_eps,
                                                    sample_seed,
                                                    step_constants,
                                                    stochastic_encode)
from celebbasis_tpu_torch.diffusion.schedules import make_ddim_schedule
from celebbasis_tpu_torch.pipeline import finish_images
from celebbasis_tpu_torch.utils import graphs
from celebbasis_tpu_torch.utils.config import load_run_spec


def make_img2img_fn(pipe, num_steps: int, strength: float,
                    guidance_scale: float, image_size: int,
                    output: str = "float"):
    """Returns fn(manager_state, basis, init_image, mask, tokens,
    uncond_tokens, ids, num_ids, generators, override_z0=None,
    override_noise=None) -> images.

    init_image (B, H, W, 3) in [-1, 1]; mask None or (1 or B, h, w, 1) at
    latent size, 1 = regenerate.  ``override_z0`` / ``override_noise`` give
    the scaled latents and the encode noise in place of the draws (then
    ``generators`` may be None).  Strength 1.0 starts from pure noise.

    The draws come first: generator j gives row j's posterior noise, then
    its encode noise.  The conditioning, the VAE encode, the DDIM chain
    (masked or not) and the decode then run as one captured ``body`` (a
    CUDA graph per shape signature on a card, ``utils.graphs``);
    ``fn.eager`` is the same function uncaptured.
    """
    ddim = make_ddim_schedule(pipe.schedule, num_steps, eta=0.0)
    t_enc = max(1, min(int(strength * num_steps), num_steps))
    steps = step_constants(ddim)[num_steps - t_enc:]
    scale_f = pipe.cfg.scale_factor

    def draws(init_image, generators, override_z0, override_noise):
        """-> (row j's posterior noise (B, h, w, C) or None, the encode
        noise)."""
        B, dev = init_image.shape[0], init_image.device
        f = pipe.latent_factor
        shape = (B, init_image.shape[1] // f, init_image.shape[2] // f,
                 pipe.vae.cfg.embed_dim)
        post = None
        if override_z0 is None:
            post = torch.cat([torch.randn((1,) + shape[1:], generator=g,
                                          device=g.device).to(dev)
                              for g in generators])
        else:
            shape = override_z0.shape
        noise = (batched_normal(generators, shape, dev)
                 if override_noise is None else override_noise)
        return post, noise

    def body(manager_state, basis, init_image, mask, tokens, uncond_tokens,
             ids, num_ids, z0, post, noise):
        B = tokens.shape[0]
        cond = pipe.conditioning(tokens, manager_state, basis, ids, num_ids)
        uncond = pipe.conditioning(uncond_tokens)
        if z0 is None:
            # row by row, as models.vae.sample_posterior computes a row
            mean, logvar = pipe.vae.encode(init_image)
            z0 = torch.cat([mean[i:i + 1] + torch.exp(0.5 * logvar[i:i + 1])
                            * post[i:i + 1] for i in range(B)]) * scale_f
        # the encode level is one DDIM index above the first decode step's;
        # at strength 1.0 there is none above: pure noise
        x = (stochastic_encode(z0, t_enc, ddim, noise=noise)
             if t_enc < num_steps else noise)
        eps_model = pipe.eps_model()
        for t, a_t, a_prev, sqrt_oma, _ in steps:
            tb = torch.full((B,), t, dtype=torch.int64, device=x.device)
            if mask is not None:
                z_known = a_t ** 0.5 * z0 + (1 - a_t) ** 0.5 * noise
                x = z_known * (1 - mask) + x * mask
            e = guided_eps(eps_model, x, tb, cond, uncond, guidance_scale)
            x, _ = ddim_step(x, e, a_t, a_prev, sqrt_oma, 0.0, 0.0)
        if mask is not None:
            x = z0 * (1 - mask) + x * mask
        return finish_images(pipe.vae.decode(x / scale_f), output)

    def make(run):
        @torch.inference_mode()
        def fn(manager_state, basis, init_image, mask, tokens, uncond_tokens,
               ids, num_ids, generators, override_z0=None,
               override_noise=None):
            post, noise = draws(init_image, generators, override_z0,
                                override_noise)
            return run(manager_state, basis, init_image, mask, tokens,
                       uncond_tokens, ids, num_ids, override_z0, post, noise)
        return fn

    return graphs.entry(make, body)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--init-img", required=True)
    p.add_argument("--mask", default=None,
                   help="grayscale mask; white = regenerate")
    p.add_argument("--prompt", default="a photo of a sks person")
    p.add_argument("--config", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--ckpt", default=None,
                   help="sd-v1-4 checkpoint (CompVis .ckpt)")
    p.add_argument("--embedding_path", default=None)
    p.add_argument("--outdir", default="outputs/img2img")
    p.add_argument("--strength", type=float, default=0.75)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=10.0)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ids", type=int, nargs="+", default=[0])
    p.add_argument("--vocab", default=None)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> np.ndarray:
    """Writes ``{i:05d}.jpg`` under ``--outdir`` and returns the images,
    (n_samples, S, S, 3) uint8, S the init image's width floored to a
    multiple of 64."""
    from PIL import Image

    args = build_argparser().parse_args(argv)
    init = Image.open(args.init_img).convert("RGB")
    size = (init.size[0] // 64) * 64 or 64
    init = init.resize((size, size), Image.LANCZOS)
    init_arr = np.asarray(init, np.float32) / 127.5 - 1.0

    spec = load_run_spec(args.config)
    asm = loader.assemble(
        spec, sd_ckpt=args.ckpt, vocab_path=args.vocab,
        embedding_ckpt=args.embedding_path, image_size=size, seed=args.seed,
        device=args.device,
        param_dtype=torch.bfloat16 if args.precision == "bf16" else None)
    dev, B = asm.device, args.n_samples
    f = asm.pipeline.latent_factor
    mask = None
    if args.mask:
        m = Image.open(args.mask).convert("L").resize(
            (size // f, size // f), Image.NEAREST)
        mask = torch.from_numpy(
            (np.asarray(m) > 127).astype(np.float32))[None, :, :, None].to(dev)

    fn = make_img2img_fn(asm.pipeline, args.ddim_steps, args.strength,
                         args.scale, size, output="uint8")
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    k = len(asm.pipeline.manager_cfg.placeholder_token_ids)
    ids = as_dev(np.tile((list(args.ids) + [0] * k)[:k], (B, 1)))
    num_ids = as_dev([len(args.ids)] * B)
    init_b = torch.from_numpy(init_arr).to(dev)[None].expand(B, -1, -1, -1)
    gens = [torch.Generator(device=dev).manual_seed(sample_seed(args.seed, j))
            for j in range(B)]
    imgs = fn(asm.manager_state, asm.basis, init_b, mask,
              as_dev(asm.tokenizer([args.prompt] * B)),
              as_dev(asm.tokenizer([""] * B)), ids, num_ids, gens)
    imgs = imgs.cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    for i, u8 in enumerate(imgs):
        Image.fromarray(u8).save(os.path.join(args.outdir, f"{i:05d}.jpg"))
    print(f"[img2img] wrote {B} images to {args.outdir}")
    return imgs


if __name__ == "__main__":
    main()
