"""txt2img CLI (counterpart of ``celebbasis_tpu/cli/txt2img.py``).

Same knobs and defaults as the reference's test script: a prompt file or one
prompt, DDIM 50 steps (``--plms`` for PLMS), CFG scale 10, eta 0, 512x512,
``--n_samples`` per prompt, seed 42, ``--embedding_path`` for the trained
coefficients, placeholder words (``sks``/``ks``) selecting saved identities
through ``--ids``, or ``--faces`` for live-face conditioning (identity
embeddings from a MetaIdNet forward on aligned crops), or
``--ti_embedding`` for a textual-inversion checkpoint (its learned vectors
stand in for its placeholders, e.g. ``*``).

Image i of a run (counted over all prompts) draws from a generator seeded
from ``(--seed, i)``.  Runs on ``cuda``; ``--device cpu`` asks for the CPU
on purpose.

``--mesh D`` samples data parallel over D processes (started by
``torchrun``): D divides ``--n_samples``, rank d draws and samples rows
``[d B/D, (d+1) B/D)`` of each prompt's batch, and rank 0 gathers them and
writes the same files a one-process run writes.  ``--tp M`` shards the
UNet's and CLIP's attention and MLP weights over M processes (Megatron
rules, ``parallel.mesh``; M divides every attention's heads), composable
with ``--mesh`` as a (data, model) mesh of D x M processes.  The collectives
are NCCL's on cards and gloo's on the CPU, or those of a group the caller
started before it called ``main`` (over gloo the chain runs uncaptured).

    python -m celebbasis_tpu_torch.cli.txt2img --config configs/aigc_id.yaml \
        --prompt "a photo of a sks person" --embedding_path emb.pt
    torchrun --nproc_per_node 4 -m celebbasis_tpu_torch.cli.txt2img \
        --mesh 2 --tp 2 --n_samples 8 ...
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from celebbasis_tpu_torch import loader
from celebbasis_tpu_torch.diffusion.sampler import sample_seed
from celebbasis_tpu_torch.parallel import mesh as pmesh
from celebbasis_tpu_torch.utils.config import load_run_spec


def save_images(arr: np.ndarray, outdir: str, start_idx: int, grid: bool):
    """(N, H, W, 3) uint8 (or float in [-1, 1]) -> ``{start_idx+i:05d}.jpg``
    files, and ``grid.jpg`` (a near-square grid) when ``grid`` and N > 1."""
    from PIL import Image
    os.makedirs(outdir, exist_ok=True)
    if arr.dtype == np.uint8:
        imgs = arr
    else:
        imgs = ((arr + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    paths = []
    for i, im in enumerate(imgs):
        p = os.path.join(outdir, f"{start_idx + i:05d}.jpg")
        Image.fromarray(im).save(p)
        paths.append(p)
    if grid and len(imgs) > 1:
        n = len(imgs)
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        h, w = imgs.shape[1:3]
        canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i, im in enumerate(imgs):
            r, c = divmod(i, cols)
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
        Image.fromarray(canvas).save(os.path.join(outdir, "grid.jpg"))
    return paths


def load_face_crops(paths, size: int) -> np.ndarray:
    """Aligned face photos -> (k, size, size, 3) float32 in [-1, 1]
    (bilinear resize, then (x - 0.5) / 0.5 on [0, 1] pixels)."""
    from PIL import Image
    out = []
    for p in paths:
        img = Image.open(p).convert("RGB").resize((size, size),
                                                  Image.BILINEAR)
        out.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    return np.stack(out)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--from-file", dest="from_file", type=str, default=None)
    p.add_argument("--outdir", type=str, default="outputs/txt2img-samples")
    p.add_argument("--config", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--ckpt", type=str, default=None,
                   help="sd-v1-4 checkpoint (CompVis .ckpt)")
    p.add_argument("--embedding_path", type=str, default=None,
                   help="embeddings_gs-*.pt with trained id coefficients")
    p.add_argument("--ti_embedding", type=str, default=None,
                   help="textual-inversion checkpoint (train_ti / merge): "
                        "its vectors replace its placeholders")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--scale", type=float, default=10.0)
    p.add_argument("--n_samples", type=int, default=8)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ids", type=int, nargs="+", default=[0, 1],
                   help="identity indices bound to placeholders sks, ks, ...")
    p.add_argument("--faces", type=str, nargs="+", default=None,
                   help="aligned face photos, one per placeholder: live-face "
                        "conditioning (test_mode='image'), the identity "
                        "embeddings come from a MetaIdNet forward instead "
                        "of saved coefficients")
    p.add_argument("--fr_ckpt", type=str, default=None,
                   help="CosFace IResNet-100 backbone.pth for --faces")
    p.add_argument("--no-grid", action="store_true")
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16",
                   help="frozen-weight storage; bf16 for inference, fp32 "
                        "for parity runs")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard the sample batch over N processes (data "
                        "parallel; N divides --n_samples)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel degree M: Megatron attention/MLP "
                        "sharding of the UNet and CLIP (composes with --mesh "
                        "as a (data, model) mesh)")
    return p


def main(argv=None) -> np.ndarray:
    """Writes the images under ``--outdir`` (one folder per prompt) and
    returns them all, (prompts * n_samples, H, W, 3) uint8."""
    args = build_argparser().parse_args(argv)
    if args.H != args.W:
        raise ValueError("square outputs only")
    mesh = None
    if args.mesh or args.tp:
        n_data, n_model = args.mesh or 1, args.tp or 1
        if args.n_samples % n_data:
            raise ValueError("--mesh must divide --n_samples")
        mesh = pmesh.make_mesh(n_data, n_model, device=args.device or "cuda")
    try:
        return _sample(args, mesh)
    finally:
        pmesh.close_mesh()


def _sample(args, mesh) -> np.ndarray:
    spec = load_run_spec(args.config)
    asm = loader.assemble(
        spec, sd_ckpt=args.ckpt, vocab_path=args.vocab, fr_ckpt=args.fr_ckpt,
        embedding_ckpt=args.embedding_path, image_size=args.H,
        seed=args.seed, device=args.device,
        param_dtype=torch.bfloat16 if args.precision == "bf16" else None)

    if args.from_file:
        with open(args.from_file) as f:
            prompts = [line.strip() for line in f if line.strip()]
    else:
        prompts = [args.prompt or "a photo of a sks person"]

    pipe, dev, B = asm.pipeline, asm.device, args.n_samples
    n_model = pmesh.axis_size(mesh, pmesh.MODEL)
    if mesh is not None:
        pmesh.shard_params(pipe, mesh, use_tp=n_model > 1)
        if pmesh.is_writer(mesh):
            print(f"[txt2img] sampling over a "
                  f"{pmesh.axis_size(mesh, pmesh.DATA)}x{n_model} data x "
                  f"model mesh")
    # this rank's rows of each prompt's batch
    b = B // pmesh.axis_size(mesh, pmesh.DATA)
    first = pmesh.axis_index(mesh, pmesh.DATA) * b
    # gloo's collectives cannot be captured: over gloo the chain runs eagerly
    pick = (lambda f: f.eager) if pmesh.runs_eagerly(mesh) else (lambda f: f)
    sampler_args = dict(num_steps=args.ddim_steps, guidance_scale=args.scale,
                        eta=args.ddim_eta, image_size=args.H,
                        sampler="plms" if args.plms else "ddim",
                        output="uint8")
    if args.faces:
        crops = torch.from_numpy(load_face_crops(args.faces, args.H)).to(dev)
        faces = crops[None].expand((b,) + tuple(crops.shape))
        faces_fn = pick(pipe.make_txt2img_faces_fn(asm.meta_net,
                                                   **sampler_args))

        def fn(_state, basis, tokens, uncond, ids, num_ids, gens):
            return faces_fn(basis, tokens, uncond, faces, ids, num_ids, gens)
    elif args.ti_embedding:
        from celebbasis_tpu_torch.core import textual_inversion as ti
        vectors = ti.load_ti_checkpoint(args.ti_embedding)
        names = sorted(vectors)
        ti_cfg = ti.TIConfig(placeholder_strings=tuple(names),
                             num_vectors_per_token=vectors[names[0]].shape[0],
                             token_dim=spec.clip.width)
        ti_params = torch.from_numpy(
            np.stack([vectors[n] for n in names])).to(dev)
        ti_fn = pick(pipe.make_txt2img_ti_fn(
            ti_cfg, ti.placeholder_token_ids(ti_cfg, asm.tokenizer),
            **sampler_args))

        def fn(_state, _basis, tokens, uncond, _ids, _num_ids, gens):
            return ti_fn(ti_params, tokens, uncond, gens)
    else:
        fn = pick(pipe.make_txt2img_fn(**sampler_args))

    # in faces mode the id axis follows the supplied photos (one face slot
    # per placeholder); otherwise it follows the placeholder list
    k = (len(args.faces) if args.faces
         else len(pipe.manager_cfg.placeholder_token_ids))
    ids_row = (list(args.ids) + [0] * k)[:k]
    n_active = len(args.faces) if args.faces else len(args.ids)
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    ids = as_dev(np.tile(ids_row, (b, 1)))
    num_ids = as_dev([n_active] * b)
    uncond = as_dev(asm.tokenizer([""] * b))
    idx, out = 0, []
    for pi, prompt in enumerate(prompts):
        tokens = as_dev(asm.tokenizer([prompt] * b))
        gens = [torch.Generator(device=dev).manual_seed(
            sample_seed(args.seed, idx + first + j)) for j in range(b)]
        imgs = fn(asm.manager_state, asm.basis, tokens, uncond, ids, num_ids,
                  gens)
        if mesh is not None:       # every data rank's rows, in order
            imgs = pmesh.all_gather(imgs, mesh.get_group(pmesh.DATA))
        imgs = imgs.cpu().numpy()
        outdir = os.path.join(args.outdir, f"{pi:03d}_" + "".join(
            c if c.isalnum() else "-" for c in prompt[:60]))
        if pmesh.is_writer(mesh):
            paths = save_images(imgs, outdir, idx, grid=not args.no_grid)
            print(f"[txt2img] {prompt!r} -> {len(paths)} images in "
                  f"{outdir}")
        idx += B
        out.append(imgs)
    return np.concatenate(out)


if __name__ == "__main__":
    main()
