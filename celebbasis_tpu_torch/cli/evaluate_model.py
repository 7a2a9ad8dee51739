"""Textual-inversion model evaluation CLI (counterpart of
``celebbasis_tpu/cli/evaluate_model.py``, the reference's
``scripts/evaluate_model.py``): the txt2img-1p4B eval config (the
BERT-conditioned legacy LDM), optionally a textual-inversion embedding
checkpoint, N images from one prompt with CFG 5.0, and CLIP image-image and
text-image similarity against the training images (``LDMCLIPEvaluator
.evaluate``), scored by ``cli/eval_imgs.build_scorers`` in float32 with TF32
off.

Image i of a run draws from a generator seeded from ``(--seed, i)``.
Without ``--ckpt-path`` / ``--clip-ckpt`` the networks have random weights
(structure checks only).  Runs on ``cuda``; ``--device cpu`` asks for the
CPU on purpose.

    python -m celebbasis_tpu_torch.cli.evaluate_model --data-dir subject/ \
        --embedding-path embeddings.pt --n-samples 8
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import yaml

from celebbasis_tpu_torch import legacy
from celebbasis_tpu_torch.cli.eval_imgs import build_scorers
from celebbasis_tpu_torch.diffusion.sampler import sample_seed
from celebbasis_tpu_torch.pipeline import finish_images
from celebbasis_tpu_torch.utils.precision import no_tf32

_DEFAULT_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "txt2img-1p4B-eval.yaml")


def make_ti_inject(ldm, embedding_path: str):
    """A TI embedding ``.pt`` -> ``inject(ids, embedded)`` for the text
    encoder's token-embedding layer: rows whose token id is a placeholder
    get the learned vector (one token a placeholder, its first vector)."""
    from celebbasis_tpu_torch.core.textual_inversion import \
        load_ti_checkpoint
    pairs = []
    for string, vecs in load_ti_checkpoint(embedding_path).items():
        tok = ldm.tokenizer.tokenize(string)[0]
        pairs.append((tok, torch.from_numpy(np.asarray(vecs[0])).to(
            ldm.device)))

    def inject(ids, embedded):
        for tok, vec in pairs:
            if vec.shape[-1] != embedded.shape[-1]:
                raise ValueError(f"TI vector dim {vec.shape[-1]} != text "
                                 f"width {embedded.shape[-1]}")
            embedded = torch.where((ids == tok)[..., None], vec, embedded)
        return embedded
    return inject


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prompt", default="a painting of a * monster "
                                        "playing guitar")
    ap.add_argument("--config", default=_DEFAULT_CFG)
    ap.add_argument("--ckpt-path", default=None,
                    help="pretrained LDM .ckpt (CompVis layout)")
    ap.add_argument("--embedding-path", default=None,
                    help="TI embedding manager .pt")
    ap.add_argument("--data-dir", required=True,
                    help="folder of training images to compare against")
    ap.add_argument("--out-dir", default="./eval_out")
    ap.add_argument("--n-samples", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=5.0)
    ap.add_argument("--clip-ckpt", default=None)
    ap.add_argument("--tiny-scorers", action="store_true",
                    help="toy CLIP scorers (functional verification)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--device", type=str, default=None,
                    help="default: cuda (fails without a card); 'cpu' runs "
                         "on the CPU on purpose")
    return ap


def main(argv=None) -> dict:
    """Writes up to 8 samples and ``scores.json`` under ``--out-dir`` /
    the prompt; -> the scores."""
    args = build_argparser().parse_args(argv)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    ldm = legacy.prepare(cfg, ckpt=args.ckpt_path, seed=args.seed,
                         device=args.device)
    dev = ldm.device
    inject = make_ti_inject(ldm, args.embedding_path) \
        if args.embedding_path else None
    sample = ldm.make_sample_fn(num_steps=args.steps,
                                guidance_scale=args.scale, inject=inject)

    # the source images (PersonalizedBase at 256, no flips)
    from celebbasis_tpu_torch.data.personalized import (PersonalizedBase,
                                                        PersonalizedConfig)
    ds = PersonalizedBase(PersonalizedConfig(data_root=args.data_dir,
                                             image_size=256, flip_p=0.0,
                                             repeats=1))
    src = np.stack([ds[i]["image"] for i in range(len(ds))])

    gen, n_done = [], 0
    while n_done < args.n_samples:
        n = min(args.batch_size, args.n_samples - n_done)
        gens = [torch.Generator(device=dev).manual_seed(
            sample_seed(args.seed, n_done + j)) for j in range(n)]
        imgs = sample([args.prompt] * n, n, gens)
        gen.append(imgs.clamp(-1.0, 1.0))
        n_done += n
        print(f"[evaluate_model] sampled {n_done}/{args.n_samples}")
    gen = torch.cat(gen)
    pixels = finish_images(gen, "uint8").cpu().numpy()
    gen = gen.cpu().numpy()

    _, clip_eval = build_scorers(clip_ckpt=args.clip_ckpt,
                                 tiny=args.tiny_scorers, device=dev)
    with no_tf32():                  # float32 scoring, as cli/eval_imgs.py
        sim_img = clip_eval.img_to_img_similarity(src, gen)
        sim_text = clip_eval.txt_to_img_similarity(
            args.prompt.replace("*", ""), gen)

    out_dir = os.path.join(args.out_dir, args.prompt.replace(" ", "-"))
    os.makedirs(out_dir, exist_ok=True)
    from PIL import Image
    for i in range(min(8, len(pixels))):
        Image.fromarray(pixels[i]).save(os.path.join(out_dir, f"{i:03}.png"))
    scores = {"sim_img": float(sim_img), "sim_text": float(sim_text),
              "n_samples": int(len(gen)), "prompt": args.prompt}
    with open(os.path.join(out_dir, "scores.json"), "w") as f:
        json.dump(scores, f, indent=2)
    print("Image similarity: ", scores["sim_img"])
    print("Text similarity: ", scores["sim_text"])
    return scores


if __name__ == "__main__":
    main()
