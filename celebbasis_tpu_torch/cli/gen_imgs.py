"""Batch generation for evaluation (counterpart of
``celebbasis_tpu/cli/gen_imgs.py``, the reference's ``evaluation/gen_imgs.py``;
stage 1 of W4).

Writes the reference's generated-evaluation folder:

    <outdir>/prompts.txt            one line per item (N id-pairs x L prompts,
    <outdir>/in_image_paths.txt      prompt fastest), str(list) formatting
    <outdir>/in_image_ids.txt
    <outdir>/imgs/{i:05d}_id{id0:05d}_{prompt}/{cnt:05d}.jpg

which ``cli/eval_imgs.py`` reads.  A folder that already holds images is
continued from its count (``--n_samples`` more are made only while it holds
fewer).  A prompt with a second ``ks person`` binds the pair's second
identity (``--pair_shift``).  Image ``j`` of item ``i`` draws from a
generator seeded from ``(--seed, i * n_samples + j)``.  Runs on ``cuda``;
``--device cpu`` asks for the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.gen_imgs --config configs/aigc_id.yaml \
        --embedding_path emb.pt --from-file prompts_single.txt --ids 0 1
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from celebbasis_tpu_torch import loader
from celebbasis_tpu_torch.diffusion.sampler import sample_seed
from celebbasis_tpu_torch.eval.prompt_templates import get_pos_neg_temps
from celebbasis_tpu_torch.utils.config import load_run_spec


def _save_list(items, path):
    """'{}\\n'.format(x): lists are written as str(list), which the
    evaluation side parses back with its regular expressions."""
    with open(path, "w") as f:
        f.writelines("{}\n".format(x) for x in items)


def _src_paths_by_id(folder, ids):
    """id -> source image path; takes the reference dataset's naming
    (``*_id<j>_#*.jpg``) or any name with an ``_id<j>`` part."""
    out = {}
    if not folder:
        return {j: f"src_id{j}.jpg" for j in ids}
    for f in sorted(os.listdir(folder)):
        if not f.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        for part in os.path.splitext(f)[0].split("_"):
            if part.startswith("id") and part[2:].isdigit():
                out.setdefault(int(part[2:]), os.path.join(folder, f))
    missing = [j for j in ids if j not in out]
    if missing:
        raise FileNotFoundError(
            f"--src_folder {folder}: no *_id<j>_* image for ids {missing}")
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--embedding_path", type=str, required=True)
    p.add_argument("--ckpt", type=str, default=None,
                   help="sd-v1-4 checkpoint (CompVis .ckpt)")
    p.add_argument("--from-file", dest="from_file", type=str, required=True)
    p.add_argument("--outdir", type=str, default="outputs/eval_gen")
    p.add_argument("--ids", type=int, nargs="+", default=list(range(10)))
    p.add_argument("--pair_shift", type=int, default=1,
                   help="second identity = (id + shift) %% n_ids for "
                        "two-person prompts")
    p.add_argument("--src_folder", type=str, default=None,
                   help="aligned source crops (*_id<j>_* naming) for "
                        "in_image_paths.txt; placeholders and a warning if "
                        "unset")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=10.0)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--use_pos_temp", action="store_true",
                   help="wrap prompts in the positive template (the "
                        "reference ships this line commented out; by "
                        "default the raw prompt)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> int:
    """Writes the folder; returns the number of images made."""
    args = build_argparser().parse_args(argv)
    spec = load_run_spec(args.config)
    asm = loader.assemble(spec, sd_ckpt=args.ckpt, vocab_path=args.vocab,
                          embedding_ckpt=args.embedding_path,
                          image_size=args.H, seed=args.seed,
                          device=args.device,
                          param_dtype=torch.bfloat16
                          if args.precision == "bf16" else None)
    with open(args.from_file) as f:
        prompts = [line.strip() for line in f if line.strip()]
    # the negative template is the unconditional prompt under guidance; the
    # positive one is opt-in
    pos_t, neg_t = get_pos_neg_temps(os.path.basename(args.from_file))

    n_ids = len(args.ids)
    src_of = _src_paths_by_id(args.src_folder, args.ids)
    if not args.src_folder:
        print("[gen_imgs] WARNING: no --src_folder -- in_image_paths.txt "
              "gets placeholders; eval_imgs needs real source crops")
    # the flat evaluation grid: id pairs outer, prompts inner
    items = []
    for id_idx in args.ids:
        pair = [id_idx, args.ids[(args.ids.index(id_idx) + args.pair_shift)
                                 % n_ids]]
        for prompt in prompts:
            items.append((prompt, pair))
    os.makedirs(args.outdir, exist_ok=True)
    _save_list([it[0] for it in items],
               os.path.join(args.outdir, "prompts.txt"))
    _save_list([[src_of[j] for j in it[1]] for it in items],
               os.path.join(args.outdir, "in_image_paths.txt"))
    _save_list([it[1] for it in items],
               os.path.join(args.outdir, "in_image_ids.txt"))

    fn = asm.pipeline.make_txt2img_fn(num_steps=args.ddim_steps,
                                      guidance_scale=args.scale,
                                      image_size=args.H, output="uint8")
    from PIL import Image
    B, dev = args.n_samples, asm.device
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    k = len(asm.pipeline.manager_cfg.placeholder_token_ids)
    made = 0
    for i, (prompt, pair) in enumerate(items):
        sub = os.path.join(args.outdir,
                           f"imgs/{i:05d}_id{pair[0]:05d}_{prompt}")
        os.makedirs(sub, exist_ok=True)
        cnt = len(os.listdir(sub))            # resumable numbering
        if cnt >= B:
            continue
        two_person = "ks person" in prompt.replace("sks person", "")
        text = pos_t.format(prompt) if args.use_pos_temp else prompt
        ids_row = (list(pair) + [0] * k)[:k]
        gens = [torch.Generator(device=dev).manual_seed(
            sample_seed(args.seed, i * B + j)) for j in range(B)]
        imgs = fn(asm.manager_state, asm.basis,
                  as_dev(asm.tokenizer([text] * B)),
                  as_dev(asm.tokenizer([neg_t] * B)),
                  as_dev(np.tile(ids_row, (B, 1))),
                  as_dev([2 if two_person else 1] * B), gens).cpu().numpy()
        for u8 in imgs:
            Image.fromarray(u8).save(os.path.join(sub, f"{cnt:05d}.jpg"))
            cnt += 1
        made += len(imgs)
        print(f"[gen_imgs] item {i}/{len(items)}: done")
    return made


if __name__ == "__main__":
    main()
