"""Celeb-basis builder CLI (W1; counterpart of
``celebbasis_tpu/cli/build_basis.py``): build the PCA basis from the names
file and the token table, and write it as a reference-compatible
``celeb_basis.pt``.

Runs on ``cuda``; ``--device cpu`` asks for the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.build_basis \
        --celeb_txt infer_images/wiki_names_v2.txt --out weights/celeb_basis.pt
"""
from __future__ import annotations

import argparse
import os

from celebbasis_tpu_torch import loader
from celebbasis_tpu_torch.core import basis as basis_mod
from celebbasis_tpu_torch.utils.config import load_run_spec


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--celeb_txt", type=str, default=None,
                   help="override the config's names file")
    p.add_argument("--ckpt", type=str, default=None,
                   help="sd-v1-4 checkpoint for the real token table")
    p.add_argument("--out", type=str, default="weights/celeb_basis.pt")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    spec = load_run_spec(args.config)
    if args.celeb_txt:
        spec.celeb_txt = args.celeb_txt
    asm = loader.assemble(spec, sd_ckpt=args.ckpt, vocab_path=args.vocab,
                          device=args.device)
    basis = asm.basis.cpu().numpy()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    basis_mod.save_basis_pt(basis, args.out)
    print(f"[build_basis] {basis.shape} basis "
          f"(mean+{basis.shape[1] - 1} dirs x {basis.shape[0]} columns) "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
