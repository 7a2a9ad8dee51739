"""Extraction CLI (counterpart of ``celebbasis_tpu/cli/extract.py``).

Loads a trained ``embeddings_gs-*.pt``, reconstructs each identity's text
embedding ``z = coeff . P + mean`` against the celeb basis, and writes the
textual-inversion-compatible files:

* ``celeb_basis.pt``           -- the (es, 1+inner, width) basis tensor;
* ``id_embedding_{i}.pt``      -- per identity, (es*h, width) embeddings;
* ``id_coefficient_{i}.pt``    -- per identity, (es, h, inner) coefficients.

Runs on ``cuda``; ``--device cpu`` asks for the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.extract \
        --embedding_path logs/.../embeddings_gs-800.pt --outdir weights/ti
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from celebbasis_tpu_torch import loader
from celebbasis_tpu_torch.core import basis as basis_mod
from celebbasis_tpu_torch.utils.config import load_run_spec
from celebbasis_tpu_torch.utils.pt_io import save_pt


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--embedding_path", type=str, required=True)
    p.add_argument("--outdir", type=str, default="weights/ti_id_embeddings")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    spec = load_run_spec(args.config)
    asm = loader.assemble(spec, vocab_path=args.vocab,
                          embedding_ckpt=args.embedding_path,
                          device=args.device)
    max_ids = asm.pipeline.manager_cfg.max_ids
    basis = asm.basis.cpu().numpy()

    os.makedirs(args.outdir, exist_ok=True)
    basis_mod.save_basis_pt(basis, os.path.join(args.outdir, "celeb_basis.pt"))
    coeffs = asm.manager_state.id_coefficients.cpu().numpy()
    for i in range(max_ids):
        z = basis_mod.reconstruct(coeffs[i], basis)
        save_pt(z.astype(np.float32),
                os.path.join(args.outdir, f"id_embedding_{i}.pt"))
        save_pt(coeffs[i].astype(np.float32),
                os.path.join(args.outdir, f"id_coefficient_{i}.pt"))
    print(f"[extract] wrote celeb_basis.pt + {max_ids} id embeddings/"
          f"coefficients to {args.outdir}")


if __name__ == "__main__":
    main()
