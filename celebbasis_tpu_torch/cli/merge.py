"""Merge textual-inversion embedding checkpoints (counterpart of
``celebbasis_tpu/cli/merge.py``, the reference's ``merge_embeddings.py``).

Combines several TI checkpoints into one; a placeholder that two files share
must be renamed with ``--rename old.pt:placeholder=new_name`` (the reference
asks interactively; the flag is the non-interactive equivalent), or the
merge raises.  Host work only: no device is involved.

    python -m celebbasis_tpu_torch.cli.merge --manager_ckpts a.pt b.pt \
        --output_path merged.pt --rename 'b.pt:*=@'
"""
from __future__ import annotations

import argparse

import torch

from celebbasis_tpu_torch.core import textual_inversion as ti
from celebbasis_tpu_torch.utils.pt_io import save_pt


def main(argv=None):
    """Writes the merged checkpoint; returns {placeholder: (V, D) vectors}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manager_ckpts", type=str, nargs="+", required=True)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--rename", type=str, nargs="*", default=[],
                   help="entries 'path:placeholder=newname'")
    args = p.parse_args(argv)

    rename = dict(item.split("=", 1) for item in args.rename)
    merged = ti.merge_ti_checkpoints(args.manager_ckpts, rename)
    save_pt({
        "string_to_token": {k: torch.tensor(0, dtype=torch.int64)
                            for k in merged},
        "string_to_param": {k: torch.from_numpy(v.astype("float32"))
                            for k, v in merged.items()},
    }, args.output_path)
    print(f"[merge] wrote {len(merged)} placeholders to {args.output_path}: "
          f"{sorted(merged)}")
    return merged


if __name__ == "__main__":
    main()
