#!/usr/bin/env python3
"""Device times of the flash-attention backward kernels (bf16, packed) at the
train step's eight attention shapes, beside their bounds and the library's
backward.

    python3 torch_scripts/time_backward.py [--root DIR] [--repeat N]

For each SD v1 level (N tokens, head dim D; batch 2, 8 heads) with M = N and
M = 77 keys: ``dq`` and ``dkv`` ms (each one kernel launch through
``flash_attention_bwd``; CUDA-graph replay as in ``chip_smoke.time_ms``),
their bounds (``chip_smoke.train_bound``), the dk/dv query split, and the
library's backward (``autograd.grad`` through
``F.scaled_dot_product_attention``, dq+dk+dv together, less its forward).
``--root`` times the ``celebbasis_tpu_torch`` package of another checkout
(e.g. a parent commit unpacked into a git-ignored directory), so that two
versions can be compared in turns on one card.  Needs a CUDA device; prints
the card and one JSON line per repeat.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=REPO,
                    help="checkout whose celebbasis_tpu_torch is timed")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from celebbasis_tpu_torch.ops import flash_attention as fa
    if not os.path.abspath(fa.__file__).startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")
    sys.path.insert(1, REPO)
    import chip_smoke   # time_ms, train_bound, the levels
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line(), flush=True)
    F = torch.nn.functional
    B, H = chip_smoke.B_TRAIN, chip_smoke.H_SERVE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for _ in range(args.repeat):
        out = {}
        for N, D in chip_smoke.SERVE_LEVELS:
            for M in (N, 77):
                g = torch.Generator(device="cuda").manual_seed(N + M + D)
                mk = lambda L: torch.randn(B, L, H * D, device="cuda",
                                           generator=g).to(torch.bfloat16)
                q, k, v, do = mk(N), mk(M), mk(M), mk(N)
                o, lse = fa.flash_attention_lse(q, k, v, H)
                delta = fa.flash_attention_delta(o, do, H)
                iters = 10 if N * M >= 1 << 22 else 50
                rec = {}
                for name, kw in (("dq", {"need_dkv": False}),
                                 ("dkv", {"need_dq": False})):
                    rec[name] = chip_smoke.time_ms(
                        lambda: fa.flash_attention_bwd(
                            q, k, v, o, lse, do, H, delta=delta, **kw),
                        iters)[0]
                    rec[f"{name}_bound"] = chip_smoke.train_bound(
                        name, B, H, N, M, D, torch.bfloat16)[0]
                q4, k4, v4, do4 = (fa._split(x, H) for x in (q, k, v, do))
                leaves = [x.detach().clone().requires_grad_(True)
                          for x in (q4, k4, v4)]

                def library():
                    torch.autograd.grad(F.scaled_dot_product_attention(
                        *leaves), leaves, do4)

                fwd = chip_smoke.time_ms(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4),
                    iters)[0]
                rec["library_bwd"] = chip_smoke.time_ms(library, iters)[0] \
                    - fwd
                if hasattr(fa, "dkv_split_plan"):
                    rec["dkv_splits"] = fa.dkv_split_plan(B, H, N, M, D,
                                                          sms)[0]
                out[f"{N}x{M}/D={D}"] = rec
        print(json.dumps({"root": root, "times_ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
