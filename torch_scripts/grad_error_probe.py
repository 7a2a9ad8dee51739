#!/usr/bin/env python3
"""How far are bf16 attention gradients from the fp32-product plain version,
for the port's backward kernels and for the library's?

    python3 torch_scripts/grad_error_probe.py

For flat (q_scale 1) and peaked (q_scale 4) softmaxes at the train step's
self-attention shapes it prints, for dq, dk and dv, the largest error in units
of two limits: ``bf16_error_ratio`` (one bf16 ulp of the element plus 2**-5 of
the tensor's rms) and ``bf16_grad_error_ratio`` (the same with the rms taken
over the element's own row where that is larger) -- once for the kernels of
``csrc/flash_attention_bwd.cu`` and once for ``torch.autograd.grad`` through
``F.scaled_dot_product_attention`` on the same inputs.  Needs a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from celebbasis_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0])
    B, H = 2, 8
    for N, D in ((4096, 40), (1024, 80), (256, 160)):
        for q_scale in (1.0, 4.0):
            g = torch.Generator(device="cuda").manual_seed(N + D)
            mk = lambda s=1.0: (torch.randn(B, H, N, D, device="cuda",
                                            generator=g) * s).bfloat16()
            q, k, v, do = mk(q_scale), mk(), mk(), mk()
            o, lse = fa.flash_attention_lse(q, k, v)
            ours = fa.flash_attention_bwd(q, k, v, o, lse, do)
            ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            lib = torch.autograd.grad(
                torch.nn.functional.scaled_dot_product_attention(*leaves),
                leaves, do)
            for name, a, b, r in zip(("dq", "dk", "dv"), ours, lib, ref):
                row = r.float().square().mean(-1).sqrt()
                print(f"N={N} D={D} q_scale={q_scale} {name}: rms "
                      f"{r.float().square().mean().sqrt().item():.4f}, "
                      f"largest row rms {row.max().item():.4f}; kernel "
                      f"{fa.bf16_error_ratio(a, r):.3f} / "
                      f"{fa.bf16_grad_error_ratio(a, r):.3f}, library "
                      f"{fa.bf16_error_ratio(b, r):.3f} / "
                      f"{fa.bf16_grad_error_ratio(b, r):.3f} "
                      f"(tensor-rms limit / row-rms limit)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
