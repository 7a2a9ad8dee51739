#!/usr/bin/env python3
"""Device times of the int8 matmul (bf16) at the UNet's projection shapes,
beside ``torch._int_mm``, the bound and the plain version; or the host time
of a call, this checkout's against another's.

    python3 torch_scripts/time_int8.py [--root DIR] [--repeat N]
    python3 torch_scripts/time_int8.py --host-vs DIR

For each shape of ``chip_smoke.INT8_TIMED`` (M x K -> N, bf16): the kernel
as its plan runs it and, where the timed package has modes
(``quant._int8_matmul_mode``), each mode that can run the shape forced
("fused", "streamed"), timed in turns (A B B A), each a CUDA-graph replay as in
``chip_smoke.time_ms``; ``torch._int_mm`` on x already quantised (the
library's int8 product alone: no quantisation, no dequantisation, an int32
output); the plain version; the bound (``chip_smoke.int8_bound``) and the
plan.

``--root`` times the ``celebbasis_tpu_torch`` package of another checkout
(e.g. a parent commit unpacked with ``git archive`` into the git-ignored
``_parent/``), so that two versions can be compared in turns on one card.

``--host-vs DIR`` measures instead what the host spends on one
``int8_matmul`` call at each timed shape, the whole wrapper with its C entry
and launches, for this checkout's package and DIR's, imported side by side
into one process, in HOST_ROUNDS rounds alternating A B B A; each round
times HOST_CALLS calls queued behind a sleeping kernel, so that the device
never holds the host back.

Needs a CUDA device; prints the card and one JSON line per repeat.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CALLS, HOST_ROUNDS = 100, 40
HOST_SLEEP_CYCLES = 20_000_000   # about 10 ms at the H100's SM clock
ROUNDS = 2                       # A B B A rounds of the mode timings


def import_aside(root):
    """The ``quant`` module of `root`'s ``celebbasis_tpu_torch``, imported
    beside this checkout's: the package's modules already imported are set
    aside while it is, and put back after (its functions keep their own
    modules)."""
    def take():
        return {n: sys.modules.pop(n) for n in list(sys.modules)
                if n.split(".")[0] == "celebbasis_tpu_torch"}

    kept = take()
    sys.path.insert(0, root)
    try:
        from celebbasis_tpu_torch.ops import quant
    finally:
        sys.path.remove(root)
        take()
        sys.modules.update(kept)
    if not os.path.abspath(quant.__file__).startswith(root):
        raise RuntimeError(f"imported {quant.__file__}, not from {root}")
    return quant


def inputs(quant, M, K, N):
    """x (bf16), w_q, w_scale as chip_smoke.check_int8 makes them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(M + 3 * K + 7 * N)
    w = torch.randn(K, N, device="cuda", generator=g) * K ** -0.5
    w_q, w_s = quant.quantize_per_channel(w)
    x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
    return x, w_q, w_s


def host_us(call) -> float:
    """Host microseconds per call of `call`, over HOST_CALLS calls queued
    behind a sleeping kernel."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        call()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def host_ab(other: str) -> dict:
    """Host time of an int8_matmul call at each timed shape, this checkout's
    package against `other`'s, in rounds A B B A."""
    import numpy as np

    sys.path.insert(0, REPO)
    from celebbasis_tpu_torch.ops import quant
    import chip_smoke
    mods = {"this": quant, "other": import_aside(other)}
    out = {"this": REPO, "other": other, "rounds": HOST_ROUNDS,
           "calls_a_round": HOST_CALLS, "shapes": {}}
    for M, K, N in chip_smoke.INT8_TIMED:
        x, w_q, w_s = inputs(quant, M, K, N)
        calls = {side: (lambda q=q: q.int8_matmul(x, w_q, w_s))
                 for side, q in mods.items()}
        counts = {side: mods[side].launch_counts()["int8_matmul"]
                  for side in calls}
        for call in calls.values():
            for _ in range(20):
                call()
        for side in calls:
            if mods[side].launch_counts()["int8_matmul"] != counts[side] + 20:
                raise RuntimeError(f"{side}: the kernel did not launch")
        readings = {side: [] for side in calls}
        for r in range(HOST_ROUNDS):
            for side in (("this", "other") if r % 2 == 0
                         else ("other", "this")):
                readings[side].append(host_us(calls[side]))
        diffs = [a - b for a, b in zip(readings["this"], readings["other"])]
        out["shapes"][f"{M}x{K}->{N}"] = {
            "host_us_median": {s: float(np.median(v))
                               for s, v in readings.items()},
            "host_us_least": {s: min(v) for s, v in readings.items()},
            "this_less_other_median_us": float(np.median(diffs))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--host-vs", metavar="DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.host_vs:
        result = host_ab(os.path.abspath(args.host_vs))
        import chip_smoke
        print(chip_smoke.smi_line(), flush=True)
        print(json.dumps(result), flush=True)
        return 0
    import numpy as np
    root = os.path.abspath(args.root)
    sys.path.insert(0, REPO)
    import chip_smoke   # time_ms, int8_bound, the shapes: this checkout's
    if root == REPO:
        from celebbasis_tpu_torch.ops import quant
    else:
        quant = import_aside(root)
    print(chip_smoke.smi_line(), flush=True)
    modes = hasattr(quant, "_int8_matmul_mode")
    bf16 = torch.bfloat16

    def shape(M, K, N):
        x, w_q, w_s = inputs(quant, M, K, N)
        iters = 10 if M * N >= 1 << 24 else 50
        runs = {"kernel": lambda: quant.int8_matmul(x, w_q, w_s)}
        rec = {}
        if modes:
            rec["plan"] = quant.plan(x.device, bf16, M, N, K)
            for v in ("fused", "streamed"):
                try:
                    quant._forced_plan(x.device, bf16, M, N, K, v)
                except ValueError:
                    continue       # a mode that cannot run the shape
                runs[v] = (lambda v=v: quant._int8_matmul_mode(x, w_q, w_s,
                                                               v))
        readings = {k: [] for k in runs}
        for r in range(ROUNDS):
            order = list(runs) if r % 2 == 0 else list(runs)[::-1]
            for k in order:
                readings[k].append(chip_smoke.time_ms(runs[k], iters)[0])
        for k, v in readings.items():
            rec[f"{k}_ms"] = float(np.median(v))
            rec[f"{k}_ms_readings"] = v
        xq = quant._quantize_rows(x)[0].to(torch.int8)
        rec["int_mm_ms"] = chip_smoke.time_ms(
            lambda: torch._int_mm(xq, w_q), iters)[0]
        rec["plain_ms"] = chip_smoke.time_ms(
            lambda: quant.int8_matmul_plain(x, w_q, w_s), 3)[0]
        rec["bound_ms"], rec["bound_by"] = chip_smoke.int8_bound(M, K, N,
                                                                 bf16)
        rec["kernel_over_int_mm"] = rec["kernel_ms"] / rec["int_mm_ms"]
        rec["bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
        return rec

    for _ in range(args.repeat):
        out = {"root": root,
               "shapes": {f"{M}x{K}->{N}": shape(M, K, N)
                          for M, K, N in chip_smoke.INT8_TIMED}}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
