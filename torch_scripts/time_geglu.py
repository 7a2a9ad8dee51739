#!/usr/bin/env python3
"""Device times of the fused GEGLU kernels (bf16) at the SD v1 UNet's FF
sub-block shapes, beside the "xla" route, the library pair and the bound;
or the host time of a kernel-route call, this checkout's against another's.

    python3 torch_scripts/time_geglu.py [--root DIR] [--repeat N]
    python3 torch_scripts/time_geglu.py --host-vs DIR

For each FF level (rows x C, inner = 4C) of serving (batch 4: 2 x guidance)
and of the train step (batch 2): ``geglu_block`` (#7) and ``geglu_ffn``
(#6) on the kernel route, the "xla" route of the block (``geglu_block_xla``:
LayerNorm, two cuBLAS products, the gate and the residual, each a kernel of
its own), the block's two ``F.linear`` products alone (the library pair; no
PyTorch call computes a GEGLU block), each a CUDA-graph replay as in
``chip_smoke.time_ms``, and the bound (``chip_smoke.geglu_bound``).  Where
the timed package has the C entry ``geglu_plan``, each level also gets the
launch's plan.  ``modelled_weight_mb`` is a model, not a count (nothing on
the card counts L2 bytes): the MB of weights, and of the LN'd rows that the
kernel streams, that the blocks would read from L2 if each cluster read
each weight piece once for its row tiles and multicast it, and each row
tile's LN'd rows were read once a chunk (``modelled_weight_bytes``); for a
package without the plan (the mma.sync kernel before), all the weights once
per row tile of ``rows_per_block`` rows.  Last, the FF family of one CFG
UNet forward and of one train step's forward (16 sub-blocks: 5, 5, 5 and 1
at the four levels), kernel route against "xla" route, from the per-level
times.

``--root`` times the ``celebbasis_tpu_torch`` package of another checkout
(e.g. a parent commit unpacked with ``git archive`` into the git-ignored
``_parent/``), so that two versions can be compared in turns on one card.

``--host-vs DIR`` measures instead what the host spends on one
``geglu_block(impl="cuda")`` call at each serving level, the whole wrapper
with its C entry and launches, for this checkout's package and DIR's,
imported side by side into one process, in HOST_ROUNDS rounds alternating
A B B A; each round times HOST_CALLS calls queued behind a sleeping kernel,
so that the device never holds the host back.  The "xla" route's host time
is given beside them.

Needs a CUDA device; prints the card and one JSON line per repeat.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# FF sub-blocks of one UNet call at each level: 64^2, 32^2, 16^2, mid
PER_UNET = (5, 5, 5, 1)
HOST_CALLS, HOST_ROUNDS = 100, 40
HOST_SLEEP_CYCLES = 20_000_000   # about 10 ms at the H100's SM clock


def modelled_weight_bytes(how, C, inner, es):
    """The model of a call's L2 reads described in the module docstring,
    from its plan: W1 and W2 (3 C inner values) once a cluster of
    `partners` row tiles; in bf16, a row tile's LN'd rows x C once a
    chunk."""
    nbytes = how["row_tiles"] / how["partners"] * 3.0 * C * inner * es
    if how["variant"]:   # bf16: the LN'd rows are streamed
        chunks = -(-inner // how["chunk"])
        nbytes += how["row_tiles"] * chunks * how["rows"] * C * es
    return nbytes


def import_aside(root):
    """The ``geglu`` module of `root`'s ``celebbasis_tpu_torch``, imported
    and then taken out of ``sys.modules``, so that this checkout's package
    can be imported beside it (its functions keep their own modules)."""
    sys.path.insert(0, root)
    try:
        from celebbasis_tpu_torch.ops import geglu
    finally:
        sys.path.remove(root)
    for name in list(sys.modules):
        if name.split(".")[0] == "celebbasis_tpu_torch":
            del sys.modules[name]
    if not os.path.abspath(geglu.__file__).startswith(root):
        raise RuntimeError(f"imported {geglu.__file__}, not from {root}")
    return geglu


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
    """Host time of a kernel-route block call at each serving level, this
    checkout's package against `other`'s, in rounds A B B A."""
    import numpy as np
    import torch

    mods = {"other": import_aside(other)}
    sys.path.insert(0, REPO)
    from celebbasis_tpu_torch.ops import geglu
    import chip_smoke   # geglu_inputs, the shapes
    mods["this"] = geglu
    out = {"this": REPO, "other": other, "rounds": HOST_ROUNDS,
           "calls_a_round": HOST_CALLS, "levels": {}}
    for rows, C in chip_smoke.GEGLU_SERVE_SHAPES:
        x, (lns, lnb), w1, b1, w2, b2 = chip_smoke.geglu_inputs(
            rows, C, torch.bfloat16, rows * 7 + C)
        calls = {side: (lambda g=g: g.geglu_block(x, lns, lnb, w1, b1, w2,
                                                  b2, impl="cuda"))
                 for side, g in mods.items()}
        calls["xla"] = lambda: mods["this"].geglu_block_xla(
            x, lns, lnb, w1, b1, w2, b2)
        counts = {side: mods[side].launch_counts()["geglu_block"]
                  for side in ("this", "other")}
        for call in calls.values():
            for _ in range(20):
                call()
        for side in ("this", "other"):
            if mods[side].launch_counts()["geglu_block"] != counts[side] + 20:
                raise RuntimeError(f"{side}: the kernel route did not launch")
        readings = {side: [] for side in calls}
        for r in range(HOST_ROUNDS):
            order = ("this", "other", "xla") if r % 2 == 0 else \
                ("xla", "other", "this")
            for side in order:
                readings[side].append(host_us(calls[side]))
        diffs = [a - b for a, b in zip(readings["this"], readings["other"])]
        out["levels"][f"{rows}x{C}"] = {
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
    if args.host_vs:
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        result = host_ab(os.path.abspath(args.host_vs))
        import chip_smoke
        print(chip_smoke.smi_line(), flush=True)
        print(json.dumps(result), flush=True)
        return 0
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from celebbasis_tpu_torch.ops import geglu
    if not os.path.abspath(geglu.__file__).startswith(root):
        raise RuntimeError(f"imported {geglu.__file__}, not from {root}")
    sys.path.insert(1, REPO)
    import chip_smoke   # time_ms, geglu_inputs, geglu_bound, the shapes
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line(), flush=True)
    F = torch.nn.functional
    bf16, dev = torch.bfloat16, torch.device("cuda")

    def level(rows, C):
        x, (lns, lnb), w1, b1, w2, b2 = chip_smoke.geglu_inputs(
            rows, C, bf16, rows * 7 + C)
        u = torch.randn(rows, C, device="cuda").to(bf16)
        y = torch.randn(rows, 4 * C, device="cuda").to(bf16)
        w1t, w2t = w1.t(), w2.t()
        iters = 10 if rows * C >= 1 << 22 else 50
        rec = {
            "block_ms": chip_smoke.time_ms(lambda: geglu.geglu_block(
                x, lns, lnb, w1, b1, w2, b2, impl="cuda"), iters)[0],
            "ffn_ms": chip_smoke.time_ms(lambda: geglu.geglu_ffn(
                x, w1, b1, w2, b2, impl="cuda"), iters)[0],
            "xla_route_ms": chip_smoke.time_ms(lambda: geglu.geglu_block_xla(
                x, lns, lnb, w1, b1, w2, b2), iters)[0],
            "library_ms": chip_smoke.time_ms(lambda: (
                F.linear(u, w1t), F.linear(y, w2t)), iters)[0],
            "bound_ms": chip_smoke.geglu_bound(rows, C, bf16)[0],
        }
        inner = 4 * C
        if hasattr(geglu, "plan"):
            how = geglu.plan(dev, bf16, rows, C, inner)
            rec["plan"] = how
            rec["modelled_weight_mb"] = modelled_weight_bytes(
                how, C, inner, 2) / 1e6
        else:
            tiles = -(-rows // geglu.rows_per_block(bf16, C))
            rec["modelled_weight_mb"] = tiles * 3.0 * C * inner * 2 / 1e6
        return rec

    for _ in range(args.repeat):
        out = {"root": root}
        for name, shapes in (("serving", chip_smoke.GEGLU_SERVE_SHAPES),
                             ("training", chip_smoke.GEGLU_TRAIN_SHAPES)):
            recs = {f"{rows}x{C}": level(rows, C) for rows, C in shapes}
            out[name] = recs
            family = {}
            for key in ("block_ms", "xla_route_ms"):
                family[key] = sum(n * r[key] for n, r in
                                  zip(PER_UNET, recs.values()))
            out[f"{name}_ff_family_ms"] = family
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
