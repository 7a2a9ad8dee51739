#!/usr/bin/env python3
"""Device times of the flash-attention kernels (bf16, packed) at the SD v1
UNet's attention shapes, beside their bounds and the library's times, and
the host time of one eager forward launch.

    python3 torch_scripts/time_flash.py [--root DIR] [--repeat N]

For each SD v1 level (N tokens, head dim D; 8 heads) with M = N and M = 77
keys:

* serving (batch 4, classifier-free guidance): the inference forward
  (``flash_attention_nhd``);
* training (batch 2): the forward with logsumexp (``flash_attention_lse``),
  ``dq`` and ``dkv`` (each one kernel launch through ``flash_attention_bwd``).

Each kernel's ms is a CUDA-graph replay as in ``chip_smoke.time_ms``, beside
its bound (``chip_smoke.bound`` / ``train_bound``) and the library's time:
``F.scaled_dot_product_attention`` for a forward, ``autograd.grad`` through
it (dq+dk+dv together, less its forward) for the backward.  A forward also
gets its exponential floor, ``B*H*N*M`` ex2 over 16 a clock per SM at the
card's maximum SM clock (``nvidia-smi clocks.max.sm``), and, where the timed
library reports it (``flash_attention_fwd_plan``), its grid
(``chip_smoke.fwd_grid``).

``host_us`` is what the host spends to issue one eager forward launch,
which CUDA-graph timing does not see: the C entry ``flash_attention_fwd``
called through ctypes alone (no wrapper, no allocation) at the 64-token
level (batch 4, D = 160, M = 64), 200 calls a round behind a sleeping
kernel that keeps the stream busy, so that no call waits for the card;
the wall time of a round's calls over 200, median and least of
``HOST_ROUNDS`` rounds.  ``--host-vs DIR`` reads it for this checkout's
library and DIR's in one process, in rounds alternating A B B A, and
prints only that (the two medians, the two least readings, and the median
of the paired differences, DIR's less this one's).

``--root`` times the ``celebbasis_tpu_torch`` package of another checkout
(e.g. a parent commit unpacked into a git-ignored directory), so that two
versions can be compared in turns on one card.  Needs a CUDA device; prints
the card and one JSON line per repeat.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_LAUNCHES, HOST_ROUNDS = 200, 40
HOST_SLEEP_CYCLES = 20_000_000   # about 10 ms at the H100's SM clock


def exp_floor_ms(B, H, N, M, sms, clock_mhz):
    """One ex2 a score over the MUFU unit: 16 a clock per SM."""
    return B * H * N * M / (16.0 * sms * clock_mhz * 1e6) * 1e3


def host_launch(fn, stream):
    """A call of `fn` (an inference forward C entry of either checkout) at
    the 64-token serving shape, and the tensors it reads and writes."""
    import torch
    from celebbasis_tpu_torch.ops import flash_attention as fa

    B, H, N, D = 4, 8, 64, 160
    q, k, v, o = (torch.randn(B, N, H * D, device="cuda").to(torch.bfloat16)
                  for _ in range(4))
    strides = fa._stride_array((q, k, v, o), H)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B, H,
            N, N, D, strides, D ** -0.5, stream)
    return (lambda: fn(*args)), (q, k, v, o, strides)


def host_us(call) -> float:
    """Host microseconds per call of `call`, over one round of
    HOST_LAUNCHES calls queued behind a sleeping kernel."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(HOST_LAUNCHES):
        rc = call()
    us = (time.perf_counter() - t0) / HOST_LAUNCHES * 1e6
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd failed ({rc})")
    return us


def forward_entry(lib):
    """The inference forward C entry of a loaded library, typed."""
    from celebbasis_tpu_torch.ops import flash_attention as fa

    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = fa._SIGNATURES["flash_attention_fwd"][1] + [ctypes.c_void_p]
    return fn


def host_ab(other: str) -> dict:
    """This checkout's forward library against `other`'s, host time per
    launch, in rounds alternating A B B A."""
    import torch
    from celebbasis_tpu_torch.ops import cuda_build

    spec = importlib.util.spec_from_file_location(
        "other_cuda_build",
        os.path.join(other, "celebbasis_tpu_torch", "ops", "cuda_build.py"))
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    keep = []
    for side, lib in (("this", cuda_build.load("flash_attention_fwd")),
                      ("other", ctypes.CDLL(
                          other_build.build("flash_attention_fwd")))):
        call, tensors = host_launch(forward_entry(lib), stream)
        keep.append(tensors)
        for _ in range(20):
            call()
        calls[side] = call
    readings = {"this": [], "other": []}
    for r in range(HOST_ROUNDS):
        for side in (("this", "other") if r % 2 == 0 else ("other", "this")):
            readings[side].append(host_us(calls[side]))
    diffs = [b - a for a, b in zip(readings["this"], readings["other"])]
    return {"this": REPO, "other": other,
            "host_us_median": {s: float(np.median(x))
                               for s, x in readings.items()},
            "host_us_least": {s: min(x) for s, x in readings.items()},
            "other_less_this_median_us": float(np.median(diffs)),
            "rounds": HOST_ROUNDS, "launches_a_round": HOST_LAUNCHES,
            "host_us": readings}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=REPO,
                    help="checkout whose celebbasis_tpu_torch is timed")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--host-vs", metavar="DIR",
                    help="only the host time per launch, this checkout's "
                         "library against DIR's")
    args = ap.parse_args()
    if args.host_vs:
        import torch
        sys.path.insert(0, REPO)
        import chip_smoke
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        print(chip_smoke.smi_line(), flush=True)
        print(json.dumps(host_ab(os.path.abspath(args.host_vs))), flush=True)
        return 0
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from celebbasis_tpu_torch.ops import cuda_build
    from celebbasis_tpu_torch.ops import flash_attention as fa
    if not os.path.abspath(fa.__file__).startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")
    sys.path.insert(1, REPO)
    import chip_smoke   # time_ms, bound, train_bound, the levels
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line(), flush=True)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    F = torch.nn.functional
    H, bf16 = chip_smoke.H_SERVE, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    has_plan = hasattr(cuda_build.load("flash_attention_fwd"),
                       "flash_attention_fwd_plan")

    def inputs(B, N, M, D, extra=0):
        g = torch.Generator(device="cuda").manual_seed(N + M + D + extra)
        mk = lambda L: torch.randn(B, L, H * D, device="cuda",
                                   generator=g).to(bf16)
        return mk(N), mk(M), mk(M), mk(N)

    def forward_record(B, N, M, D, run, q, k, v, iters):
        q4, k4, v4 = (fa._split(x, H) for x in (q, k, v))
        rec = {"ms": chip_smoke.time_ms(run, iters)[0],
               "sdpa_ms": chip_smoke.time_ms(
                   lambda: F.scaled_dot_product_attention(q4, k4, v4),
                   iters)[0],
               "exp_floor_ms": exp_floor_ms(B, H, N, M, sms, clock)}
        if has_plan:
            rec["grid"] = chip_smoke.fwd_grid(B, H, N, M, D)
        return rec

    for _ in range(args.repeat):
        serving, training = {}, {}
        for N, D in chip_smoke.SERVE_LEVELS:
            for M in (N, 77):
                iters = 10 if N * M >= 1 << 22 else 50
                label = f"{N}x{M}/D={D}"
                B = chip_smoke.B_SERVE
                q, k, v, _ = inputs(B, N, M, D)
                rec = forward_record(
                    B, N, M, D, lambda: fa.flash_attention_nhd(q, k, v, H),
                    q, k, v, iters)
                rec["bound_ms"] = chip_smoke.bound(B, H, N, M, D, bf16)[0]
                serving[label] = rec

                B = chip_smoke.B_TRAIN
                q, k, v, do = inputs(B, N, M, D, extra=1)
                o, lse = fa.flash_attention_lse(q, k, v, H)
                delta = fa.flash_attention_delta(o, do, H)
                rec = {"fwd_lse": forward_record(
                    B, N, M, D, lambda: fa.flash_attention_lse(q, k, v, H),
                    q, k, v, iters)}
                rec["fwd_lse"]["bound_ms"] = chip_smoke.train_bound(
                    "fwd_lse", B, H, N, M, D, bf16)[0]
                for name, kw in (("dq", {"need_dkv": False}),
                                 ("dkv", {"need_dq": False})):
                    rec[name] = {
                        "ms": chip_smoke.time_ms(
                            lambda: fa.flash_attention_bwd(
                                q, k, v, o, lse, do, H, delta=delta, **kw),
                            iters)[0],
                        "bound_ms": chip_smoke.train_bound(
                            name, B, H, N, M, D, bf16)[0]}
                q4, k4, v4, do4 = (fa._split(x, H) for x in (q, k, v, do))
                leaves = [x.detach().clone().requires_grad_(True)
                          for x in (q4, k4, v4)]

                def library():
                    torch.autograd.grad(F.scaled_dot_product_attention(
                        *leaves), leaves, do4)

                rec["library_bwd_ms"] = chip_smoke.time_ms(library, iters)[0] \
                    - rec["fwd_lse"]["sdpa_ms"]
                if hasattr(fa, "dkv_split_plan"):
                    rec["dkv"]["splits"] = fa.dkv_split_plan(B, H, N, M, D,
                                                             sms)[0]
                training[label] = rec

        call, _tensors = host_launch(
            forward_entry(cuda_build.load("flash_attention_fwd")),
            torch.cuda.current_stream().cuda_stream)
        for _ in range(20):
            call()
        rounds = [host_us(call) for _ in range(HOST_ROUNDS)]
        print(json.dumps({"root": root, "sms": sms, "clock_mhz": clock,
                          "host_us_median": float(np.median(rounds)),
                          "host_us_least": min(rounds),
                          "serving_ms": serving, "training_ms": training}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
