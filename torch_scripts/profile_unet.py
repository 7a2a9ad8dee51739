#!/usr/bin/env python3
"""Where one denoising step of the PyTorch/CUDA port spends its time.

    python3 torch_scripts/profile_unet.py [--steps 5] [--batch 2]

Builds the SD v1 UNet of ``celebbasis_tpu_torch`` at full width on random
bf16 weights, runs classifier-free-guidance forwards (batch doubled, 64x64
latents, 77x768 context) on the GPU, and prints

* the wall time of one CFG forward (host clock around a synchronised
  loop) and the share of it the device was busy (sum of kernel times from
  ``torch.profiler`` over the same loop);
* device time by kernel family: the hand-written flash attention, cuDNN /
  cuBLAS convolutions and matrix products, normalisations, elementwise;
* the same forward with attention on the plain route, for the end-to-end
  effect of the kernel;
* the same forward with the FF sub-blocks on the GEGLU kernel route against
  the default plain route (attention on its kernel route on both sides): wall
  time in turns, device time by family and peak memory of each.

Needs a CUDA device; prints one JSON line at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from celebbasis_tpu_torch.diffusion.sampler import guided_eps  # noqa: E402
from celebbasis_tpu_torch.loader import init_weights  # noqa: E402
from celebbasis_tpu_torch.models.unet import UNetConfig, UNetModel  # noqa: E402
from celebbasis_tpu_torch.ops import attention as attn_ops  # noqa: E402
from celebbasis_tpu_torch.ops import geglu  # noqa: E402
from celebbasis_tpu_torch.utils.precision import cast_float_params  # noqa: E402

FAMILIES = (
    ("flash_attention", ("flash_fwd", "flash_bwd")),
    ("geglu", ("geglu_",)),
    ("conv", ("conv", "cudnn", "implicit_gemm", "fprop", "xmma")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet", "splitk")),
    ("norm", ("norm", "RowwiseMoments", "welford")),
    ("softmax", ("softmax",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "elementwise_and_copies"


def wall_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms_by_family(fn, iters):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out, flash = {}, {}
    for ev in p.key_averages():
        dev = getattr(ev, "self_device_time_total", 0) or 0
        if dev and getattr(ev, "device_type", None) is not None \
                and "cuda" in str(ev.device_type).lower():
            fam = family(ev.key)
            out[fam] = out.get(fam, 0.0) + dev / 1e3 / iters
            if fam == "flash_attention":
                flash[ev.key] = {"launches_per_forward": ev.count / iters,
                                 "mean_device_us": dev / ev.count}
    return out, flash


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        unet = UNetModel(UNetConfig.sd_v1(), torch.bfloat16)
    unet.requires_grad_(False).eval()
    init_weights(unet, gen, zero_convs=False)
    cast_float_params(unet, torch.bfloat16)
    B = args.batch
    x = torch.randn(B, 64, 64, 4, device="cuda", generator=gen)
    t = torch.full((B,), 500, device="cuda", dtype=torch.int64)
    cond = torch.randn(B, 77, 768, device="cuda", generator=gen)
    uncond = torch.randn(B, 77, 768, device="cuda", generator=gen)

    @torch.inference_mode()
    def step():
        return guided_eps(unet, x, t, cond, uncond, 10.0)

    result = {"card": card, "batch": B, "steps": args.steps}
    for route in ("cuda", "xla", "xla", "cuda"):     # in turns, one process
        attn_ops.set_default_impl(route)
        ms = wall_ms(step, args.steps)
        result.setdefault(f"cfg_forward_ms_{route}", []).append(ms)
        print(f"attention route {route}: {ms:.2f} ms per CFG forward")
    attn_ops.set_default_impl(None)
    fams, flash = device_ms_by_family(step, args.steps)
    busy = sum(fams.values())
    wall = min(result["cfg_forward_ms_cuda"])
    if busy <= 0:
        print("torch.profiler reported no device time; only wall times are "
              "valid")
    else:
        for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"  {fam:24s} {ms:7.3f} ms  {100 * ms / busy:5.1f}% of "
                  f"device time")
        for name, rec in sorted(flash.items()):
            label = re.search(r"flash_(fwd|bwd)_\w+<[^>]*>", name)
            print(f"  {label.group(0) if label else name}: "
                  f"{rec['launches_per_forward']:.0f} launches per forward, "
                  f"mean {rec['mean_device_us']:.1f} us on the device")
        print(f"device busy {busy:.2f} ms of {wall:.2f} ms wall: idle share "
              f"{100 * max(0.0, 1 - busy / wall):.1f}%")
    result.update(device_ms_by_family=fams, device_busy_ms=busy,
                  flash_kernels=flash)
    result.update(geglu_routes(step, args.steps, "forward"))
    print(json.dumps(result))
    return 0


def geglu_routes(fn, iters, what):
    """`fn` with the FF sub-blocks on the plain and on the kernel GEGLU
    route: wall ms in turns, then device ms by family and peak memory of
    one call on each route."""
    out = {}
    for route in ("xla", "cuda", "cuda", "xla"):     # in turns, one process
        geglu.set_default_impl(route)
        ms = wall_ms(fn, iters)
        out.setdefault(f"geglu_{route}_ms", []).append(ms)
        print(f"GEGLU route {route}: {ms:.2f} ms per {what}")
    for route in ("xla", "cuda"):
        geglu.set_default_impl(route)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[f"geglu_{route}_peak_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        fams, _ = device_ms_by_family(fn, iters)
        out[f"geglu_{route}_device_ms_by_family"] = fams
        busy = sum(fams.values())
        print(f"GEGLU route {route}: device busy {busy:.2f} ms per {what}, "
              f"peak {out[f'geglu_{route}_peak_gib']:.2f} GiB; "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                  fams.items(), key=lambda kv: -kv[1])))
    geglu.set_default_impl(None)
    return out


if __name__ == "__main__":
    sys.exit(main())
