#!/usr/bin/env python3
"""Where one personalisation train step of the PyTorch/CUDA port spends its
time.

    python3 torch_scripts/profile_train_step.py [--steps 5]

Assembles ``configs/aigc_id.yaml`` at full Stable Diffusion v1 width on random
weights (bf16 compute), builds the train step of
``celebbasis_tpu_torch.train.step`` (batch 2, 512x512 images, two 512x512
faces per sample, synthetic batches) and prints, for the GPU it runs on,

* the wall time of one step (host clock around a synchronised loop) with
  attention on the kernel route and on the plain route, in turns, for the
  uncached step with float32 and with bf16 storage of the frozen nets, and
  for the cached step;
* for the uncached step: the share of the wall time the device was busy and
  device time by kernel family (``torch.profiler``), with every flash kernel
  instantiation's launches per step and mean device time;
* peak device memory of a step;
* the uncached step (float32 storage) with the FF sub-blocks on the GEGLU
  kernel route against the plain route: wall time in turns, device time by
  family and peak memory of each;
* the uncached and the cached step (float32 storage) captured as CUDA graphs
  (``train.step``'s default on a card) against the same steps run eagerly,
  in turns: wall time, device busy time and idle share of each.

Every section but the last runs the steps eagerly (``step.eager``), as
earlier versions of this script did.

Needs a CUDA device; prints one JSON line at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (synthetic_batch)
from profile_unet import (device_ms_by_family, geglu_routes,  # noqa: E402
                          graph_vs_eager, wall_ms)

from celebbasis_tpu_torch.loader import assemble, init_weights  # noqa: E402
from celebbasis_tpu_torch.ops import attention as attn_ops  # noqa: E402
from celebbasis_tpu_torch.train import step as tstep  # noqa: E402
from celebbasis_tpu_torch.utils.config import RunSpec, load_run_spec  # noqa: E402
from celebbasis_tpu_torch.utils.precision import cast_float_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    config = os.path.join(REPO, "configs", "aigc_id.yaml")
    try:
        spec = load_run_spec([config])
    except ImportError:
        spec = RunSpec.sd_v1()
    spec.celeb_txt = os.path.join(REPO, "infer_images", "wiki_names_v2.txt")
    asm = assemble(spec, image_size=512, seed=1, dtype=torch.bfloat16,
                   cache_dir=None)
    pipe, meta = asm.pipeline, asm.meta_net
    init_weights(pipe.unet, torch.Generator(device="cuda").manual_seed(5),
                 zero_convs=False)
    batches = [chip_smoke.synthetic_batch(asm.tokenizer, 512, 512, 100 + i,
                                          "cuda") for i in range(2)]
    trainable = tstep.build_trainable(meta)
    opt = tstep.make_optimizer(trainable, 1e-2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = tstep.init_train_state(gen, trainable, opt, asm.manager_state)
    uncached = tstep.make_train_step(pipe, meta, opt)
    cached_fn = tstep.make_cached_train_step(pipe, meta, opt)
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        uncached.eager(state, asm.basis, batches[calls["n"] % 2])

    def graph_step():
        calls["n"] += 1
        uncached(state, asm.basis, batches[calls["n"] % 2])

    result = {"card": card, "steps": args.steps}

    def ab(label, fn):
        for route in ("cuda", "xla", "xla", "cuda"):   # in turns, one process
            attn_ops.set_default_impl(route)
            ms = wall_ms(fn, args.steps)
            result.setdefault(f"{label}_ms_{route}", []).append(ms)
            print(f"{label}, attention route {route}: {ms:.2f} ms per step")
        attn_ops.set_default_impl(None)

    ab("uncached_fp32_storage", step)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    result["peak_gib_fp32_storage"] = torch.cuda.max_memory_allocated() / 2**30
    fams, flash = device_ms_by_family(step, args.steps)
    busy = sum(fams.values())
    wall = min(result["uncached_fp32_storage_ms_cuda"])
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:24s} {ms:7.3f} ms  {100 * ms / busy:5.1f}% of device "
              f"time")
    for name, rec in sorted(flash.items()):
        label = re.search(r"flash_(fwd|bwd)_\w+<[^>]*>", name)
        print(f"  {label.group(0) if label else name}: "
              f"{rec['launches_per_forward']:.0f} launches per step, mean "
              f"{rec['mean_device_us']:.1f} us on the device")
    print(f"device busy {busy:.2f} ms of {wall:.2f} ms wall: idle share "
          f"{100 * max(0.0, 1 - busy / wall):.1f}%")
    result.update(device_ms_by_family=fams, device_busy_ms=busy,
                  flash_kernels=flash)

    result.update(geglu_routes(step, args.steps, "step"))

    cache = tstep.precompute_cache(pipe, meta, batches, 2)

    def cached_step():
        calls["n"] += 1
        cached_fn.eager(state, asm.basis, cache[calls["n"] % 2])

    def cached_graph_step():
        calls["n"] += 1
        cached_fn(state, asm.basis, cache[calls["n"] % 2])

    ab("cached_fp32_storage", cached_step)
    cfams, _ = device_ms_by_family(cached_step, args.steps)
    result.update(cached_device_ms_by_family=cfams,
                  cached_device_busy_ms=sum(cfams.values()))

    for label, eager, graph in (("uncached", step, graph_step),
                                ("cached", cached_step, cached_graph_step)):
        graph()                  # captures
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        graph()
        torch.cuda.synchronize()
        result[f"{label}_graph_peak_gib"] = \
            torch.cuda.max_memory_allocated() / 2**30
        print(f"{label} step, graph vs eager (float32 storage):")
        result.update({f"{label}_{k}": v for k, v in graph_vs_eager(
            eager, graph, args.steps, "step").items()})
    # the graphs read the weights where they lay at capture: none is
    # replayed after the cast below, whose sections run eagerly

    # bf16 storage of the frozen nets (TrainerConfig.frozen_bf16)
    cast_float_params(pipe, torch.bfloat16)
    cast_float_params(meta.fr_net, torch.bfloat16)
    ab("uncached_bf16_storage", step)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    result["peak_gib_bf16_storage"] = torch.cuda.max_memory_allocated() / 2**30
    bfams, _ = device_ms_by_family(step, args.steps)
    result.update(bf16_storage_device_ms_by_family=bfams,
                  bf16_storage_device_busy_ms=sum(bfams.values()))
    ab("cached_bf16_storage", cached_step)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
