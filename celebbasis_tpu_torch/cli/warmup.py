"""Build and capture the standard paths before a run (counterpart of
``celebbasis_tpu/cli/warmup.py``).

The JAX command pre-compiles the txt2img sampler and the personalisation
train step into XLA's persistent compilation cache, so that interactive runs
start hot.  The port's counterparts:

* **the kernel libraries** (``ops/cuda_build.py``: one ``nvcc`` per source
  under ``celebbasis_tpu_torch/csrc``, into ``celebbasis_tpu_torch/_build/``,
  named by a hash of source and flags) are what persists: every later run
  loads them instead of compiling.  This command builds every library the
  paths load (the flash forward and backward, and the opt-in GEGLU route's);
* **the CUDA graphs** (``utils/graphs.py``) take the place of the compiled
  programs.  A graph lives only in the process that captured it, so this
  command captures the txt2img graph (the sampler's ``--ddim_steps`` DDIM
  chain at ``--n_samples`` rows with guidance 10, uint8 output, the weights
  in ``--precision``) and the train-step graph (batch ``--batch_size``, two
  faces, float32 weights), prints how long each capture took, and so shows
  that both capture on this card.  A capture that fails raises and the
  command exits non-zero.

``--cache_dir`` keeps the JAX flag and default: nothing there can hold a
graph, so the command writes ``warmup.json`` there (the libraries built and
the seconds of each build and capture), beside the libraries it built.

Runs on ``cuda``; ``--device cpu`` runs the same paths eagerly on the CPU
(no kernel is built, no graph exists there).

    python -m celebbasis_tpu_torch.cli.warmup --config configs/aigc_id.yaml
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_kernels() -> dict:
    """Builds every kernel library the paths load; name -> path."""
    from celebbasis_tpu_torch.ops import cuda_build
    from celebbasis_tpu_torch.ops import flash_attention, geglu
    return cuda_build.build_all(flash_attention.LIBRARIES + geglu.LIBRARIES)


def warm_sample(asm, args) -> float:
    """Captures the txt2img graph; returns the seconds of its first call."""
    from celebbasis_tpu_torch.diffusion.sampler import sample_seed

    pipe, dev, B = asm.pipeline, asm.device, args.n_samples
    fn = pipe.make_txt2img_fn(num_steps=args.ddim_steps, guidance_scale=10.0,
                              image_size=args.image_size, output="uint8")
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    k = len(pipe.manager_cfg.placeholder_token_ids)
    gens = [torch.Generator(device=dev).manual_seed(sample_seed(0, j))
            for j in range(B)]
    t0 = time.perf_counter()
    imgs = fn(asm.manager_state, asm.basis,
              as_dev(asm.tokenizer(["a photo of a sks person"] * B)),
              as_dev(asm.tokenizer([""] * B)), as_dev(np.zeros((B, k))),
              as_dev(np.ones(B)), gens)
    imgs.cpu()
    return time.perf_counter() - t0


def warm_train(asm, args) -> float:
    """Captures the train-step graph; returns the seconds of its first
    call."""
    from celebbasis_tpu_torch.train import step as tstep

    pipe, dev = asm.pipeline, asm.device
    trainable = tstep.build_trainable(asm.meta_net)
    opt = tstep.make_optimizer(trainable, 1e-2)
    step_fn = tstep.make_train_step(pipe, asm.meta_net, opt)
    state = tstep.init_train_state(
        torch.Generator(device=dev).manual_seed(0), trainable, opt,
        asm.manager_state)
    B, k, s = args.batch_size, 2, args.image_size
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    batch = {
        "image": torch.zeros((B, s, s, 3), device=dev),
        "tokens": as_dev(asm.tokenizer(["a face of sks person"] * B)),
        "faces": torch.zeros((B, k, s, s, 3), device=dev),
        "ids": as_dev(np.zeros((B, k))),
        "num_ids": as_dev(np.ones(B)),
    }
    t0 = time.perf_counter()
    _, logs = step_fn(state, asm.basis, batch)
    float(logs["loss"])
    return time.perf_counter() - t0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--cache_dir", type=str, default=".cache/jax")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--n_samples", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_sample", action="store_true")
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16",
                   help="match the inference CLIs' weight-storage precision "
                        "so the captured graph is the one they run")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> dict:
    """Returns the record written to ``<cache_dir>/warmup.json``."""
    args = build_argparser().parse_args(argv)
    from celebbasis_tpu_torch.loader import assemble, resolve_device
    from celebbasis_tpu_torch.utils.config import load_run_spec
    from celebbasis_tpu_torch.utils.precision import cast_float_params

    os.makedirs(args.cache_dir, exist_ok=True)
    record = {"device": str(resolve_device(args.device))}
    if record["device"].startswith("cuda"):
        t0 = time.perf_counter()
        libs = build_kernels()
        record["build_s"] = time.perf_counter() - t0
        record["libraries"] = sorted(os.path.basename(p)
                                     for p in libs.values())
        print(f"[warmup] kernels built in {record['build_s']:.1f}s: "
              f"{', '.join(record['libraries'])}")
    spec = load_run_spec(args.config)
    asm = assemble(spec, image_size=args.image_size, device=args.device)
    # training keeps float32 weights (its parity default); the sampling
    # CLIs store them in --precision, so the train step is captured first
    if not args.skip_train:
        record["train_s"] = warm_train(asm, args)
        print(f"[warmup] train step graph captured in "
              f"{record['train_s']:.1f}s")
    if not args.skip_sample:
        if args.precision == "bf16":
            cast_float_params(asm.pipeline, torch.bfloat16)
        record["txt2img_s"] = warm_sample(asm, args)
        print(f"[warmup] txt2img graph captured in "
              f"{record['txt2img_s']:.1f}s")
    path = os.path.join(os.path.abspath(args.cache_dir), "warmup.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[warmup] record at {path}")
    return record


if __name__ == "__main__":
    main()
