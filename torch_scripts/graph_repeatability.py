#!/usr/bin/env python3
"""Does a train step repeat its bits, eagerly and on its CUDA graph?

    python3 torch_scripts/graph_repeatability.py

Assembles ``configs/tiny.yaml`` (32x32, the UNet's output convs drawn) on
the card and takes three uncached train steps from one state three times:
eagerly, eagerly again, and on the step's CUDA graph (``train.step``), in
float32 and in bfloat16 compute, each with and without
``torch.backends.cudnn.deterministic``.  Prints, for each case, the largest
difference of the losses, the MLP gradients, the MLP parameters after AdamW
and the manager state, eager against eager and graph against eager (0 is
bit for bit).  A graph can only repeat the bits its eager run repeats.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from celebbasis_tpu_torch.loader import assemble, init_weights  # noqa: E402
from celebbasis_tpu_torch.train import step as tstep  # noqa: E402
from celebbasis_tpu_torch.utils.config import load_run_spec  # noqa: E402

CFG = os.path.join(REPO, "configs", "tiny.yaml")


def steps(asm, batch, start, eager):
    """Three steps from the MLP weights ``start``: their losses, then the
    last gradients, parameters and manager state."""
    meta = asm.meta_net
    with torch.no_grad():
        for p, p0 in zip(meta.mlp.parameters(), start):
            p.copy_(p0)
    trainable = tstep.build_trainable(meta)
    opt = tstep.make_optimizer(trainable, 1e-2)
    step = tstep.make_train_step(asm.pipeline, meta, opt)
    state = tstep.init_train_state(
        torch.Generator(device="cuda").manual_seed(1), trainable, opt,
        asm.manager_state)
    fn = step.eager if eager else step
    out = {"loss": []}
    for _ in range(3):
        state, logs = fn(state, asm.basis, batch)
        out["loss"].append(logs["loss"].clone())
    out["grads"] = [p.grad.clone() for p in trainable["meta"]]
    out["params"] = [p.detach().clone() for p in trainable["meta"]]
    out["manager"] = list(state.manager_state)
    return out


def largest(a, b):
    return {k: max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a[k], b[k])) for k in a}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    r = np.random.default_rng(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            asm = assemble(load_run_spec([CFG]), image_size=32,
                           device="cuda", dtype=dtype)
            init_weights(asm.pipeline.unet, torch.Generator(device="cuda")
                         .manual_seed(5), zero_convs=False)
            dev = lambda a, dt=torch.float32: torch.as_tensor(
                a, device="cuda", dtype=dt)
            batch = {"image": dev(r.uniform(-1, 1, (2, 32, 32, 3))),
                     "tokens": dev(asm.tokenizer(["a sks person",
                                                  "a ks person"]),
                                   torch.int64),
                     "faces": dev(r.uniform(-1, 1, (2, 2, 32, 32, 3))),
                     "ids": dev([[0, 1], [1, 0]], torch.int64),
                     "num_ids": dev([2, 1], torch.int64)}
            start = [p.detach().clone() for p in asm.meta_net.mlp.parameters()]
            a = steps(asm, batch, start, eager=True)
            b = steps(asm, batch, start, eager=True)
            g = steps(asm, batch, start, eager=False)
            row = {"dtype": str(dtype).split(".")[-1],
                   "cudnn_deterministic": deterministic,
                   "eager_vs_eager": largest(a, b),
                   "graph_vs_eager": largest(g, a)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    torch.backends.cudnn.deterministic = False
    print(json.dumps({"rows": rows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
