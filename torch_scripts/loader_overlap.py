#!/usr/bin/env python3
"""Does the face-ID loader's thread slow a personalisation train step?

    python3 torch_scripts/loader_overlap.py [--rounds 3] [--steps 8]

Assembles ``configs/aigc_id.yaml`` at full Stable Diffusion v1 width on random
weights (bf16 compute, the UNet's output convs drawn) and runs
``Trainer.fit`` (batch 2, 512x512 images and faces, uncached) in turns on

* ``loader``: ``data.face_id.PrefetchLoader`` over a pickle of three
  random-pixel 512x512 PNGs, its thread decoding and augmenting while the
  steps run, as ``cli/train.py`` feeds the trainer;
* ``ready``: the same loader's batches, made before the run (the thread is
  idle while the steps run);
* ``thread``: the ``ready`` batches, while a thread of this process decodes
  and augments dataset items without a pause (``churn``);
* ``process``: the ``ready`` batches, while a process of its own does the
  same ``churn``.

``thread`` and ``process`` load the host alike, but only ``thread`` shares
this process's interpreter lock: if both slow the step, the host's cores
are the contention; if only ``thread`` does, the lock is.  Each side copies
its batches to the card in the step loop.  Every mode runs twice a round:
with the trainer's captured step (a CUDA graph: a step is one replay, and
the main thread waits on the card instead of launching kernels) and with
its eager step (``step_fn.eager``), in turns.  Prints, for the GPU it runs
on, the median ms per step (``metrics.jsonl`` ``step_time_s``, steps 2 on:
a captured run's first step warms up and captures) and ms waiting for the
batch (``data_wait_s``) of every run, and one JSON line at the end.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import face_crops  # noqa: E402

from celebbasis_tpu_torch.cli.serve import encode_png  # noqa: E402
from celebbasis_tpu_torch.data.face_id import (FaceIdDataset,  # noqa: E402
                                               PrefetchLoader)
from celebbasis_tpu_torch.loader import assemble, init_weights  # noqa: E402
from celebbasis_tpu_torch.train.trainer import (Trainer,  # noqa: E402
                                                TrainerConfig)
from celebbasis_tpu_torch.utils.config import load_run_spec  # noqa: E402


def medians(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f][1:]
    return (float(np.median([r["step_time_s"] for r in recs])) * 1e3,
            float(np.median([r["data_wait_s"] for r in recs])) * 1e3)


def churn(data_cfg, stop, busy) -> None:
    """The loader's per-item work (decode, augment) over and over, until
    ``stop`` is set; ``busy`` is set after the first item."""
    ds = FaceIdDataset(data_cfg)
    i = 0
    while not stop.is_set():
        ds[i % len(ds)]
        i += 1
        busy.set()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    spec = load_run_spec([os.path.join(REPO, "configs", "aigc_id.yaml")])
    spec.celeb_txt = os.path.join(REPO, "infer_images", "wiki_names_v2.txt")
    asm = assemble(spec, image_size=512, seed=1, cache_dir=None)
    init_weights(asm.pipeline.unet,
                 torch.Generator(device="cuda").manual_seed(5),
                 zero_convs=False)
    work = tempfile.mkdtemp(prefix="loader_overlap_")
    try:
        paths = []
        for i, img in enumerate(face_crops(512, 77, k=3)):
            paths.append(os.path.join(work, f"{i:05d}.png"))
            with open(paths[-1], "wb") as f:
                f.write(encode_png(img))
        spec.train_data.pickle_path = os.path.join(work, "faces.pickle")
        with open(spec.train_data.pickle_path, "wb") as f:
            pickle.dump(paths, f)

        def loader():
            return PrefetchLoader(FaceIdDataset(spec.train_data),
                                  asm.tokenizer, 2, face_size=512, seed=23)

        it = iter(loader())
        ready = [next(it) for _ in range(args.steps)]
        it.close()
        modes = ("loader", "ready", "thread", "process")
        spawn = multiprocessing.get_context("spawn")
        runs = {f"{mode}_{way}": [] for mode in modes
                for way in ("graph", "eager")}
        for r in range(args.rounds):
            order = modes[r % 4:] + modes[:r % 4]
            ways = ("graph", "eager") if r % 2 == 0 else ("eager", "graph")
            for mode, way in ((m, w) for m in order for w in ways):
                cfg = TrainerConfig(logdir=work, suffix=f"{mode}{way}{r}",
                                    max_steps=args.steps, log_every=1,
                                    ckpt_every=10 ** 6, seed=23)
                trainer = Trainer(asm.pipeline, asm.meta_net, asm.basis,
                                  loader() if mode == "loader" else ready,
                                  cfg)
                if way == "eager":
                    trainer.step_fn = trainer.step_fn.eager
                side = None
                if mode in ("thread", "process"):
                    lib = threading if mode == "thread" else spawn
                    stop, busy = lib.Event(), lib.Event()
                    make = (threading.Thread if mode == "thread"
                            else spawn.Process)
                    side = make(target=churn, daemon=True,
                                args=(spec.train_data, stop, busy))
                    side.start()
                    if not busy.wait(300):
                        raise RuntimeError(f"the {mode} churn did not start")
                try:
                    trainer.fit(trainer.init_state(asm.manager_state))
                finally:
                    if side is not None:
                        stop.set()
                        side.join(60)
                step_ms, wait_ms = medians(trainer.run_dir)
                runs[f"{mode}_{way}"].append({"step_ms": step_ms,
                                              "wait_ms": wait_ms})
                print(f"round {r} {mode} {way}: ms per step {step_ms:.1f}, "
                      f"ms waiting for the batch {wait_ms:.2f}", flush=True)
                del trainer
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"card": card, "steps": args.steps, "runs": runs,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
