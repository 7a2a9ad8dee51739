#!/usr/bin/env python3
"""Does the card-against-CPU check of the landmark trainers refuse TF32?

    python3 torch_scripts/align_train_tf32_probe.py

Writes ``chip_smoke.py``'s synthetic raw WFLW and data_300W_CELEBA layouts,
cuts them with ``cli/preprocess_pipnet.py`` and takes one step of each
trainer (PIPNet ResNet-101 at batch 2, PIPNetGSSL ResNet-18 at batch 4 with
the four task codes) from one seeded state on the card and on the CPU
(``chip_smoke.step_parity``) twice:

* ``fp32``: as the smoke's ``align_train`` phase does (TF32 off);
* ``tf32``: with TF32 left on for the card's convolutions and products (the
  trainers' ``no_tf32`` replaced by a context that does nothing).

Prints each record beside ``chip_smoke.ALIGN_TRAIN_TOL`` and which limits
it breaks, and one JSON line at the end.  Needs a CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from celebbasis_tpu_torch.align import pipnet_gssl as pg  # noqa: E402
from celebbasis_tpu_torch.align import pipnet_train as pt  # noqa: E402
from celebbasis_tpu_torch.cli import preprocess_pipnet  # noqa: E402
from celebbasis_tpu_torch.cli.train_pipnet import (  # noqa: E402
    load_labels, load_meanface)

LIMIT_OF = {"loss": "loss_rel_err", "grad_rel_l2_median": "grad_rel_l2_median",
            "grad_rel_l2_max": "grad_rel_l2_max",
            "param_lr_max": "param_err_lr_max",
            "param_lr_mean": "param_err_lr_mean",
            "param_share_over_half_lr": "param_share_over_half_lr"}


@contextlib.contextmanager
def tf32_on_the_card():
    saved = (pt.no_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    pt.no_tf32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (pt.no_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("align_train_tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    work = tempfile.mkdtemp(prefix="tf32_probe_")
    try:
        root = os.path.join(work, "pipnet_data")
        cs.write_pipnet_raw(root, 51)
        for name in ("WFLW", "CELEBA", "data_300W_CELEBA"):
            preprocess_pipnet.main([name, "--root", root, "--quiet"])
        wflw = os.path.join(root, "WFLW")
        gssl = os.path.join(root, "data_300W_CELEBA")
        cases = {
            "pipnet": (*cs._normalised_crops(
                os.path.join(wflw, "images_train"),
                load_labels(os.path.join(wflw, "train.txt"))[:2]),
                load_meanface(os.path.join(wflw, "meanface.txt")), None),
            "gssl": (*cs._normalised_crops(
                os.path.join(gssl, "images_train"),
                load_labels(os.path.join(gssl, "train_300W.txt"))[:4]),
                load_meanface(os.path.join(gssl, "meanface.txt")),
                torch.tensor([pg.TASK_STD, pg.TASK_CLS1, pg.TASK_CLS2,
                              pg.TASK_CLS3]))}
        out = {}
        for mode in ("fp32", "tf32"):
            for kind, (x, lms, meanface, task) in cases.items():
                ctx = (tf32_on_the_card() if mode == "tf32"
                       else contextlib.nullcontext())
                with ctx:
                    rec = cs.step_parity(kind, x, lms, meanface, task=task)
                rec["breaks"] = sorted(
                    lim for lim, key in LIMIT_OF.items()
                    if rec[key] > cs.ALIGN_TRAIN_TOL[lim])
                out[f"{kind}_{mode}"] = rec
                print(f"[probe] {kind} {mode}: {json.dumps(rec)}",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"limits": cs.ALIGN_TRAIN_TOL, "records": out,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
