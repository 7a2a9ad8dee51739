"""PIPNet landmark training (W0; counterpart of
``celebbasis_tpu/cli/train_pipnet.py``, the reference's ``python
lib/train.py experiments/WFLW/pip_32_16_60_r101_l2_l1_10_1_nb10.py``).

Reads the layout ``cli/preprocess_pipnet`` writes:

    <data_dir>/images_train/        training crops
    <data_dir>/train.txt            "<image> x1 y1 x2 y2 ..." (normalised)
    <data_dir>/meanface.txt         one line of 2L floats

and trains ``align/pipnet.py``'s PIPNet with ``align/pipnet_train.py`` (the
reference's loss and augmentations; every leaf trained, BatchNorm
statistics included, as in the JAX package), fp32 with TF32 off.  The net
starts from a seeded random init.  Checkpoints land in
``<save_dir>/epoch<N>.pth`` in the reference's key layout, which
``cli/align.py --pipnet_ckpt`` reads.  Runs on ``cuda``; ``--device cpu``
asks for the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.train_pipnet --data_dir data/WFLW \\
        --save_dir snapshots/WFLW
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from celebbasis_tpu_torch.align import pipnet_train as pt
from celebbasis_tpu_torch.align.pipnet import (PIPNet, PIPNetConfig,
                                               read_meanface)
from celebbasis_tpu_torch.loader import init_weights, resolve_device


def load_labels(path: str):
    """train.txt -> [(image name, (2L,) float32 array)]."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            out.append((parts[0],
                        np.asarray([float(x) for x in parts[1:]],
                                   np.float32)))
    return out


def load_meanface(path: str) -> np.ndarray:
    return read_meanface(path).astype(np.float32)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="snapshots/pipnet")
    p.add_argument("--num_nb", type=int, default=10)
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--net_stride", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--init_lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--decay_steps", type=int, nargs="+", default=[30, 50])
    p.add_argument("--save_interval", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--from_scratch", action="store_true",
                   help="adds Adam weight_decay 5e-4 (the reference's "
                        "train.py without a pretrained backbone)")
    p.add_argument("--tiny", action="store_true",
                   help="toy backbone for smoke runs/tests")
    p.add_argument("--backbone", type=str, default="resnet101",
                   choices=["resnet101", "resnet50", "resnet18", "mbnetv2",
                            "mbnetv3"],
                   help="the reference's five Pip_* wrappers "
                        "(lib/networks.py)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None):
    """-> ``fit_pipnet``'s result: ``params`` (the trained state on the
    device), ``history`` (mean loss per epoch), ``step_s`` (seconds of each
    step, to a sync)."""
    from PIL import Image

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    labels = load_labels(os.path.join(args.data_dir, "train.txt"))
    meanface = load_meanface(os.path.join(args.data_dir, "meanface.txt"))
    L = meanface.shape[0]
    if any(len(t) != 2 * L for _, t in labels):
        raise ValueError("label width must match the meanface's landmark "
                         "count")

    if args.tiny:
        net_cfg = PIPNetConfig(num_lms=L, num_nb=args.num_nb,
                               input_size=args.input_size,
                               net_stride=args.net_stride,
                               layers=(1, 1, 1, 1), width=8)
    else:
        preset = getattr(PIPNetConfig, args.backbone)
        net_cfg = preset(num_lms=L, num_nb=args.num_nb,
                         input_size=args.input_size,
                         net_stride=args.net_stride)
    tcfg = pt.PIPTrainConfig(
        num_lms=L, num_nb=args.num_nb, input_size=args.input_size,
        net_stride=args.net_stride, batch_size=args.batch_size,
        init_lr=args.init_lr, num_epochs=args.epochs,
        decay_steps=tuple(args.decay_steps),
        pretrained=not args.from_scratch)
    points_flip = (np.asarray(pt.WFLW_POINTS_FLIP, np.int32)
                   if L == 98 else None)
    img_dir = os.path.join(args.data_dir, "images_train")

    def batches_fn(epoch):
        rng = np.random.default_rng(args.seed * 100_003 + epoch)
        order = rng.permutation(len(labels))
        B = args.batch_size
        for s in range(0, len(order) - B + 1, B):     # drop_last
            ims, tgts = [], []
            for i in order[s:s + B]:
                name, target = labels[i]
                img = Image.open(os.path.join(img_dir, name)).convert("RGB")
                if img.size != (args.input_size, args.input_size):
                    img = img.resize((args.input_size, args.input_size),
                                     Image.BILINEAR)
                arr, tgt = pt.augment(img, target, rng,
                                      points_flip=points_flip)
                ims.append(arr)
                tgts.append(np.clip(tgt.reshape(L, 2), 0.0, 1.0))
            yield np.stack(ims), np.stack(tgts)

    # drawn on the CPU, so that a seed gives one init on every device
    model = PIPNet(net_cfg)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    params = pt.leaf_state(model.state_dict(), device)
    model.to(device)
    result = pt.fit_pipnet(
        model, params, batches_fn, tcfg, meanface,
        steps_per_epoch=max(len(labels) // args.batch_size, 1),
        save_dir=args.save_dir, save_interval=args.save_interval)
    print(f"[train_pipnet] done; checkpoints in {args.save_dir}")
    return result


if __name__ == "__main__":
    main()
