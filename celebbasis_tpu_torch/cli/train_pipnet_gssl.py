"""GSSL (semi-supervised) PIPNet training (W0; counterpart of
``celebbasis_tpu/cli/train_pipnet_gssl.py``, the reference's ``python
lib/train_gssl.py experiments/data_300W_CELEBA/...``).

Reads the curriculum layout that ``cli/preprocess_pipnet`` writes
(data_300W_CELEBA / data_300W_COFW_WFLW):

    <data_dir>/train_300W.txt            labeled rows (68 points, normalised)
    <data_dir>/train_CELEBA.txt          unlabeled names   (CELEBA task)
    <data_dir>/train_COFW.txt + train_WFLW.txt  (COFW_WFLW task)
    <data_dir>/images_train/             all crops
    <data_dir>/meanface.txt
    <data_dir>/images_test_{300W,COFW,WFLW}/ + test_*.txt   (--eval)

and runs ``align/pipnet_gssl.py``'s curriculum on a ResNet-18, stride-32
``PIPNetGSSL`` (cls3 -> cls2 -> std x3, or std x3 with --no_curriculum), the
reference's augmentations re-drawn for every row each epoch.  ``--eval``
prints the inter-ocular NME on the three test splits with neighbour-merged
predictions.  The last state is written to ``<save_dir>/epoch<epochs-1>.pth``
in the reference's key layout.  Runs on ``cuda``; ``--device cpu`` asks for
the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.preprocess_pipnet data_300W_CELEBA \\
        --root data
    python -m celebbasis_tpu_torch.cli.train_pipnet_gssl \\
        --data_dir data/data_300W_CELEBA --save_dir snapshots/gssl --eval
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch.func import functional_call

from celebbasis_tpu_torch.align import pipnet_gssl as pg
from celebbasis_tpu_torch.align import pipnet_train as pt
from celebbasis_tpu_torch.align.metrics import compute_nme
from celebbasis_tpu_torch.align.pipnet import (IMAGENET_MEAN, IMAGENET_STD,
                                               PIPNetConfig, meanface_indices)
from celebbasis_tpu_torch.cli.train_pipnet import load_labels, load_meanface
from celebbasis_tpu_torch.loader import resolve_device
from celebbasis_tpu_torch.utils.precision import no_tf32

NORM_INDICES = (36, 45)        # the outer eye corners: inter-ocular NME


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", type=str, required=True,
                   help="data/data_300W_CELEBA or data/data_300W_COFW_WFLW")
    p.add_argument("--save_dir", type=str, default="snapshots/pipnet_gssl")
    p.add_argument("--num_nb", type=int, default=10)
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--init_lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--decay_steps", type=int, nargs="+", default=[30, 50])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_curriculum", action="store_true",
                   help="standard self-training, task list ['std']*3")
    p.add_argument("--no_augment", action="store_true",
                   help="skip the per-epoch reference augmentations")
    p.add_argument("--eval", action="store_true",
                   help="NME on the 300W/COFW/WFLW test splits after "
                        "training")
    p.add_argument("--tiny", action="store_true",
                   help="toy backbone for smoke runs/tests")
    p.add_argument("--max_unlabeled", type=int, default=None,
                   help="cap the unlabeled pool (tests/smoke)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def _load_images(img_dir: str, names, input_size: int) -> np.ndarray:
    """uint8 RGB crops resized to the net's input."""
    from PIL import Image
    out = []
    for name in names:
        img = Image.open(os.path.join(img_dir, name)).convert("RGB")
        if img.size != (input_size, input_size):
            img = img.resize((input_size, input_size), Image.BILINEAR)
        out.append(np.asarray(img, np.uint8))
    return np.stack(out)


def _normalize(u8: np.ndarray) -> np.ndarray:
    return ((u8.astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD).astype(np.float32)


def evaluate(params, net_cfg: PIPNetConfig, meanface: np.ndarray,
             data_dir: str, batch_size: int, device) -> dict:
    """Inter-ocular NME of the neighbour-merged predictions on each test
    split.  -> {split: mean NME}."""
    model = pg.PIPNetGSSL(net_cfg).to(device)
    ri1, ri2, _ = meanface_indices(meanface, net_cfg.num_nb)
    ri1 = torch.from_numpy(ri1).to(device)
    ri2 = torch.from_numpy(ri2).to(device)
    out = {}
    for split in ("300W", "COFW", "WFLW"):
        rows = load_labels(os.path.join(data_dir, f"test_{split}.txt"))
        x = _normalize(_load_images(
            os.path.join(data_dir, f"images_test_{split}"),
            [n for n, _ in rows], net_cfg.input_size))
        preds = []
        with torch.no_grad(), no_tf32():
            for i in range(0, len(x), batch_size):
                chunk = torch.from_numpy(x[i:i + batch_size]).to(device)
                preds.append(pg.gssl_decode(
                    functional_call(model, params, (chunk,)), net_cfg, ri1,
                    ri2).cpu().numpy())
        nmes = []
        for p, (_, t) in zip(np.concatenate(preds), rows):
            gt = t.reshape(-1, 2)
            norm = np.linalg.norm(gt[NORM_INDICES[0]] - gt[NORM_INDICES[1]])
            nmes.append(compute_nme(p, gt, norm))
        out[split] = float(np.mean(nmes))
        print(f"[train_pipnet_gssl] {split} nme: {out[split]:.6f}")
    return out


def main(argv=None):
    """-> ``gssl_self_train``'s result (``params``, ``init_history``,
    ``history``, ``step_s``) with ``checkpoint`` (the path written) and,
    with --eval, ``nme`` per test split."""
    from PIL import Image

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    ddir = args.data_dir
    img_dir = os.path.join(ddir, "images_train")

    meanface = load_meanface(os.path.join(ddir, "meanface.txt"))
    L = meanface.shape[0]
    labeled_rows = load_labels(os.path.join(ddir, "train_300W.txt"))
    if any(len(t) != 2 * L for _, t in labeled_rows):
        raise ValueError("label width must match the meanface's landmark "
                         "count")

    # the unlabeled pool: name-only lists
    if os.path.exists(os.path.join(ddir, "train_CELEBA.txt")):
        unl_lists = ["train_CELEBA.txt"]
    else:
        unl_lists = ["train_COFW.txt", "train_WFLW.txt"]
    unl_names = []
    for name in unl_lists:
        with open(os.path.join(ddir, name)) as f:
            unl_names += [x.strip() for x in f if x.strip()]
    if args.max_unlabeled is not None:
        unl_names = unl_names[:args.max_unlabeled]

    print(f"[train_pipnet_gssl] {len(labeled_rows)} labeled / "
          f"{len(unl_names)} unlabeled rows from {ddir}")
    imgs_l_u8 = _load_images(img_dir, [n for n, _ in labeled_rows],
                             args.input_size)
    lms_l = np.stack([t.reshape(L, 2) for _, t in labeled_rows])
    imgs_u_u8 = (_load_images(img_dir, unl_names, args.input_size)
                 if unl_names else
                 np.zeros((0, args.input_size, args.input_size, 3),
                          np.uint8))

    if args.tiny:
        net_cfg = PIPNetConfig(num_lms=L, num_nb=args.num_nb,
                               input_size=args.input_size, net_stride=32,
                               layers=(1, 1, 1, 1), width=8)
    else:
        # the reference's GSSL stack is ResNet-18 at stride 32 only
        net_cfg = PIPNetConfig.resnet18(num_lms=L, num_nb=args.num_nb,
                                        input_size=args.input_size,
                                        net_stride=32)
    tcfg = pt.PIPTrainConfig(
        num_lms=L, num_nb=args.num_nb, input_size=args.input_size,
        net_stride=32, batch_size=args.batch_size, init_lr=args.init_lr,
        num_epochs=args.epochs, decay_steps=tuple(args.decay_steps))

    all_u8 = np.concatenate([imgs_l_u8, imgs_u_u8])
    points_flip = (np.asarray(pt.POINTS_FLIP_68, np.int32) if L == 68
                   else None)

    def augment_fn(rnd, epoch, lms):
        """The reference chain re-drawn for every row this epoch; rows are
        [labeled; unlabeled]."""
        rng = np.random.default_rng(
            args.seed * 1_000_003 + rnd * 1009 + epoch)
        ims, tgts = [], []
        for i in range(len(lms)):
            arr, tgt = pt.augment(Image.fromarray(all_u8[i]),
                                  lms[i].flatten(), rng,
                                  points_flip=points_flip)
            ims.append(arr)
            tgts.append(np.clip(tgt.reshape(L, 2), 0.0, 1.0))
        return np.stack(ims).astype(np.float32), np.stack(tgts)

    result = pg.gssl_self_train(
        net_cfg, tcfg, meanface,
        (_normalize(imgs_l_u8), lms_l.astype(np.float32)),
        _normalize(imgs_u_u8),
        task_list=(("std",) * 3 if args.no_curriculum
                   else ("cls3", "cls2", "std", "std", "std")),
        augment_fn=None if args.no_augment else augment_fn,
        seed=args.seed, device=device)
    result["checkpoint"] = pt.save_checkpoint(
        result["params"], net_cfg, args.save_dir, epoch=args.epochs - 1)
    print(f"[train_pipnet_gssl] saved {result['checkpoint']}")
    if args.eval:
        result["nme"] = evaluate(result["params"], net_cfg, meanface, ddir,
                                 args.batch_size, device)
    return result


if __name__ == "__main__":
    main()
