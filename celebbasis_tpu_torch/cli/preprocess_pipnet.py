"""PIPNet dataset preprocessing (W0; counterpart of
``celebbasis_tpu/cli/preprocess_pipnet.py``, the reference's ``python
lib/preprocess.py <data_name>`` and ``python lib/preprocess_gssl.py
<data_name>``).

Converts a raw WFLW / 300W / COFW / AFLW layout into the ``images_train/
images_test/ train.txt test.txt meanface.txt`` layout that
``cli/train_pipnet`` reads; the GSSL names (CELEBA, data_300W_CELEBA,
data_300W_COFW_WFLW) build the labeled + unlabeled curriculum layouts that
``cli/train_pipnet_gssl`` reads.  Host work only (``align/preprocess.py``:
OpenCV's codecs, the port's copy of its resize).

    python -m celebbasis_tpu_torch.cli.preprocess_pipnet data_300W --root data
    python -m celebbasis_tpu_torch.cli.preprocess_pipnet WFLW --root data
    python -m celebbasis_tpu_torch.cli.preprocess_pipnet data_300W_CELEBA \\
        --root data
"""
from __future__ import annotations

import argparse

from celebbasis_tpu_torch.align import preprocess as pp

DATASETS = ("data_300W", "COFW", "WFLW", "AFLW")
GSSL_DATASETS = ("CELEBA", "data_300W_CELEBA", "data_300W_COFW_WFLW")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_name", choices=DATASETS + GSSL_DATASETS)
    p.add_argument("--root", type=str, default="data",
                   help="folder holding the raw dataset layout "
                        "(the reference runs with root='../data')")
    p.add_argument("--target_size", type=int, default=256,
                   help="crop size (the reference hardcodes 256)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.data_name in GSSL_DATASETS:
        pp.gen_data_gssl(args.root, args.data_name, args.target_size,
                         verbose=not args.quiet)
        print(f"[preprocess] {args.data_name} (GSSL): wrote the "
              f"labeled+unlabeled curriculum layout under "
              f"{args.root}/{args.data_name}")
        return
    pp.gen_data(args.root, args.data_name, args.target_size,
                verbose=not args.quiet)
    print(f"[preprocess] {args.data_name}: wrote images_train/ images_test/ "
          f"train.txt test.txt meanface.txt under "
          f"{args.root}/{args.data_name}")


if __name__ == "__main__":
    main()
