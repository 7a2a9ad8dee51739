"""Synthetic raw dataset layouts for the PIPNet preprocessing tests, in the
public datasets' own formats: random-pixel images written with OpenCV,
landmarks and boxes from a numpy seed.

* ``write_300w``: ``data_300W/{afw,helen/*,lfpw/*,ibug}`` image + ``.pts``
  pairs (68 points);
* ``write_wflw``: ``WFLW/WFLW_images`` + the ``list_98pt_rect_attr_*``
  annotation lists and the per-attribute test lists;
* ``write_cofw``: ``COFW/COFW_{train,test}_color.mat`` (colour and gray
  images in a cell array, boxes, 29-point ``phis`` with occlusion flags);
* ``write_aflw``: ``AFLW/flickr`` + ``AFLWinfo_release.mat``;
* ``write_celeba``: ``CELEBA/img_celeba`` + ``celeba_bboxes.txt``;
* ``write_cofw68``: a GSSL task folder's ``cofw68_test_bboxes.mat`` and
  ``cofw68_test_annotations/<i>_points.mat``.
"""
import os

import numpy as np

FOLDERS_300W = ("afw", "helen/trainset", "helen/testset", "lfpw/trainset",
                "lfpw/testset", "ibug")
WFLW_SUBSETS = ("largepose", "expression", "illumination", "makeup",
                "occlusion", "blur")


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _points(rng, n, h, w, margin=6):
    return np.stack([rng.uniform(margin, w - margin, n),
                     rng.uniform(margin, h - margin, n)], axis=1)


def write_300w(root, rng, per_folder=2, ext="png", size=(100, 128)):
    import cv2
    for fi, folder in enumerate(FOLDERS_300W):
        d = os.path.join(root, "data_300W", folder)
        os.makedirs(d, exist_ok=True)
        for i in range(per_folder):
            h, w = size[0] + 3 * fi, size[1] - 4 * i
            cv2.imwrite(os.path.join(d, f"im{i}.{ext}"), _image(rng, h, w))
            with open(os.path.join(d, f"im{i}.pts"), "w") as f:
                f.write("version: 1\nn_points: 68\n{\n")
                for x, y in _points(rng, 68, h, w):
                    f.write(f"{x} {y}\n")
                f.write("}\n")


def write_wflw(root, rng, n_train=3, n_test=2, size=(140, 118)):
    import cv2
    wdir = os.path.join(root, "WFLW")
    adir = os.path.join(wdir, "WFLW_annotations",
                        "list_98pt_rect_attr_train_test")
    sdir = os.path.join(wdir, "WFLW_annotations", "list_98pt_test")
    for d in (os.path.join(wdir, "WFLW_images"), adir, sdir):
        os.makedirs(d, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        rows = []
        for i in range(n):
            h, w = size[0] + 2 * i, size[1]
            name = f"{split}_{i}.jpg"
            cv2.imwrite(os.path.join(wdir, "WFLW_images", name),
                        _image(rng, h, w))
            lms = _points(rng, 98, h, w).flatten()
            rows.append(" ".join(str(v) for v in lms)
                        + f" 16.0 28.0 {w - 14}.0 {h - 10}.0 0 1 0 0 1 0 "
                        + name)
        with open(os.path.join(adir, f"list_98pt_rect_attr_{split}.txt"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")
    # every other attribute list holds the first test row
    for j, attr in enumerate(WFLW_SUBSETS):
        if j % 2 == 0:
            with open(os.path.join(sdir, f"list_98pt_test_{attr}.txt"),
                      "w") as f:
                f.write(rows[0] + "\n")


def _cofw_cells(rng, n):
    cells = np.empty((n, 1), object)
    for i in range(n):
        shape = (95, 100) if i % 2 else (95, 100, 3)
        cells[i, 0] = rng.integers(0, 256, shape, dtype=np.uint8)
    return cells


def write_cofw(root, rng, n_train=3, n_test=2):
    import scipy.io
    os.makedirs(os.path.join(root, "COFW"), exist_ok=True)
    for mat_name, n, keys in (
            ("COFW_train_color.mat", n_train, ("IsTr", "bboxesTr", "phisTr")),
            ("COFW_test_color.mat", n_test, ("IsT", "bboxesT", "phisT"))):
        bboxes = np.asarray([[10.0 + i, 8.0, 60.0, 70.0] for i in range(n)])
        phis = np.stack([np.concatenate([rng.uniform(15, 65, 29),
                                         rng.uniform(10, 78, 29),
                                         rng.integers(0, 2, 29)])
                         for _ in range(n)])
        scipy.io.savemat(os.path.join(root, "COFW", mat_name),
                         {keys[0]: _cofw_cells(rng, n), keys[1]: bboxes,
                          keys[2]: phis})


def write_aflw(root, rng, n=3, size=(110, 120)):
    import cv2
    import scipy.io
    ddir = os.path.join(root, "AFLW")
    os.makedirs(os.path.join(ddir, "flickr", "0"), exist_ok=True)
    names = np.empty((n, 1), object)
    bbox, data = np.zeros((n, 4)), np.zeros((n, 38))
    for i in range(n):
        h, w = size[0] + 5 * i, size[1]
        names[i, 0] = f"0/image{i:05d}.jpg"
        cv2.imwrite(os.path.join(ddir, "flickr", names[i, 0]),
                    _image(rng, h, w))
        bbox[i] = [8.0 + i, w - 12.0, 6.0, h - 9.0]     # xmin xmax ymin ymax
        pts = _points(rng, 19, h, w, margin=-3)       # some off the image
        data[i] = np.concatenate([pts[:, 0], pts[:, 1]])
    scipy.io.savemat(os.path.join(ddir, "AFLWinfo_release.mat"),
                     {"bbox": bbox, "data": data, "nameList": names,
                      "ra": rng.permutation(n)[None] + 1})


def write_celeba(root, rng, n=2, size=(130, 105)):
    import cv2
    cdir = os.path.join(root, "CELEBA", "img_celeba")
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(root, "CELEBA", "celeba_bboxes.txt"), "w") as f:
        for i in range(n):
            cv2.imwrite(os.path.join(cdir, f"{i:06d}.jpg"),
                        _image(rng, *size))
            f.write(f"{i:06d}.jpg {10 + i} 12 {size[1] - 15} "
                    f"{size[0] - 12}\n")


def write_cofw68(root, task, rng, n_test=2):
    import scipy.io
    tdir = os.path.join(root, task)
    os.makedirs(os.path.join(tdir, "cofw68_test_annotations"), exist_ok=True)
    scipy.io.savemat(os.path.join(tdir, "cofw68_test_bboxes.mat"),
                     {"bboxes": np.asarray([[12.0 + i, 9.0, 64.0, 70.0]
                                            for i in range(n_test)])})
    for i in range(n_test):
        scipy.io.savemat(os.path.join(tdir, "cofw68_test_annotations",
                                      f"{i + 1}_points.mat"),
                         {"Points": _points(rng, 68, 95, 100)})


def write_gssl(root, task, seed=20):
    """Every raw input the GSSL drivers read for ``task``."""
    rng = np.random.default_rng(seed)
    write_celeba(root, rng)
    write_300w(root, rng)
    write_cofw(root, rng)
    write_cofw68(root, task, rng)
    write_wflw(root, rng)
