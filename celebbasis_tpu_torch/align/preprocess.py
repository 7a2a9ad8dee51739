"""PIPNet dataset preprocessing: the WFLW / 300W / COFW / AFLW converters,
the GSSL layouts and the mean face.

Counterpart of ``celebbasis_tpu/align/preprocess.py`` (the reference's
``lib/preprocess.py`` and ``lib/preprocess_gssl.py``): crop each face around
its (expanded) annotation or detector box, resize the crop to
``target_size``, normalise the landmarks into the crop's [0, 1]^2 frame,
and write the ``train.txt`` / ``test.txt`` label rows and ``meanface.txt``
that ``cli/train_pipnet`` and ``cli/train_pipnet_gssl`` read, from the raw
public dataset layouts.

The crop and label arithmetic is numpy (arrays in, arrays out).  The resize
is ``align.cv_resample.resize_linear``, OpenCV's ``cv2.resize`` bit for bit.
Images are read and written with OpenCV's codecs (``cv2.imread`` /
``cv2.imwrite``, JPEG at its default quality 95), imported where a file is
read or written, as the JAX package does: with the same codec the port
writes the JAX package's bytes.  ``.mat`` files are read with scipy, and
MATLAB v7.3 (HDF5) ones with h5py, imported when needed.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from celebbasis_tpu_torch.align.cv_resample import resize_linear


def _resize(image: np.ndarray, target_size: int) -> np.ndarray:
    """The reference's ``cv2.resize(crop, (target_size, target_size))``."""
    return resize_linear(image, (target_size, target_size))


# ---------------------------------------------------------------------------
# per-dataset crop + landmark normalization (preprocess.py:6-141)
# ---------------------------------------------------------------------------

def process_300w_arrays(image: np.ndarray, pts: np.ndarray,
                        target_size: int,
                        scale: float = 1.1) -> Tuple[np.ndarray, List[List[float]]]:
    """300W: landmark-tight box expanded 1.1x with the reference's exact
    int-truncation sequence (preprocess.py:6-41).  ``pts`` is the raw (68,2)
    .pts coordinates (floats; the reference ints them on read).  The GSSL
    pipeline uses the same math at scale 1.3 (preprocess_gssl.py:6-41)."""
    anno = [[int(float(x)), int(float(y))] for x, y in pts]
    image_height, image_width = image.shape[:2]
    anno_x = [p[0] for p in anno]
    anno_y = [p[1] for p in anno]
    bbox_xmin, bbox_ymin = min(anno_x), min(anno_y)
    bbox_width = max(anno_x) - bbox_xmin
    bbox_height = max(anno_y) - bbox_ymin
    bbox_xmin -= int((scale - 1) / 2 * bbox_width)
    bbox_ymin -= int((scale - 1) / 2 * bbox_height)
    bbox_width = int(bbox_width * scale)
    bbox_height = int(bbox_height * scale)
    bbox_xmin = max(bbox_xmin, 0)
    bbox_ymin = max(bbox_ymin, 0)
    bbox_width = min(bbox_width, image_width - bbox_xmin - 1)
    bbox_height = min(bbox_height, image_height - bbox_ymin - 1)
    out = [[(x - bbox_xmin) / bbox_width, (y - bbox_ymin) / bbox_height]
           for x, y in anno]
    crop = image[bbox_ymin:bbox_ymin + bbox_height,
                 bbox_xmin:bbox_xmin + bbox_width, :]
    return _resize(crop, target_size), out


def process_cofw_arrays(image: np.ndarray, bbox: np.ndarray,
                        anno: np.ndarray,
                        target_size: int) -> Tuple[np.ndarray, List[List[float]]]:
    """COFW: given (xmin, ymin, w, h) box; phis rows are 29 x then 29 y
    (occlusion flags beyond 58 ignored) (preprocess.py:43-64)."""
    image_height, image_width = image.shape[:2]
    anno_x = np.asarray(anno[:29], np.float64)
    anno_y = np.asarray(anno[29:58], np.float64)
    xmin, ymin, width, height = [float(v) for v in bbox[:4]]
    xmax = xmin + width - 1
    ymax = ymin + height - 1
    xmin = max(xmin, 0)
    ymin = max(ymin, 0)
    xmax = min(xmax, image_width - 1)
    ymax = min(ymax, image_height - 1)
    anno_x = (anno_x - xmin) / (xmax - xmin)
    anno_y = (anno_y - ymin) / (ymax - ymin)
    out = [[float(x), float(y)] for x, y in zip(anno_x, anno_y)]
    crop = image[int(ymin):int(ymax), int(xmin):int(xmax), :]
    return _resize(crop, target_size), out


def process_wflw_arrays(image: np.ndarray, lms196: Sequence[float],
                        bbox: Sequence[float],
                        target_size: int,
                        drop_top: bool = False) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """WFLW: 98 landmarks + (xmin, ymin, xmax, ymax) detector box expanded
    1.2x (preprocess.py:66-112).  Landmarks are pre-clamped to the image.
    ``drop_top``: the GSSL variant (preprocess_gssl.py:43-89) *raises* the
    top edge by the same margin instead of expanding it ("remove a part of
    top area for alignment"), like its CELEBA crop."""
    image_height, image_width = image.shape[:2]
    lms = [float(x) for x in lms196]
    lms_x = [min(max(x, 0), image_width) for x in lms[0::2]]
    lms_y = [min(max(y, 0), image_height) for y in lms[1::2]]
    lms = [c for xy in zip(lms_x, lms_y) for c in xy]
    bbox_xmin, bbox_ymin, bbox_xmax, bbox_ymax = [float(x) for x in bbox]
    width = bbox_xmax - bbox_xmin
    height = bbox_ymax - bbox_ymin
    scale = 1.2
    bbox_xmin -= width * (scale - 1) / 2
    if drop_top:
        bbox_ymin += height * (scale - 1) / 2
    else:
        bbox_ymin -= height * (scale - 1) / 2
    bbox_xmax += width * (scale - 1) / 2
    bbox_ymax += height * (scale - 1) / 2
    bbox_xmin = max(bbox_xmin, 0)
    bbox_ymin = max(bbox_ymin, 0)
    bbox_xmax = min(bbox_xmax, image_width - 1)
    bbox_ymax = min(bbox_ymax, image_height - 1)
    width = bbox_xmax - bbox_xmin
    height = bbox_ymax - bbox_ymin
    crop = image[int(bbox_ymin):int(bbox_ymax),
                 int(bbox_xmin):int(bbox_xmax), :]
    lms = (np.asarray(lms) - np.asarray([bbox_xmin, bbox_ymin] * 98)) \
        / np.asarray([width, height] * 98)
    lms = lms.tolist()
    return _resize(crop, target_size), list(zip(lms[0::2], lms[1::2]))


def process_aflw_arrays(image: np.ndarray, bbox: Sequence[float],
                        anno: Sequence[float],
                        target_size: int) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """AFLW: 19 landmarks, box given as (xmin, xmax, ymin, ymax) — note the
    reference's unusual unpack order (preprocess.py:114-141)."""
    image_height, image_width = image.shape[:2]
    anno_x = [min(max(float(x), 0), image_width) for x in anno[:19]]
    anno_y = [min(max(float(y), 0), image_height) for y in anno[19:]]
    xmin, xmax, ymin, ymax = [float(v) for v in bbox[:4]]
    xmin = max(xmin, 0)
    ymin = max(ymin, 0)
    xmax = min(xmax, image_width - 1)
    ymax = min(ymax, image_height - 1)
    crop = image[int(ymin):int(ymax), int(xmin):int(xmax), :]
    ax = (np.asarray(anno_x) - xmin) / (xmax - xmin)
    ay = (np.asarray(anno_y) - ymin) / (ymax - ymin)
    flat = np.concatenate([ax.reshape(-1, 1), ay.reshape(-1, 1)],
                          axis=1).flatten()
    return _resize(crop, target_size), list(zip(flat[0::2], flat[1::2]))


# ---------------------------------------------------------------------------
# WFLW 98 -> 68 remap (convert_wflw, preprocess.py:155-231)
# ---------------------------------------------------------------------------

def wflw98_to_68(pts98: np.ndarray) -> np.ndarray:
    """(98, 2) -> (68, 2), the reference's exact remap: jaw subsampled 2:1,
    eyebrow y-coordinates averaged with the lower-arc partner (x kept),
    eye corners kept and mid-points blended 2/3:1/3 toward the apex."""
    p = np.asarray(pts98, np.float64)
    out = []
    for i in range(17):                                   # jaw
        out.append(p[i * 2])
    out.append(p[33])                                     # left eyebrow
    for a, b in ((34, 41), (35, 40), (36, 39), (37, 38)):
        out.append([p[a, 0], (p[a, 1] + p[b, 1]) / 2])
    for a, b in ((42, 50), (43, 49), (44, 48), (45, 47)):  # right eyebrow
        out.append([p[a, 0], (p[a, 1] + p[b, 1]) / 2])
    out.append(p[46])
    for i in range(51, 60):                               # nose
        out.append(p[i])
    out.append(p[60])                                     # left eye
    out.append(0.666 * p[61] + 0.333 * p[62])
    out.append(0.666 * p[63] + 0.333 * p[62])
    out.append(p[64])
    out.append(0.666 * p[65] + 0.333 * p[66])
    out.append(0.666 * p[67] + 0.333 * p[66])
    out.append(p[68])                                     # right eye
    out.append(0.666 * p[69] + 0.333 * p[70])
    out.append(0.666 * p[71] + 0.333 * p[70])
    out.append(p[72])
    out.append(0.666 * p[73] + 0.333 * p[74])
    out.append(0.666 * p[75] + 0.333 * p[74])
    for i in range(76, 96):                               # mouth
        out.append(p[i])
    return np.asarray(out, np.float64)


def convert_wflw(root_folder: str, data_name: str,
                 wflw_test_txt: str) -> None:
    """Rewrite a WFLW-format (98-landmark) test.txt into 68-landmark rows at
    ``root_folder/data_name/test.txt`` (convert_wflw, preprocess.py:155-231).
    ``wflw_test_txt`` is the source file (the reference hardcodes
    ``../data/WFLW/test.txt``)."""
    with open(wflw_test_txt) as f:
        rows = [x.strip().split() for x in f.readlines()]
    out_rows = []
    for row in rows:
        name, vals = row[0], np.asarray([float(v) for v in row[1:]])
        pts = vals.reshape(-1, 2)
        if pts.shape[0] != 98:
            raise ValueError(f"expected 98 landmarks, got {pts.shape}")
        out = wflw98_to_68(pts)
        out_rows.append(name + " " + " ".join(
            _fmt(v) for v in out.flatten()))
    with open(os.path.join(root_folder, data_name, "test.txt"), "w") as f:
        f.write("\n".join(out_rows) + "\n")


# ---------------------------------------------------------------------------
# meanface (gen_meanface, preprocess.py:143-154)
# ---------------------------------------------------------------------------

def meanface_from_rows(label_rows: Iterable[str]) -> np.ndarray:
    """train.txt rows ('name x0 y0 x1 y1 ...') -> flat (2L,) mean."""
    annos = [[float(v) for v in row.strip().split()[1:]] for row in label_rows]
    return np.mean(np.asarray(annos), axis=0)


def gen_meanface(root_folder: str, data_name: str) -> np.ndarray:
    with open(os.path.join(root_folder, data_name, "train.txt")) as f:
        meanface = meanface_from_rows(f.readlines())
    with open(os.path.join(root_folder, data_name, "meanface.txt"), "w") as f:
        f.write(" ".join(str(x) for x in meanface.tolist()))
    return meanface


# ---------------------------------------------------------------------------
# dataset drivers (gen_data, preprocess.py:233-545)
# ---------------------------------------------------------------------------

def _fmt(v) -> str:
    """str() of a python float — the reference writes raw str(x)."""
    return str(float(v))


def _write_rows(path: str, rows: Dict[str, Iterable]) -> None:
    with open(path, "w") as f:
        for name, anno in rows.items():
            f.write(name + " ")
            for x, y in anno:
                f.write(_fmt(x) + " " + _fmt(y) + " ")
            f.write("\n")


def _load_mat(path: str):
    """COFW/AFLW .mat loading: scipy for v5, h5py for v7.3 (the reference
    uses hdf5storage which handles both)."""
    import scipy.io
    try:
        return scipy.io.loadmat(path)
    except NotImplementedError:     # MATLAB v7.3 = HDF5
        import h5py
        return h5py.File(path, "r")


def _check_pairs(folder: str, imgs: List[str], lbls: List[str]) -> None:
    if len(imgs) != len(lbls):
        raise ValueError(f"{folder}: {len(imgs)} images but {len(lbls)} "
                         ".pts files")


def _read_pts(path: str) -> np.ndarray:
    """ibug .pts file: header 3 lines, trailing '}' (preprocess.py:10-13)."""
    with open(path) as f:
        rows = f.readlines()[3:-1]
    return np.asarray([[float(v) for v in r.strip().split()] for r in rows])


def gen_data(root_folder: str, data_name: str, target_size: int = 256,
             verbose: bool = False) -> None:
    """Convert a raw dataset layout into PIPNet's images_train/images_test +
    train.txt/test.txt + meanface.txt (gen_data, preprocess.py:233-545).

    Layouts expected (same as the reference):
      data_300W: afw/ helen/{train,test}set lfpw/{train,test}set ibug/
                 with paired image/.pts files
      COFW:      COFW_train_color.mat / COFW_test_color.mat
      WFLW:      WFLW_images/ + WFLW_annotations/list_98pt_rect_attr_train_test/
      AFLW:      flickr/ + AFLWinfo_release.mat
    """
    import cv2

    ddir = os.path.join(root_folder, data_name)
    os.makedirs(os.path.join(ddir, "images_train"), exist_ok=True)
    os.makedirs(os.path.join(ddir, "images_test"), exist_ok=True)
    say = print if verbose else (lambda *a: None)

    if data_name == "data_300W":
        splits = {"train": ["afw", "helen/trainset", "lfpw/trainset"],
                  "test": ["helen/testset", "lfpw/testset", "ibug"]}
        for split, folders in splits.items():
            rows: Dict[str, list] = {}
            for folder in folders:
                files = sorted(os.listdir(os.path.join(ddir, folder)))
                imgs = [x for x in files if ".pts" not in x]
                lbls = [x for x in files if ".pts" in x]
                _check_pairs(folder, imgs, lbls)
                for image_name, label_name in zip(imgs, lbls):
                    say(image_name)
                    image = cv2.imread(os.path.join(ddir, folder, image_name))
                    pts = _read_pts(os.path.join(ddir, folder, label_name))
                    crop, anno = process_300w_arrays(image, pts, target_size)
                    crop_name = folder.replace("/", "_") + "_" + image_name
                    cv2.imwrite(os.path.join(ddir, f"images_{split}",
                                             crop_name), crop)
                    rows[crop_name] = anno
            _write_rows(os.path.join(ddir, f"{split}.txt"), rows)
        # common/challenge split of the test rows (preprocess.py:289-299)
        with open(os.path.join(ddir, "test.txt")) as f:
            annos = f.readlines()
        with open(os.path.join(ddir, "test_common.txt"), "w") as f:
            f.writelines(a for a in annos if "ibug" not in a)
        with open(os.path.join(ddir, "test_challenge.txt"), "w") as f:
            f.writelines(a for a in annos if "ibug" in a)
        gen_meanface(root_folder, data_name)

    elif data_name == "COFW":
        for split, mat_name, keys in (
                ("train", "COFW_train_color.mat", ("IsTr", "bboxesTr",
                                                   "phisTr")),
                ("test", "COFW_test_color.mat", ("IsT", "bboxesT", "phisT"))):
            mat = _load_mat(os.path.join(ddir, mat_name))
            images, bboxes, annos = mat[keys[0]], mat[keys[1]], mat[keys[2]]
            rows: Dict[str, list] = {}
            for i in range(images.shape[0]):
                image = np.asarray(images[i, 0])
                if image.ndim == 2:           # grayscale
                    image = np.repeat(image[:, :, None], 3, axis=2)
                else:                         # rgb -> bgr like cv2.imread
                    image = image[:, :, ::-1]
                crop, anno = process_cofw_arrays(
                    image, np.asarray(bboxes[i]).ravel(),
                    np.asarray(annos[i]).ravel(), target_size)
                crop_name = f"cofw_{split}_{i + 1:04d}.jpg"
                say(crop_name)
                cv2.imwrite(os.path.join(ddir, f"images_{split}", crop_name),
                            crop)
                rows[crop_name] = anno
            _write_rows(os.path.join(ddir, f"{split}.txt"), rows)
        gen_meanface(root_folder, data_name)

    elif data_name == "WFLW":
        adir = os.path.join(ddir, "WFLW_annotations",
                            "list_98pt_rect_attr_train_test")
        names_mapping: Dict[str, tuple] = {}
        for split, list_name in (
                ("train", "list_98pt_rect_attr_train.txt"),
                ("test", "list_98pt_rect_attr_test.txt")):
            with open(os.path.join(adir, list_name)) as f:
                anno_rows = [x.strip().split() for x in f.readlines()]
            rows: Dict[str, list] = {}
            for count, row in enumerate(anno_rows, 1):
                image_name = row[-1]
                image = cv2.imread(os.path.join(ddir, "WFLW_images",
                                                image_name))
                crop, anno = process_wflw_arrays(
                    image, row[:196], [float(v) for v in row[196:200]],
                    target_size)
                crop_name = f"wflw_{split}_{count:04d}.jpg"
                say(crop_name)
                if split == "test":
                    names_mapping[row[0] + "_" + row[-1]] = (crop_name, anno)
                cv2.imwrite(os.path.join(ddir, f"images_{split}", crop_name),
                            crop)
                rows[crop_name] = anno
            _write_rows(os.path.join(ddir, f"{split}.txt"), rows)
        # per-attribute test subsets (preprocess.py:394-493)
        subsets = {"test_pose.txt": "list_98pt_test_largepose.txt",
                   "test_expr.txt": "list_98pt_test_expression.txt",
                   "test_illu.txt": "list_98pt_test_illumination.txt",
                   "test_mu.txt": "list_98pt_test_makeup.txt",
                   "test_occu.txt": "list_98pt_test_occlusion.txt",
                   "test_blur.txt": "list_98pt_test_blur.txt"}
        sdir = os.path.join(ddir, "WFLW_annotations", "list_98pt_test")
        for out_name, list_name in subsets.items():
            src = os.path.join(sdir, list_name)
            if not os.path.exists(src):
                continue
            with open(src) as f:
                keys = [x.strip().split() for x in f.readlines()]
            rows = {}
            for row in keys:
                key = row[0] + "_" + row[-1]
                if key not in names_mapping:
                    raise KeyError(f"{list_name}: {key} not in test set")
                crop_name, anno = names_mapping[key]
                rows[crop_name] = anno
            _write_rows(os.path.join(ddir, out_name), rows)
        gen_meanface(root_folder, data_name)

    elif data_name == "AFLW":
        mat = _load_mat(os.path.join(ddir, "AFLWinfo_release.mat"))
        bboxes, annos = mat["bbox"], mat["data"]
        name_list = mat["nameList"]
        ra = np.asarray(mat["ra"]).ravel().astype(int)
        for split, indices in (("train", ra[:20000]), ("test", ra[20000:])):
            rows: Dict[str, list] = {}
            for index in indices:
                image_name = str(np.asarray(
                    name_list[index - 1][0]).ravel()[0])   # matlab 1-based
                image = cv2.imread(os.path.join(ddir, "flickr", image_name))
                crop, anno = process_aflw_arrays(
                    image, np.asarray(bboxes[index - 1]).ravel(),
                    np.asarray(annos[index - 1]).ravel(), target_size)
                crop_name = f"aflw_{split}_{index:05d}.jpg"
                say(crop_name)
                cv2.imwrite(os.path.join(ddir, f"images_{split}", crop_name),
                            crop)
                rows[crop_name] = anno
            _write_rows(os.path.join(ddir, f"{split}.txt"), rows)
        gen_meanface(root_folder, data_name)

    else:
        raise ValueError(f"unknown dataset {data_name!r}; expected one of "
                         "data_300W, COFW, WFLW, AFLW")


# ---------------------------------------------------------------------------
# GSSL data preparation (lib/preprocess_gssl.py:1-544)
#
# The reference's semi-supervised curriculum (train_gssl.py,
# align/pipnet_gssl.py here) trains on mixed labeled+unlabeled sets prepared by
# preprocess_gssl.py: 300W crops at scale 1.3, unlabeled CelebA crops, COFW
# re-annotated to 68 points, and WFLW remapped 98->68 — written under the
# composite task layouts ``data_300W_CELEBA`` / ``data_300W_COFW_WFLW``.
# ---------------------------------------------------------------------------

def process_celeba_arrays(image: np.ndarray, bbox: Sequence[float],
                          target_size: int) -> np.ndarray:
    """CELEBA unlabeled crop (preprocess_gssl.py:91-109): detector box
    expanded 1.2x, except the top edge which is *dropped* by
    (scale+0.1-1)/2 of the height ("remove a part of top area for
    alignment").  No landmarks — the crop is the whole label."""
    image_height, image_width = image.shape[:2]
    xmin, ymin, xmax, ymax = [float(v) for v in bbox[:4]]
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    scale = 1.2
    xmin -= width * (scale - 1) / 2
    ymin += height * (scale + 0.1 - 1) / 2
    xmax += width * (scale - 1) / 2
    ymax += height * (scale - 1) / 2
    xmin = max(xmin, 0)
    ymin = max(ymin, 0)
    xmax = min(xmax, image_width - 1)
    ymax = min(ymax, image_height - 1)
    crop = image[int(ymin):int(ymax), int(xmin):int(xmax), :]
    return _resize(crop, target_size)


def _cofw68_crop(image: np.ndarray, bbox: Sequence[float],
                 anno_x: np.ndarray, anno_y: np.ndarray,
                 target_size: int) -> Tuple[np.ndarray, List[List[float]]]:
    """Shared COFW-68 geometry (preprocess_gssl.py:111-161): the given
    (xmin, ymin, w, h) box expanded 1.3x — unlike the supervised COFW path,
    which uses the raw box."""
    image_height, image_width = image.shape[:2]
    xmin, ymin, width, height = [float(v) for v in bbox[:4]]
    xmax = xmin + width - 1
    ymax = ymin + height - 1
    scale = 1.3
    xmin -= width * (scale - 1) / 2
    ymin -= height * (scale - 1) / 2
    xmax += width * (scale - 1) / 2
    ymax += height * (scale - 1) / 2
    xmin = max(xmin, 0)
    ymin = max(ymin, 0)
    xmax = min(xmax, image_width - 1)
    ymax = min(ymax, image_height - 1)
    ax = (np.asarray(anno_x, np.float64) - xmin) / (xmax - xmin)
    ay = (np.asarray(anno_y, np.float64) - ymin) / (ymax - ymin)
    out = [[float(x), float(y)] for x, y in zip(ax, ay)]
    crop = image[int(ymin):int(ymax), int(xmin):int(xmax), :]
    return _resize(crop, target_size), out


def process_cofw68_train_arrays(image: np.ndarray, bbox: Sequence[float],
                                phis: np.ndarray, target_size: int):
    """COFW train rows stay 29-landmark phis (x29|y29|occlusion29); in the
    GSSL layouts the train split is *unlabeled*, so only the crop is kept
    (preprocess_gssl.py:111-134)."""
    phis = np.asarray(phis, np.float64).ravel()
    return _cofw68_crop(image, bbox, phis[:29], phis[29:58], target_size)


def process_cofw68_test_arrays(image: np.ndarray, bbox: Sequence[float],
                               pts68: np.ndarray, target_size: int):
    """COFW test re-annotated to 68 points — per-image ``<i>_points.mat``
    'Points' arrays (preprocess_gssl.py:136-161)."""
    p = np.asarray(pts68, np.float64)
    return _cofw68_crop(image, bbox, p[:, 0].ravel(), p[:, 1].ravel(),
                        target_size)


def convert_wflw_gssl(root_folder: str, data_name: str) -> None:
    """GSSL convert_wflw (preprocess_gssl.py:176-250): rewrite
    ``<root>/<data_name>/test_WFLW_98.txt`` (normalized 98-landmark rows)
    into 68-landmark ``test_WFLW.txt`` — same remap as the supervised
    ``wflw98_to_68``."""
    ddir = os.path.join(root_folder, data_name)
    with open(os.path.join(ddir, "test_WFLW_98.txt")) as f:
        rows = [x.strip().split() for x in f.readlines() if x.strip()]
    out_rows = []
    for row in rows:
        pts = np.asarray([float(v) for v in row[1:]]).reshape(-1, 2)
        if pts.shape[0] != 98:
            raise ValueError(f"expected 98 landmarks, got {pts.shape}")
        out = wflw98_to_68(pts)
        out_rows.append(row[0] + " " + " ".join(_fmt(v)
                                                for v in out.flatten()))
    with open(os.path.join(ddir, "test_WFLW.txt"), "w") as f:
        f.write("\n".join(out_rows) + "\n")


def gen_meanface_gssl(root_folder: str, data_name: str) -> np.ndarray:
    """GSSL meanface comes from the labeled 300W rows only
    (preprocess_gssl.py:163-174: train_300W.txt)."""
    with open(os.path.join(root_folder, data_name, "train_300W.txt")) as f:
        meanface = meanface_from_rows(f.readlines())
    with open(os.path.join(root_folder, data_name, "meanface.txt"),
              "w") as f:
        f.write(" ".join(str(x) for x in meanface.tolist()))
    return meanface


def _mat_image_to_bgr(image: np.ndarray) -> np.ndarray:
    """COFW .mat cell image -> BGR like cv2.imread (grayscale repeated,
    RGB reversed) — preprocess_gssl.py:337-343."""
    image = np.asarray(image)
    if image.ndim == 2:
        return np.repeat(image[:, :, None], 3, axis=2)
    return image[:, :, ::-1]


def _gen_300w_gssl(root_folder: str, ddir: str, target_size: int, say):
    """Labeled 300W train + test at GSSL scale 1.3
    (preprocess_gssl.py:287-325): crops into images_train /
    images_test_300W, rows into train_300W.txt / test_300W.txt."""
    import cv2
    for split, folders, img_dir in (
            ("train", ["afw", "helen/trainset", "lfpw/trainset"],
             "images_train"),
            ("test", ["helen/testset", "lfpw/testset", "ibug"],
             "images_test_300W")):
        rows: Dict[str, list] = {}
        for folder in folders:
            fdir = os.path.join(root_folder, "data_300W", folder)
            files = sorted(os.listdir(fdir))
            imgs = [x for x in files if ".pts" not in x]
            lbls = [x for x in files if ".pts" in x]
            _check_pairs(folder, imgs, lbls)
            for image_name, label_name in zip(imgs, lbls):
                say(image_name)
                image = cv2.imread(os.path.join(fdir, image_name))
                crop, anno = process_300w_arrays(
                    image, _read_pts(os.path.join(fdir, label_name)),
                    target_size, scale=1.3)
                crop_name = folder.replace("/", "_") + "_" + image_name
                cv2.imwrite(os.path.join(ddir, img_dir, crop_name), crop)
                rows[crop_name] = anno
        _write_rows(os.path.join(ddir, f"{split}_300W.txt"), rows)


def _gen_cofw68_test(root_folder: str, ddir: str, target_size: int, say):
    """COFW-68 test split (preprocess_gssl.py:327-355): images from
    ``<root>/COFW/COFW_test_color.mat``, boxes from
    ``<ddir>/cofw68_test_bboxes.mat``, per-image 68-point annotations from
    ``<ddir>/cofw68_test_annotations/<i>_points.mat``."""
    import cv2
    mat = _load_mat(os.path.join(root_folder, "COFW",
                                 "COFW_test_color.mat"))
    images = mat["IsT"]
    bboxes = _load_mat(os.path.join(ddir,
                                    "cofw68_test_bboxes.mat"))["bboxes"]
    rows: Dict[str, list] = {}
    for i in range(images.shape[0]):
        image = _mat_image_to_bgr(images[i, 0])
        anno = _load_mat(os.path.join(
            ddir, "cofw68_test_annotations",
            f"{i + 1}_points.mat"))["Points"]
        crop, anno = process_cofw68_test_arrays(
            image, np.asarray(bboxes[i]).ravel(), np.asarray(anno),
            target_size)
        crop_name = f"cofw_test_{i + 1:04d}.jpg"
        say(crop_name)
        cv2.imwrite(os.path.join(ddir, "images_test_COFW", crop_name), crop)
        rows[crop_name] = anno
    _write_rows(os.path.join(ddir, "test_COFW.txt"), rows)


def _gen_wflw_gssl_split(root_folder: str, ddir: str, split: str,
                         target_size: int, say, labeled: bool):
    """WFLW split for the GSSL layouts (preprocess_gssl.py:356-379,
    486-528): test rows keep their normalized 98-point labels in
    test_WFLW_98.txt; train rows are unlabeled name lists."""
    import cv2
    list_name = f"list_98pt_rect_attr_{split}.txt"
    with open(os.path.join(root_folder, "WFLW", "WFLW_annotations",
                           "list_98pt_rect_attr_train_test",
                           list_name)) as f:
        anno_rows = [x.strip().split() for x in f.readlines() if x.strip()]
    img_dir = "images_test_WFLW" if labeled else "images_train"
    out_rows: Dict[str, list] = {}
    names: List[str] = []
    for count, row in enumerate(anno_rows, 1):
        image = cv2.imread(os.path.join(root_folder, "WFLW", "WFLW_images",
                                        row[-1]))
        crop, anno = process_wflw_arrays(
            image, row[:196], [float(v) for v in row[196:200]], target_size,
            drop_top=True)
        crop_name = f"wflw_{split}_{count:04d}.jpg"
        say(crop_name)
        cv2.imwrite(os.path.join(ddir, img_dir, crop_name), crop)
        out_rows[crop_name] = anno
        names.append(crop_name)
    if labeled:
        _write_rows(os.path.join(ddir, "test_WFLW_98.txt"), out_rows)
    else:
        with open(os.path.join(ddir, "train_WFLW.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


def gen_data_gssl(root_folder: str, data_name: str, target_size: int = 256,
                  verbose: bool = False) -> None:
    """GSSL dataset drivers (gen_data, preprocess_gssl.py:251-531).

    data_name:
      CELEBA               unlabeled crops from celeba_bboxes.txt ->
                           images_train/ + train.txt (names only)
      data_300W_CELEBA     labeled 300W (scale 1.3) + the CELEBA crops as
                           the unlabeled pool; 300W/COFW-68/WFLW-68 test
                           splits; meanface from train_300W.txt
      data_300W_COFW_WFLW  labeled 300W + unlabeled COFW/WFLW train crops;
                           same three test splits
    """
    import shutil

    import cv2

    ddir = os.path.join(root_folder, data_name)
    os.makedirs(os.path.join(ddir, "images_train"), exist_ok=True)
    say = print if verbose else (lambda *a: None)

    if data_name == "CELEBA":
        with open(os.path.join(ddir, "celeba_bboxes.txt")) as f:
            bboxes = [x.strip().split() for x in f.readlines() if x.strip()]
        with open(os.path.join(ddir, "train.txt"), "w") as f:
            for row in bboxes:
                image_name = row[0]
                say(image_name)
                f.write(image_name + "\n")
                image = cv2.imread(os.path.join(ddir, "img_celeba",
                                                image_name))
                crop = process_celeba_arrays(
                    image, [int(x) for x in row[1:5]], target_size)
                cv2.imwrite(os.path.join(ddir, "images_train", image_name),
                            crop)
        return

    if data_name not in ("data_300W_CELEBA", "data_300W_COFW_WFLW"):
        raise ValueError(f"unknown GSSL dataset {data_name!r}; expected "
                         "CELEBA, data_300W_CELEBA, or data_300W_COFW_WFLW")

    for sub in ("images_test_300W", "images_test_COFW", "images_test_WFLW"):
        os.makedirs(os.path.join(ddir, sub), exist_ok=True)

    if data_name == "data_300W_CELEBA":
        # The CELEBA crops become the unlabeled pool
        # (preprocess_gssl.py:276-279: ``cp -r .../CELEBA/images_train
        # .../data_300W_CELEBA/.`` + train.txt -> train_CELEBA.txt).  The
        # destination images_train/ already exists (pre-created above, as in
        # the reference), so cp merges the crops flat into it — which this
        # copy loop reproduces.
        cdir = os.path.join(root_folder, "CELEBA")
        for name in sorted(os.listdir(os.path.join(cdir, "images_train"))):
            dst = os.path.join(ddir, "images_train", name)
            if not os.path.exists(dst):
                shutil.copy(os.path.join(cdir, "images_train", name), dst)
        shutil.copy(os.path.join(cdir, "train.txt"),
                    os.path.join(ddir, "train_CELEBA.txt"))

    _gen_300w_gssl(root_folder, ddir, target_size, say)

    if data_name == "data_300W_COFW_WFLW":
        # unlabeled COFW train crops (preprocess_gssl.py:436-466)
        mat = _load_mat(os.path.join(root_folder, "COFW",
                                     "COFW_train_color.mat"))
        images, bboxes, annos = mat["IsTr"], mat["bboxesTr"], mat["phisTr"]
        with open(os.path.join(ddir, "train_COFW.txt"), "w") as f:
            for i in range(images.shape[0]):
                image = _mat_image_to_bgr(images[i, 0])
                crop, _ = process_cofw68_train_arrays(
                    image, np.asarray(bboxes[i]).ravel(),
                    np.asarray(annos[i]).ravel(), target_size)
                crop_name = f"cofw_train_{i + 1:04d}.jpg"
                say(crop_name)
                f.write(crop_name + "\n")
                cv2.imwrite(os.path.join(ddir, "images_train", crop_name),
                            crop)

    _gen_cofw68_test(root_folder, ddir, target_size, say)

    if data_name == "data_300W_COFW_WFLW":
        _gen_wflw_gssl_split(root_folder, ddir, "train", target_size, say,
                             labeled=False)
    _gen_wflw_gssl_split(root_folder, ddir, "test", target_size, say,
                         labeled=True)

    convert_wflw_gssl(root_folder, data_name)
    gen_meanface_gssl(root_folder, data_name)
