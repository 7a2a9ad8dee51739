"""Legacy-LDM datasets — LSUN / FacesHQ / ImageNet (+SR), on the host.

The port's own copy of ``celebbasis_tpu/data/legacy.py`` (numpy, PIL, scipy
and OpenCV only; it imports nothing of the JAX package), which the tests
hold to it bit for bit.

Parity targets (behavior, not code):
* ``LSUNBase`` + subclasses (`ldm/data/lsun.py:9-92`):
  txt filelist under a data root, score-sde center-crop to square, resize,
  random horizontal flip, pixels scaled to [-1, 1] float32.
* ``taming.data.faceshq`` FFHQ/CelebAHQ train/val (named by
  `configs/latent-diffusion/{celebahq,ffhq}-ldm-vq-4.yaml`): taming's
  ``ImagePaths`` semantics — smallest side resized to ``size``, center crop.
  taming is not vendored in the reference; this follows the public taming
  construction.
* ``ImageNetTrain/Validation`` (`ldm/data/imagenet.py:26-270`)
  minus the network self-download (impossible here): an on-disk synset tree
  or explicit filelist, class labels by sorted unique synset (the
  reference's ``class_dict``), smallest-side resize + (random|center) crop.
* ``ImageNetSRTrain/Validation`` (`imagenet.py:272-394`): random-fraction
  square crop, area resize to ``size``, and a degraded ``LR_image`` at
  ``size/downscale_f`` (the pil_* interpolation family, or the
  ``bsrgan`` / ``bsrgan_light`` degradation of ``data/degradation.py``).

Everything returns numpy dicts; nothing here imports torch.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

_PIL_INTERP = {
    "linear": Image.BILINEAR,
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "lanczos": Image.LANCZOS,
    "nearest": Image.NEAREST,
    "box": Image.BOX,
    "hamming": Image.HAMMING,
}


def _to_pm1(img: Image.Image) -> np.ndarray:
    return (np.asarray(img, dtype=np.uint8) / 127.5 - 1.0).astype(np.float32)


def _center_crop_square(arr: np.ndarray) -> np.ndarray:
    """score-sde preprocessing (lsun.py:46-51)."""
    h, w = arr.shape[0], arr.shape[1]
    crop = min(h, w)
    return arr[(h - crop) // 2:(h + crop) // 2,
               (w - crop) // 2:(w + crop) // 2]


def _open_rgb(path: str) -> Image.Image:
    image = Image.open(path)
    if image.mode != "RGB":
        image = image.convert("RGB")
    return image


class ImageListBase:
    """LSUNBase equivalent: filelist + root, square-crop/resize/flip."""

    def __init__(self, txt_file: str, data_root: str,
                 size: Optional[int] = None,
                 interpolation: str = "bicubic",
                 flip_p: float = 0.5, seed: Optional[int] = None):
        with open(txt_file) as f:
            self.image_paths = f.read().splitlines()
        self.data_root = data_root
        self.size = size
        self.interpolation = _PIL_INTERP[interpolation]
        self.flip_p = flip_p
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> Dict:
        rel = self.image_paths[i]
        path = os.path.join(self.data_root, rel)
        img = np.asarray(_open_rgb(path), dtype=np.uint8)
        image = Image.fromarray(_center_crop_square(img))
        if self.size is not None:
            image = image.resize((self.size, self.size),
                                 resample=self.interpolation)
        if self.flip_p > 0 and self._rng.random() < self.flip_p:
            image = image.transpose(Image.FLIP_LEFT_RIGHT)
        return {"relative_file_path_": rel, "file_path_": path,
                "image": _to_pm1(image)}


def _lsun(txt, root):
    class _DS(ImageListBase):
        def __init__(self, flip_p=0.5, **kw):
            kw.setdefault("txt_file", txt)
            kw.setdefault("data_root", root)
            super().__init__(flip_p=flip_p, **kw)
    return _DS


LSUNChurchesTrain = _lsun("data/lsun/church_outdoor_train.txt",
                          "data/lsun/churches")
LSUNBedroomsTrain = _lsun("data/lsun/bedrooms_train.txt", "data/lsun/bedrooms")
LSUNCatsTrain = _lsun("data/lsun/cat_train.txt", "data/lsun/cats")


def _lsun_val(txt, root):
    base = _lsun(txt, root)

    class _DS(base):   # type: ignore[valid-type]
        def __init__(self, flip_p=0.0, **kw):
            super().__init__(flip_p=flip_p, **kw)
    return _DS


LSUNChurchesValidation = _lsun_val("data/lsun/church_outdoor_val.txt",
                                   "data/lsun/churches")
LSUNBedroomsValidation = _lsun_val("data/lsun/bedrooms_val.txt",
                                   "data/lsun/bedrooms")
LSUNCatsValidation = _lsun_val("data/lsun/cat_val.txt", "data/lsun/cats")


class FacesHQBase:
    """taming ImagePaths semantics: smallest side -> ``size``, center crop."""

    def __init__(self, txt_file: str, data_root: str, size: int = 256,
                 keys: Sequence[str] = ("image",)):
        with open(txt_file) as f:
            self.image_paths = f.read().splitlines()
        self.data_root = data_root
        self.size = size
        self.keys = tuple(keys)

    def __len__(self) -> int:
        return len(self.image_paths)

    def _process(self, path: str) -> np.ndarray:
        image = _open_rgb(path)
        w, h = image.size
        scale = self.size / min(w, h)
        image = image.resize((max(self.size, round(w * scale)),
                              max(self.size, round(h * scale))),
                             resample=Image.BILINEAR)
        arr = _center_crop_square(np.asarray(image, dtype=np.uint8))
        return (arr[:self.size, :self.size] / 127.5 - 1.0).astype(np.float32)

    def __getitem__(self, i: int) -> Dict:
        rel = self.image_paths[i]
        path = os.path.join(self.data_root, rel)
        return {"relative_file_path_": rel, "file_path_": path,
                "image": self._process(path)}


def _faceshq(txt, root):
    class _DS(FacesHQBase):
        def __init__(self, **kw):
            kw.setdefault("txt_file", txt)
            kw.setdefault("data_root", root)
            super().__init__(**kw)
    return _DS


FFHQTrain = _faceshq("data/ffhqtrain.txt", "data/ffhq")
FFHQValidation = _faceshq("data/ffhqvalidation.txt", "data/ffhq")
CelebAHQTrain = _faceshq("data/celebahqtrain.txt", "data/celebahq")
CelebAHQValidation = _faceshq("data/celebahqvalidation.txt", "data/celebahq")


class ImageNetFolder:
    """ImageNetTrain/Validation without the self-download: reads an existing
    ``data_root`` synset tree (``n01440764/xxx.JPEG``) or an explicit
    ``txt_filelist`` of relative paths (the reference's filelist.txt)."""

    def __init__(self, data_root: str, txt_filelist: Optional[str] = None,
                 size: int = 256, random_crop: bool = False,
                 process_images: bool = True, seed: Optional[int] = None):
        if txt_filelist and os.path.exists(txt_filelist):
            with open(txt_filelist) as f:
                relpaths = f.read().splitlines()
        else:
            if not os.path.isdir(data_root):
                raise FileNotFoundError(
                    f"ImageNet data_root {data_root!r} not found; this "
                    "offline build does not self-download "
                    "(reference imagenet.py:150-196 does) — place the "
                    "extracted synset folders there or pass txt_filelist")
            relpaths = []
            for syn in sorted(os.listdir(data_root)):
                d = os.path.join(data_root, syn)
                if os.path.isdir(d):
                    relpaths += [f"{syn}/{f}" for f in sorted(os.listdir(d))]
        # the reference drops one known-corrupt file (imagenet.py:49-52)
        relpaths = [p for p in relpaths
                    if p.split("/")[-1] != "n06596364_9591.JPEG"]
        self.relpaths = relpaths
        self.data_root = data_root
        self.synsets = [p.split("/")[0] for p in relpaths]
        uniq = sorted(set(self.synsets))
        class_dict = {s: i for i, s in enumerate(uniq)}
        self.class_labels = [class_dict[s] for s in self.synsets]
        self.size = size
        self.random_crop = random_crop
        self.process_images = process_images
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.relpaths)

    def path(self, i: int) -> str:
        return os.path.join(self.data_root, self.relpaths[i])

    def _crop(self, arr: np.ndarray, side: int) -> np.ndarray:
        h, w = arr.shape[:2]
        if self.random_crop:
            top = int(self._rng.integers(0, h - side + 1))
            left = int(self._rng.integers(0, w - side + 1))
        else:
            top, left = (h - side) // 2, (w - side) // 2
        return arr[top:top + side, left:left + side]

    def __getitem__(self, i: int) -> Dict:
        out = {"relpath": self.relpaths[i], "synsets": self.synsets[i],
               "class_label": np.int32(self.class_labels[i]),
               "file_path_": self.path(i)}
        if not self.process_images:
            return out
        image = _open_rgb(self.path(i))
        w, h = image.size
        scale = self.size / min(w, h)   # SmallestMaxSize
        image = image.resize((max(self.size, round(w * scale)),
                              max(self.size, round(h * scale))),
                             resample=Image.BICUBIC)
        arr = self._crop(np.asarray(image, dtype=np.uint8), self.size)
        out["image"] = (arr / 127.5 - 1.0).astype(np.float32)
        return out


class ImageNetTrain(ImageNetFolder):
    def __init__(self, data_root: str = "data/imagenet/train", **kw):
        kw.setdefault("random_crop", True)
        super().__init__(data_root, **kw)


class ImageNetValidation(ImageNetFolder):
    def __init__(self, data_root: str = "data/imagenet/val", **kw):
        kw.setdefault("random_crop", False)
        super().__init__(data_root, **kw)


class ImageNetSR:
    """Superresolution pairs (imagenet.py:272-374): random-fraction square
    crop -> area resize to ``size`` -> degraded ``LR_image``."""

    def __init__(self, base, size: int, degradation: str = "pil_bicubic",
                 downscale_f: int = 4, min_crop_f: float = 0.5,
                 max_crop_f: float = 1.0, random_crop: bool = True,
                 seed: Optional[int] = None):
        assert size % downscale_f == 0
        self._bsr = None
        if degradation.startswith("bsrgan"):
            # the reference's degradation_fn_bsr(_light) pipelines
            # (imagenet.py:306-311 -> image_degradation/bsrgan*.py)
            from celebbasis_tpu_torch.data.degradation import \
                degradation_bsrgan_variant
            light = degradation.endswith("light")
            self._bsr = lambda img, rng: degradation_bsrgan_variant(
                img, sf=downscale_f, rng=rng, light=light)["image"]
            self._lr_interp = None
        else:
            name = degradation.split("_", 1)[-1]
            if name == "area":
                self._lr_interp = Image.BOX   # PIL's area-style filter
            else:
                self._lr_interp = _PIL_INTERP[name]
        self.base = base
        self.size = size
        self.LR_size = size // downscale_f
        self.min_crop_f, self.max_crop_f = min_crop_f, max_crop_f
        self.center_crop = not random_crop
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> Dict:
        base = self.base[i]
        example = dict(base) if isinstance(base, dict) \
            else {"file_path_": base}
        image = np.asarray(_open_rgb(example["file_path_"]), dtype=np.uint8)
        min_side = min(image.shape[:2])
        side = int(min_side * self._rng.uniform(self.min_crop_f,
                                                self.max_crop_f))
        h, w = image.shape[:2]
        if self.center_crop:
            top, left = (h - side) // 2, (w - side) // 2
        else:
            top = int(self._rng.integers(0, h - side + 1))
            left = int(self._rng.integers(0, w - side + 1))
        crop = Image.fromarray(image[top:top + side, left:left + side])
        hr = crop.resize((self.size, self.size), resample=Image.BOX)
        if self._bsr is not None:
            lr_arr = self._bsr(np.asarray(hr, dtype=np.uint8), self._rng)
            example["LR_image"] = (lr_arr / 127.5 - 1.0).astype(np.float32)
        else:
            lr = hr.resize((self.LR_size, self.LR_size),
                           resample=self._lr_interp)
            example["LR_image"] = _to_pm1(lr)
        example["image"] = _to_pm1(hr)
        return example


def _sr(folder_cls, split_root):
    class _DS(ImageNetSR):
        def __init__(self, data_root: str = split_root, **kw):
            base = folder_cls(data_root=data_root, process_images=False)
            super().__init__(base, **kw)
    return _DS


ImageNetSRTrain = _sr(ImageNetTrain, "data/imagenet/train")
ImageNetSRValidation = _sr(ImageNetValidation, "data/imagenet/val")
