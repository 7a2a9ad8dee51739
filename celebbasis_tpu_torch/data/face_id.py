"""FaceId training dataset: pickle contract, captions, augmentation.

Counterpart of ``celebbasis_tpu/data/face_id.py``, kept as the port's own
copy (the port imports nothing of the JAX package):

* the alignment stage writes a pickle holding a flat list of image paths;
  identity = file basename, one id per file for the one-shot datasets; a
  list of ``(path, quality)`` tuples is the VGG-style layout (identity =
  parent folder, best quality first);
* ``num_ids`` / ``specific_ids`` / ``images_per_id`` / ``repeats`` select
  and tile the training list;
* per-example augmentation: resize, random hflip, colour jitter (brightness,
  contrast, saturation 0.8-1.2, hue 0.01) with torchvision's PIL arithmetic,
  normalise to [-1, 1];
* the training image is pasted at a random scale onto a black (-1)
  background (``_add_bg``); the two-person composition (``_mix_two``) sits
  behind ``dual_prob``, 0 by default (the reference's dual branch is dead);
* ``faces``: the (1 + diff_cnt + 1 + diff_cnt) crops per example that feed
  MetaIdNet, with their ids; the caption comes from CLIP-style templates
  around 'face of <placeholder> person'.

Every draw comes from one ``np.random.Generator`` seeded from the config, in
the JAX module's order, so that the same pickle and seed give the same
arrays and captions bit for bit.  Batches are numpy and channels-last, as
``train.trainer`` takes them.  Pure numpy / PIL: no torch.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance

from celebbasis_tpu_torch.text.tokenizer import \
    PLACEHOLDER_WORDS as PLACEHOLDER_STRINGS

TEMPLATES_SMALL = [
    "a photo of a {}",
    "a rendering of a {}",
    "a cropped photo of the {}",
    "the photo of a {}",
    "a photo of a clean {}",
    "a photo of a dirty {}",
    "a dark photo of the {}",
    "a photo of my {}",
    "a photo of the cool {}",
    "a close-up photo of a {}",
    "a bright photo of the {}",
    "a cropped photo of a {}",
    "a photo of the {}",
    "a good photo of the {}",
    "a photo of one {}",
    "a close-up photo of the {}",
    "a rendition of the {}",
    "a photo of the clean {}",
    "a rendition of a {}",
    "a photo of a nice {}",
    "a good photo of a {}",
    "a photo of the nice {}",
    "a photo of the small {}",
    "a photo of the weird {}",
    "a photo of the large {}",
    "a photo of a cool {}",
    "a photo of a small {}",
]

TEMPLATES_DUAL = [
    "a photo of a {} and a {}",
    "a rendering of a {} and a {}",
    "a cropped photo of a {} and a {}",
    "the photo of a {} with a {}",
    "a dark photo of a {} and a {}",
    "a close-up photo of a {} and a {}",
    "a bright photo of a {} and a {}",
]


# -- torchvision-functional colour ops (PIL backend) --------------------------
# The arithmetic of torchvision.transforms.functional's PIL path, which is
# what the reference's ColorJitter runs (it sits before ToTensor).

def adjust_brightness(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Brightness(img).enhance(factor)


def adjust_contrast(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Contrast(img).enhance(factor)


def adjust_saturation(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Color(img).enhance(factor)


def adjust_hue(img: Image.Image, hue_factor: float) -> Image.Image:
    """HSV round trip with uint8 wraparound on the H channel (torchvision's
    ``F_pil.adjust_hue``: shift = trunc(hue_factor * 255) mod 256)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    h, s, v = img.convert("HSV").split()
    np_h = np.asarray(h, np.uint8)
    np_h = ((np_h.astype(np.int16) + int(hue_factor * 255)) % 256
            ).astype(np.uint8)
    return Image.merge("HSV", (Image.fromarray(np_h, "L"), s, v)
                       ).convert("RGB")


def _resize(img: np.ndarray, size_hw) -> np.ndarray:
    """A [-1, 1] image through uint8 and PIL's bilinear resize."""
    return np.asarray(Image.fromarray(
        ((img + 1) * 127.5).astype(np.uint8)).resize(
            (size_hw[1], size_hw[0]), Image.BILINEAR),
        np.float32) / 127.5 - 1.0


@dataclass
class FaceIdDatasetConfig:
    pickle_path: str
    num_ids: int = 10
    specific_ids: Optional[Sequence[int]] = None
    images_per_id: int = 1
    image_size: int = 512
    repeats: int = 100
    flip_p: float = 0.5
    split: str = "train"
    diff_cnt: int = 0
    dual_prob: float = 0.0     # the reference's dual branch is dead (always 0)
    reg_ids: int = 0
    reg_repeats: int = 0
    seed: int = 0


def parse_specific_ids(spec) -> Optional[List[int]]:
    """'3-7' -> [3, 4, 5, 6]; lists pass through."""
    if spec is None or isinstance(spec, (list, tuple)):
        return list(spec) if spec is not None else None
    lo, hi = (int(x) for x in str(spec).split("-"))
    return list(range(lo, hi))


class FaceIdDataset:
    def __init__(self, cfg: FaceIdDatasetConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.img_dict: Dict[int, Dict] = {}
        self._load_from_pickle()
        self._length = cfg.num_ids * cfg.images_per_id * cfg.repeats
        self.num_train = self._length

    def _load_from_pickle(self):
        cfg = self.cfg
        with open(cfg.pickle_path, "rb") as f:
            paths = pickle.load(f)
        by_id: Dict[str, List[str]] = {}
        if paths and isinstance(paths[0], (tuple, list)):
            # VGG-style: (path, quality); identity = parent folder, best
            # quality first
            for p, _iqa in sorted(paths, key=lambda x: x[1], reverse=True):
                key = os.path.basename(os.path.dirname(p))
                by_id.setdefault(key, []).append(p)
        else:
            # one-shot: flat path list, identity = file basename
            for p in paths:
                key = os.path.basename(p).split(".")[0]
                by_id.setdefault(key, []).append(p)
        spec = parse_specific_ids(cfg.specific_ids)
        walk, use = 0, 0
        for key, images in by_id.items():
            if use >= cfg.num_ids:
                break
            if len(images) >= cfg.images_per_id:
                if spec is not None and walk not in spec:
                    walk += 1
                    continue
                self.img_dict[use] = {"id": key,
                                      "images": images[: cfg.images_per_id]}
                walk += 1
                use += 1
        if use < cfg.num_ids:
            raise ValueError(
                f"not enough identities: wanted {cfg.num_ids}, found {use} "
                f"in {cfg.pickle_path}")

    def __len__(self):
        return self._length

    # -- augmentation -------------------------------------------------------
    def _color_jitter(self, img: Image.Image) -> Image.Image:
        """torchvision ``ColorJitter(brightness=(0.8, 1.2), contrast=(0.8,
        1.2), saturation=(0.8, 1.2), hue=0.01)`` on the PIL backend: the four
        factors are drawn first, then the ops run in a random order."""
        fb = self.rng.uniform(0.8, 1.2)
        fc = self.rng.uniform(0.8, 1.2)
        fs = self.rng.uniform(0.8, 1.2)
        fh = self.rng.uniform(-0.01, 0.01)
        ops = (lambda im: adjust_brightness(im, fb),
               lambda im: adjust_contrast(im, fc),
               lambda im: adjust_saturation(im, fs),
               lambda im: adjust_hue(im, fh))
        for idx in self.rng.permutation(4):
            img = ops[idx](img)
        return img

    def _load_aug(self, id_idx: int, img_idx: int) -> np.ndarray:
        cfg = self.cfg
        img = Image.open(self.img_dict[id_idx]["images"][img_idx]
                         ).convert("RGB")
        if img.size != (cfg.image_size, cfg.image_size):
            img = img.resize((cfg.image_size, cfg.image_size), Image.BILINEAR)
        # the reference's order: Resize -> RandomHorizontalFlip ->
        # ColorJitter -> ToTensor -> Normalize(.5, .5)
        if self.rng.random() < cfg.flip_p:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if cfg.split != "dev":
            img = self._color_jitter(img)
        arr = np.asarray(img, np.float32) / 255.0
        return arr * 2.0 - 1.0  # (H, W, 3) in [-1, 1]

    def _add_bg(self, img: np.ndarray, scale=(0.1, 1.0)) -> np.ndarray:
        h, w = img.shape[:2]
        out = np.full_like(img, -1.0)
        rh = max(min(int(h * self.rng.uniform(*scale)), h), 1)
        rw = max(min(int(rh * self.rng.uniform(0.9, 1.1)), w), 1)
        small = _resize(img, (rh, rw))
        ph = self.rng.integers(0, h - rh) if h > rh else 0
        pw = self.rng.integers(0, w - rw) if w > rw else 0
        out[ph: ph + rh, pw: pw + rw] = small
        return out

    def _mix_two(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        h, w = left.shape[:2]
        out = np.full_like(left, -1.0)
        lw = int(self.rng.integers(h // 4, h // 4 * 3))
        lh = min(int(lw * self.rng.uniform(0.8, 1.2)), h)
        rw_ = min(int((w - lw) * self.rng.uniform(0.9, 1.0)), w - lw)
        rh_ = min(int(rw_ * self.rng.uniform(0.9, 1.1)), h)
        lph = int(self.rng.integers(0, max(h - lh, 1)))
        lpw = max(int(self.rng.integers(0, max(w - lw - rw_, 1))), 0)
        rph = int(self.rng.integers(0, max(h - rh_, 1)))
        rpw = max(int(self.rng.integers(lpw + lw,
                                        max(w - rw_, lpw + lw + 1))), 0)
        out[lph: lph + lh, lpw: lpw + lw] = _resize(left, (lh, lw))
        out[rph: rph + rh_, rpw: rpw + rw_] = _resize(right, (rh_, rw_))
        return out

    # -- sampling -----------------------------------------------------------
    def _id_and_img(self, i: int):
        i %= self.cfg.num_ids * self.cfg.images_per_id
        return i // self.cfg.images_per_id, i % self.cfg.images_per_id

    def __getitem__(self, i: int) -> Dict:
        cfg = self.cfg
        id_idx, img_idx = self._id_and_img(i)
        img = self._load_aug(id_idx, img_idx)

        # crops of other identities
        diff_ids, diff_imgs = [], []
        for _ in range(cfg.diff_cnt):
            other = id_idx
            while other == id_idx:
                other, oimg = self._id_and_img(
                    int(self.rng.integers(self.num_train)))
            diff_ids.append(other)
            diff_imgs.append(self._load_aug(other, oimg))
        # a second augmentation of each
        aug2_ids = [id_idx] + diff_ids
        aug2_imgs = [self._load_aug(j, int(self.rng.integers(
            cfg.images_per_id))) for j in aug2_ids]

        dual = cfg.dual_prob > 0 and self.rng.random() < cfg.dual_prob \
            and len(diff_imgs) > 0
        faces = np.stack([img] + diff_imgs + aug2_imgs)  # (k, H, W, 3)
        ids = np.asarray([id_idx] + diff_ids + aug2_ids, np.int32)

        if dual:
            train_img = self._mix_two(img, diff_imgs[0])
            num_ids = 2
            t = str(self.rng.choice(TEMPLATES_DUAL))
            s1, s2 = PLACEHOLDER_STRINGS[0], PLACEHOLDER_STRINGS[1]
            caption = t.format(f"face of {s1} person", f"face of {s2} person")
            caption = (f"{caption}, left is a face of {s1} person, "
                       f"right is another face of {s2} person")
        else:
            train_img = self._add_bg(img) if cfg.split != "dev" else img
            num_ids = 1
            t = str(self.rng.choice(TEMPLATES_SMALL))
            caption = t.format(f"face of {PLACEHOLDER_STRINGS[0]} person")

        return {"image": train_img.astype(np.float32),
                "faces": faces.astype(np.float32),
                "ids": ids, "num_ids": np.int32(num_ids),
                "caption": caption, "id_idx": id_idx}


class PrefetchLoader:
    """Threaded batcher: collates dataset items and tokenises captions.

    One daemon thread per iteration builds batches ahead (``prefetch`` of
    them).  It stops when the iterator is exhausted, closed or dropped, and
    an exception it meets is raised in the iterating thread."""

    _POLL_S = 0.05     # how often a blocked worker checks for a stop

    def __init__(self, dataset: FaceIdDataset, tokenizer, batch_size: int,
                 face_size: Optional[int] = None, shuffle: bool = True,
                 prefetch: int = 4, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1):
        """``shard_id`` / ``num_shards``: per-host data sharding.  Every
        host shuffles the same global order (the seed must match across
        hosts) and takes the ``shard_id``-th strided slice, so hosts see
        disjoint examples; ``batch_size`` is the per-host batch and the
        global batch is ``batch_size * num_shards``."""
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.ds = dataset
        self.tokenizer = tokenizer
        self.bs = batch_size
        self.face_size = face_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards

    @classmethod
    def for_host(cls, dataset, tokenizer, batch_size, mesh=None, **kw):
        """Shard by this process: its ``data`` coordinate of ``mesh`` and the
        mesh's data size, or without a mesh its rank and the world size of
        the running process group (the JAX process index and count)."""
        import torch.distributed as dist
        if mesh is not None:
            from celebbasis_tpu_torch.parallel.mesh import (DATA, axis_index,
                                                            axis_size)
            shard_id, num_shards = axis_index(mesh, DATA), axis_size(mesh,
                                                                     DATA)
        elif dist.is_available() and dist.is_initialized():
            shard_id, num_shards = dist.get_rank(), dist.get_world_size()
        else:
            raise ValueError("for_host shards by process: pass a mesh or "
                             "start a process group")
        return cls(dataset, tokenizer, batch_size, shard_id=shard_id,
                   num_shards=num_shards, **kw)

    def _resize_faces(self, faces: np.ndarray) -> np.ndarray:
        if self.face_size is None or faces.shape[1] == self.face_size:
            return faces
        size = (self.face_size, self.face_size)
        return np.stack([_resize(f, size) for f in faces])

    def _collate(self, items: List[Dict]) -> Dict:
        return {
            "image": np.stack([it["image"] for it in items]),
            "faces": np.stack([self._resize_faces(it["faces"])
                               for it in items]),
            "ids": np.stack([it["ids"] for it in items]),
            "num_ids": np.stack([it["num_ids"] for it in items]),
            "tokens": self.tokenizer([it["caption"] for it in items]),
            "captions": [it["caption"] for it in items],
        }

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=self._POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                batch = []
                for i in order:
                    batch.append(self.ds[int(i)])
                    if len(batch) == self.bs:
                        if not put(self._collate(batch)):
                            return
                        batch = []
                put(done)
            except Exception as e:  # handed to the iterating thread
                put(e)

        t = threading.Thread(target=worker, daemon=True,
                             name="PrefetchLoader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self):
        return len(self.ds) // self.bs
