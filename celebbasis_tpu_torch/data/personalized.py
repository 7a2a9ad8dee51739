"""Textual-inversion folder datasets (the baseline path).

Counterpart of ``celebbasis_tpu/data/personalized.py`` (the reference's
``PersonalizedBase`` and ``personalized_style.py``): a folder of subject
images, captions drawn from the CLIP template bank around the placeholder
word (or from the style templates), resize / flip / centre-crop
augmentation, images in [-1, 1].  numpy and PIL only: with one seed the
items are the JAX package's, bit for bit (same generator, same draws in the
same order: the flip, then the template).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
from PIL import Image

from celebbasis_tpu_torch.data.face_id import TEMPLATES_SMALL

STYLE_TEMPLATES = [
    "a painting in the style of {}",
    "a rendering in the style of {}",
    "a cropped painting in the style of {}",
    "the painting in the style of {}",
    "a clean painting in the style of {}",
    "a picture in the style of {}",
    "a cool painting in the style of {}",
    "a close-up painting in the style of {}",
    "a bright painting in the style of {}",
    "a good painting in the style of {}",
]


@dataclass
class PersonalizedConfig:
    data_root: str
    placeholder: str = "*"
    image_size: int = 512
    repeats: int = 100
    flip_p: float = 0.5
    center_crop: bool = False
    style: bool = False
    coarse_class_text: Optional[str] = None  # e.g. 'person' -> '* person'
    seed: int = 0


class PersonalizedBase:
    """Items ``{"image": (S, S, 3) float32 in [-1, 1], "caption": str}``;
    the generator advances with every item read, as in the reference."""

    def __init__(self, cfg: PersonalizedConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.paths = sorted(
            os.path.join(cfg.data_root, f) for f in os.listdir(cfg.data_root)
            if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if not self.paths:
            raise ValueError(f"no images in {cfg.data_root}")
        self._length = len(self.paths) * cfg.repeats

    def __len__(self):
        return self._length

    def __getitem__(self, i: int) -> Dict:
        cfg = self.cfg
        img = Image.open(self.paths[i % len(self.paths)]).convert("RGB")
        if cfg.center_crop:
            w, h = img.size
            s = min(w, h)
            img = img.crop(((w - s) // 2, (h - s) // 2,
                            (w + s) // 2, (h + s) // 2))
        img = img.resize((cfg.image_size,) * 2, Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 127.5 - 1.0
        if self.rng.random() < cfg.flip_p:
            arr = arr[:, ::-1].copy()
        subject = cfg.placeholder
        if cfg.coarse_class_text:
            subject = f"{subject} {cfg.coarse_class_text}"
        bank = STYLE_TEMPLATES if cfg.style else TEMPLATES_SMALL
        caption = str(self.rng.choice(bank)).format(subject)
        return {"image": arr, "caption": caption}
