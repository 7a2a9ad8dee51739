"""Evaluation pipeline base layer — grids, naming contract, resumability.

The port's own copy of ``celebbasis_tpu/eval/base.py`` (plain Python).
Parity target: the reference's ``evaluation/base_class.py``:

* ``EvalGrid`` (EvalDatasetBase, :142-222): the prompts x identities
  enumeration with the ``shift_id`` pairing rule for two-person prompts and
  the ``{prompt_idx:05d}_id{id}_#{img}.jpg`` naming convention;
* ``ModelInfer`` (ModelInferBase.start_infer, :82-110): drives an
  ``infer_one`` callback over the grid, skipping work whose outputs already
  exist (resumable);
* ``GeneratedDataset`` (:240-319): walks a generated tree back into arrays
  grouped by (prompt, id).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def prompt_slug(prompt: str, n: int = 50) -> str:
    return "".join(c if c.isalnum() else "-" for c in prompt[:n])


def image_name(prompt_idx: int, id_idx: int, img_idx: int) -> str:
    return f"{prompt_idx:05d}_id{id_idx}_#{img_idx}.jpg"


def parse_image_name(name: str) -> Optional[Tuple[int, int, int]]:
    base = os.path.splitext(os.path.basename(name))[0]
    try:
        p, idp, imgp = base.split("_")
        return int(p), int(idp[2:]), int(imgp[1:])
    except (ValueError, IndexError):
        return None


@dataclass(frozen=True)
class EvalItem:
    prompt_idx: int
    prompt: str
    id_idx: int
    pair_idx: int
    two_person: bool
    out_dir: str


class EvalGrid:
    """prompts x ids enumeration with shift-pairing (EvalDatasetBase)."""

    def __init__(self, prompts: Sequence[str], ids: Sequence[int],
                 out_root: str, shift_id: int = 1,
                 pos_template: str = "{}"):
        self.prompts = list(prompts)
        self.ids = list(ids)
        self.out_root = out_root
        self.shift_id = shift_id
        self.pos_template = pos_template

    @staticmethod
    def is_two_person(prompt: str) -> bool:
        rest = prompt.replace("sks person", "")
        return "ks person" in rest

    def __iter__(self) -> Iterator[EvalItem]:
        n = len(self.ids)
        for pi, prompt in enumerate(self.prompts):
            out_dir = os.path.join(self.out_root,
                                   f"{pi:03d}_{prompt_slug(prompt)}")
            for id_idx in self.ids:
                yield EvalItem(
                    prompt_idx=pi,
                    prompt=self.pos_template.format(prompt),
                    id_idx=id_idx,
                    pair_idx=self.ids[(self.ids.index(id_idx)
                                       + self.shift_id) % n],
                    two_person=self.is_two_person(prompt),
                    out_dir=out_dir)

    def __len__(self):
        return len(self.prompts) * len(self.ids)


class ModelInfer:
    """Resumable grid runner (ModelInferBase.start_infer parity).

    ``infer_one(item) -> list[np.ndarray]`` returns the generated images in
    [-1, 1]; they are written with the naming contract. Items whose first
    output exists are skipped.
    """

    def __init__(self, infer_one: Callable[[EvalItem], List[np.ndarray]]):
        self.infer_one = infer_one

    def start_infer(self, grid: EvalGrid, verbose: bool = True) -> int:
        from PIL import Image
        n_done = 0
        for item in grid:
            os.makedirs(item.out_dir, exist_ok=True)
            first = os.path.join(item.out_dir,
                                 image_name(item.prompt_idx, item.id_idx, 0))
            if os.path.exists(first):
                continue
            images = self.infer_one(item)
            for bi, img in enumerate(images):
                u8 = (img if img.dtype == np.uint8
                      else ((img + 1) * 127.5).clip(0, 255).astype(np.uint8))
                Image.fromarray(u8).save(os.path.join(
                    item.out_dir,
                    image_name(item.prompt_idx, item.id_idx, bi)))
            n_done += 1
            if verbose:
                print(f"[infer] prompt {item.prompt_idx} id {item.id_idx}: "
                      f"{len(images)} images")
        return n_done


class GeneratedDataset:
    """Walk a generated tree into {(prompt_dir, id): [arrays]}."""

    def __init__(self, root: str):
        self.root = root

    def groups(self) -> Dict[Tuple[str, int], List[str]]:
        out: Dict[Tuple[str, int], List[str]] = {}
        for d in sorted(os.listdir(self.root)):
            full = os.path.join(self.root, d)
            if not os.path.isdir(full):
                continue
            for f in sorted(os.listdir(full)):
                parsed = parse_image_name(f)
                if parsed is None:
                    continue
                out.setdefault((d, parsed[1]), []).append(
                    os.path.join(full, f))
        return out

    def load_group(self, paths: Sequence[str]) -> np.ndarray:
        from PIL import Image
        return np.stack([
            np.asarray(Image.open(p).convert("RGB"), np.float32) / 127.5 - 1.0
            for p in paths])
