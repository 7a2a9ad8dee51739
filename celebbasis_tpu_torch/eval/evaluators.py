"""Quantitative evaluators: CLIP similarity, identity cosine, aggregation.

Counterpart of ``celebbasis_tpu/eval/evaluators.py`` (the reference's
``evaluation/clip_eval.py`` and ``base_class.py``):

* ``CLIPEvaluator``: ViT-B/32 image-image and text-image cosine
  similarities over normalised features.  The image preprocessing is the
  evaluation's own arithmetic (``models.clip_vit.preprocess_images``).
* ``IdentityEvaluator``: ``start_calc(ori1, ori2)`` -- uint8 round trip ->
  face crop (the first image always kept and counted has_face) ->
  ToPILImage / Resize / ToTensor / Normalize(0.5) replay -> the fixed
  insightface affine (``ops.warp``: grid_sample at crop resolution, then
  interpolate to 112) -> sphere20 -> normalised-feature cosine / MSE /
  L2 = sqrt(MSE * dim) / 2.
* ``IdCLIPEvaluator`` combining both;
* ``GeneratedEvalFolder`` / ``IDCLIPScoreCalculator`` walking the generated
  evaluation folder (``prompts.txt`` / ``in_image_paths.txt`` /
  ``in_image_ids.txt`` + ``imgs/{i:05d}_id{id:05d}_{prompt}/``) and
  averaging, with the ``id_cos > 1e-6`` inclusion filter.

The networks take state dicts in the port's names (``convert_*`` of their
modules) and run on ``device`` (``cuda`` unless the caller asks for the CPU)
in float32 with TF32 off (``utils.precision.no_tf32``), as the JAX package
scores at ``"highest"`` matmul precision.  ``face_cropper_from_nets``
builds the identity scorer's alignment cropper from the W0 nets (FaceBoxes
and PIPNet, ``align/``); scoring without a cropper treats inputs as aligned
crops.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from celebbasis_tpu_torch.eval.sphere import SphereConfig, SphereNet
from celebbasis_tpu_torch.loader import resolve_device
from celebbasis_tpu_torch.models.clip_text import CLIPTextConfig
from celebbasis_tpu_torch.models.clip_vit import (CLIPTextTower,
                                                  CLIPVisionConfig,
                                                  CLIPVisionEncoder,
                                                  preprocess_images,
                                                  text_config_b32)
from celebbasis_tpu_torch.ops.warp import (INSIGHTFACE_TRANS_MATRIX,
                                           batched_affine_warp_resize)
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.utils.precision import no_tf32


def _norm(x: np.ndarray) -> np.ndarray:
    """Plain feature normalisation (exact division, as clip_eval.py)."""
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _f_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """torch F.normalize(p=2, dim=-1): x / max(||x||, eps)."""
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


def _frozen(module: torch.nn.Module, state) -> torch.nn.Module:
    module.load_state_dict(state, strict=True)
    return module.requires_grad_(False).eval()


class CLIPEvaluator:
    """img-img and txt-img similarity on the shared CLIP space."""

    def __init__(self, vision_params, text_params, tokenizer: CLIPTokenizer,
                 vision_cfg: CLIPVisionConfig = CLIPVisionConfig.vit_b32(),
                 text_cfg: Optional[CLIPTextConfig] = None, device=None):
        text_cfg = text_cfg or text_config_b32()
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        with torch.device(self.device):
            self.vision = _frozen(CLIPVisionEncoder(vision_cfg),
                                  vision_params)
            self.text = _frozen(CLIPTextTower(text_cfg,
                                              proj_dim=vision_cfg.proj_dim),
                                text_params)
        self.size = vision_cfg.image_size

    def image_features(self, images_minus1_1: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(preprocess_images(images_minus1_1, self.size))
        with torch.inference_mode(), no_tf32():
            feats = self.vision(x.to(self.device)).cpu().numpy()
        return _norm(feats)

    def text_features(self, texts: Sequence[str]) -> np.ndarray:
        toks = torch.from_numpy(np.asarray(self.tokenizer(list(texts)),
                                           np.int64))
        with torch.inference_mode(), no_tf32():
            feats = self.text(toks.to(self.device)).cpu().numpy()
        return _norm(feats)

    def img_to_img_similarity(self, src_images, generated_images) -> float:
        a = self.image_features(src_images)
        b = self.image_features(generated_images)
        return float((a @ b.T).mean())

    def txt_to_img_similarity(self, text: str, generated_images) -> float:
        t = self.text_features([text])
        i = self.image_features(generated_images)
        return float((t @ i.T).mean())

    def evaluate(self, gen_samples, src_images, target_text: str):
        """(sim_img, sim_text), the '*' taken out of the text."""
        return (self.img_to_img_similarity(src_images, gen_samples),
                self.txt_to_img_similarity(target_text.replace("*", ""),
                                           gen_samples))


def face_cropper_from_nets(detector, landmarker, img_size: int = 512,
                           mode: str = "ffhq"):
    """The reference's ``_check_lmk_box_for_one_image``: detect (at scale
    1) -> the first detection's 98 landmarks -> ``get_5_from_98`` -> the
    ``img_size`` FFHQ ``norm_crop``.  The returned function maps a uint8
    image to (crop, True), or to (the image, False) when no face is
    found."""
    from celebbasis_tpu_torch.align.alignment import get_5_from_98, norm_crop

    def crop(img_u8: np.ndarray) -> Tuple[np.ndarray, bool]:
        dets = detector.detect(img_u8, im_scale=1.0)
        if not dets:
            return img_u8, False
        lmk98 = landmarker.landmarks_for_box(img_u8, dets[0])
        return norm_crop(img_u8, get_5_from_98(lmk98), img_size, mode), True

    return crop


def _trans_arr_to_tensor(crop_u8: np.ndarray, img_size: int) -> np.ndarray:
    """ToPILImage -> Resize(img_size) -> ToTensor -> Normalize(0.5), HWC
    float32 in [-1, 1].  Resize(int) is torchvision's short-side contract:
    a no-op for square crops of that size."""
    from PIL import Image
    img = Image.fromarray(crop_u8)
    w, h = img.size
    if min(w, h) != img_size:
        if w <= h:
            nw, nh = img_size, int(img_size * h / w)
        else:
            nw, nh = int(img_size * w / h), img_size
        img = img.resize((nw, nh), Image.BILINEAR)
    x = np.asarray(img, np.float32)
    return (x / np.float32(255.0) - np.float32(0.5)) / np.float32(0.5)


class IdentityEvaluator:
    """Face-identity similarity through sphere20 CosFace on aligned crops.

    ``face_cropper`` is a callable (image_u8) -> (crop_u8, success); None
    treats every input as an already aligned crop (success=True).
    """

    def __init__(self, sphere_params, face_cropper=None,
                 cfg: SphereConfig = SphereConfig.sphere20(),
                 img_size: int = 512, face_size: int = 112, device=None):
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.net = _frozen(SphereNet(dataclasses.replace(
                cfg, input_size=face_size)), sphere_params)
        self.face_cropper = face_cropper
        self.img_size = img_size
        self.face_size = face_size
        self._trans = INSIGHTFACE_TRANS_MATRIX.to(self.device)

    def embed_crops(self, crops_minus1_1: np.ndarray) -> np.ndarray:
        """Two-stage resample (grid_sample at crop resolution, then
        interpolate to 112: the reference's filtering), then sphere20."""
        crops = torch.from_numpy(np.ascontiguousarray(crops_minus1_1,
                                                      np.float32))
        with torch.inference_mode(), no_tf32():
            faces = batched_affine_warp_resize(
                crops.to(self.device), self._trans,
                (self.face_size, self.face_size))
            return self.net(faces).cpu().numpy()

    def _check_lmk_box(self, imgs_minus1_1: np.ndarray):
        """uint8 round trip, a crop per image; the FIRST image is always
        kept and counted has_face, even without a face (the reference's
        ``success or i == 0``)."""
        arr = ((imgs_minus1_1 + 1.0) * 127.5).astype(np.uint8)
        kept: List[np.ndarray] = []
        has, no = 0, 0
        for i, img in enumerate(arr):
            if self.face_cropper is None:
                crop, ok = img, True
            else:
                crop, ok = self.face_cropper(img)
            if ok or i == 0:
                has += 1
                kept.append(_trans_arr_to_tensor(crop, self.img_size))
            else:
                no += 1
        return np.stack(kept), has, no

    def _img_to_img_id_sim(self, face1: np.ndarray, face2: np.ndarray):
        """Normalised features; cosine over all (n1, n2) pairs; MSE / L2 on
        the n2-tiled rows (defined for n1 == 1, like the reference's
        sklearn call)."""
        n1, n2 = len(face1), len(face2)
        if n1 < 1 or n2 < 1:
            return 0.0, 0.0, 0.0
        feats = _f_normalize(self.embed_crops(
            np.concatenate([face1, face2], axis=0)))
        f1, f2 = feats[:n1], feats[n1:]
        cos = float((f1 @ f2.T).mean())
        if n1 != 1:
            raise ValueError(
                "MSE/L2 pairing requires one source image per item (the "
                "reference's repeat(n2, 1) against (n2, d) raises otherwise)")
        diff = np.tile(f1, (n2, 1)) - f2
        mse = float((diff ** 2).mean())
        l2 = float(np.sqrt(mse * feats.shape[-1]) / 2)
        return cos, mse, l2

    def start_calc(self, ori1: np.ndarray, ori2: np.ndarray
                   ) -> Dict[str, float]:
        """ori1 (n1, H, W, C) sources, ori2 (n2, H, W, C) generations, in
        [-1, 1], channels-last."""
        n1 = len(ori1)
        crops, has, no = self._check_lmk_box(
            np.concatenate([ori1, ori2], axis=0))
        cos, mse, l2 = self._img_to_img_id_sim(crops[:n1], crops[n1:])
        return {"cos_sim": cos, "mse_dist": mse, "l2_dist": l2,
                "num_has_face": has, "num_no_face": no}


class IdCLIPEvaluator:
    """CLIP and identity metrics together."""

    def __init__(self, clip_eval: CLIPEvaluator, id_eval: IdentityEvaluator):
        self.clip = clip_eval
        self.id = id_eval

    def evaluate(self, gen_samples: np.ndarray, src_images: np.ndarray,
                 target_text: str):
        """The reference's argument order (gen, src, text); returns
        (sim_img, sim_text, id_result_dict)."""
        sim_img = self.clip.img_to_img_similarity(src_images, gen_samples)
        sim_text = self.clip.txt_to_img_similarity(target_text, gen_samples)
        id_dict = self.id.start_calc(src_images, gen_samples)
        return sim_img, sim_text, id_dict


def _load_minus1_1(path: str) -> np.ndarray:
    """jpg -> HWC float32 by the ToTensor / Normalize(0.5) arithmetic."""
    from PIL import Image
    x = np.asarray(Image.open(path).convert("RGB"), np.float32)
    return (x / np.float32(255.0) - np.float32(0.5)) / np.float32(0.5)


class GeneratedEvalFolder:
    """The generated evaluation folder: ``prompts.txt`` /
    ``in_image_paths.txt`` / ``in_image_ids.txt`` beside
    ``imgs/{i:05d}_id{src_id:05d}_{prompt}/`` folders of generations.  The
    list files hold ``str(list)`` lines, parsed back by the reference's
    regular expressions."""

    def __init__(self, eval_folder: str):
        import re
        self.eval_folder = eval_folder
        with open(os.path.join(eval_folder, "prompts.txt")) as f:
            self.prompts = f.read().splitlines()
        path_pat = re.compile(r"[a-zA-Z\d#.:/_-]+")
        with open(os.path.join(eval_folder, "in_image_paths.txt")) as f:
            self.src_img_paths = [path_pat.findall(line)
                                  for line in f.read().splitlines()]
        num_pat = re.compile(r"\d+")
        with open(os.path.join(eval_folder, "in_image_ids.txt")) as f:
            self.src_ids = [num_pat.findall(line)
                            for line in f.read().splitlines()]
        self.gen_img_folders = [
            os.path.join(eval_folder,
                         f"imgs/{i:05d}_id{int(self.src_ids[i][0]):05d}_"
                         f"{self.prompts[i]}")
            for i in range(len(self.prompts))]

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, index: int):
        src = _load_minus1_1(self.src_img_paths[index][0])[None]
        folder = self.gen_img_folders[index]
        gen = np.stack([_load_minus1_1(os.path.join(folder, x))
                        for x in sorted(os.listdir(folder))])
        return self.prompts[index], src, gen


class IDCLIPScoreCalculator:
    """Walk a generated evaluation folder and average the scores:
    image / text similarity over every item; identity cos / MSE / L2 over
    the items whose cos clears 1e-6; face counts summed."""

    def __init__(self, eval_folder: str, evaluator: IdCLIPEvaluator,
                 verbose: bool = True):
        self.dataset = GeneratedEvalFolder(eval_folder)
        self.evaluator = evaluator
        self.verbose = verbose

    def start_calc(self) -> Dict[str, float]:
        sim_img_list: List[float] = []
        sim_text_list: List[float] = []
        cos_list: List[float] = []
        mse_list: List[float] = []
        l2_list: List[float] = []
        num_has_face, num_no_face = 0, 0
        for idx in range(len(self.dataset)):
            prompt, src, gen = self.dataset[idx]
            sim_img, sim_text, id_dict = self.evaluator.evaluate(
                gen, src, prompt.replace("sks", ""))
            if self.verbose:
                print("Image similarity: ", sim_img)
                print("Text similarity: ", sim_text)
                print("Identity cos similarity: ", id_dict["cos_sim"])
            sim_img_list.append(sim_img)
            sim_text_list.append(sim_text)
            if id_dict["cos_sim"] > 1e-6:
                cos_list.append(id_dict["cos_sim"])
                mse_list.append(id_dict["mse_dist"])
                l2_list.append(id_dict["l2_dist"])
            num_has_face += id_dict["num_has_face"]
            num_no_face += id_dict["num_no_face"]
        out = {
            "image_sim": float(np.mean(sim_img_list)),
            "text_sim": float(np.mean(sim_text_list)),
            "id_cos_sim": float(np.mean(cos_list)) if cos_list else 0.0,
            "id_mse_dist": float(np.mean(mse_list)) if mse_list else 0.0,
            "id_l2_dist": float(np.mean(l2_list)) if l2_list else 0.0,
            "num_has_face": num_has_face,
            "num_no_face": num_no_face,
            "n_items": len(self.dataset),
            "n_id_items": len(cos_list),
        }
        if self.verbose:
            print("Image similarity (avg): ", out["image_sim"])
            print("Text similarity (avg): ", out["text_sim"])
            print("Identity cos similarity (avg): ", out["id_cos_sim"],
                  f"mse_dist={out['id_mse_dist']:.4f}, "
                  f"l2_dist={out['id_l2_dist']:.4f}",
                  f"has_face={num_has_face}, no_face={num_no_face}")
        return out
