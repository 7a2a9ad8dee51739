"""Score computation (counterpart of ``celebbasis_tpu/cli/eval_imgs.py``, the
reference's ``evaluation/eval_imgs.py``; stage 2 of W4).

Walks the generated evaluation folder that ``cli/gen_imgs.py`` writes with
the reference's IDCLIPScoreCalculator loop: CLIP ViT-B/32 image-image and
text-image similarity, identity cosine / MSE / L2 through sphere20, face
counts, and with ``--fid`` the FID against the source folder (Inception-v3
pool3 with ``--inception_ckpt``, else CLIP-FID on the ViT's features).
Prints the scores and writes ``scores.json``.  Without checkpoints the
networks are random (a warning says so): for contract checks only.

Scoring runs in float32 with TF32 off (``utils.precision.no_tf32``).  With
``--detector_ckpt`` or ``--pipnet_ckpt`` every image is first aligned by the
W0 chain (FaceBoxes -> PIPNet -> FFHQ ``norm_crop``, ``build_cropper``) and
an image without a face counts in ``num_no_face``; without them the inputs
count as aligned crops, as in the JAX package.  Runs on ``cuda``;
``--device cpu`` asks for the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.eval_imgs --eval_folder out/ \
        --clip_ckpt ViT-B-32.pt --sphere_ckpt sphere20.pth --fid \
        --inception_ckpt pt_inception-2015-12-05.pth
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from celebbasis_tpu_torch.eval.evaluators import (CLIPEvaluator,
                                                  IdCLIPEvaluator,
                                                  IdentityEvaluator,
                                                  IDCLIPScoreCalculator,
                                                  face_cropper_from_nets)
from celebbasis_tpu_torch.eval.fid import (FIDScorer, clip_feature_fn,
                                           copy_together)
from celebbasis_tpu_torch.eval.sphere import (SphereConfig, SphereNet,
                                              convert_sphere)
from celebbasis_tpu_torch.loader import init_weights, resolve_device
from celebbasis_tpu_torch.models.clip_text import CLIPTextConfig
from celebbasis_tpu_torch.models.clip_vit import (CLIPTextTower,
                                                  CLIPVisionConfig,
                                                  CLIPVisionEncoder,
                                                  convert_hf_clip,
                                                  convert_openai_clip,
                                                  text_config_b32)
from celebbasis_tpu_torch.text.tokenizer import (CLIPTokenizer,
                                                 default_tokenizer)
from celebbasis_tpu_torch.utils.precision import no_tf32
from celebbasis_tpu_torch.utils.pt_io import load_pt


def _random_state(module: torch.nn.Module, seed: int):
    """A random state dict for `module` (``loader.init_weights``)."""
    return init_weights(module, torch.Generator().manual_seed(seed)
                        ).state_dict()


def build_cropper(detector_ckpt=None, pipnet_ckpt=None, meanface=None,
                  img_size=512, mode="ffhq", seed=0, device=None):
    """The identity scorer's alignment chain (FaceBoxesV2, PIPNet
    ResNet-101) from the reference's files; random nets where a file is
    not given."""
    from celebbasis_tpu_torch.cli.align import (_init_detector,
                                                _init_landmarker)
    detector = _init_detector(detector_ckpt, seed=seed, device=device)
    landmarker = _init_landmarker(pipnet_ckpt, meanface, seed=seed,
                                  device=device)
    return face_cropper_from_nets(detector, landmarker, img_size, mode)


def build_scorers(clip_ckpt=None, sphere_ckpt=None, vocab=None, seed=0,
                  tiny=False, face_cropper=None, img_size=512, device=None):
    """-> (IdCLIPEvaluator, CLIPEvaluator) on ``device``; random networks
    where no checkpoint is given; ``tiny`` for toy-size scorers."""
    dev = resolve_device(device)
    if tiny:
        vcfg, tcfg = CLIPVisionConfig.tiny(), CLIPTextConfig.tiny()
    else:
        vcfg, tcfg = CLIPVisionConfig.vit_b32(), text_config_b32()
    tokenizer = default_tokenizer(vocab)
    if tokenizer.vocab_size != tcfg.vocab_size:
        tokenizer = CLIPTokenizer.synthetic(tcfg.vocab_size)
    if clip_ckpt:
        state = load_pt(clip_ckpt)
        state = state.get("state_dict", state)
        convert = (convert_hf_clip if any(
            str(k).startswith("vision_model.") for k in state)
            else convert_openai_clip)
        vp, tp = convert(state, vcfg, tcfg)
    else:
        print("[eval] WARNING: no CLIP checkpoint -- random weights")
        vp = _random_state(CLIPVisionEncoder(vcfg), seed)
        tp = _random_state(CLIPTextTower(tcfg, proj_dim=vcfg.proj_dim), seed)
    clip_eval = CLIPEvaluator(vp, tp, tokenizer, vcfg, tcfg, device=dev)

    scfg = SphereConfig.tiny() if tiny else SphereConfig.sphere20()
    if sphere_ckpt:
        sp = convert_sphere(load_pt(sphere_ckpt), scfg)
    else:
        print("[eval] WARNING: no sphere20 checkpoint -- random weights")
        sp = _random_state(SphereNet(scfg), seed)
    id_eval = IdentityEvaluator(sp, face_cropper=face_cropper, cfg=scfg,
                                img_size=img_size,
                                face_size=scfg.input_size, device=dev)
    return IdCLIPEvaluator(clip_eval, id_eval), clip_eval


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--eval_folder", type=str, required=True,
                   help="gen_imgs output dir (prompts.txt + imgs/)")
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="CLIP ViT-B/32 (OpenAI .pt or HuggingFace layout)")
    p.add_argument("--sphere_ckpt", type=str, default=None)
    p.add_argument("--detector_ckpt", type=str, default=None,
                   help="FaceBoxesV2 weights for the identity cropper; omit "
                        "(and --pipnet_ckpt) to score inputs as aligned "
                        "crops")
    p.add_argument("--pipnet_ckpt", type=str, default=None,
                   help="PIPNet (ResNet-101, WFLW) weights for the cropper")
    p.add_argument("--meanface", type=str, default=None)
    p.add_argument("--img_size", type=int, default=512,
                   help="identity crop size (clip_eval.py img_size)")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--fid", action="store_true")
    p.add_argument("--fid_src", type=str, default=None,
                   help="source folder for FID (default: the folder of "
                        "in_image_paths.txt's first entry)")
    p.add_argument("--inception_ckpt", type=str, default=None,
                   help="InceptionV3 weights (pytorch-fid pt_inception or "
                        "torchvision inception_v3): Inception-pool3 FID; "
                        "without it --fid reports CLIP-FID")
    p.add_argument("--tiny", action="store_true",
                   help="toy-size scorers (functional checks)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> dict:
    """Scores the folder; returns the scores written to ``scores.json``."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    with no_tf32():
        cropper = None
        if args.detector_ckpt or args.pipnet_ckpt:
            cropper = build_cropper(args.detector_ckpt, args.pipnet_ckpt,
                                    args.meanface, args.img_size,
                                    device=device)
        evaluator, clip_eval = build_scorers(
            args.clip_ckpt, args.sphere_ckpt, args.vocab, tiny=args.tiny,
            face_cropper=cropper, img_size=args.img_size, device=device)
        calc = IDCLIPScoreCalculator(args.eval_folder, evaluator)
        scores = calc.start_calc()
        if args.fid:
            src_folder = args.fid_src or os.path.dirname(
                calc.dataset.src_img_paths[0][0])
            flat = os.path.join(args.eval_folder, "_flat_for_fid")
            copy_together(os.path.join(args.eval_folder, "imgs"), flat)
            if args.inception_ckpt:
                from celebbasis_tpu_torch.eval.inception import load_inception
                feat_fn, _ = load_inception(args.inception_ckpt,
                                            device=clip_eval.device)
                scores["fid"] = FIDScorer(feat_fn).fid(src_folder, flat)
            else:
                print("[eval] no --inception_ckpt: reporting CLIP-FID (not "
                      "comparable to Inception-FID numbers)")
                scores["clip_fid"] = FIDScorer(
                    clip_feature_fn(clip_eval)).fid(src_folder, flat)

    print(json.dumps(scores, indent=2))
    out = args.out or os.path.join(args.eval_folder, "scores.json")
    with open(out, "w") as f:
        json.dump(scores, f, indent=2)
    print(f"[eval_imgs] wrote {out}")
    return scores


if __name__ == "__main__":
    main()
