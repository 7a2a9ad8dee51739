"""Face align and crop (W0; counterpart of ``celebbasis_tpu/cli/align.py``,
the reference's ``00_align_face.sh`` + ``PIPNet/start_align.py``).

A folder of photos -> FaceBoxesV2 detection -> PIPNet 98 landmarks ->
``get_5_from_98`` -> FFHQ-template ``norm_crop`` (256 x 256) -> resized to
``--crop_size`` -> the crops, saved under the photos' names, and
``<out_folder>.pickle``, the list of their paths that the training data
reads (the reference's ``alignment/gen_pickle.py``).

Weights: ``--detector_ckpt`` (FaceBoxesV2.pth), ``--pipnet_ckpt``
(epoch59.pth, ResNet-101 on WFLW) and ``--meanface`` in the reference's
formats; without them the nets are random (a warning says so) and the
mean face a uniform grid.  The nets run on ``cuda``; ``--device cpu`` asks
for the CPU on purpose.  ``--workers`` threads each take whole photos
through the chain, sharing the two nets; the crops are those of
``--workers 1`` byte for byte.

    python -m celebbasis_tpu_torch.cli.align --in_folder photos/ \\
        --out_folder aligned/ --detector_ckpt FaceBoxesV2.pth \\
        --pipnet_ckpt epoch59.pth --meanface meanface.txt
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import shutil

import numpy as np
import torch
from PIL import Image

from celebbasis_tpu_torch.align.alignment import get_5_from_98, norm_crop
from celebbasis_tpu_torch.align.faceboxes import (FaceBoxesDetector,
                                                  FaceBoxesV2)
from celebbasis_tpu_torch.align.pipnet import (PIPNet, PIPNetConfig,
                                               PIPNetLandmarker,
                                               read_meanface)
from celebbasis_tpu_torch.loader import init_weights, resolve_device
from celebbasis_tpu_torch.utils.precision import no_tf32

IMAGE_PATTERNS = ("*.jpg", "*.jpeg", "*.png")


def gen_pickle_abs(folder: str, out_pickle: str):
    """Every entry of ``folder``, sorted, joined onto the folder as given
    (the pickle lives outside the folder, so it never lists itself)."""
    paths = [os.path.join(folder, n) for n in sorted(os.listdir(folder))]
    with open(out_pickle, "wb") as f:
        pickle.dump(paths, f)
    return paths


def _random_state(module: torch.nn.Module, seed: int):
    return init_weights(module, torch.Generator().manual_seed(seed)
                        ).state_dict()


def _init_detector(ckpt, seed=0, device=None):
    if ckpt:
        from celebbasis_tpu_torch.utils.bridge_align import convert_faceboxes
        from celebbasis_tpu_torch.utils.pt_io import load_pt
        params = convert_faceboxes(load_pt(ckpt))
    else:
        print("[align] WARNING: no detector checkpoint -- random weights")
        params = _random_state(FaceBoxesV2(), seed)
    return FaceBoxesDetector(params, device=device)


def _init_landmarker(ckpt, meanface_path, seed=0, device=None):
    cfg = PIPNetConfig()
    if ckpt:
        from celebbasis_tpu_torch.utils.bridge_align import convert_pipnet
        from celebbasis_tpu_torch.utils.pt_io import load_pt
        params = convert_pipnet(load_pt(ckpt), cfg)
    else:
        print("[align] WARNING: no PIPNet checkpoint -- random weights")
        params = _random_state(PIPNet(cfg), seed)
    if meanface_path and os.path.exists(meanface_path):
        meanface = read_meanface(meanface_path)
    else:
        print("[align] WARNING: no meanface file -- using a uniform grid")
        g = int(np.ceil(np.sqrt(cfg.num_lms)))
        xs, ys = np.meshgrid(np.linspace(0.1, 0.9, g),
                             np.linspace(0.1, 0.9, g))
        meanface = np.stack([xs.ravel(), ys.ravel()], -1)[: cfg.num_lms]
    return PIPNetLandmarker(params, cfg, meanface, device=device)


def _align_one(path: str, out_folder: str, detector, landmarker,
               crop_size: int, mode: str, hires: bool = False) -> bool:
    """One photo through the reference's product chain:

    * the RGB array goes into both nets as it is, at scale 1 (the
      reference never rescales here, and its PIPNet therefore sees
      channel-flipped crops);
    * the first detection after NMS;
    * the crop of ``aligned_crop``, saved under the photo's own name."""
    rgb = np.asarray(Image.open(path).convert("RGB"))
    dets = detector.detect(rgb, im_scale=1.0)
    if not dets:
        print(f"[align] no face in {path}")
        return False
    lmk98 = landmarker.landmarks_for_box(rgb, dets[0])
    out_arr = aligned_crop(rgb, lmk98, crop_size, mode, hires)
    Image.fromarray(out_arr).save(os.path.join(out_folder,
                                               os.path.basename(path)))
    return True


def aligned_crop(rgb: np.ndarray, lmk98: np.ndarray, crop_size: int,
                 mode: str = "ffhq", hires: bool = False) -> np.ndarray:
    """98 landmarks -> the saved crop: ``norm_crop`` at a fixed 256,
    resized by PIL (bilinear) to ``crop_size``, then the reference's
    ToTensor / Normalize(0.5) / ``((t + 1) * 127.5).astype(uint8)`` round
    trip in float32, which can take a level off a pixel.  ``hires=True``
    crops at ``crop_size`` directly, without the 256 step and the round
    trip."""
    lmk5 = get_5_from_98(lmk98)
    if hires:
        return norm_crop(rgb, lmk5, crop_size, mode)
    pil = Image.fromarray(norm_crop(rgb, lmk5, 256, mode))
    if crop_size != 256:
        pil = pil.resize((crop_size, crop_size), Image.BILINEAR)
    x = np.asarray(pil, np.float32)
    t = (x / np.float32(255.0) - np.float32(0.5)) / np.float32(0.5)
    return ((t + np.float32(1.0)) * np.float32(127.5)).astype(np.uint8)


def annotate_frame(rgb: np.ndarray, detector, landmarker):
    """The reference's demo drawing: every detection's enlarged box and its
    landmarks in red.  -> (annotated PIL image, any face found)."""
    from PIL import ImageDraw
    img = Image.fromarray(np.ascontiguousarray(rgb))
    # the demos feed the nets the BGR frame; landmarks_for_box flips the crop
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    dets = detector.detect(bgr, im_scale=1.0)
    draw = ImageDraw.Draw(img)
    H, W = rgb.shape[:2]
    s = landmarker.det_box_scale
    for det in dets:
        xmin = max(det.xmin - int(det.width * (s - 1) / 2), 0)
        ymin = min(max(det.ymin + int(det.height * (s - 1) / 2), 0), H - 1)
        xmax = min(det.xmin + det.width - 1 + int(det.width * (s - 1) / 2),
                   W - 1)
        ymax = min(det.ymin + det.height - 1 + int(det.height * (s - 1) / 2),
                   H - 1)
        draw.rectangle([xmin, ymin, xmax, ymax], outline=(255, 0, 0), width=2)
        for x, y in landmarker.landmarks_for_box(bgr, det):
            draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=(255, 0, 0))
    return img, bool(dets)


def _annotate_one(path: str, out_folder: str, detector, landmarker) -> bool:
    """The demo on one photo -> ``<name>_out.jpg``."""
    rgb = np.asarray(Image.open(path).convert("RGB"))
    img, found = annotate_frame(rgb, detector, landmarker)
    name = os.path.splitext(os.path.basename(path))[0] + "_out.jpg"
    img.save(os.path.join(out_folder, name))
    return found


def _images(folder: str):
    return sorted(p for ext in IMAGE_PATTERNS
                  for p in glob.glob(os.path.join(folder, ext)))


def annotate_video(in_path: str, out_path: str, detector, landmarker,
                   thresh: float = 0.9) -> int:
    """Detect, landmark and annotate every frame of a stream (the
    reference's ``lib/demo_video.py``, detector threshold 0.9).

    ``in_path`` is a directory of frames (annotated frames go to the
    directory ``out_path`` as ``frame_%06d.jpg``), a video file or
    ``camera`` (OpenCV decodes and writes mp4v; without a codec the frames
    go to ``<out_path>_frames/``).  -> the number of frames."""
    old_thresh, detector.thresh = detector.thresh, thresh
    try:
        if os.path.isdir(in_path):
            frames = _images(in_path)
            os.makedirs(out_path, exist_ok=True)
            for i, fp in enumerate(frames):
                rgb = np.asarray(Image.open(fp).convert("RGB"))
                img, _ = annotate_frame(rgb, detector, landmarker)
                img.save(os.path.join(out_path, f"frame_{i:06d}.jpg"))
            return len(frames)

        import cv2     # video decoding and encoding only
        cap = cv2.VideoCapture(0 if in_path == "camera" else in_path)
        if not cap.isOpened():
            raise IOError(f"cannot open video stream {in_path!r}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        frame_dir = None
        if not writer.isOpened():
            frame_dir = os.path.splitext(out_path)[0] + "_frames"
            os.makedirs(frame_dir, exist_ok=True)
            print(f"[align] no mp4 codec -- writing frames to {frame_dir}")
        count = 0
        while True:
            ret, frame = cap.read()     # BGR
            if not ret:
                break
            img, _ = annotate_frame(frame[:, :, ::-1], detector, landmarker)
            if frame_dir is None:
                writer.write(np.asarray(img)[:, :, ::-1])
            else:
                img.save(os.path.join(frame_dir, f"frame_{count:06d}.jpg"))
            count += 1
        cap.release()
        if frame_dir is None:
            writer.release()
        return count
    finally:
        detector.thresh = old_thresh


def align_folder(in_folder: str, out_folder: str, detector, landmarker,
                 crop_size: int = 512, mode: str = "ffhq",
                 workers: int = 4, hires: bool = False) -> int:
    """Each of ``workers`` threads takes whole photos through the chain
    (decode, detect, landmarks, crop, save), so that one photo's host work
    overlaps another's device work; the per-photo code is the serial one.
    -> the number of faces cropped."""
    os.makedirs(out_folder, exist_ok=True)
    images = _images(in_folder)
    one = lambda p: _align_one(p, out_folder, detector, landmarker,
                               crop_size, mode, hires)
    # TF32 off for the whole run: no_tf32 saves and restores a global
    # setting, so the threads' own blocks (in the nets' forwards) must find
    # it off already, or one thread's exit could turn it on under another
    with no_tf32():
        if workers <= 1:
            return sum(one(p) for p in images)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return sum(pool.map(one, images))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in_folder", default=None,
                   help="input photo folder (required unless --video)")
    p.add_argument("--out_folder", required=True)
    p.add_argument("--crop_size", type=int, default=512)
    p.add_argument("--mode", type=str, default="ffhq",
                   choices=["ffhq", "arcface", "set1", "mtcnn"])
    p.add_argument("--detector_ckpt", type=str, default=None)
    p.add_argument("--pipnet_ckpt", type=str, default=None)
    p.add_argument("--meanface", type=str, default=None)
    p.add_argument("--workers", type=int, default=4,
                   help="threads taking photos through the chain (1: one "
                        "after another)")
    p.add_argument("--out_pickle", type=str, default=None,
                   help="path list pickle (default: <out_folder>.pickle)")
    p.add_argument("--hires_crop", action="store_true",
                   help="norm_crop directly at crop_size instead of the "
                        "reference's 256 crop and resize")
    p.add_argument("--annotate", action="store_true",
                   help="demo mode: draw boxes and landmarks instead of "
                        "cropping; no pickle is written")
    p.add_argument("--video", type=str, default=None,
                   help="video demo: a video file, 'camera', or a "
                        "directory of frames; --out_folder is the output "
                        "video path (or frame directory)")
    p.add_argument("--video_thresh", type=float, default=0.9,
                   help="detector threshold for --video")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> int:
    """-> the number of faces cropped (frames or photos annotated with
    --video or --annotate)."""
    p = build_argparser()
    args = p.parse_args(argv)
    if args.video is None and args.in_folder is None:
        p.error("--in_folder is required unless --video is given")
    device = resolve_device(args.device)
    detector = _init_detector(args.detector_ckpt, device=device)
    landmarker = _init_landmarker(args.pipnet_ckpt, args.meanface,
                                  device=device)
    if args.video:
        n = annotate_video(args.video, args.out_folder, detector, landmarker,
                           thresh=args.video_thresh)
        print(f"[align] annotated {n} video frames -> {args.out_folder}")
        return n
    if args.annotate:
        os.makedirs(args.out_folder, exist_ok=True)
        images = _images(args.in_folder)
        n = sum(_annotate_one(p_, args.out_folder, detector, landmarker)
                for p_ in images)
        print(f"[align] annotated {n}/{len(images)} images with faces")
        return n
    if os.path.isdir(args.out_folder):
        # a stale out_folder would end up in the listdir-built pickle
        shutil.rmtree(args.out_folder)
    n = align_folder(args.in_folder, args.out_folder, detector, landmarker,
                     args.crop_size, args.mode, workers=args.workers,
                     hires=args.hires_crop)
    pkl = args.out_pickle or "{}.pickle".format(args.out_folder)
    paths = gen_pickle_abs(args.out_folder, pkl)
    print(f"[align] cropped {n} faces; pickle with {len(paths)} paths at "
          f"{pkl}")
    return n


if __name__ == "__main__":
    main()
