"""PyTorch port, W0 from the command line and the evaluation's cropper, on
the CPU, with weight files in the reference's layouts (``FaceBoxesV2.pth``;
a tiny 98-landmark PIPNet in ``epoch59.pth``'s layout, the CLIs' PIPNet
configuration swapped for it on both sides):

* ``cli/align.main --device cpu`` writes a crop per photo and the pickle
  that the JAX ``gen_pickle_abs`` writes for that folder, after removing a
  stale output folder; ``--annotate`` and ``--video`` on a directory of
  frames run;
* ``face_cropper_from_nets`` and ``eval_imgs --detector_ckpt --pipnet_ckpt
  --tiny --device cpu`` against the JAX cropper built from the same files:
  the same has-face flags, bit-equal crops, and the face counts they imply.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from celebbasis_tpu.align import pipnet as jpip
from celebbasis_tpu.cli import align as jcli
from celebbasis_tpu.cli import eval_imgs as jeval_cli
from celebbasis_tpu_torch.align import pipnet as tpip
from celebbasis_tpu_torch.cli import align as tcli
from celebbasis_tpu_torch.cli import eval_imgs
from celebbasis_tpu_torch.eval import evaluators as tev
from celebbasis_tpu_torch.utils import bridge_align

from _torch_port_helpers import align_params, reference_layout, \
    write_photos
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

JCFG = dataclasses.replace(jpip.PIPNetConfig.tiny(), num_lms=98)
TCFG = tpip.PIPNetConfig(**JCFG.__dict__)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The two weight files in the reference's layouts, and the nets on both
    sides from the same weights."""
    pytest.importorskip("cv2")     # the JAX chain resamples through it
    root = tmp_path_factory.mktemp("align_files")
    p = align_params(JCFG, seed=21)
    fb, pip = str(root / "FaceBoxesV2.pth"), str(root / "epoch59.pth")
    torch.save(reference_layout(p["fb_state"],
                                bridge_align.faceboxes_pairs()), fb)
    torch.save(reference_layout(p["pip_state"],
                                bridge_align.pipnet_pairs(TCFG)), pip)
    return dict(root=root, fb=fb, pip=pip)


@pytest.fixture
def tiny_pipnet(monkeypatch):
    """The CLIs' PIPNet configuration (ResNet-101) swapped for the tiny
    98-landmark one, in both packages."""
    monkeypatch.setattr(tcli, "PIPNetConfig", lambda: TCFG)
    monkeypatch.setattr(jcli, "PIPNetConfig", lambda: JCFG)


def test_cli_writes_crops_and_the_pickle(files, tiny_pipnet, tmp_path):
    photos = write_photos(str(tmp_path / "photos"), 3, seed=4)
    out = tmp_path / "aligned"
    out.mkdir()
    (out / "stale.png").write_bytes(b"x")
    n = tcli.main(["--in_folder", str(tmp_path / "photos"), "--out_folder",
                   str(out), "--detector_ckpt", files["fb"], "--pipnet_ckpt",
                   files["pip"], "--crop_size", "128", "--workers", "2",
                   "--device", "cpu"])
    assert n == len(photos)
    assert sorted(os.listdir(out)) == sorted(os.path.basename(p)
                                             for p in photos)
    for name in os.listdir(out):
        assert np.asarray(Image.open(out / name)).shape == (128, 128, 3)
    with open(f"{out}.pickle", "rb") as f:
        ours = pickle.load(f)
    ref = jcli.gen_pickle_abs(str(out), str(tmp_path / "ref.pickle"))
    with open(tmp_path / "ref.pickle", "rb") as f:
        assert ours == ref == pickle.load(f)


def test_cli_annotate_and_video_frames(files, tiny_pipnet, tmp_path):
    write_photos(str(tmp_path / "photos"), 2, seed=5)
    common = ["--detector_ckpt", files["fb"], "--pipnet_ckpt", files["pip"],
              "--device", "cpu"]
    n = tcli.main(["--in_folder", str(tmp_path / "photos"), "--out_folder",
                   str(tmp_path / "ann"), "--annotate", *common])
    assert n == 2 and sorted(os.listdir(tmp_path / "ann")) == [
        "photo_0_out.jpg", "photo_1_out.jpg"]
    frames = tmp_path / "frames"
    write_photos(str(frames), 3, hw=(96, 128), seed=6)
    n = tcli.main(["--video", str(frames), "--out_folder",
                   str(tmp_path / "vid"), "--video_thresh", "0.6", *common])
    assert n == 3 and sorted(os.listdir(tmp_path / "vid")) == [
        f"frame_{i:06d}.jpg" for i in range(3)]


def _eval_folder(root, n_items=2, n_gen=2, size=64, seed=7):
    """A generated-evaluation folder (the gen_imgs contract) of random
    JPEGs."""
    r = np.random.default_rng(seed)
    src = root / "src"
    src.mkdir()
    prompts, paths, ids = [], [], []
    for i in range(n_items):
        sp = src / f"face_id{i}_#0.png"
        Image.fromarray(r.integers(0, 256, (size, size, 3), np.uint8)
                        ).save(sp)
        prompt = "a photo of sks person"
        d = root / "gen" / "imgs" / f"{i:05d}_id{i:05d}_{prompt}"
        d.mkdir(parents=True)
        for c in range(n_gen):
            Image.fromarray(r.integers(0, 256, (size, size, 3), np.uint8)
                            ).save(d / f"{c:05d}.jpg")
        prompts.append(prompt)
        paths.append(str([str(sp)]))
        ids.append(str([i]))
    for name, lines in (("prompts.txt", prompts),
                        ("in_image_paths.txt", paths),
                        ("in_image_ids.txt", ids)):
        (root / "gen" / name).write_text("\n".join(lines) + "\n")
    return str(root / "gen")


def test_cropper_and_eval_imgs_match_the_jax_cropper(files, tiny_pipnet,
                                                     tmp_path):
    gen = _eval_folder(tmp_path)
    jcrop = jeval_cli.build_cropper(files["fb"], files["pip"], None, 64)
    tcrop = eval_imgs.build_cropper(files["fb"], files["pip"], None, 64,
                                    device="cpu")
    folder = tev.GeneratedEvalFolder(gen)
    has, no, faces = 0, 0, 0
    for i in range(len(folder)):
        _, src, imgs = folder[i]
        arr = ((np.concatenate([src, imgs]) + 1.0) * 127.5).astype(np.uint8)
        for k, img in enumerate(arr):
            (jc, jok), (tc, tok) = jcrop(img), tcrop(img)
            assert jok == tok
            np.testing.assert_array_equal(tc, jc)
            faces += tok
            has += tok or k == 0
            no += not (tok or k == 0)
    assert faces > 0
    scores = eval_imgs.main(["--eval_folder", gen, "--tiny", "--img_size",
                             "64", "--detector_ckpt", files["fb"],
                             "--pipnet_ckpt", files["pip"], "--device",
                             "cpu"])
    assert (scores["num_has_face"], scores["num_no_face"]) == (has, no)
    assert all(np.isfinite(v) for v in scores.values())
