"""PyTorch port, W0's training side from the command line, on the CPU
(``--device cpu``), in the order a user runs it:

* ``cli/preprocess_pipnet WFLW`` on a synthetic raw WFLW layout, then
  ``cli/train_pipnet --tiny`` for 2 epochs with ``--save_interval 2``
  (``epoch1.pth`` and nothing else), then ``cli/align.py`` reading that
  file: the aligner's PIPNet holds exactly the trained state, and every
  photo is cropped;
* ``cli/preprocess_pipnet CELEBA`` and ``data_300W_CELEBA``, then
  ``cli/train_pipnet_gssl --tiny --eval`` (the warmup and the five rounds
  of the default curriculum, with augmentation): finite losses, a
  checkpoint the reader takes, a finite NME on each test split;
* without a card, both trainers raise unless asked for the CPU.
"""
import os

import numpy as np
import pytest
import torch

from celebbasis_tpu_torch.align import pipnet as tpip
from celebbasis_tpu_torch.cli import align as tcli
from celebbasis_tpu_torch.cli import (preprocess_pipnet, train_pipnet,
                                      train_pipnet_gssl)
from celebbasis_tpu_torch.utils import bridge_align

import _pipnet_layouts as layouts
from _torch_port_helpers import align_params, reference_layout, \
    write_photos
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

pytest.importorskip("cv2")          # the preprocessing's image codecs

# the aligner's PIPNet swapped for the tiny net the trainer's --tiny builds
# with 98 landmarks, 3 neighbours and a 64x64 input
TCFG = tpip.PIPNetConfig(num_lms=98, num_nb=3, input_size=64,
                         layers=(1, 1, 1, 1), width=8)


def test_preprocess_train_then_align_reads_the_checkpoint(tmp_path,
                                                          monkeypatch):
    root = tmp_path / "data"
    layouts.write_wflw(str(root), np.random.default_rng(0), n_train=8)
    preprocess_pipnet.main(["WFLW", "--root", str(root), "--target_size",
                            "64", "--quiet"])
    wflw = root / "WFLW"
    assert len(os.listdir(wflw / "images_train")) == 8
    save = tmp_path / "snap"
    out = train_pipnet.main([
        "--data_dir", str(wflw), "--save_dir", str(save), "--tiny",
        "--num_nb", "3", "--input_size", "64", "--batch_size", "4",
        "--epochs", "2", "--save_interval", "2", "--device", "cpu"])
    assert len(out["history"]) == 2 and len(out["step_s"]) == 4
    assert np.isfinite(out["history"]).all()
    assert os.listdir(save) == ["epoch1.pth"]

    monkeypatch.setattr(tcli, "PIPNetConfig", lambda: TCFG)
    fb = str(tmp_path / "FaceBoxesV2.pth")
    torch.save(reference_layout(align_params(TCFG, seed=21)["fb_state"],
                                bridge_align.faceboxes_pairs()), fb)
    land = tcli._init_landmarker(str(save / "epoch1.pth"),
                                 str(wflw / "meanface.txt"), device="cpu")
    got = land.net.state_dict()
    assert sorted(got) == sorted(out["params"])
    for k, v in out["params"].items():
        assert torch.equal(got[k], v.detach()), k
    photos = write_photos(str(tmp_path / "photos"), 3, seed=4)
    n = tcli.main(["--in_folder", str(tmp_path / "photos"), "--out_folder",
                   str(tmp_path / "aligned"), "--detector_ckpt", fb,
                   "--pipnet_ckpt", str(save / "epoch1.pth"), "--meanface",
                   str(wflw / "meanface.txt"), "--crop_size", "64",
                   "--workers", "1", "--device", "cpu"])
    assert n == len(photos)
    assert len(os.listdir(tmp_path / "aligned")) == len(photos)


def test_preprocess_then_gssl_train_and_eval(tmp_path):
    root = tmp_path / "data"
    layouts.write_gssl(str(root), "data_300W_CELEBA", seed=30)
    for name in ("CELEBA", "data_300W_CELEBA"):
        preprocess_pipnet.main([name, "--root", str(root), "--target_size",
                                "128", "--quiet"])
    ddir = root / "data_300W_CELEBA"
    save = tmp_path / "snap"
    out = train_pipnet_gssl.main([
        "--data_dir", str(ddir), "--save_dir", str(save), "--tiny",
        "--num_nb", "2", "--input_size", "128", "--batch_size", "2",
        "--epochs", "1", "--eval", "--device", "cpu"])
    # 6 labeled 300W rows and 2 unlabeled CelebA crops: the warmup takes 3
    # steps, each of the five rounds 4
    assert len(out["init_history"]) == 1 and len(out["history"]) == 5
    assert len(out["step_s"]) == 3 + 5 * 4
    assert np.isfinite(out["init_history"] + sum(out["history"], [])).all()
    assert out["checkpoint"] == str(save / "epoch0.pth")
    cfg = tpip.PIPNetConfig(num_lms=68, num_nb=2, input_size=128,
                            layers=(1, 1, 1, 1), width=8)
    state = bridge_align.convert_pipnet(
        torch.load(out["checkpoint"], weights_only=True), cfg)
    for k, v in out["params"].items():
        assert torch.equal(state[k], v.detach()), k
    assert sorted(out["nme"]) == ["300W", "COFW", "WFLW"]
    assert all(np.isfinite(v) and v > 0 for v in out["nme"].values())


def test_trainers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    for cli in (train_pipnet, train_pipnet_gssl):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--data_dir", "unused"])
