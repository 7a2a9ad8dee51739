"""PyTorch port: ``cli/train.py`` in process through ``main(argv)`` on the
tiny config with ``--device cpu``, from a synthetic aligned-face pickle:
two uncached steps (validation, TensorBoard and ``DeviceMonitor`` on), two
cached steps with the contra loss (its g-net), then ``cli/txt2img.py`` with
the run's checkpoint.  The run dir holds what the JAX CLI's does
(``tests/test_cli_e2e.py``): ``checkpoints/embeddings_gs-2.pt``,
``configs/<base>``, ``configs/resolved.yaml`` and ``metrics.jsonl``.
"""
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from celebbasis_tpu_torch.cli import train, txt2img
from celebbasis_tpu_torch.utils.tb import read_scalars

import _torch_port_helpers  # noqa: F401  (one PyTorch thread per worker)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "tiny.yaml")
SIZE = 32


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_train") / "faces"
    d.mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = d / f"{i:05d}.png"
        Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    with open(d / "ffhq.pickle", "wb") as f:
        pickle.dump(paths, f)
    return d


def _common(data_root, logdir):
    return ["--base", CFG, "--logdir", str(logdir), "--data_root",
            str(data_root), "--image_size", str(SIZE), "--face_size",
            str(SIZE), "--max_steps", "2", "--device", "cpu",
            "lightning.trainer.log_every_n_steps=1"]


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_then_txt2img_from_the_checkpoint(data_root, tmp_path):
    run = train.main(_common(data_root, tmp_path / "logs") + [
        "--name", "tinytest", "lightning.trainer.val_check_interval=2",
        "lightning.trainer.limit_val_batches=1",
        "lightning.callbacks.device_monitor.params.every=1",
        "lightning.tensorboard=true",
        "data.params.validation.params.pickle_path=unused",
        "data.params.validation.params.num_ids=2"])
    assert os.path.basename(run).endswith("_tinytest")
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == \
        ["embeddings_gs-2.pt"]
    assert sorted(os.listdir(os.path.join(run, "configs"))) == \
        ["resolved.yaml", "tiny.yaml"]
    with open(os.path.join(run, "configs", "resolved.yaml")) as f:
        assert yaml.safe_load(f) == {"name": "tinytest", "seed": 23,
                                     "max_steps": 2, "lr": 5e-3}
    recs = _metrics(run)
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(set(r) == {"step", "loss", "loss_simple", "step_time_s",
                          "data_wait_s", "wall_s"}
               and np.isfinite(r["loss"]) and r["data_wait_s"] >= 0
               for r in steps)
    vals = [r for r in recs if "val_loss_simple" in r]
    assert [r["step"] for r in vals] == [2]
    assert all(np.isfinite(r["val_loss_simple"]) for r in vals)
    with open(os.path.join(run, "device_stats.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    (events,) = glob.glob(os.path.join(run, "tensorboard", "*"))
    assert {tag for _, tag, _ in read_scalars(events)} == {
        "train/loss", "train/loss_simple", "val/loss_simple"}

    ckpt = os.path.join(run, "checkpoints", "embeddings_gs-2.pt")
    saved = torch.load(ckpt, weights_only=True)["id_coefficients"]
    assert len(saved) == 4 and torch.stack(saved).abs().sum() > 0
    imgs = txt2img.main([
        "--config", CFG, "--embedding_path", ckpt, "--device", "cpu",
        "--prompt", "a photo of a sks person", "--outdir",
        str(tmp_path / "samples"), "--ddim_steps", "2", "--n_samples", "2",
        "--H", str(SIZE), "--W", str(SIZE), "--ids", "0",
        "--precision", "fp32"])
    assert imgs.shape == (2, SIZE, SIZE, 3) and imgs.dtype == np.uint8
    assert len(glob.glob(str(tmp_path / "samples" / "*" / "*.jpg"))) == 3


def test_cached_contra_run_and_resume(data_root, tmp_path):
    loss = "model.params.personalization_config.params.loss_type=contra"
    run = train.main(_common(data_root, tmp_path / "logs") + [
        "--name", "cached", "--cache_latents", "1",
        "lightning.trainer.limit_val_batches=0",
        loss])
    assert [r["step"] for r in _metrics(run)] == [1, 2]
    assert all(np.isfinite(r["loss"]) and "loss" in r
               for r in _metrics(run))
    # -r: the same run dir, the latest checkpoint by step number
    os.rename(os.path.join(run, "checkpoints", "embeddings_gs-2.pt"),
              os.path.join(run, "checkpoints", "embeddings_gs-10.pt"))
    open(os.path.join(run, "checkpoints", "embeddings_gs-9.pt"), "w").close()
    assert train.latest_checkpoint(run).endswith("embeddings_gs-10.pt")
    assert train.main(_common(data_root, tmp_path / "other") + [
        "-r", run, "--max_steps", "1", "--cache_latents", "1",
        "lightning.trainer.limit_val_batches=0"]) == run
    assert os.path.exists(os.path.join(run, "checkpoints",
                                       "embeddings_gs-1.pt"))
    assert not os.path.exists(tmp_path / "other")


def test_train_cli_refuses_what_is_not_ported_and_needs_a_device(data_root,
                                                                 tmp_path):
    base = _common(data_root, tmp_path)
    # a mesh of two needs two processes (tests/test_torch_mesh.py starts
    # them); --fsdp shards over a mesh
    for flags, match in ((["--mesh", "2"], "torchrun"),
                         (["--mesh", "1", "2", "3"], "data and a model"),
                         (["--fsdp"], "--mesh")):
        with pytest.raises(ValueError, match=match):
            train.main(base + flags)
    if torch.cuda.is_available():
        return
    without = [a for a in base if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(without)
