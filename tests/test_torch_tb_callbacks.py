"""PyTorch port: ``utils/tb.py``, ``train/callbacks.py`` and the trainer's
validation, TensorBoard scalars, mid-run UNet unfreeze and "melk" handler,
on the CPU at tiny size.

* ``TBWriter`` writes the JAX package's writer's bytes for the same tags,
  values, steps and wall time; each package's ``read_scalars`` reads the
  other's file.
* ``Trainer.validate`` is the mean of the port's eval step (pinned against
  the JAX one in ``test_torch_train_step.py``) over the val batches, which
  carry ``override_*`` draws; in cached mode it reads held-out cached
  batches.
* ``unfreeze_unet`` gives the same next step as a trainer built with
  ``unfreeze_model=True``.
* The melk handler is called directly (never by sending a signal).
"""
import copy
import dataclasses
import glob
import json
import os
import signal
import time

import numpy as np
import pytest
import torch
from PIL import Image

from celebbasis_tpu.utils import tb as jtb
from celebbasis_tpu_torch.core.meta_net import MetaIdNet, MetaNetConfig
from celebbasis_tpu_torch.loader import assemble, init_weights
from celebbasis_tpu_torch.train import callbacks as cb
from celebbasis_tpu_torch.train import step as tstep
from celebbasis_tpu_torch.train import trainer as ttrainer
from celebbasis_tpu_torch.utils import tb as ttb
from celebbasis_tpu_torch.utils.config import load_run_spec

import _torch_port_helpers  # noqa: F401  (one PyTorch thread per worker)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, FACE, B = 32, 40, 2


@pytest.fixture(scope="module")
def asm():
    spec = load_run_spec([os.path.join(REPO, "configs", "tiny.yaml")])
    a = assemble(spec, image_size=SIZE, device="cpu", dtype=torch.float32,
                 cache_dir=None)
    cfg = dataclasses.replace(MetaNetConfig.tiny(),
                              inner_dim=spec.meta_inner_dim,
                              token_dim=spec.clip.width)
    a.meta_net = init_weights(
        MetaIdNet(cfg, dtype=torch.float32).requires_grad_(False).eval(),
        torch.Generator().manual_seed(1))
    init_weights(a.pipeline.unet, torch.Generator().manual_seed(2),
                 zero_convs=False)
    return a


def _batches(asm, n, seed=0, overrides=False):
    r = np.random.default_rng(seed)
    tokens = np.asarray(asm.tokenizer(["face of sks person",
                                       "sks person and ks person"]))
    lat = SIZE // asm.pipeline.latent_factor
    out = []
    for _ in range(n):
        b = {"image": r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
             "tokens": tokens, "captions": ["a", "b"],
             "faces": r.uniform(-1, 1, (B, 2, FACE, FACE, 3)).astype(
                 np.float32),
             "ids": np.array([[0, 1], [2, 1]]), "num_ids": np.array([1, 2])}
        if overrides:
            b.update(override_znoise=r.standard_normal(
                (B, lat, lat, 4)).astype(np.float32),
                override_t=r.integers(0, 1000, B),
                override_noise=r.standard_normal((B, lat, lat, 4)).astype(
                    np.float32))
        out.append(b)
    return out


def _cfg(tmp_path, **kw):
    return ttrainer.TrainerConfig(logdir=str(tmp_path), seed=3, **kw)


def _to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()
            if k != "captions"}


def test_tb_writer_writes_the_jax_writers_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    img = np.random.default_rng(0).integers(0, 255, (8, 12, 3),
                                            dtype=np.uint8)
    files = []
    for name, mod in (("port", ttb), ("jax", jtb)):
        w = mod.TBWriter(str(tmp_path / name))
        w.add_scalar("train/loss", 0.125, 1)
        w.add_scalar("val/loss_simple", -3.5e-4, 2 ** 40)
        w.add_image("samples", img, 7)
        w.close()
        files.append(w.path)
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        assert a.read() == b.read()
    want = [(1, "train/loss", 0.125),
            (2 ** 40, "val/loss_simple", np.float32(-3.5e-4))]
    assert ttb.read_scalars(files[1]) == jtb.read_scalars(files[0]) == want
    assert ttb.crc32c(b"123456789") == jtb.crc32c(b"123456789") == 0xE3069283


def test_fit_writes_tensorboard_scalars_and_validates(tmp_path, asm):
    """``tensorboard=True`` (refused before this was ported): the event file
    holds the metrics' losses and the validation losses."""
    cfg = _cfg(tmp_path, max_steps=2, log_every=1, ckpt_every=10,
               tensorboard=True)
    tr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis,
                          _batches(asm, 2), cfg,
                          val_loader=_batches(asm, 1, seed=5), val_every=2,
                          val_batches=1)
    tr.fit(tr.init_state(asm.manager_state))
    tr.close()
    with open(tr.metrics_path) as f:
        recs = [json.loads(line) for line in f]
    assert [sorted(r) for r in recs] == [
        ["data_wait_s", "loss", "loss_simple", "step", "step_time_s",
         "wall_s"]] * 2 + [["step", "val_loss_simple"]]
    (events,) = glob.glob(os.path.join(tr.run_dir, "tensorboard", "*"))
    want = []
    for r in recs:
        if "loss" in r:
            want += [(r["step"], "train/loss", np.float32(r["loss"])),
                     (r["step"], "train/loss_simple",
                      np.float32(r["loss_simple"]))]
        else:
            want.append((r["step"], "val/loss_simple",
                         np.float32(r["val_loss_simple"])))
    assert ttb.read_scalars(events) == want


def test_validate_is_the_mean_of_the_eval_step(tmp_path, asm):
    val = _batches(asm, 3, seed=9, overrides=True)
    tr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis, [],
                          _cfg(tmp_path), val_loader=val, val_batches=2)
    state = tr.init_state(asm.manager_state)
    emb0 = state.manager_state.id_embeddings.clone()
    eval_fn = tstep.make_eval_step(asm.pipeline, asm.meta_net)
    want = np.mean([float(eval_fn(state, tr.basis, _to_torch(b),
                                  torch.Generator())["loss_simple"])
                    for b in val[:2]])
    got = tr.validate(state)
    assert got == pytest.approx(want, rel=1e-6, abs=0)
    assert state.step == 0 and torch.equal(
        state.manager_state.id_embeddings, emb0)

    # cached mode without a val loader: held-out cached batches
    ctr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis,
                           _batches(asm, 3), _cfg(tmp_path, cache_latents=1),
                           val_batches=1)
    cstate = ctr.init_state(asm.manager_state)
    got = ctr.validate(cstate)
    assert len(ctr._cache) == 1 and len(ctr._val_cache) == 1
    ceval = tstep.make_eval_step(asm.pipeline, asm.meta_net, cached=True)
    want = float(ceval(cstate, ctr.basis, ctr._val_cache[0],
                       torch.Generator().manual_seed(0))["loss_simple"])
    assert got == want


def test_unfreeze_unet_gives_the_unfrozen_trainers_step(tmp_path, asm):
    batch = {k: v for k, v in _to_torch(
        _batches(asm, 1, seed=4, overrides=True)[0]).items()}
    lr = 1e-3
    results = []
    for swap in (True, False):
        pipe = copy.deepcopy(asm.pipeline)
        meta = copy.deepcopy(asm.meta_net)
        cfg = _cfg(tmp_path) if swap else _cfg(
            tmp_path, unfreeze_model=True, model_lr=lr)
        tr = ttrainer.Trainer(pipe, meta, asm.basis, [], cfg)
        state = tr.init_state(asm.manager_state)
        if swap:
            state = tr.unfreeze_unet(state, lr)
            assert tr.cfg.unfreeze_model and tr.cfg.model_lr == lr
            assert state.optimizer is tr.optimizer
        state, logs = tr.step_fn(state, tr.basis, batch)
        results.append((pipe.unet.state_dict(), meta.mlp.state_dict(),
                        state.manager_state, float(logs["loss"])))
    (u1, m1, s1, l1), (u2, m2, s2, l2) = results
    assert l1 == l2
    for a, b in ((u1, u2), (m1, m2)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(u1["conv_out.weight"],
                           asm.pipeline.unet.conv_out.weight)
    assert torch.equal(s1.id_coefficients, s2.id_coefficients)
    cached = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis, [],
                              _cfg(tmp_path, cache_latents=1))
    with pytest.raises(ValueError, match="uncached"):
        cached.unfreeze_unet(cached.init_state(asm.manager_state), lr)


class _Melk:
    """Calls the trainer's SIGUSR1 handler directly at ``at``."""

    def __init__(self, at):
        self.at = at

    def on_step(self, step, trainer, state):
        if step == self.at:
            trainer.melk(signal.SIGUSR1, None)


def test_melk_checkpoints_and_ends_the_run(tmp_path, asm):
    before = signal.getsignal(signal.SIGUSR1)
    tr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis,
                          _batches(asm, 1),
                          _cfg(tmp_path, max_steps=5, ckpt_every=100),
                          callbacks=[_Melk(2)])
    state = tr.fit(tr.init_state(asm.manager_state))
    assert state.step == 2
    assert sorted(os.listdir(os.path.join(tr.run_dir, "checkpoints"))) == \
        ["embeddings_gs-2.pt", "embeddings_last.pt"]
    assert signal.getsignal(signal.SIGUSR1) == before


def test_callbacks_at_tiny_size(tmp_path, asm):
    pipe = copy.deepcopy(asm.pipeline)
    run = str(tmp_path / "run")
    for sub in ("checkpoints", "images"):
        os.makedirs(os.path.join(run, sub))
    callbacks = [
        cb.DeviceMonitor(run, every=1),
        cb.ImageLogger(pipe, run, asm.tokenizer, every=2, max_images=2,
                       image_size=SIZE, num_steps=2),
        cb.Profiler(run, start=1, stop=2),
        cb.ModeSwap(swap_step=2, model_lr=1e-3)]
    tr = ttrainer.Trainer(pipe, asm.meta_net, asm.basis, _batches(asm, 2),
                          _cfg(tmp_path, max_steps=3, ckpt_every=100),
                          run_dir=run, callbacks=callbacks)
    w2 = None

    class Snapshot:
        def on_step(self, step, trainer, state):
            nonlocal w2
            if step == 2:
                w2 = pipe.unet.conv_out.weight.detach().clone()

    tr.callbacks.append(Snapshot())
    tr.fit(tr.init_state(asm.manager_state))
    with open(os.path.join(run, "device_stats.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(r["bytes_in_use"] is None and r["interval_s"] >= 0
               for r in recs)
    grid = np.asarray(Image.open(os.path.join(run, "images",
                                              "samples_gs-000002.jpg")))
    assert grid.shape == (SIZE, 2 * SIZE, 3)
    assert os.listdir(os.path.join(run, "profile")) == ["trace_1-2.json"]
    # the swap at step 2: from step 3 on the UNet trains too
    assert tr.cfg.unfreeze_model and "unet" in tr.trainable
    assert all(p.requires_grad for p in pipe.unet.parameters())
    assert not torch.equal(pipe.unet.conv_out.weight, w2)
