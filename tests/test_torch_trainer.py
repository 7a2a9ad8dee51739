"""PyTorch port: ``train.trainer`` on the CPU (``device="cpu"``) -- the
run-dir contract, ``metrics.jsonl``, the checkpoint cadence, and the config
block that feeds it.  Tiny configs; the model comes from ``loader.assemble``
with a tiny face net swapped in.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from celebbasis_tpu.train import trainer as jtrainer
from celebbasis_tpu_torch.core import manager as tmgr
from celebbasis_tpu_torch.core.meta_net import MetaIdNet, MetaNetConfig
from celebbasis_tpu_torch.loader import assemble, init_weights
from celebbasis_tpu_torch.train import trainer as ttrainer
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
    # the assembled face net is the full IResNet-100; the loop is the same
    # with a tiny one
    cfg = dataclasses.replace(MetaNetConfig.tiny(),
                              inner_dim=spec.meta_inner_dim,
                              token_dim=spec.clip.width)
    a.meta_net = init_weights(
        MetaIdNet(cfg, dtype=torch.float32).requires_grad_(False).eval(),
        torch.Generator().manual_seed(1))
    init_weights(a.pipeline.unet, torch.Generator().manual_seed(2),
                 zero_convs=False)
    return a


def _loader(asm, n):
    r = np.random.default_rng(0)
    tokens = np.asarray(asm.tokenizer(["face of sks person",
                                       "sks person and ks person"]))
    lat = SIZE // asm.pipeline.latent_factor
    return [{
        "image": r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        "tokens": tokens, "captions": ["a", "b"],
        "faces": r.uniform(-1, 1, (B, 2, FACE, FACE, 3)).astype(np.float32),
        "ids": np.array([[0, 1], [2, 1]]), "num_ids": np.array([1, 2]),
    } for _ in range(n)]


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_config_and_run_dir_match_the_jax_package(tmp_path):
    ours, ref = ttrainer.TrainerConfig(), jtrainer.TrainerConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ttrainer.effective_lr(ours) == jtrainer.effective_lr(ref) == 1e-2
    scaled = dataclasses.replace(ours, accumulate=2, batch_size=4)
    assert ttrainer.effective_lr(scaled) == 2 * 4 * 5e-3
    assert ttrainer.effective_lr(dataclasses.replace(ours, scale_lr=False)) \
        == 5e-3
    cfg = dataclasses.replace(ours, logdir=str(tmp_path), suffix="x")
    run = ttrainer.make_run_dir(cfg, now="2024-01-01T00-00-00")
    jrun = jtrainer.make_run_dir(dataclasses.replace(
        ref, logdir=str(tmp_path / "j"), suffix="x"),
        now="2024-01-01T00-00-00")
    assert os.path.basename(run) == os.path.basename(jrun) == \
        "2024-01-01T00-00-00_aigc_id_x"
    assert sorted(os.listdir(run)) == sorted(os.listdir(jrun)) == \
        ["checkpoints", "configs", "images"]


def test_run_spec_carries_a_typed_trainer_block():
    spec = load_run_spec([os.path.join(REPO, "configs", "aigc_id.yaml")])
    assert isinstance(spec.trainer, ttrainer.TrainerConfig)
    assert (spec.trainer.max_steps, spec.trainer.ckpt_every,
            spec.trainer.batch_size, spec.trainer.base_lr,
            spec.trainer.loss_type) == (800, 200, 2, 5e-3, "none")
    assert spec.unfreeze_model is False and spec.model_lr == 0.0
    over = load_run_spec([os.path.join(REPO, "configs", "aigc_id.yaml")],
                         ["lightning.trainer.max_steps=7"])
    assert over.trainer.max_steps == 7


def test_fit_writes_checkpoints_and_metrics(tmp_path, asm):
    cfg = ttrainer.TrainerConfig(logdir=str(tmp_path), max_steps=5,
                                 ckpt_every=2, log_every=2, seed=3)
    tr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis,
                          _loader(asm, 2), cfg)       # 2 batches: 3 epochs
    state = tr.init_state(asm.manager_state)
    emb0 = state.manager_state.id_embeddings.clone()
    w0 = asm.meta_net.mlp.layer_0.weight.detach().clone()
    state = tr.fit(state)
    assert state.step == 5
    ckpts = sorted(os.listdir(os.path.join(tr.run_dir, "checkpoints")))
    # every ckpt_every steps, and the final state
    assert ckpts == ["embeddings_gs-2.pt", "embeddings_gs-4.pt",
                     "embeddings_gs-5.pt"]
    recs = _metrics(tr.run_dir)
    assert [r["step"] for r in recs] == [1, 2, 4]
    assert all(np.isfinite(r["loss"]) and r["step_time_s"] > 0
               and set(r) == {"step", "loss", "loss_simple", "step_time_s",
                              "data_wait_s", "wall_s"} for r in recs)
    assert not torch.equal(asm.meta_net.mlp.layer_0.weight, w0)
    # the dictionaries moved at the ids used (0, 1, 2) and nowhere else
    moved = (state.manager_state.id_embeddings - emb0).abs().amax(dim=(1, 2))
    assert (moved[:3] > 0).all() and (moved[3:] == 0).all()
    back = tmgr.load_checkpoint(
        asm.pipeline.manager_cfg,
        os.path.join(tr.run_dir, "checkpoints", "embeddings_gs-5.pt"))
    assert torch.equal(back.id_coefficients,
                       state.manager_state.id_coefficients)
    # frozen modules stay frozen
    assert all(p.grad is None for p in asm.pipeline.parameters())
    assert all(p.grad is None for p in asm.meta_net.fr_net.parameters())
    # a second fit from the returned state does nothing more than save
    assert tr.fit(state).step == 5


def test_cached_fit_and_accumulation(tmp_path, asm):
    cfg = ttrainer.TrainerConfig(logdir=str(tmp_path), max_steps=2,
                                 ckpt_every=1, log_every=1, cache_latents=1,
                                 accumulate=2)
    tr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis,
                          _loader(asm, 3), cfg)
    assert ttrainer.effective_lr(cfg) == 2e-2
    state = tr.fit(tr.init_state(asm.manager_state))
    assert state.step == 4                  # micro-batches; 2 optimizer steps
    assert len(tr._cache) == 1 and "fr_feats" in tr._cache[0]
    assert sorted(os.listdir(os.path.join(tr.run_dir, "checkpoints"))) == \
        ["embeddings_gs-1.pt", "embeddings_gs-2.pt"]
    assert [r["step"] for r in _metrics(tr.run_dir)] == [1, 2]


def test_options_that_are_not_ported_raise(tmp_path, asm):
    # the mesh options need their mesh (tests/test_torch_mesh.py runs them)
    for bad, match in ((dict(fsdp=True), "mesh"),
                       (dict(n_data_shards=2), "data axis has 1")):
        with pytest.raises(ValueError, match=match):
            ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis, [],
                             ttrainer.TrainerConfig(logdir=str(tmp_path),
                                                    **bad))
    with pytest.raises(ValueError):
        ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis, [],
                         ttrainer.TrainerConfig(logdir=str(tmp_path),
                                                cache_latents=1,
                                                unfreeze_model=True))
    tr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis, [],
                          ttrainer.TrainerConfig(logdir=str(tmp_path),
                                                 max_steps=1))
    with pytest.raises(ValueError, match="no batch"):
        tr.fit(tr.init_state(asm.manager_state))
