"""Personalisation trainer: the loop around the train step.

Counterpart of ``celebbasis_tpu/train/trainer.py``:

* run-dir layout contract: ``logs/<timestamp>_<name>[_<suffix>]/
  {checkpoints,configs,images}`` -- downstream scripts derive config paths
  from the folder name;
* LR recipe: ``lr = accumulate x n_shards x batch x base_lr`` when
  ``scale_lr`` (2 x 5e-3 = 1e-2 by default);
* ``embeddings_gs-{step}.pt`` checkpoints every ``ckpt_every`` optimizer
  steps, and at the end, in the reference schema;
* per-step jsonl metrics (``metrics.jsonl``) every ``log_every`` steps;
* ``frozen_bf16`` stores the frozen nets' weights in bf16; ``cache_latents``
  precomputes the frozen VAE posteriors and face features of that many
  batches and cycles over them.

The loader is any iterable of batch dicts (numpy arrays or tensors, layouts
as in ``train.step``).  Not ported yet: the mid-run optimizer swap
(``unfreeze_unet``), validation, signal handlers, callbacks, TensorBoard, and
the mesh / FSDP options (their config fields exist and raise when set).
"""
from __future__ import annotations

import datetime
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from celebbasis_tpu_torch.core import manager as mgr
from celebbasis_tpu_torch.core.meta_net import MetaIdNet
from celebbasis_tpu_torch.train import step as tstep
from celebbasis_tpu_torch.utils.precision import cast_float_params


@dataclass
class TrainerConfig:
    name: str = "aigc_id"
    logdir: str = "logs"
    suffix: str = ""
    max_steps: int = 800
    ckpt_every: int = 200
    batch_size: int = 2
    base_lr: float = 5.0e-3
    scale_lr: bool = True
    accumulate: int = 1
    loss_type: str = "none"
    unfreeze_model: bool = False
    model_lr: float = 0.0
    cache_latents: int = 0   # >0: precompute N batches of frozen features
    frozen_bf16: bool = False  # store frozen UNet/VAE/CLIP/FR weights bf16
    fsdp: bool = False       # not ported: raises when set
    log_every: int = 10
    seed: int = 23
    n_data_shards: int = 1
    tensorboard: bool = False  # not ported: raises when set


def make_run_dir(cfg: TrainerConfig, now: Optional[str] = None) -> str:
    now = now or datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    suffix = f"_{cfg.suffix}" if cfg.suffix else ""
    run = os.path.join(cfg.logdir, f"{now}_{cfg.name}{suffix}")
    for sub in ("checkpoints", "configs", "images"):
        os.makedirs(os.path.join(run, sub), exist_ok=True)
    return run


def effective_lr(cfg: TrainerConfig) -> float:
    if cfg.scale_lr:
        return (cfg.accumulate * cfg.n_data_shards * cfg.batch_size
                * cfg.base_lr)
    return cfg.base_lr


class Trainer:
    """Owns the optimizer and the step function for one run.  The pipeline
    and the MetaIdNet come frozen (as ``loader.assemble`` returns them) and
    lie on one device; the trainer marks what trains."""

    def __init__(self, pipeline, meta_net: MetaIdNet, basis: torch.Tensor,
                 loader, cfg: TrainerConfig, run_dir: Optional[str] = None):
        for name in ("fsdp", "tensorboard"):
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"TrainerConfig.{name} is not ported yet")
        if cfg.n_data_shards != 1:
            raise NotImplementedError("data-parallel training is not ported "
                                      "yet (n_data_shards must be 1)")
        if cfg.cache_latents > 0 and cfg.unfreeze_model:
            raise ValueError("cache_latents requires the frozen-UNet path")
        self.pipeline = pipeline
        self.meta_net = meta_net
        self.cfg = cfg
        self.loader = loader
        self.device = pipeline.device
        self.basis = torch.as_tensor(basis).to(self.device)
        self.run_dir = run_dir or make_run_dir(cfg)
        self.metrics_path = os.path.join(self.run_dir, "metrics.jsonl")

        if cfg.frozen_bf16:
            # the frozen nets are read-only: bf16 storage halves the bytes
            # their weights take in the forward and the backward; the MLP
            # keeps float32 masters
            cast_float_params(pipeline, torch.bfloat16)
            cast_float_params(meta_net.fr_net, torch.bfloat16)
        self.gnet = None
        if cfg.loss_type == "contra":
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            self.gnet = tstep.init_gnet_params(pipeline, gen)
        self.trainable = tstep.build_trainable(
            meta_net, unet=pipeline.unet if cfg.unfreeze_model else None,
            gnet=self.gnet)
        self.optimizer = tstep.make_optimizer(
            self.trainable, effective_lr(cfg),
            cfg.model_lr if cfg.unfreeze_model else None,
            accumulate=cfg.accumulate)
        if cfg.cache_latents > 0:
            self.step_fn = tstep.make_cached_train_step(
                pipeline, meta_net, self.optimizer, loss_type=cfg.loss_type,
                gnet=self.gnet)
        else:
            self.step_fn = tstep.make_train_step(
                pipeline, meta_net, self.optimizer, loss_type=cfg.loss_type,
                train_unet=cfg.unfreeze_model, gnet=self.gnet)
        self._cache = None

    def init_state(self, manager_state: mgr.ManagerState,
                   generator: Optional[torch.Generator] = None
                   ) -> tstep.TrainState:
        """A fresh TrainState; the default generator is seeded with
        ``cfg.seed`` on the trainer's device."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed)
        return tstep.init_train_state(generator, self.trainable,
                                      self.optimizer,
                                      manager_state.to(self.device))

    # -- checkpointing -------------------------------------------------------
    def save(self, state: tstep.TrainState, tag: Optional[str] = None) -> str:
        # state.step counts micro-batches; checkpoints are named by optimizer
        # steps like the reference's global_step
        step = state.step // max(self.cfg.accumulate, 1)
        name = tag or f"embeddings_gs-{step}.pt"
        path = os.path.join(self.run_dir, "checkpoints", name)
        mgr.save_checkpoint(self.pipeline.manager_cfg, state.manager_state,
                            path, meta_net=self.meta_net)
        return path

    # -- frozen-feature cache (fast-personalisation mode) --------------------
    def _build_cache(self) -> None:
        print(f"[trainer] caching {self.cfg.cache_latents} augmented batches "
              f"of frozen features")
        self._cache = tstep.precompute_cache(
            self.pipeline, self.meta_net, self.loader, self.cfg.cache_latents)

    def _batches(self):
        if self._cache is not None:
            i = 0
            while True:
                yield self._cache[i % len(self._cache)]
                i += 1
        else:
            keys = ("image", "tokens", "faces", "ids", "num_ids")
            for batch in self.loader:
                yield {k: torch.as_tensor(v).to(self.device)
                       for k, v in batch.items()
                       if k in keys or k.startswith("override_")}

    # -- main loop -----------------------------------------------------------
    def fit(self, state: tstep.TrainState) -> tstep.TrainState:
        cfg = self.cfg
        accum = max(cfg.accumulate, 1)
        step = state.step // accum
        t_start = time.perf_counter()
        if cfg.cache_latents > 0 and self._cache is None:
            self._build_cache()
        with open(self.metrics_path, "a") as log_f:
            try:
                while step < cfg.max_steps:
                    seen = False
                    for batch in self._batches():
                        seen = True
                        if step >= cfg.max_steps:
                            break
                        t0 = time.perf_counter()
                        state, logs = self.step_fn(state, self.basis, batch)
                        if state.step % accum != 0:
                            continue
                        step += 1
                        if step % cfg.log_every == 0 or step == 1:
                            # reading the loss waits for the device
                            rec = {"step": step, "loss": float(logs["loss"]),
                                   "loss_simple": float(logs["loss_simple"]),
                                   "step_time_s": time.perf_counter() - t0,
                                   "wall_s": time.perf_counter() - t_start}
                            log_f.write(json.dumps(rec) + "\n")
                            log_f.flush()
                        if step % cfg.ckpt_every == 0:
                            self.save(state)
                    if not seen:
                        raise ValueError("the loader yielded no batch")
            except KeyboardInterrupt:
                print("[trainer] interrupted -- saving last checkpoint")
                self.save(state, tag="embeddings_last.pt")
                raise
        self.save(state)
        return state
