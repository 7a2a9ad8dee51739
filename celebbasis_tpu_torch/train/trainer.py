"""Personalisation trainer: the loop around the train step.

Counterpart of ``celebbasis_tpu/train/trainer.py``:

* run-dir layout contract: ``logs/<timestamp>_<name>[_<suffix>]/
  {checkpoints,configs,images}`` -- downstream scripts derive config paths
  from the folder name;
* LR recipe: ``lr = accumulate x n_shards x batch x base_lr`` when
  ``scale_lr`` (2 x 5e-3 = 1e-2 by default);
* ``embeddings_gs-{step}.pt`` checkpoints every ``ckpt_every`` optimizer
  steps, and at the end, in the reference schema; SIGUSR1 ("melk") writes
  ``embeddings_last.pt`` and ends the run at the next step boundary (the
  handler is installed while ``fit`` runs, from the main thread only);
* per-step jsonl metrics (``metrics.jsonl``) every ``log_every`` steps,
  with the host seconds the step waited for its batch (``data_wait_s``: the
  loader, and the copy of the batch to the device),
  and the same scalars in a TensorBoard event file when ``cfg.tensorboard``
  (``<run>/tensorboard``);
* validation (``validate``): the loss-only eval step over ``val_batches``
  batches every ``val_every`` steps, from ``val_loader``, or in cached mode
  without one from held-out cached batches;
* callbacks (``train.callbacks``) after every optimizer step; one may hand
  back a new state (``ModeSwap`` -> ``unfreeze_unet``);
* ``frozen_bf16`` stores the frozen nets' weights in bf16; ``cache_latents``
  precomputes the frozen VAE posteriors and face features of that many
  batches and cycles over them.

On a card the train and eval steps run as CUDA graphs (``train.step``),
captured by their first call; ``unfreeze_unet`` builds new steps, whose
graphs are captured anew for the new trainable set.  ``frozen_bf16`` casts
the weights before any step is built, so every graph reads the cast ones.

The loader is any iterable of batch dicts (numpy arrays or tensors, layouts
as in ``train.step``), such as ``data.face_id.PrefetchLoader``.

Data parallel over a ``mesh`` (``parallel.mesh.make_mesh``; one process per
rank, ``cfg.n_data_shards`` its ``data`` size): the loader yields the global
batch, each rank takes its block of rows (``shard_batch``) and the steps
compute the global step (``train.step``).  The frozen weights stay whole on
every rank (as the JAX trainer, no tensor-parallel rule: the ``model`` axis
holds copies) unless ``cfg.fsdp`` shards the large frozen leaves over
``data``.  Rank 0 alone writes the checkpoints, ``metrics.jsonl`` and the
TensorBoard file; the logged losses are the global means.  Under NCCL the
steps run on their CUDA graphs; under gloo uncaptured (``runs_eagerly``).
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from celebbasis_tpu_torch.core import manager as mgr
from celebbasis_tpu_torch.core.meta_net import MetaIdNet
from celebbasis_tpu_torch.parallel import mesh as pmesh
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
    fsdp: bool = False       # shard large frozen leaves over the 'data' axis
    log_every: int = 10
    seed: int = 23
    n_data_shards: int = 1   # the mesh's 'data' size
    tensorboard: bool = False  # also write a TensorBoard event file


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
    lie on one device; the trainer marks what trains, and over a ``mesh``
    places the frozen weights (module docstring)."""

    def __init__(self, pipeline, meta_net: MetaIdNet, basis: torch.Tensor,
                 loader, cfg: TrainerConfig, run_dir: Optional[str] = None,
                 callbacks=(), val_loader=None, val_every: int = 200,
                 val_batches: int = 4, mesh=None):
        if cfg.n_data_shards != pmesh.axis_size(mesh, pmesh.DATA):
            raise ValueError(f"n_data_shards={cfg.n_data_shards} but the "
                             f"mesh's data axis has "
                             f"{pmesh.axis_size(mesh, pmesh.DATA)} ranks")
        if cfg.fsdp and mesh is None:
            raise ValueError("fsdp shards over a mesh's data axis: pass "
                             "the mesh")
        if cfg.fsdp and pipeline.manager_cfg.test_mode == "image":
            raise ValueError("test_mode 'image' saves the whole MetaIdNet, "
                             "whose face net fsdp shards")
        if cfg.cache_latents > 0 and cfg.unfreeze_model:
            raise ValueError("cache_latents requires the frozen-UNet path")
        self.mesh = mesh
        self.writer = pmesh.is_writer(mesh)
        self.pipeline = pipeline
        self.meta_net = meta_net
        self.cfg = cfg
        self.loader = loader
        self.callbacks = list(callbacks)
        self.val_loader = val_loader
        self.val_every = val_every
        self.val_batches = val_batches
        self.device = pipeline.device
        self.basis = torch.as_tensor(basis).to(self.device)
        self.run_dir = run_dir or make_run_dir(cfg)
        self.metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self.tb = None
        if cfg.tensorboard and self.writer:
            from celebbasis_tpu_torch.utils.tb import TBWriter
            self.tb = TBWriter(os.path.join(self.run_dir, "tensorboard"))

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
        if mesh is not None:
            # frozen weights replicated, or their large leaves sharded over
            # 'data' (what trains is never sharded)
            for module in (pipeline, meta_net):
                pmesh.shard_params(module, mesh, fsdp=cfg.fsdp)
        self.optimizer = tstep.make_optimizer(
            self.trainable, effective_lr(cfg),
            cfg.model_lr if cfg.unfreeze_model else None,
            accumulate=cfg.accumulate)
        self._build_steps()
        self._cache = None
        self._val_cache = None
        self._state = None           # the live state while fit runs
        self._interrupted = False

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

    # -- mid-run optimizer swap -----------------------------------------------
    def unfreeze_unet(self, state: tstep.TrainState,
                      model_lr: float) -> tstep.TrainState:
        """From here on the UNet trains too, at ``model_lr``: a fresh
        two-group AdamW (the reference builds a new optimizer) and the
        rebuilt train and eval steps.  The step count, the generator and the
        manager state carry over.  Refused in cached mode, where the UNet's
        inputs are not recomputed."""
        cfg = self.cfg
        if cfg.cache_latents > 0:
            raise ValueError("the mode swap needs the uncached path")
        if cfg.fsdp:
            raise ValueError("the mode swap trains the UNet, whose frozen "
                             "weights fsdp has sharded")
        cfg.unfreeze_model, cfg.model_lr = True, model_lr
        self.trainable = tstep.build_trainable(
            self.meta_net, unet=self.pipeline.unet, gnet=self.gnet)
        self.optimizer = tstep.make_optimizer(
            self.trainable, effective_lr(cfg), model_lr,
            accumulate=cfg.accumulate)
        self._build_steps()
        return tstep.TrainState(state.step, self.trainable, self.optimizer,
                                state.manager_state, state.generator)

    def _build_steps(self) -> None:
        """The train and eval steps for the current trainable set; gloo's
        collectives cannot be captured, so over a gloo mesh they run
        uncaptured."""
        cfg, mesh = self.cfg, self.mesh
        common = dict(loss_type=cfg.loss_type, gnet=self.gnet, mesh=mesh)
        if cfg.cache_latents > 0:
            step = tstep.make_cached_train_step(
                self.pipeline, self.meta_net, self.optimizer, **common)
        else:
            step = tstep.make_train_step(
                self.pipeline, self.meta_net, self.optimizer,
                train_unet=cfg.unfreeze_model, **common)
        # validation in cached mode without a val loader runs over held-out
        # cached batches, so it takes the cached eval step
        self._eval_cached = cfg.cache_latents > 0 and self.val_loader is None
        evaluate = tstep.make_eval_step(
            self.pipeline, self.meta_net, train_unet=cfg.unfreeze_model,
            cached=self._eval_cached, **common)
        eager = pmesh.runs_eagerly(mesh)
        self.step_fn = step.eager if eager else step
        self.eval_fn = evaluate.eager if eager else evaluate

    # -- checkpointing --------------------------------------------------------
    def save(self, state: tstep.TrainState, tag: Optional[str] = None) -> str:
        # state.step counts micro-batches; checkpoints are named by optimizer
        # steps like the reference's global_step
        step = state.step // max(self.cfg.accumulate, 1)
        name = tag or f"embeddings_gs-{step}.pt"
        path = os.path.join(self.run_dir, "checkpoints", name)
        if self.writer:          # every rank holds the same state
            mgr.save_checkpoint(self.pipeline.manager_cfg,
                                state.manager_state, path,
                                meta_net=self.meta_net)
        return path

    def melk(self, signum=None, frame=None) -> None:
        """The SIGUSR1 handler: checkpoint the live state to
        ``embeddings_last.pt``; ``fit`` then stops at the next step
        boundary."""
        print(f"[trainer] signal {signum}: checkpointing to "
              f"embeddings_last.pt")
        self.save(self._state, tag="embeddings_last.pt")
        self._interrupted = True

    # -- frozen-feature cache (fast-personalisation mode) ---------------------
    def _build_cache(self) -> None:
        """The training cache, plus ``val_batches`` held-out batches when
        validation runs over cached batches."""
        cfg = self.cfg
        n_val = self.val_batches if self._eval_cached else 0
        print(f"[trainer] caching {cfg.cache_latents}+{n_val} augmented "
              f"batches of frozen features")
        cache = tstep.precompute_cache(
            self.pipeline, self.meta_net,
            (pmesh.shard_batch(b, self.mesh) for b in self.loader),
            cfg.cache_latents + n_val)
        self._cache = cache[: cfg.cache_latents]
        self._val_cache = cache[cfg.cache_latents:]

    def _device_batches(self, loader):
        keys = ("image", "tokens", "faces", "ids", "num_ids")
        it = iter(loader)
        try:
            for batch in it:
                batch = {k: v for k, v in batch.items()
                         if k in keys or k.startswith("override_")}
                # this rank's rows of the global batch
                yield {k: torch.as_tensor(v).to(self.device) for k, v in
                       pmesh.shard_batch(batch, self.mesh).items()}
        finally:
            if hasattr(it, "close"):
                it.close()           # stops a prefetching loader's thread

    def _batches(self):
        if self._cache is None:
            yield from self._device_batches(self.loader)
            return
        i = 0
        while True:
            yield self._cache[i % len(self._cache)]
            i += 1

    # -- validation -----------------------------------------------------------
    def validate(self, state: tstep.TrainState) -> float:
        """Mean ``loss_simple`` of the loss-only eval step over up to
        ``val_batches`` batches, each with a generator seeded 0; nothing is
        updated.  Without a ``val_loader`` it reads the training loader (the
        reference's val split is the train dataset), or in cached mode the
        held-out cached batches (made here if need be)."""
        if self._eval_cached:
            if self._cache is None:
                self._build_cache()
            source = iter(self._val_cache or self._cache[: self.val_batches])
        else:
            source = self._device_batches(self.val_loader
                                          if self.val_loader is not None
                                          else self.loader)
        losses = []
        try:
            for batch in source:
                if len(losses) >= self.val_batches:
                    break
                gen = torch.Generator(device=self.device).manual_seed(0)
                logs = self.eval_fn(state, self.basis, batch, gen)
                losses.append(float(logs["loss_simple"]))
        finally:
            if hasattr(source, "close"):
                source.close()
        return float(np.mean(losses)) if losses else float("nan")

    # -- main loop ------------------------------------------------------------
    def _log(self, log_f, rec: dict, scalars: dict) -> None:
        if log_f is None:
            return
        log_f.write(json.dumps(rec) + "\n")
        log_f.flush()
        if self.tb is not None:
            for tag, value in scalars.items():
                self.tb.add_scalar(tag, value, rec["step"])
            self.tb.flush()

    def fit(self, state: tstep.TrainState) -> tstep.TrainState:
        cfg = self.cfg
        accum = max(cfg.accumulate, 1)
        step = state.step // accum
        t_start = time.perf_counter()
        if cfg.cache_latents > 0 and self._cache is None:
            self._build_cache()
        validating = self.val_loader is not None or self._eval_cached
        self._state, self._interrupted = state, False
        main = threading.current_thread() is threading.main_thread()
        previous = signal.signal(signal.SIGUSR1, self.melk) if main else None
        try:
            with (open(self.metrics_path, "a") if self.writer
                  else contextlib.nullcontext()) as log_f:
                while step < cfg.max_steps and not self._interrupted:
                    batches, seen = self._batches(), False
                    try:
                        while step < cfg.max_steps and not self._interrupted:
                            t_wait = time.perf_counter()
                            batch = next(batches, None)
                            if batch is None:
                                break
                            seen = True
                            t0 = time.perf_counter()
                            state, logs = self.step_fn(state, self.basis,
                                                       batch)
                            self._state = state
                            if state.step % accum != 0:
                                continue
                            step += 1
                            if step % cfg.log_every == 0 or step == 1:
                                # reading the loss waits for the device
                                loss = float(logs["loss"])
                                simple = float(logs["loss_simple"])
                                self._log(log_f, {
                                    "step": step, "loss": loss,
                                    "loss_simple": simple,
                                    "step_time_s": time.perf_counter() - t0,
                                    "data_wait_s": t0 - t_wait,
                                    "wall_s": time.perf_counter() - t_start},
                                    {"train/loss": loss,
                                     "train/loss_simple": simple})
                            if step % cfg.ckpt_every == 0:
                                self.save(state)
                            if validating and step % self.val_every == 0:
                                val = self.validate(state)
                                self._log(log_f, {"step": step,
                                                  "val_loss_simple": val},
                                          {"val/loss_simple": val})
                            for cb in self.callbacks:
                                new_state = cb.on_step(step, self, state)
                                if new_state is not None:
                                    state = self._state = new_state
                    finally:
                        batches.close()
                    if not seen:
                        raise ValueError("the loader yielded no batch")
        except KeyboardInterrupt:
            print("[trainer] interrupted -- saving last checkpoint")
            self.save(state, tag="embeddings_last.pt")
            raise
        finally:
            if main:     # a handler not set from Python reads back as None
                signal.signal(signal.SIGUSR1, previous if previous is not None
                              else signal.SIG_DFL)
        self.save(state)
        return state

    def close(self) -> None:
        """Closes the TensorBoard event file."""
        if self.tb is not None:
            self.tb.close()
            self.tb = None
