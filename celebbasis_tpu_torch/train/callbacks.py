"""Trainer callbacks: sample images, device telemetry, profiling, mode swap.

Counterpart of ``celebbasis_tpu/train/callbacks.py`` (the reference's
Lightning callbacks).  A callback has ``on_step(step, trainer, state)``,
called after every optimizer step; one that returns a ``TrainState`` hands
the trainer a new state (``ModeSwap``).

* ``ImageLogger`` -- every ``every`` steps a grid of samples from
  ``pipeline.make_txt2img_fn`` with the live manager state, into
  ``<run>/images/samples_gs-{step:06d}.jpg``;
* ``DeviceMonitor`` -- ``<run>/device_stats.jsonl``: wall time per interval
  and the trainer device's allocated and peak bytes (null on the CPU);
* ``Profiler`` -- ``torch.profiler`` over steps [start, stop), its trace in
  ``<run>/profile``;
* ``ModeSwap`` -- unfreezes the UNet at ``swap_step``
  (``Trainer.unfreeze_unet``);
* ``Resume`` -- the legacy trainers' crash recovery: their whole state in
  ``<run>/resume/step_{step:08d}.pt`` every ``every`` steps, and the latest
  file read back (the JAX package's ``OrbaxResume``, with ``torch.save``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


class ImageLogger:
    """A sample grid every ``every`` steps under ``<run_dir>/images``.
    ``write=False`` samples without writing (a data-parallel rank other
    than 0); ``eager`` samples uncaptured (over a gloo mesh)."""

    def __init__(self, pipeline, run_dir: str, tokenizer, every: int = 600,
                 max_images: int = 4, image_size: int = 512,
                 prompt: str = "a photo of a sks person", num_steps: int = 20,
                 seed: int = 0, write: bool = True, eager: bool = False):
        self.every = every
        self.write = write
        self.dir = os.path.join(run_dir, "images")
        if write:
            os.makedirs(self.dir, exist_ok=True)
        self.pipeline = pipeline
        self.tokenizer = tokenizer
        self.prompt = prompt
        self.max_images = max_images
        self.seed = seed
        self._fn = pipeline.make_txt2img_fn(
            num_steps=num_steps, guidance_scale=7.5, image_size=image_size,
            output="uint8")
        if eager:
            self._fn = self._fn.eager

    def on_step(self, step: int, trainer, state) -> None:
        self.maybe_log(step, state.manager_state, trainer.basis)

    def maybe_log(self, step: int, manager_state, basis) -> Optional[str]:
        if step % self.every != 0:
            return None
        from PIL import Image
        dev = self.pipeline.device
        B = self.max_images
        as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                           device=dev)
        k = len(self.pipeline.manager_cfg.placeholder_token_ids)
        gens = [torch.Generator(device=dev).manual_seed(self.seed + j)
                for j in range(B)]
        u8 = self._fn(manager_state, basis,
                      as_dev(self.tokenizer([self.prompt] * B)),
                      as_dev(self.tokenizer([""] * B)),
                      as_dev(np.zeros((B, k))), as_dev(np.ones(B)), gens)
        grid = np.concatenate(list(u8.cpu().numpy()), axis=1)
        if not self.write:
            return None
        path = os.path.join(self.dir, f"samples_gs-{step:06d}.jpg")
        Image.fromarray(grid).save(path)
        return path


class DeviceMonitor:
    """Wall time and device memory every ``every`` steps."""

    def __init__(self, run_dir: str, every: int = 100):
        self.every = every
        self.path = os.path.join(run_dir, "device_stats.jsonl")
        self._t0 = time.perf_counter()
        self._last = self._t0

    def on_step(self, step: int, trainer, state) -> None:
        self.maybe_log(step, trainer.device)

    def maybe_log(self, step: int, device: torch.device) -> None:
        if step % self.every != 0:
            return
        now = time.perf_counter()
        on_card = device.type == "cuda"
        rec = {"step": step, "interval_s": now - self._last,
               "total_s": now - self._t0,
               "bytes_in_use": (torch.cuda.memory_allocated(device)
                                if on_card else None),
               "peak_bytes_in_use": (torch.cuda.max_memory_allocated(device)
                                     if on_card else None)}
        self._last = now
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class Profiler:
    """``torch.profiler`` over steps [start, stop); the Chrome trace goes to
    ``<run>/profile/trace_{start}-{stop}.json``."""

    def __init__(self, run_dir: str, start: int = 10, stop: int = 13):
        self.dir = os.path.join(run_dir, "profile")
        self.start, self.stop = start, stop
        self._prof = None

    def on_step(self, step: int, trainer=None, state=None) -> None:
        self.step(step)

    def step(self, step: int) -> None:
        if step == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif step >= self.stop and self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.dir, f"trace_{self.start}-{self.stop}.json"))
            self._prof = None


class ModeSwap:
    """From ``swap_step`` on, the UNet trains too, at ``model_lr``, with a
    fresh two-group optimizer (the reference's ModeSwapCallback); the swap
    happens at a step boundary."""

    def __init__(self, swap_step: int, model_lr: float = 1.0e-6):
        self.swap_step = swap_step
        self.model_lr = model_lr
        self._swapped = False

    def on_step(self, step: int, trainer, state):
        if self._swapped or step < self.swap_step:
            return None
        self._swapped = True
        print(f"[ModeSwap] step {step}: unfreezing the UNet "
              f"(model_lr={self.model_lr})")
        return trainer.unfreeze_unet(state, self.model_lr)


class Resume:
    """Save and restore a legacy trainer's whole state -- the trained
    modules, the optimizer(s), the EMA copies, the step, the generator --
    as one ``torch.save`` file a step, under ``<run_dir>/resume``.
    Counterpart of the JAX package's ``train/callbacks.py::OrbaxResume``;
    the state is whatever dict of tensors, state dicts and numbers the
    caller hands over (``cli/train_legacy.py``, ``cli/train_ae.py``)."""

    def __init__(self, run_dir: str, every: int = 200):
        self.every = every
        self.dir = os.path.abspath(os.path.join(run_dir, "resume"))

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.pt")

    def maybe_save(self, step: int, state: dict) -> None:
        if step % self.every != 0:
            return
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.dir):
            return None
        steps = [int(f[5:13]) for f in os.listdir(self.dir)
                 if f.startswith("step_") and f.endswith(".pt")]
        return max(steps) if steps else None

    def restore(self, step: int, device=None) -> dict:
        return torch.load(self.path(step), map_location=device,
                          weights_only=True)

