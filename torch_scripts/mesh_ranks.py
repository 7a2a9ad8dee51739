#!/usr/bin/env python3
"""The ranks of ``chip_smoke.py``'s ``mesh`` phase: the port's mesh paths
through their entry points, ``cli/train.py --mesh [--fsdp]`` and
``cli/txt2img.py --mesh/--tp``, each beside the one-process run it must
reproduce.  One process a rank, started by ``torchrun``:

    python -m torch.distributed.run --nproc_per_node 1 \\
        torch_scripts/mesh_ranks.py nccl1 WORK
    python -m torch.distributed.run --nproc_per_node 2 \\
        torch_scripts/mesh_ranks.py gloo2 WORK

``nccl1`` (NCCL, one rank, the paths on their CUDA graphs): three uncached
train steps without a mesh, with ``--mesh 1`` and with ``--mesh 1
--fsdp``, and ``txt2img`` without a mesh and with ``--mesh 1 --tp 1``.
``gloo2`` (two ranks over gloo on one card, uncaptured): rank 0 trains two
steps at the global batch without a mesh, at the rate ``--mesh 2`` takes
(``scale_lr`` multiplies it by the data ranks), and takes its first step's
gradient also as the mean over the batch's halves (``split_gradients``),
while rank 1 waits; then both train with ``--mesh 2`` and ``--mesh 2
--fsdp``; rank 0 samples without a mesh (bf16 on the kernel and on the
plain attention route, float32, and bf16 one sample a call as each rank of
``--mesh 2`` samples), then both with ``--mesh 2`` (bf16 and float32) and
with ``--tp 2``.

``WORK`` holds ``faces/ffhq.pickle`` (aligned-face PNGs, written by the
caller).  Each rank writes ``WORK/<task>_rank<r>.pt``: per run the logged
losses, the MLP before and after the run and its gradient after the first
step (and the split gradients), the
manager state, ms a step to a sync, peak memory, flash launches, UNet calls,
the FSDP bytes stored and predicted, the images, and (gloo) the seconds
spent in collectives.  ``chip_smoke.phase_mesh`` checks them.  The weights
are random from the CLIs' seed with the UNet's output convs drawn.
``--config``, ``--size``, ``--steps`` and ``--device cpu`` rehearse the
same runs at a tiny size on the CPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from celebbasis_tpu_torch import loader  # noqa: E402
from celebbasis_tpu_torch.cli import train as train_cli  # noqa: E402
from celebbasis_tpu_torch.cli import txt2img as txt2img_cli  # noqa: E402
from celebbasis_tpu_torch.ops import flash_attention as fa  # noqa: E402
from celebbasis_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from celebbasis_tpu_torch.train import step as tstep  # noqa: E402
from celebbasis_tpu_torch.utils.config import load_run_spec  # noqa: E402


def log(msg: str) -> None:
    print(f"[mesh] rank {dist.get_rank()}: {msg}", flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Runs:
    """While entered, the CLIs' assemblies draw the UNet's output convs and
    count its calls, the train CLI's ``Trainer`` is recorded (its FSDP bytes,
    ms a step, its first step's MLP gradient), and (``time_collectives``)
    every all-reduce and all-gather is timed to a sync."""

    def __init__(self, device, time_collectives=False, fp32=False,
                 witness=False):
        self.device, self.time_collectives = device, time_collectives
        self.fp32, self.witness = fp32, witness

    def __enter__(self):
        runs = self
        self.unet_calls, self.trainers, self.collective_s = 0, [], 0.0
        self.collectives = 0
        self._real = (loader.assemble, train_cli.assemble, train_cli.Trainer,
                      dist.all_reduce, dist.all_gather_into_tensor)

        def assemble(*args, **kw):
            if self.fp32:
                kw["dtype"] = torch.float32
            asm = self._real[0](*args, **kw)
            loader.init_weights(
                asm.pipeline.unet,
                torch.Generator(device=asm.device).manual_seed(5),
                zero_convs=False)
            if kw.get("param_dtype") is not None:
                from celebbasis_tpu_torch.utils.precision import \
                    cast_float_params
                cast_float_params(asm.pipeline, kw["param_dtype"])
            asm.pipeline.unet.register_forward_pre_hook(self._count)
            return asm

        class Trainer(self._real[2]):
            def __init__(tr, pipeline, meta_net, *args, mesh=None, **kw):
                frozen = (pipeline, meta_net)
                tstep.build_trainable(meta_net)   # the MLP is not sharded
                n = pmesh.axis_size(mesh, pmesh.DATA)
                tr.fsdp_predicted = sum(
                    p.numel() // (n if spec else 1) * p.element_size()
                    for m in frozen
                    for name, spec in pmesh.param_shardings(
                        m, n, fsdp=True).items()
                    for p in [m.get_parameter(name)] if not p.requires_grad)
                tr.whole_bytes = sum(pmesh.stored_bytes(m) for m in frozen)
                tr.split_grads = None
                super().__init__(pipeline, meta_net, *args, mesh=mesh, **kw)
                tr.stored_bytes = sum(pmesh.stored_bytes(m) for m in frozen)
                tr.step_ms, tr.first_grad = [], None
                tr.mlp0 = flat(tr.trainable["meta"])
                tr.callbacks.append(tr)
                runs.trainers.append(tr)
                sync(runs.device)
                tr._t = time.perf_counter()

            def _build_steps(tr):
                super()._build_steps()
                if not runs.witness:
                    return
                step_fn = tr.step_fn

                def first_split(state, basis, batch):
                    if tr.split_grads is None:
                        tr.split_grads = split_gradients(tr, state, basis,
                                                         batch)
                    return step_fn(state, basis, batch)
                tr.step_fn = first_split

            def on_step(tr, step, trainer, state):
                sync(runs.device)
                now = time.perf_counter()
                tr.step_ms.append((now - tr._t) * 1e3)
                if step == 1:
                    tr.first_grad = flat(p.grad for p in tr.trainable["meta"])
                tr._t = time.perf_counter()

        def timed(fn):
            def call(*args, **kw):
                sync(runs.device)
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                sync(runs.device)
                runs.collective_s += time.perf_counter() - t0
                runs.collectives += 1
                return out
            return call

        loader.assemble = train_cli.assemble = assemble
        train_cli.Trainer = Trainer
        if self.time_collectives:
            dist.all_reduce = timed(self._real[3])
            dist.all_gather_into_tensor = timed(self._real[4])
        return self

    def _count(self, module, args):
        self.unet_calls += 1

    def __exit__(self, *exc):
        (loader.assemble, train_cli.assemble, train_cli.Trainer,
         dist.all_reduce, dist.all_gather_into_tensor) = self._real


def flat(tensors) -> torch.Tensor:
    """The tensors as one float32 vector on the host."""
    return torch.cat([t.detach().float().reshape(-1).cpu() for t in tensors])


def split_gradients(tr, state, basis, batch) -> dict:
    """The first step's MLP gradient without a mesh, taken eagerly from the
    step's own draws (the generator is put back): over the whole batch, and
    the mean of the gradients over its two halves, each half a call of its
    own.  The halves are what the two ranks of ``--mesh 2`` compute, at
    their batch size, with no collective between them (the momentum update
    does not reach the injected embeddings, and ``loss_type`` is 'none')."""
    pipe = tr.pipeline
    if tr.cfg.loss_type != "none":
        raise ValueError("the split gradients need loss_type 'none'")
    saved = state.generator.get_state()
    full = tstep.draw_step_noise(batch, state.generator,
                                 tstep.latent_shape(pipe, batch),
                                 pipe.cfg.timesteps, pipe.device)
    state.generator.set_state(saved)
    loss_fn = tstep.make_loss_fn(pipe, tr.meta_net, tr.cfg.loss_type,
                                 gnet=tr.gnet)
    params = list(tr.trainable["meta"])
    n = full["tokens"].shape[0]

    def grad(rows):
        part = {k: v[rows] if torch.is_tensor(v) and v.dim() and
                v.shape[0] == n else v for k, v in full.items()}
        loss, _ = loss_fn(state.manager_state, basis, part, None)
        return flat(torch.autograd.grad(loss, params))

    whole = grad(slice(0, n))
    halves = (grad(slice(0, n // 2)) + grad(slice(n // 2, n))) / 2
    return {"whole": whole, "halves": halves}


def measured(name, device, fn, time_collectives=False, fp32=False,
             witness=False):
    """Runs ``fn(runs)`` with the flash counters at 0 and the peak memory
    reset (``fp32``: the CLIs' models compute in float32, TF32 off;
    ``witness``: the train CLI's first step also takes ``split_gradients``,
    whose launches the counts hold); -> (its result, a record)."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    fa.reset_launch_count()
    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if fp32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        with Runs(device, time_collectives, fp32, witness) as runs:
            out = fn(runs)
            sync(device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rec = {"run": name, "wall_s": time.perf_counter() - t0,
           "launches": {k: v for k, v in fa.launch_counts().items() if v},
           "unet_calls": runs.unet_calls,
           "collective_s": runs.collective_s,
           "collectives": runs.collectives}
    if torch.device(device).type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for tr in runs.trainers:
        with open(tr.metrics_path) if tr.writer else open(os.devnull) as f:
            rec["losses"] = [json.loads(line)["loss"] for line in f]
        rec.update(
            step_ms=tr.step_ms, first_grad=tr.first_grad, mlp0=tr.mlp0,
            mlp=flat(tr.trainable["meta"]), split_grads=tr.split_grads,
            id_coefficients=tr._state.manager_state.id_coefficients.cpu(),
            id_embeddings=tr._state.manager_state.id_embeddings.cpu(),
            fsdp_predicted=tr.fsdp_predicted, stored_bytes=tr.stored_bytes,
            whole_bytes=tr.whole_bytes)
    if isinstance(out, np.ndarray):
        rec["images"] = out
    log(f"{name}: {rec['wall_s']:.1f} s, losses {rec.get('losses')}, ms a "
        f"step {[round(x, 1) for x in rec.get('step_ms', [])]}, launches "
        f"{json.dumps(rec['launches'])}, UNet calls {rec['unet_calls']}, "
        f"collectives {rec['collectives']} in {rec['collective_s']:.2f} s, "
        f"peak {rec.get('peak_gib', 0):.2f} GiB"
        + (f", FSDP bytes stored {rec['stored_bytes']} predicted "
           f"{rec['fsdp_predicted']} whole {rec['whole_bytes']}"
           if "stored_bytes" in rec else ""))
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("task", choices=["nccl1", "gloo2"])
    p.add_argument("work")
    p.add_argument("--config", default=os.path.join(REPO, "configs",
                                                    "aigc_id.yaml"))
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--ddim_steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    # a rehearsal on the CPU takes gloo for both
    backend = "nccl" if args.task == "nccl1" and args.device == "cuda" \
        else "gloo"
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    # the group is this program's: the CLIs' make_mesh finds it running
    dist.init_process_group(backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    os.chdir(REPO)
    dev = args.device
    train_args = [
        "--base", args.config, "--data_root", os.path.join(args.work, "faces"),
        "--image_size", str(args.size), "--face_size", str(args.size),
        "--device", dev,
        "lightning.trainer.log_every_n_steps=1",
        "lightning.trainer.limit_val_batches=0"]
    sample_args = ["--config", args.config, "--H", str(args.size), "--W",
                   str(args.size), "--ddim_steps", str(args.ddim_steps),
                   "--n_samples", "2", "--device", dev]
    gloo = backend == "gloo"
    base_lr = load_run_spec([args.config]).trainer.base_lr
    recs = []

    def train(name, flags, steps, batch, witness=False):
        logdir = os.path.join(args.work, f"{args.task}_{name}")
        recs.append(measured(name, dev, lambda runs: train_cli.main(
            train_args + ["--logdir", logdir, "--max_steps", str(steps),
                          f"data.params.batch_size={batch}"] + flags),
            time_collectives=gloo, witness=witness))

    def sample(name, flags, fp32=False):
        outdir = os.path.join(args.work, f"{args.task}_{name}_r{rank}")
        recs.append(measured(name, dev, lambda runs: txt2img_cli.main(
            sample_args + ["--outdir", outdir] + flags
            + ["--precision", "fp32"] * fp32),
            time_collectives=gloo, fp32=fp32))
        recs[-1]["files"] = sorted(
            os.path.relpath(os.path.join(d, f), outdir)
            for d, _, fs in os.walk(outdir) for f in fs)
        if "--tp" in flags:
            recs[-1]["local_heads"] = TP_HEADS[:]

    if args.task == "nccl1":
        train("train", [], args.steps, 2)
        train("train_mesh1", ["--mesh", "1"], args.steps, 2)
        train("train_mesh1_fsdp", ["--mesh", "1", "--fsdp"], args.steps, 2)
        sample("txt2img", [])
        sample("txt2img_mesh1_tp1", ["--mesh", "1", "--tp", "1"])
    else:
        if rank == 0:             # the one-process runs; rank 1 waits
            # scale_lr multiplies the rate by the data ranks: the reference
            # takes the rate that --mesh 2 trains at
            train("train_b4",
                  [f"model.params.base_learning_rate={base_lr * world}"],
                  2, 2 * world, witness=True)
        dist.barrier()
        train("train_mesh2", ["--mesh", str(world)], 2, 2 * world)
        train("train_mesh2_fsdp", ["--mesh", str(world), "--fsdp"], 2,
              2 * world)
        if rank == 0:
            sample("txt2img", [])
            sample("txt2img_fp32", [], fp32=True)
            # bf16 rounding alone: the same run on the plain attention route
            # (the yardstick of the bf16 pixels below)
            from celebbasis_tpu_torch.ops import attention
            attention.set_default_impl("xla")
            sample("txt2img_plain", [])
            attention.set_default_impl(None)
            # --mesh 2's per-rank calls in one process: one sample a call,
            # sample i still drawn from (--seed, i)
            prompts = os.path.join(args.work, "prompts.txt")
            with open(prompts, "w") as f:
                f.write("a photo of a sks person\n" * world)
            sample("txt2img_n1", ["--n_samples", "1", "--from-file",
                                  prompts])
        dist.barrier()
        sample("txt2img_mesh2", ["--mesh", str(world)])
        sample("txt2img_mesh2_fp32", ["--mesh", str(world)], fp32=True)
        sample("txt2img_tp2", ["--tp", str(world)])
    torch.save(recs, os.path.join(args.work, f"{args.task}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# the local heads of every attention after --tp sharded them (read by a
# wrapper of shard_params below)
TP_HEADS: list = []
_shard_params = pmesh.shard_params


def _recording_shard_params(module, mesh, **kw):
    out = _shard_params(module, mesh, **kw)
    if kw.get("use_tp"):
        TP_HEADS[:] = sorted({m.heads for m in module.modules()
                              if hasattr(m, "heads")})
    return out


pmesh.shard_params = _recording_shard_params

if __name__ == "__main__":
    main()
