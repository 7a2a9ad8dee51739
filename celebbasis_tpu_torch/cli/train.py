"""Training CLI (counterpart of ``celebbasis_tpu/cli/train.py``): the
reference's ``main_id_embed.py``, as ``01_start_train.sh`` calls it.

``--base`` config(s) and ``key=value`` overrides, ``--actual_resume`` (the
SD checkpoint), ``--fr_ckpt`` (the CosFace backbone), ``--name`` /
``--logdir`` for the run dir, ``--data_root`` (the aligned-face folder: its
``ffhq.pickle`` if there is one, else ``<folder>.pickle`` beside it, as
``cli/align.py`` writes), ``-r`` to resume from a run dir's latest
``embeddings_gs-*.pt``.  The run dir holds ``configs/<base>`` and
``configs/resolved.yaml``, ``metrics.jsonl`` and ``checkpoints/``.  A
validation loader is built when the config has a ``data.params.validation``
block (cached mode validates on held-out cached batches without one).  The
pacing comes from the config's ``lightning`` block, with Lightning's names:
``trainer.val_check_interval`` (200) and ``trainer.limit_val_batches`` (4)
pace validation, ``trainer.log_every_n_steps`` the metrics;
``callbacks.image_logger.params.batch_frequency`` (and ``max_images``) turns
on ``ImageLogger``, ``callbacks.device_monitor.params.every`` turns on
``DeviceMonitor`` (both off when absent); ``tensorboard: true`` writes a
TensorBoard event file.

Runs on ``cuda``; ``--device cpu`` asks for the CPU on purpose.

``--mesh D [M]`` trains data parallel over D ranks (one process each,
started by ``torchrun``; M > 1 adds copies over the mesh's ``model`` axis,
as the JAX trainer applies no tensor-parallel rule), and ``--fsdp`` shards
the large frozen weights over them.  The config's ``batch_size`` is the
global batch: every rank reads the one-process loader's batches and takes
its block of rows.  Rank 0 alone writes the run dir, the checkpoints and
``metrics.jsonl``; ``-r`` reads them back on every rank.  The collectives
are NCCL's on cards and gloo's on the CPU, or those of a group the caller
started before it called ``main``.

    python -m celebbasis_tpu_torch.cli.train --base configs/aigc_id.yaml \
        --actual_resume sd-v1-4.ckpt --fr_ckpt backbone.pth \
        --data_root faces/
    torchrun --nproc_per_node 8 -m celebbasis_tpu_torch.cli.train \
        --base configs/aigc_id_multi.yaml --mesh 8 [--fsdp] ...
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil

from celebbasis_tpu_torch.data.face_id import FaceIdDataset, PrefetchLoader
from celebbasis_tpu_torch.loader import assemble
from celebbasis_tpu_torch.parallel import mesh as pmesh
from celebbasis_tpu_torch.train.callbacks import DeviceMonitor, ImageLogger
from celebbasis_tpu_torch.train.trainer import Trainer, make_run_dir
from celebbasis_tpu_torch.utils.config import get, load_run_spec


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--name", type=str, default="aigc_id")
    p.add_argument("--logdir", type=str, default="logs")
    p.add_argument("--actual_resume", type=str, default=None,
                   help="sd-v1-4 checkpoint (CompVis .ckpt)")
    p.add_argument("--fr_ckpt", type=str, default=None,
                   help="CosFace R100 backbone.pth")
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--face_size", type=int, default=512)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--cache_latents", type=int, default=0,
                   help="fast mode: precompute N augmented batches of frozen "
                        "VAE posteriors and face features and cycle them")
    p.add_argument("--frozen_bf16", action="store_true",
                   help="store the frozen UNet/VAE/CLIP/face-net weights in "
                        "bf16 (fp32 is the parity default)")
    p.add_argument("-r", "--resume", type=str, default=None,
                   help="resume from a run dir (its latest "
                        "embeddings_gs-*.pt)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   help="data [model] shard counts, e.g. --mesh 8 or 4 2 "
                        "(one torchrun process each)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard large frozen weights over the mesh 'data' "
                        "axis (all-gathered where they are read)")
    p.add_argument("overrides", nargs="*", default=[],
                   help="config dot-list overrides key=value")
    return p


def latest_checkpoint(run_dir: str):
    """The run dir's ``embeddings_gs-*.pt`` with the highest step, or None."""
    cands = glob.glob(os.path.join(run_dir, "checkpoints",
                                   "embeddings_gs-*.pt"))
    step = lambda p: int(p.rsplit("-", 1)[1].split(".")[0])
    return max(cands, key=step) if cands else None


def main(argv=None) -> str:
    """Trains and returns the run dir."""
    # key=value overrides may stand between the flags
    args = build_argparser().parse_intermixed_args(argv)
    if args.fsdp and not args.mesh:
        raise ValueError("--fsdp shards over the --mesh 'data' axis")
    if args.mesh and len(args.mesh) > 2:
        raise ValueError("--mesh takes a data and a model count")
    mesh = None
    if args.mesh:
        mesh = pmesh.make_mesh(args.mesh[0], (args.mesh + [1])[1],
                               device=args.device or "cuda")
    try:
        return _train(args, mesh)
    finally:
        pmesh.close_mesh()


def _train(args, mesh) -> str:
    import yaml
    spec = load_run_spec(args.base, args.overrides)
    if args.data_root and spec.train_data:
        inside = os.path.join(args.data_root, "ffhq.pickle")
        beside = args.data_root.rstrip("/\\") + ".pickle"
        spec.train_data.pickle_path = (
            inside if os.path.exists(inside) else beside)
    if args.max_steps:
        spec.trainer.max_steps = args.max_steps
    if spec.train_data:
        spec.train_data.image_size = args.image_size
    tcfg = spec.trainer
    tcfg.cache_latents = args.cache_latents
    tcfg.frozen_bf16 = args.frozen_bf16
    tcfg.fsdp = args.fsdp
    tcfg.n_data_shards = pmesh.axis_size(mesh, pmesh.DATA)
    writer = pmesh.is_writer(mesh)
    tcfg.name, tcfg.logdir, tcfg.seed = args.name, args.logdir, args.seed
    tcfg.unfreeze_model, tcfg.model_lr = spec.unfreeze_model, spec.model_lr
    if spec.unfreeze_model:
        print(f"[train] UNet unfrozen (model_lr={spec.model_lr})")

    resume_ckpt = latest_checkpoint(args.resume) if args.resume else None
    if resume_ckpt:
        print(f"[train] resuming embeddings from {resume_ckpt}")
    asm = assemble(spec, sd_ckpt=args.actual_resume, fr_ckpt=args.fr_ckpt,
                   vocab_path=args.vocab, image_size=args.image_size,
                   seed=args.seed, embedding_ckpt=resume_ckpt,
                   device=args.device)

    run_dir = args.resume or (make_run_dir(tcfg) if writer else None)
    if mesh is not None:               # rank 0's timestamp names the run
        import torch.distributed as dist
        shared = [run_dir]
        dist.broadcast_object_list(shared, src=0)
        run_dir = shared[0]
    if writer:
        for base in args.base:
            shutil.copy(base, os.path.join(run_dir, "configs",
                                           os.path.basename(base)))
        with open(os.path.join(run_dir, "configs", "resolved.yaml"),
                  "w") as f:
            yaml.safe_dump({"name": args.name, "seed": args.seed,
                            "max_steps": tcfg.max_steps,
                            "lr": tcfg.base_lr}, f)

    loader = PrefetchLoader(FaceIdDataset(spec.train_data), asm.tokenizer,
                            tcfg.batch_size, face_size=args.face_size,
                            seed=args.seed)
    val_loader = None
    if spec.val_data and spec.val_data.pickle_path:
        spec.val_data.image_size = args.image_size
        if args.data_root:
            spec.val_data.pickle_path = spec.train_data.pickle_path
        try:
            val_loader = PrefetchLoader(
                FaceIdDataset(spec.val_data), asm.tokenizer, tcfg.batch_size,
                face_size=args.face_size, shuffle=False, seed=args.seed + 1)
        except (ValueError, FileNotFoundError) as e:
            print(f"[train] no validation data ({e})")

    light = get(spec.raw, "lightning", None) or {}
    callbacks = []
    monitor_every = get(light, "callbacks.device_monitor.params.every", 0)
    if monitor_every and writer:
        callbacks.append(DeviceMonitor(run_dir, every=monitor_every))
    sample = get(light, "callbacks.image_logger.params", None) or {}
    if sample.get("batch_frequency"):
        # every rank samples (FSDP's gathers are collective), rank 0 writes
        callbacks.append(ImageLogger(
            asm.pipeline, run_dir, asm.tokenizer,
            every=sample["batch_frequency"],
            max_images=sample.get("max_images", tcfg.batch_size),
            image_size=args.image_size, seed=args.seed, write=writer,
            eager=pmesh.runs_eagerly(mesh)))
    trainer = Trainer(
        asm.pipeline, asm.meta_net, asm.basis, loader, tcfg,
        run_dir=run_dir, callbacks=callbacks, val_loader=val_loader,
        val_every=get(light, "trainer.val_check_interval", 200),
        val_batches=get(light, "trainer.limit_val_batches", 4), mesh=mesh)
    try:
        state = trainer.fit(trainer.init_state(asm.manager_state))
    finally:
        trainer.close()
    print(f"[train] done at step {state.step}; checkpoints in "
          f"{os.path.join(run_dir, 'checkpoints')}")
    return run_dir


if __name__ == "__main__":
    main()
