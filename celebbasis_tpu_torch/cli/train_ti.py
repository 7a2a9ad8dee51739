"""Textual-inversion baseline trainer (counterpart of
``celebbasis_tpu/cli/train_ti.py``): the reference's ``main.py`` path.

Trains a placeholder's learned vectors directly through the frozen diffusion
stack (no face encoder, no basis): the ``--init_word`` recipe of
``textual_train.sh`` / ``v1-finetune.yaml``.  Only the vectors take
gradients; the VAE, CLIP and UNet stay frozen and hold no ``.grad``.  AdamW
with torch's default weight decay 1e-2 at ``--lr`` times the batch size (the
reference's ``scale_lr``).  The run dir holds ``metrics.jsonl`` (step 1 and
every 50th) and ``checkpoints/embeddings_gs-{step}.pt`` (every 500th step
and the last) in the reference's TI schema.

Runs on ``cuda``; ``--device cpu`` asks for the CPU on purpose.

    python -m celebbasis_tpu_torch.cli.train_ti --base configs/aigc_id.yaml \
        --actual_resume sd-v1-4.ckpt --data_root subject/ --init_word face
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from celebbasis_tpu_torch import loader
from celebbasis_tpu_torch.core import textual_inversion as ti
from celebbasis_tpu_torch.data.personalized import (PersonalizedBase,
                                                    PersonalizedConfig)
from celebbasis_tpu_torch.diffusion import ddpm
from celebbasis_tpu_torch.train.step import (draw_step_noise, latent_shape,
                                             make_optimizer, noisy_latents,
                                             written_in_place)
from celebbasis_tpu_torch.train.trainer import TrainerConfig, make_run_dir
from celebbasis_tpu_torch.utils import graphs
from celebbasis_tpu_torch.utils.config import load_run_spec


def make_ti_loss_fn(pipe, cfg: ti.TIConfig, ph_ids, reg_weight: float = 0.0,
                    init_vectors=None):
    """``loss_fn(ti_params, batch, generator) -> (loss, logs)``: frozen VAE
    encode, posterior / t / eps draws (``train.step.noisy_latents``: the
    batch may carry ``override_znoise``, ``override_t`` and
    ``override_noise`` in their place), the vectors injected at the
    placeholders, CLIP, the UNet's eps and its MSE, plus ``reg_weight``
    times the pull toward ``init_vectors``.  batch: image (B, H, W, 3) in
    [-1, 1], tokens (B, 77) int64."""
    sched = ddpm.ScheduleArrays.from_schedule(pipe.schedule, pipe.device)
    ph = torch.as_tensor(ph_ids, dtype=torch.int64, device=pipe.device)

    def loss_fn(ti_params, batch, generator):
        with torch.no_grad():
            mean, logvar = pipe.vae.encode(batch["image"])
            embeds = pipe.clip.token_embed(batch["tokens"])
        z_t, t, noise = noisy_latents(pipe, sched, batch, generator, mean,
                                      logvar)
        ctx = pipe.clip.encode(ti.ti_inject(cfg, ti_params, ph,
                                            batch["tokens"], embeds))
        loss, logs = ddpm.eps_mse_loss(pipe.unet(z_t, t, ctx), noise)
        if reg_weight > 0 and init_vectors is not None:
            loss = loss + reg_weight * ti.embedding_reg_loss(ti_params,
                                                             init_vectors)
        return loss, logs

    return loss_fn


def make_ti_train_step(pipe, cfg: ti.TIConfig, ph_ids, optimizer,
                       reg_weight: float = 0.0, init_vectors=None):
    """``step(ti_params, batch, generator) -> logs``: the draws from
    ``generator`` (posterior noise, t, eps), then one loss, backward and
    optimizer step, captured as one CUDA graph per signature on a card
    (``utils.graphs``; ``step.eager`` is the step uncaptured);
    ``ti_params``, the optimizer's one parameter, is updated in place."""
    loss_fn = make_ti_loss_fn(pipe, cfg, ph_ids, reg_weight, init_vectors)
    (param,) = [p for g in optimizer.param_groups for p in g["params"]]

    def body(batch):
        loss, logs = loss_fn(param, batch, None)
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in logs.items()}

    def make(run):
        def step(ti_params, batch, generator):
            if ti_params is not param:
                raise ValueError("ti_params must be the optimizer's "
                                 "parameter")
            batch = draw_step_noise(batch, generator,
                                    latent_shape(pipe, batch),
                                    pipe.cfg.timesteps, pipe.device)
            return run(batch)
        return step

    return graphs.entry(make, body,
                        restore=lambda: written_in_place(optimizer))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--placeholder", type=str, default="*")
    p.add_argument("--init_word", type=str, default="face")
    p.add_argument("--num_vectors", type=int, default=1)
    p.add_argument("--actual_resume", type=str, default=None,
                   help="sd-v1-4 checkpoint (CompVis .ckpt)")
    p.add_argument("--name", type=str, default="ti")
    p.add_argument("--logdir", type=str, default="logs")
    p.add_argument("--max_steps", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=5.0e-3)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--coarse_class", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    return p


def main(argv=None) -> str:
    """Trains and returns the run dir."""
    args = build_argparser().parse_args(argv)
    spec = load_run_spec(args.base)
    asm = loader.assemble(spec, sd_ckpt=args.actual_resume,
                          vocab_path=args.vocab, image_size=args.image_size,
                          seed=args.seed, device=args.device)
    pipe, dev = asm.pipeline, asm.device

    cfg = ti.TIConfig(placeholder_strings=(args.placeholder,),
                      num_vectors_per_token=args.num_vectors,
                      token_dim=spec.clip.width)
    init_vectors = ti.init_ti_params(cfg, asm.tokenizer, pipe.token_table(),
                                     [args.init_word]).to(dev)
    params = torch.nn.Parameter(init_vectors.clone())
    ph_ids = ti.placeholder_token_ids(cfg, asm.tokenizer)
    optimizer = make_optimizer({"ti": [params]},
                               lr=args.lr * args.batch_size)
    step_fn = make_ti_train_step(pipe, cfg, ph_ids, optimizer,
                                 reg_weight=0.0, init_vectors=init_vectors)

    ds = PersonalizedBase(PersonalizedConfig(
        data_root=args.data_root, placeholder=args.placeholder,
        image_size=args.image_size, coarse_class_text=args.coarse_class,
        seed=args.seed))
    run_dir = make_run_dir(TrainerConfig(name=args.name, logdir=args.logdir,
                                         max_steps=args.max_steps))
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as logf:
        for step in range(1, args.max_steps + 1):
            idx = np.random.default_rng(step).integers(0, len(ds),
                                                       args.batch_size)
            items = [ds[int(i)] for i in idx]
            batch = {
                "image": torch.from_numpy(
                    np.stack([it["image"] for it in items])).to(dev),
                "tokens": torch.from_numpy(np.asarray(asm.tokenizer(
                    [it["caption"] for it in items]), np.int64)).to(dev),
            }
            logs = step_fn(params, batch, generator)
            if step % 50 == 0 or step == 1:
                logf.write(json.dumps({"step": step,
                                       "loss": float(logs["loss"])}) + "\n")
                logf.flush()
            if step % 500 == 0 or step == args.max_steps:
                ti.save_ti_checkpoint(
                    cfg, params, ph_ids,
                    os.path.join(run_dir, "checkpoints",
                                 f"embeddings_gs-{step}.pt"))
    print(f"[train_ti] done; run dir {run_dir}")
    return run_dir


if __name__ == "__main__":
    main()
