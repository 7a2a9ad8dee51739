"""Legacy latent-diffusion training CLI: the reference's ``main.py`` fitting
a ``configs/latent-diffusion/*.yaml`` (counterpart of
``celebbasis_tpu/cli/train_legacy.py``).  Frozen first stage, eps-prediction
loss on its latents, the cond stage trained with the UNet where the config
says ``cond_stage_trainable: true``, the ``LambdaLinearScheduler``, EMA
weights (``LitEma``) and ``scale_by_std`` calibration on the first batch.

One train step -- the frozen first-stage encode, ``q_sample``, the UNet,
the l1/l2 eps loss, its backward, AdamW over the UNet (and the cond stage),
the EMA update -- runs as one CUDA graph on a card (``utils.graphs``; the
JAX CLI's ``jax.jit``), captured at the first step and replayed after.
AdamW is ``capturable`` there, its rate a device tensor that the schedule
writes between steps.  t and eps are drawn before the graph from the run's
generator (seeded by ``--seed``).  ``trainer.step.eager`` is the same step
uncaptured, which the CPU runs.

    python -m celebbasis_tpu_torch.cli.train_legacy \\
        --config celebbasis_tpu_torch/configs/celebahq-ldm-vq-4.yaml \\
        --fake-data 96 --max-steps 10

``--fake-data N`` trains on N random images (no dataset needs to be on
disk); otherwise the config's ``data.params.train`` target resolves through
``utils.registry``.  ``--ckpt-every`` / ``-r`` save and resume the whole
state (``train.callbacks.Resume``), ``--image-every`` writes a DDIM sample
grid (``LegacyLDM.make_sample_fn``) and ``--export-torch`` a CompVis
``.ckpt`` (the EMA UNet when EMA is on, the first stage and the cond stage)
that ``legacy.load_reference_checkpoint`` reads.  Runs on ``cuda``;
``--device cpu`` asks for the CPU on purpose.  Weights are random from
``--seed`` (the reference's zero-initialised output convs kept).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import yaml

from celebbasis_tpu_torch import legacy
from celebbasis_tpu_torch.core.losses import EmaState, ema_init, ema_update_
from celebbasis_tpu_torch.loader import init_weights, resolve_device
from celebbasis_tpu_torch.models.unet import (dropout_generators,
                                              set_dropout_generator)
from celebbasis_tpu_torch.train.callbacks import Resume
from celebbasis_tpu_torch.train.lr_schedule import (adamw_with_schedule,
                                                    lambda_linear_traceable,
                                                    set_lr)
from celebbasis_tpu_torch.train.step import allocate_state, written_in_place
from celebbasis_tpu_torch.utils import graphs
from celebbasis_tpu_torch.utils.config import get
from celebbasis_tpu_torch.utils.registry import instantiate_from_config


class LegacyTrainer:
    """``make_legacy_trainer``'s result.  ``step(images, cond_input=None,
    t=None, noise=None) -> loss`` trains the model in place; t and eps come
    from ``generator`` unless given.  ``step.eager`` is the uncaptured step
    and ``step.captured`` its ``utils.graphs.Captured``."""

    def __init__(self, ldm: legacy.LegacyLDM, cfg: Dict, batch_size: int,
                 ema: Optional[EmaState] = None,
                 generator: Optional[torch.Generator] = None):
        mp = get(cfg, "model.params", {}) or {}
        self.ldm, self.ema, self.generator = ldm, ema, generator
        self.lr = get(cfg, "model.base_learning_rate", 1e-4) * batch_size
        self.schedule: Optional[Callable[[int], float]] = None
        sched_cfg = mp.get("scheduler_config")
        if sched_cfg:
            # only the lambda-linear family appears in the published configs
            assert sched_cfg["target"].endswith("LambdaLinearScheduler"), \
                sched_cfg["target"]
            p = dict(sched_cfg.get("params", {}) or {})
            p.pop("verbosity_interval", None)
            self.schedule = lambda_linear_traceable(self.lr, **p)
        self.cond_trainable = bool(mp.get("cond_stage_trainable", False)) \
            and ldm.cond_kind != "uncond"

        ldm.requires_grad_(False)
        ldm.unet.requires_grad_(True).train()
        params = list(ldm.unet.parameters())
        if self.cond_trainable:
            ldm.cond_stage.requires_grad_(True)
            params += list(ldm.cond_stage.parameters())
        on_card = params[0].is_cuda
        # weight decay 1e-2, torch AdamW's default: the reference's
        # configure_optimizers constructs AdamW(params, lr=lr)
        self.optimizer = adamw_with_schedule(
            params, self.schedule or (lambda step: self.lr),
            capturable=on_card)
        if on_card:
            allocate_state(self.optimizer)
        if ldm.unet.cfg.dropout:
            set_dropout_generator(ldm.unet, generator)
        self._ema_src = dict(ldm.unet.named_parameters())
        self.sched = ldm.schedule_arrays()
        self.steps_done = 0
        self.step = graphs.entry(self._make, self._body,
                                 restore=self.written_in_place,
                                 generators=lambda: dropout_generators(
                                     ldm.unet))

    def ctx_of(self, cond_input: Optional[torch.Tensor]):
        """The conditioning of a batch: the LR image as it is (identity),
        the frozen first-stage encode (inpainting), or the cond stage's
        output, with grad where the cond stage trains."""
        ldm = self.ldm
        if cond_input is None:
            return None
        if ldm.cond_kind == "identity":
            return cond_input
        if ldm.cond_kind == "first_stage":
            with torch.no_grad():
                return ldm.encode_first_stage(cond_input) / ldm.scale_factor
        with torch.set_grad_enabled(self.cond_trainable
                                    and torch.is_grad_enabled()):
            return ldm.learned_conditioning(cond_input)

    def _body(self, images, cond_input, t, noise):
        with torch.no_grad():
            z = self.ldm.encode_first_stage(images)
        loss = self.ldm.eps_loss(self.sched, z, self.ctx_of(cond_input), t,
                                 noise)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        self.optimizer.step()
        if self.ema is not None:
            ema_update_(self.ema, self._ema_src)
        return loss.detach()

    def latent_shape(self, images: torch.Tensor) -> tuple:
        """The first stage's latents of ``images``: (B, H/f, W/f,
        embed_dim)."""
        fs = self.ldm.first_stage.cfg
        f = 2 ** (len(fs.ch_mult) - 1)
        B, H, W = images.shape[:3]
        return (B, H // f, W // f, fs.embed_dim)

    def _make(self, run):
        def step(images, cond_input=None, t=None, noise=None):
            if t is None or noise is None:
                z_like = torch.empty(self.latent_shape(images),
                                     device=images.device)
                t_d, n_d = self.ldm.draw_t_noise(z_like, self.generator)
                t = t_d if t is None else t
                noise = n_d if noise is None else noise
            loss = run(images, cond_input, t, noise)
            self.steps_done += 1
            if self.schedule is not None:
                set_lr(self.optimizer, self.schedule(self.steps_done))
            return loss
        return step

    def written_in_place(self) -> list:
        """What a step writes in place: the trained parameters, their
        gradients, AdamW's state, the EMA copies and count."""
        out = written_in_place(self.optimizer)
        if self.ema is not None:
            out += list(self.ema.params.values()) + [self.ema.num_updates]
        return out

    # -- resume ---------------------------------------------------------
    def state_dict(self) -> Dict:
        ldm = self.ldm
        return {
            "unet": ldm.unet.state_dict(),
            "cond_stage": (ldm.cond_stage.state_dict()
                           if self.cond_trainable else None),
            "optimizer": self.optimizer.state_dict(),
            "ema": (None if self.ema is None else
                    {k: v.detach().clone() for k, v in self.ema.params.items()}),
            "ema_num_updates": (None if self.ema is None
                                else int(self.ema.num_updates)),
            "steps_done": self.steps_done,
            "generator": (None if self.generator is None
                          else self.generator.get_state()),
            "scale_factor": ldm.scale_factor}

    def load_state_dict(self, state: Dict) -> None:
        """Everything in place (the tensors a captured step reads keep
        their storage): call before the first step."""
        ldm = self.ldm
        ldm.unet.load_state_dict(state["unet"])
        if state["cond_stage"] is not None:
            ldm.cond_stage.load_state_dict(state["cond_stage"])
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            if self.ema is not None and state["ema"] is not None:
                for k, v in state["ema"].items():
                    self.ema.params[k].copy_(v)
                self.ema.num_updates.fill_(state["ema_num_updates"])
        self.steps_done = int(state["steps_done"])
        if self.generator is not None and state["generator"] is not None:
            self.generator.set_state(state["generator"])
        ldm.scale_factor = float(state["scale_factor"])


def make_legacy_trainer(ldm: legacy.LegacyLDM, cfg: Dict, batch_size: int,
                        ema: Optional[EmaState] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> LegacyTrainer:
    """The reference's ``LatentDiffusion.configure_optimizers``: AdamW over
    the UNet (and the cond stage where it trains), lr = batch size x
    ``base_learning_rate`` (``main.py``'s ``scale_lr`` on one device), the
    config's lambda scheduler; ``ema`` (from :func:`make_ema`) is updated
    after every step."""
    return LegacyTrainer(ldm, cfg, batch_size, ema, generator)


def make_ema(unet: torch.nn.Module) -> EmaState:
    """``LitEma`` over the UNet's parameters (decay 0.9999 with the
    early-step ramp), its count on the parameters' device."""
    params = dict(unet.named_parameters())
    ema = ema_init(params)
    dev = next(iter(params.values())).device
    return ema._replace(num_updates=ema.num_updates.to(dev))


def build_model(cfg: Dict, seed: int, device: torch.device
                ) -> legacy.LegacyLDM:
    """The config's model on ``device``: bf16 compute over float32 storage
    (the trained parameters' masters), random weights from ``seed``."""
    ldm = legacy.build_legacy_ldm(cfg, dtype=torch.bfloat16, device=device)
    init_weights(ldm, torch.Generator(device=device).manual_seed(seed))
    return ldm


def fake_dataset(ldm: legacy.LegacyLDM, n: int):
    """The JAX CLI's ``--fake-data`` set: n random images in [-1, 1], class
    labels, captions and the concat configs' conditioning images, drawn
    from the same numpy seeds."""
    img_res = ldm.first_stage.cfg.resolution
    data = np.random.default_rng(0).uniform(
        -1, 1, (n, img_res, img_res, 3)).astype(np.float32)
    n_classes = ldm.cond_stage.n_classes if ldm.cond_kind == "class" else 0
    labels = np.random.default_rng(1).integers(0, max(n_classes, 1), (n,))
    caps = [f"a photo number {i}" for i in range(n)]
    conds = None
    if ldm.cond_mode == "concat":
        if ldm.cond_kind == "first_stage":
            conds = data                           # masked-image stand-in
        elif ldm.cond_kind == "rescaler":
            n_up = 2 ** ldm.cond_stage.n_stages
            shape = (n, ldm.image_size * n_up, ldm.image_size * n_up,
                     ldm.cond_stage_params.get("in_channels", 3))
            conds = np.random.default_rng(2).uniform(
                -1, 1, shape).astype(np.float32)
        else:                                      # identity (LR image)
            c_ch = ldm.unet.cfg.in_channels - ldm.channels
            conds = np.random.default_rng(2).uniform(
                -1, 1, (n, ldm.image_size, ldm.image_size,
                        c_ch)).astype(np.float32)
    return data, labels, caps, conds


def cond_batch(ldm: legacy.LegacyLDM, lab, caps, cond_img):
    """The host side of a batch's conditioning (None when unconditional):
    the concat image, class labels or token ids, on the model's device."""
    if ldm.cond_mode == "concat":
        return torch.as_tensor(cond_img, device=ldm.device)
    if ldm.cond_kind == "uncond":
        return None
    return ldm.conditioning_input(lab if ldm.cond_kind == "class" else caps)


def export_reference_checkpoint(ldm: legacy.LegacyLDM, path: str,
                                unet_state: Optional[Dict] = None) -> int:
    """A CompVis ``.ckpt``: ``model.diffusion_model.*`` (``unet_state``, or
    the UNet's own), ``first_stage_model.*`` and the cond stage's keys.
    -> the number of keys written."""
    from celebbasis_tpu_torch.utils import bridge
    sd = bridge.export_unet(unet_state or ldm.unet.state_dict(),
                            ldm.unet.cfg)
    fs_export = bridge.export_vq if ldm.first_stage_kind == "vq" \
        else bridge.export_vae
    sd.update(fs_export(ldm.first_stage.state_dict(), ldm.first_stage.cfg))
    if ldm.cond_kind == "bert":
        sd.update(bridge.export_bert_text(ldm.cond_stage.state_dict(),
                                          ldm.cond_stage.cfg.depth))
    elif ldm.cond_kind == "class":
        sd["cond_stage_model.embedding.weight"] = \
            ldm.cond_stage.weight.detach().float().cpu().clone()
    elif ldm.cond_kind == "rescaler" \
            and hasattr(ldm.cond_stage, "channel_mapper"):
        for k, v in ldm.cond_stage.channel_mapper.state_dict().items():
            sd[f"cond_stage_model.channel_mapper.{k}"] = v.float().cpu()
    torch.save({"state_dict": sd}, path)
    return len(sd)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--fake-data", type=int, default=0)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--logdir", default="./logs_legacy")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the whole training state every N steps")
    ap.add_argument("-r", "--resume", action="store_true",
                    help="resume from the latest saved state in logdir")
    ap.add_argument("--export-torch", default=None,
                    help="after training, write a reference-loadable .ckpt "
                         "(model.diffusion_model + first_stage_model + "
                         "cond_stage_model state_dict)")
    ap.add_argument("--image-every", type=int, default=0,
                    help="save a DDIM sample grid every N steps (the "
                         "reference ImageLogger)")
    ap.add_argument("--image-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", type=str, default=None,
                    help="default: cuda (fails without a card); 'cpu' runs "
                         "on the CPU on purpose")
    return ap


def main(argv=None) -> Dict:
    """-> ``{"ldm", "trainer", "losses" ({step: loss} at the logged
    steps), "wall_s"}``."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    ldm = build_model(cfg, args.seed, dev)
    bs = args.batch_size or get(cfg, "data.params.batch_size", 4)
    use_ema = get(cfg, "model.params.use_ema", True) and not args.no_ema
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ema = make_ema(ldm.unet) if use_ema else None
    trainer = make_legacy_trainer(ldm, cfg, bs, ema=ema, generator=gen)
    print(f"[train_legacy] {ldm.first_stage_kind}/{ldm.cond_kind} "
          f"latent {ldm.image_size}^2x{ldm.channels}, batch {bs}, "
          f"cond_trainable={trainer.cond_trainable}, ema={use_ema}, "
          f"device {dev}")

    if args.fake_data:
        data, labels, caps, conds = fake_dataset(ldm, args.fake_data)

        def batch(i):
            idx = [(i * bs + j) % args.fake_data for j in range(bs)]
            return (data[idx], labels[idx], [caps[k] for k in idx],
                    conds[idx] if conds is not None else None)
    else:
        ds = instantiate_from_config(get(cfg, "data.params.train"))

        def batch(i):
            idx = [(i * bs + j) % len(ds) for j in range(bs)]
            ex = [ds[k] for k in idx]
            imgs = np.stack([e["image"] for e in ex])
            lab = np.asarray([e.get("class_label", 0) for e in ex])
            caps_ = [e.get("caption", "") for e in ex]
            cond = np.stack([e[ldm.cond_stage_key] for e in ex]) \
                if ldm.cond_mode == "concat" else None
            return imgs, lab, caps_, cond

    if ldm.scale_by_std:         # on the first batch, before any capture
        ldm.calibrate_scale(torch.from_numpy(batch(0)[0]).to(dev))
        print(f"[train_legacy] scale_by_std -> {ldm.scale_factor:.4f}")

    os.makedirs(args.logdir, exist_ok=True)
    resume, start = None, 0
    if args.ckpt_every or args.resume:
        resume = Resume(args.logdir, every=max(args.ckpt_every, 1))
        latest = resume.latest_step() if args.resume else None
        if latest is not None:
            trainer.load_state_dict(resume.restore(latest, dev))
            start = latest
            print(f"[train_legacy] resumed from step {latest}")

    sample_fn = None

    def log_images(step, cond_sample):
        nonlocal sample_fn
        from PIL import Image
        from celebbasis_tpu_torch.diffusion.sampler import sample_seed
        from celebbasis_tpu_torch.pipeline import finish_images
        if sample_fn is None:
            sample_fn = ldm.make_sample_fn(num_steps=args.image_steps)
        n = min(4, bs)
        gens = [torch.Generator(device=dev).manual_seed(
            sample_seed(1000 + step, i)) for i in range(n)]
        imgs = sample_fn(cond_sample[:n] if cond_sample is not None
                         else None, n, gens)
        grid = torch.cat(list(imgs), dim=1)
        pixels = finish_images(grid[None], "uint8")[0].cpu().numpy()
        path = os.path.join(args.logdir, "images", f"step_{step:06}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(pixels).save(path)

    losses: Dict[int, float] = {}
    metrics = open(os.path.join(args.logdir, "metrics.jsonl"), "a")
    t0 = time.time()
    for i in range(start, args.max_steps):
        imgs, lab, caps_, cond_img = batch(i)
        loss = trainer.step(torch.from_numpy(imgs).to(dev),
                            cond_batch(ldm, lab, caps_, cond_img))
        if i % args.log_every == 0 or i == args.max_steps - 1:
            losses[i] = float(loss)
            row = {"step": i, "loss": losses[i],
                   "time": round(time.time() - t0, 2)}
            print(f"[train_legacy] {json.dumps(row)}")
            metrics.write(json.dumps(row) + "\n")
            metrics.flush()
        if resume is not None and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            resume.maybe_save(i + 1, trainer.state_dict())
        if args.image_every and (i + 1) % args.image_every == 0:
            if ldm.cond_mode == "concat":
                cs = cond_img
            elif ldm.cond_kind == "uncond":
                cs = None
            else:
                cs = lab if ldm.cond_kind == "class" else caps_
            log_images(i + 1, cs)
    metrics.close()
    if args.export_torch:
        n = export_reference_checkpoint(
            ldm, args.export_torch,
            unet_state=ema.params if use_ema else None)
        print(f"[train_legacy] exported torch state_dict ({n} keys"
              f"{', EMA unet' if use_ema else ''}) -> {args.export_torch}")
    wall = time.time() - t0
    print(f"[train_legacy] done in {wall:.1f}s")
    return {"ldm": ldm, "trainer": trainer, "losses": losses, "wall_s": wall}


if __name__ == "__main__":
    main()
