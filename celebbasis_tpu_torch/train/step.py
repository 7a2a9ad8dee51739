"""Personalisation training step: coefficient-only backprop.

Counterpart of ``celebbasis_tpu/train/step.py``.  One step: VAE-encode the
image (no grad), draw t and noise, run the CLIP encoder with the embedding
manager injecting MetaIdNet's predicted identity embeddings, predict eps with
the frozen UNet, and take an AdamW step on **only** the StyleVectorizer MLP
(about 0.5 M parameters; everything else is frozen).

Where the JAX package splits parameter trees into ``frozen`` and
``trainable`` and differentiates with respect to the latter, the modules here
own their weights and *which parameters train* is which have
``requires_grad``: ``build_trainable`` sets that and returns the groups the
optimizer takes.  Gradients reach the MLP **through** the frozen UNet and
CLIP, whose parameters get no ``.grad``.

The step updates in place what JAX returns anew: module parameters (by the
optimizer), and the fields of ``TrainState``.  The momentum dictionaries stay
functional (``ManagerState`` is replaced, not written into).

Randomness comes from the ``torch.Generator`` carried in the state, drawn in
a fixed order (posterior noise, t, eps) before the step runs
(``draw_step_noise``).  A batch may carry deterministic draws instead --
``override_znoise``, ``override_t`` (B,) and ``override_noise`` -- so that
tests can feed this step and the JAX one the same numbers (the two
frameworks' streams differ).

The train and eval steps behave like the JAX ``jax.jit(step_fn)``: the loss,
the backward and the optimizer step run as one CUDA graph, captured by the
first call with a given shape signature and replayed by later ones
(``utils.graphs``); on CPU tensors the same Python runs eagerly.  Each
returned step has the uncaptured step as its ``eager`` attribute, for
comparisons, and its ``utils.graphs.Captured`` as ``captured``.  So that a
graph can be replayed, every tensor the step writes is allocated before the
first step and written only in place: on a card the optimizer is AdamW with
``capturable=True`` whose state and gradients ``make_optimizer`` allocates
up front (for the eager step and the graph alike, so the two compare bit for
bit), gradients are zeroed and never set to None, and the accumulation
buffers and their count live on the device.

Batches are channels-last like the JAX package's: image (B, H, W, 3) in
[-1, 1]; tokens (B, 77) int64; faces (B, k, Hf, Wf, 3); ids (B, k) int64;
num_ids (B,) int64.

Data parallel (``mesh``, a ``parallel.mesh`` mesh): each process takes its
block of the global batch's rows, and the step computes what the JAX
program computes once over the whole batch.  The draws are made for the
global batch from the shared generator and each rank keeps its rows; the
momentum update runs over every rank's (row, face) entries in global order;
the ``id_neg_loss`` term sees every rank's predictions (its gradient flows
back to each rank's rows); the trained gradients are averaged over ``data``
with one all-reduce; the logs are the means over ``data``.  The collectives
are NCCL's under a CUDA graph, or gloo's (``trainer.Trainer`` then runs the
uncaptured steps).  On a (data, model) mesh whose frozen weights
``parallel.mesh.shard_params`` split by the tensor-parallel rules
(``use_tp``, ``conv_tp``), the model ranks of a data rank take the same rows
and draws, the gradient passes back through the tensor-parallel layers
(their autograd collectives), and the MLP's gradient, which each of them
holds whole, is averaged over ``data`` alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from celebbasis_tpu_torch.core import manager as mgr
from celebbasis_tpu_torch.core.meta_net import MetaIdNet
from celebbasis_tpu_torch.diffusion import ddpm
from celebbasis_tpu_torch.parallel import mesh as pmesh
from celebbasis_tpu_torch.utils import graphs


@dataclass
class TrainState:
    step: int                          # micro-batches seen
    trainable: Dict[str, List[nn.Parameter]]
    optimizer: "torch.optim.Optimizer | AccumulatingOptimizer"
    manager_state: mgr.ManagerState
    generator: torch.Generator


def make_gnet(pipeline) -> nn.Module:
    """The contra head's trainable g-net, sized for the flattened per-face
    metas; on the pipeline's device."""
    from celebbasis_tpu_torch.core.losses import ContrastiveGNet
    width = pipeline.cfg.clip.width
    return ContrastiveGNet(pipeline.manager_cfg.reps * width,
                           meta_dim=width).to(pipeline.device)


def init_gnet_params(pipeline, generator: torch.Generator) -> nn.Module:
    """A g-net with LeCun-normal kernel and zero bias drawn from
    ``generator`` (flax's Dense initialisers)."""
    gnet = make_gnet(pipeline)
    w = gnet.Dense_0.weight
    with torch.no_grad():
        draw = torch.randn(w.shape, generator=generator,
                           device=generator.device) * w.shape[1] ** -0.5
        w.copy_(draw.to(w.device))
        gnet.Dense_0.bias.zero_()
    return gnet


def build_trainable(meta_net: MetaIdNet, unet: Optional[nn.Module] = None,
                    gnet: Optional[nn.Module] = None
                    ) -> Dict[str, List[nn.Parameter]]:
    """The parameter groups that train: ``{"meta": [...]}`` plus ``"unet"``
    and ``"gnet"`` when those modules are given.  Sets ``requires_grad`` on
    exactly these (and clears it on the rest of the MetaIdNet)."""
    meta_net.requires_grad_(False)
    out = {"meta": meta_net.trainable_parameters()}
    if unet is not None:
        out["unet"] = list(unet.parameters())
    if gnet is not None:
        out["gnet"] = list(gnet.parameters())
    for group in out.values():
        for p in group:
            p.requires_grad_(True)
    return out


class AccumulatingOptimizer:
    """Gradient accumulation with ``optax.MultiSteps`` semantics: the
    gradients of ``every`` micro-batches are averaged (as a running mean) and
    one update of the inner optimizer is applied on the boundary.

    ``accumulate`` and ``apply`` touch only device tensors (the running
    mean's count included), so a captured step holds one of two graphs: an
    accumulating step, and a boundary step that accumulates and applies.
    ``mini_step``, the host's count, picks between them."""

    def __init__(self, inner: torch.optim.Optimizer, every: int):
        self.inner, self.every = inner, every
        self.mini_step = 0
        self._params = [p for g in inner.param_groups for p in g["params"]]
        self._acc = [torch.zeros_like(p) for p in self._params]
        self._seen = torch.zeros((), device=self._params[0].device)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @property
    def boundary_next(self) -> bool:
        """Whether the next micro-batch ends an accumulation."""
        return self.mini_step + 1 >= self.every

    @torch.no_grad()
    def accumulate(self) -> None:
        self._seen += 1
        for acc, p in zip(self._acc, self._params):
            if p.grad is not None:
                acc += (p.grad - acc) / self._seen
            else:
                acc -= acc / self._seen

    @torch.no_grad()
    def apply(self) -> None:
        for acc, p in zip(self._acc, self._params):
            if p.grad is None:
                p.grad = acc.clone()
            else:
                p.grad.copy_(acc)
            acc.zero_()
        self._seen.zero_()
        self.inner.step()

    def advance(self, boundary: bool) -> None:
        self.mini_step = 0 if boundary else self.mini_step + 1

    def step(self) -> None:
        boundary = self.boundary_next
        self.accumulate()
        if boundary:
            self.apply()
        self.advance(boundary)

    def tensors(self) -> List[torch.Tensor]:
        """What a step writes in place, besides the inner optimizer's."""
        return self._acc + [self._seen]


def allocate_state(optimizer: torch.optim.Optimizer) -> None:
    """Allocate each parameter's gradient (zeros) and AdamW's state now, as
    its first step would (step 0, zero moments), so that neither is created
    inside a captured step."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32,
                                            device=p.device)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def written_in_place(optimizer) -> List[torch.Tensor]:
    """Every tensor a train step writes in place: the trained parameters,
    their gradients, the optimizer's state and the accumulation buffers (a
    graph's warm-up puts them back)."""
    inner = getattr(optimizer, "inner", optimizer)
    out = []
    for group in inner.param_groups:
        for p in group["params"]:
            out.append(p)
            if p.grad is not None:
                out.append(p.grad)
            out += [v for v in inner.state[p].values()
                    if isinstance(v, torch.Tensor)]
    if isinstance(optimizer, AccumulatingOptimizer):
        out += optimizer.tensors()
    return out


def make_optimizer(trainable: Dict[str, List[nn.Parameter]],
                   lr: float = 1e-2, model_lr: Optional[float] = None,
                   accumulate: int = 1, weight_decay: float = 1e-2):
    """AdamW, reference LR recipe: base 5e-3 scaled by batch (= 1e-2 at batch
    2).

    ``weight_decay`` is torch's AdamW default 1e-2: the reference constructs
    ``torch.optim.AdamW(embedding_params, lr=lr)`` with no explicit decay, and
    the JAX package sets the same value on optax (whose own default differs).

    With ``model_lr`` set, the ``"unet"`` group runs at its own rate (the
    reference's ``unfreeze_model`` / ``model_lr`` path); the g-net, if
    present, rides with the MLP at the base rate.  ``accumulate > 1`` wraps
    the optimizer in ``AccumulatingOptimizer``.  Parameters on a card get
    ``capturable=True`` and their gradients and state allocated now
    (``allocate_state``), so that a captured step can update them.
    """
    base = [p for name, group in trainable.items() if name != "unet"
            for p in group]
    groups = [{"params": base, "lr": lr}]
    if model_lr is not None:
        groups.append({"params": trainable["unet"], "lr": model_lr})
    elif "unet" in trainable:
        raise ValueError("an unfrozen UNet needs model_lr")
    on_card = base[0].is_cuda
    opt = torch.optim.AdamW(groups, lr=lr, weight_decay=weight_decay,
                            capturable=on_card)
    if on_card:
        allocate_state(opt)
    return AccumulatingOptimizer(opt, accumulate) if accumulate > 1 else opt


def _check_loss_type(loss_type: str) -> None:
    if loss_type not in mgr.VALID_LOSS_TYPES:   # never a silent no-op
        raise ValueError(f"unknown loss_type {loss_type!r}; "
                         f"expected one of {mgr.VALID_LOSS_TYPES}")


def _randn(shape, generator, device):
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def draw_step_noise(batch, generator, latent_shape, timesteps: int,
                    device, mesh=None) -> dict:
    """The step's draws, taken from ``generator`` before the step runs and
    in the order the step used them (posterior noise, t, eps), as the
    batch's ``override_znoise`` / ``override_t`` / ``override_noise``; a
    draw the batch already carries is kept and not drawn.  Over a ``mesh``
    the batch is this rank's block of rows: the draws are made for the
    global batch and this rank keeps its rows of each."""
    out = dict(batch)
    n = pmesh.axis_size(mesh, pmesh.DATA)
    shape = (latent_shape[0] * n,) + tuple(latent_shape[1:])
    mine = lambda a: pmesh.shard_batch(a, mesh) if n > 1 else a
    if "override_znoise" not in out:
        out["override_znoise"] = mine(_randn(shape, generator, device))
    if "override_t" not in out:
        out["override_t"] = mine(torch.randint(
            0, timesteps, (shape[0],), generator=generator,
            device=generator.device).to(device))
    if "override_noise" not in out:
        out["override_noise"] = mine(_randn(shape, generator, device))
    return out


def latent_shape(pipeline, batch) -> tuple:
    """The VAE posterior's shape for a batch: (B, h, w, embed_dim)."""
    if "latent_mean" in batch:
        return tuple(batch["latent_mean"].shape)
    B, H, W = batch["image"].shape[:3]
    f = pipeline.latent_factor
    return (B, H // f, W // f, pipeline.cfg.vae.embed_dim)


def noisy_latents(pipeline, sched, batch, generator, mean, logvar):
    """Sample the VAE posterior (mean, logvar), draw t and eps and noise the
    latents: -> (z_t, t, eps).  The draws come from ``generator`` in this
    order (posterior noise, t, eps) unless the batch carries
    ``override_znoise`` / ``override_t`` / ``override_noise``."""
    dev = mean.device
    zn = batch.get("override_znoise")
    if zn is None:
        zn = _randn(mean.shape, generator, dev)
    z0 = ((mean + torch.exp(0.5 * logvar) * zn)
          * pipeline.cfg.scale_factor).detach()
    t = batch.get("override_t")
    if t is None:
        t = torch.randint(0, pipeline.cfg.timesteps, (z0.shape[0],),
                          generator=generator,
                          device=generator.device).to(dev)
    noise = batch.get("override_noise")
    if noise is None:
        noise = _randn(z0.shape, generator, dev)
    return ddpm.q_sample(sched, z0, t, noise), t, noise


def _data_group(mesh):
    return None if mesh is None else mesh.get_group(pmesh.DATA)


def _loss_from_posterior(pipeline, sched, loss_type, gnet, manager_state,
                         batch, generator, mean, logvar, pred_z, pred_coeff,
                         group=None):
    """Steps 1b-5 shared by the cached and uncached losses: sample the
    posterior, draw t and eps, inject, encode, predict, take the loss.
    With a data ``group`` the momentum update and ``id_neg_loss`` take the
    rows of every rank (module docstring)."""
    z_t, t, noise = noisy_latents(pipeline, sched, batch, generator, mean,
                                  logvar)
    with torch.no_grad():
        embeds = pipeline.clip.token_embed(batch["tokens"])
    rows = None
    if group is not None:
        rows = tuple(pmesh.gather_rows(a, group) for a in (
            pred_z, pred_coeff, batch["ids"], batch["num_ids"]))
    new_embeds, new_mstate = mgr.train_inject(
        pipeline.manager_cfg, manager_state, batch["tokens"], embeds, pred_z,
        pred_coeff, batch["ids"], batch["num_ids"], update_rows=rows)
    context = pipeline.clip.encode(new_embeds)
    eps_pred = pipeline.unet(z_t, t, context)
    loss, logs = ddpm.eps_mse_loss(eps_pred, noise)
    metas, cefs = pred_z, pred_coeff
    if group is not None and loss_type != "none":
        metas = pmesh.gather_rows(pred_z, group, grad=True)
        cefs = pmesh.gather_rows(pred_coeff, group, grad=True)
    neg, neg_logs = mgr.id_neg_loss(loss_type, metas, cefs, gnet)
    logs.update(neg_logs)
    return loss + neg, (new_mstate, logs)


def _mean_logs(logs: dict, group) -> dict:
    """The logged scalars averaged over the data group (one all-reduce)."""
    if group is None:
        return logs
    flat = torch.stack([v.detach().float().reshape(()) for v in
                        logs.values()])
    pmesh.all_reduce_mean_([flat], group)
    return dict(zip(logs, flat.unbind(0)))


def make_loss_fn(pipeline, meta_net: MetaIdNet, loss_type: str = "none",
                 train_unet: bool = False, gnet: Optional[nn.Module] = None,
                 mesh=None):
    """The full personalisation loss,
    ``loss_fn(manager_state, basis, batch, generator) ->
    (loss, (new_manager_state, logs))``, shared by the train step (backward)
    and the eval step (value only).

    ``train_unet`` is kept for the JAX package's signature; whether the UNet
    gets gradients is decided by its parameters' ``requires_grad`` (see
    ``build_trainable``), and this function checks that the two agree.
    ``gnet`` is required by ``loss_type='contra'``.  ``mesh``: the batch is
    this rank's rows of a data-parallel batch (module docstring).
    """
    _check_loss_type(loss_type)
    if loss_type == "contra" and gnet is None:
        raise ValueError("loss_type='contra' needs the trainable g-net")
    sched = ddpm.ScheduleArrays.from_schedule(pipeline.schedule,
                                              pipeline.device)
    group = _data_group(mesh)

    def loss_fn(manager_state, basis, batch, generator):
        if any(p.requires_grad for p in pipeline.unet.parameters()) \
                != train_unet:
            raise ValueError("train_unet disagrees with the UNet "
                             "parameters' requires_grad")
        # 1. frozen VAE encode
        with torch.no_grad():
            mean, logvar = pipeline.vae.encode(batch["image"])
        # 3a. identity prediction (frozen face net, trainable MLP)
        pred_z, pred_coeff = meta_net.multi_faces(batch["faces"],
                                                  batch["ids"], basis)
        return _loss_from_posterior(pipeline, sched, loss_type, gnet,
                                    manager_state, batch, generator, mean,
                                    logvar, pred_z, pred_coeff, group)

    return loss_fn


def make_cached_loss_fn(pipeline, meta_net: MetaIdNet,
                        loss_type: str = "none",
                        gnet: Optional[nn.Module] = None, mesh=None):
    """Loss over precomputed frozen features (fast-personalisation mode).

    The VAE posterior (mean, logvar) and the frozen face features are
    deterministic functions of the augmented inputs, so they are computed
    once per augmented sample and reused; a step is then UNet + CLIP + MLP.
    The posterior is still *sampled* afresh each step.

    batch: latent_mean / latent_logvar (B, h, w, 4); fr_feats (B, k, fr_dim);
    tokens (B, 77); ids (B, k); num_ids (B,).
    """
    _check_loss_type(loss_type)
    if loss_type == "contra" and gnet is None:
        raise ValueError("loss_type='contra' needs the trainable g-net")
    sched = ddpm.ScheduleArrays.from_schedule(pipeline.schedule,
                                              pipeline.device)
    group = _data_group(mesh)

    def loss_fn(manager_state, basis, batch, generator):
        feats = batch["fr_feats"]
        B, k = feats.shape[:2]
        z, coeff = meta_net.z_from_features(
            feats.reshape(-1, feats.shape[-1]), basis)
        pred_z = z.reshape(B, k, *z.shape[1:])
        pred_coeff = coeff.reshape(B, k, *coeff.shape[1:])
        return _loss_from_posterior(
            pipeline, sched, loss_type, gnet, manager_state, batch,
            generator, batch["latent_mean"], batch["latent_logvar"], pred_z,
            pred_coeff, group)

    return loss_fn


def _step_from_loss(pipeline, loss_fn, optimizer, mesh=None):
    """``step_fn(state, basis, batch) -> (state, logs)``: the draws from
    ``state.generator``, then the loss, the backward and the optimizer step
    captured as one graph per signature (one for an accumulating and one
    for a boundary step with ``AccumulatingOptimizer``).  Over a ``mesh``
    the gradients are averaged over ``data`` before the optimizer takes
    them."""
    accumulating = isinstance(optimizer, AccumulatingOptimizer)
    group = _data_group(mesh)
    inner = getattr(optimizer, "inner", optimizer)
    params = [p for g in inner.param_groups for p in g["params"]]

    def body(manager_state, basis, batch, boundary):
        loss, (new_mstate, logs) = loss_fn(manager_state, basis, batch, None)
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        if group is not None:
            pmesh.all_reduce_mean_([p.grad for p in params], group)
        if accumulating:
            optimizer.accumulate()
            if boundary:
                optimizer.apply()
        else:
            optimizer.step()
        return new_mstate, _mean_logs(
            {k: v.detach() for k, v in logs.items()}, group)

    def make(run):
        def step_fn(state: TrainState, basis, batch):
            batch = draw_step_noise(batch, state.generator,
                                    latent_shape(pipeline, batch),
                                    pipeline.cfg.timesteps, pipeline.device,
                                    mesh)
            boundary = optimizer.boundary_next if accumulating else True
            new_mstate, logs = run(state.manager_state, basis, batch,
                                   boundary)
            if accumulating:
                optimizer.advance(boundary)
            state.step += 1
            state.manager_state = new_mstate
            return state, logs
        return step_fn

    return graphs.entry(make, body,
                        restore=lambda: written_in_place(optimizer))


def make_train_step(pipeline, meta_net: MetaIdNet, optimizer,
                    loss_type: str = "none", train_unet: bool = False,
                    gnet: Optional[nn.Module] = None, mesh=None):
    """Returns ``step_fn(state, basis, batch) -> (state, logs)``; the state
    and the trainable parameters are updated in place.  ``mesh``: data
    parallel over its ``data`` axis (module docstring)."""
    return _step_from_loss(
        pipeline, make_loss_fn(pipeline, meta_net, loss_type, train_unet,
                               gnet, mesh), optimizer, mesh)


def make_cached_train_step(pipeline, meta_net: MetaIdNet, optimizer,
                           loss_type: str = "none",
                           gnet: Optional[nn.Module] = None, mesh=None):
    """Fast-personalisation step over precomputed frozen features (see
    ``make_cached_loss_fn``)."""
    return _step_from_loss(
        pipeline, make_cached_loss_fn(pipeline, meta_net, loss_type, gnet,
                                      mesh), optimizer, mesh)


def make_eval_step(pipeline, meta_net: MetaIdNet, loss_type: str = "none",
                   train_unet: bool = False, cached: bool = False,
                   gnet: Optional[nn.Module] = None, mesh=None):
    """Loss-only step for validation: no gradients, no optimizer, and the
    momentum dictionaries are NOT advanced.

    Returns ``eval_fn(state, basis, batch, generator) -> logs``, captured
    like the train step; over a ``mesh`` the logs are the global means.
    """
    if cached:
        loss_fn = make_cached_loss_fn(pipeline, meta_net, loss_type, gnet,
                                      mesh)
    else:
        loss_fn = make_loss_fn(pipeline, meta_net, loss_type, train_unet,
                               gnet, mesh)
    group = _data_group(mesh)

    def body(manager_state, basis, batch):
        loss, (_, logs) = loss_fn(manager_state, basis, batch, None)
        logs["loss"] = loss
        return _mean_logs(logs, group)

    def make(run):
        @torch.no_grad()
        def eval_fn(state: TrainState, basis, batch, generator):
            batch = draw_step_noise(batch, generator,
                                    latent_shape(pipeline, batch),
                                    pipeline.cfg.timesteps, pipeline.device,
                                    mesh)
            return run(state.manager_state, basis, batch)
        return eval_fn

    return graphs.entry(make, body)


def init_train_state(generator: torch.Generator, trainable, optimizer,
                     manager_state: mgr.ManagerState) -> TrainState:
    return TrainState(0, trainable, optimizer, manager_state, generator)


@torch.no_grad()
def precompute_cache(pipeline, meta_net: MetaIdNet, loader, n_batches: int):
    """Run the frozen VAE and face net over ``n_batches`` augmented batches
    and return a list of cached-step batches on the pipeline's device."""
    dev = pipeline.device
    cached = []
    for bi, batch in enumerate(loader):
        if bi >= n_batches:
            break
        to_dev = lambda key: torch.as_tensor(batch[key]).to(dev)
        mean, logvar = pipeline.vae.encode(to_dev("image"))
        faces = to_dev("faces")
        B, k = faces.shape[:2]
        v = meta_net.face_features(faces.reshape((B * k,) + faces.shape[2:]))
        cached.append({
            "latent_mean": mean, "latent_logvar": logvar,
            "fr_feats": v.reshape(B, k, -1), "tokens": to_dev("tokens"),
            "ids": to_dev("ids"), "num_ids": to_dev("num_ids"),
        })
    return cached
