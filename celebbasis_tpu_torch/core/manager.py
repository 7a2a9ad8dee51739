"""Identity embedding manager: functional state on tensors.

Counterpart of ``celebbasis_tpu/core/manager.py``.  The momentum dictionaries
of the reference's EmbeddingManagerId are a pair of stacked tensors
(``ManagerState``), carried through the training step:

* the training forward injects the batch's *predicted* embeddings (gradients
  flow into the StyleVectorizer only) and returns the *updated* dictionaries;
  the momentum update runs over the batch's (row, face) entries in order, so
  that duplicate ids within a batch compound as in the reference's row loop;
* at test time the injected vectors come from the saved coefficients
  reconstructed against the basis (mode ``coefficient``), the saved raw
  embeddings (mode ``embedding``), or caller-supplied live predictions (mode
  ``image``);
* checkpoints are written and read in the reference's ``.pt`` schema
  ``{"id_coefficients": [max_ids x (es, h, inner)]}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import torch

from celebbasis_tpu_torch.core.injection import inject_batch
from celebbasis_tpu_torch.utils.pt_io import load_pt, save_pt


@dataclass(frozen=True)
class ManagerConfig:
    placeholder_token_ids: Tuple[int, ...]   # token ids of 'sks','ks',...
    max_ids: int = 10
    num_es: int = 2
    heads: int = 1
    inner_dim: int = 512
    token_dim: int = 768
    momentum: float = 0.99
    test_mode: str = "coefficient"           # coefficient | embedding | image
    loss_type: str = "none"
    save_fp16: bool = False

    @property
    def reps(self) -> int:
        return self.num_es * self.heads


class ManagerState(NamedTuple):
    id_embeddings: torch.Tensor      # (max_ids, es*h, token_dim)
    id_coefficients: torch.Tensor    # (max_ids, es, h, inner_dim)

    def to(self, device) -> "ManagerState":
        return ManagerState(self.id_embeddings.to(device),
                            self.id_coefficients.to(device))


def init_state(cfg: ManagerConfig, generator: torch.Generator,
               init_embedding: torch.Tensor | None = None,
               device: torch.device | str = "cpu") -> ManagerState:
    """init_embedding: the initializer word's token embedding (token_dim,),
    repeated over ids and slots as the reference repeats 'face'.  Random
    draws come from ``generator`` (on its own device) and are moved to
    ``device``."""
    gdev = generator.device
    if init_embedding is None:
        emb = torch.rand((cfg.max_ids, cfg.reps, cfg.token_dim),
                         generator=generator, device=gdev)
    else:
        emb = init_embedding.float().to(gdev).expand(
            cfg.max_ids, cfg.reps, cfg.token_dim).clone()
    coeff = torch.randn((cfg.max_ids, cfg.num_es, cfg.heads, cfg.inner_dim),
                        generator=generator, device=gdev)
    return ManagerState(emb.float().to(device), coeff.float().to(device))


def momentum_update(cfg: ManagerConfig, state: ManagerState,
                    pred_z: torch.Tensor, pred_coeff: torch.Tensor,
                    ids: torch.Tensor, valid: torch.Tensor) -> ManagerState:
    """Sequential momentum update over flattened (row, face) entries.

    pred_z: (K, es*h, D), pred_coeff: (K, es, h, inner), ids: (K,),
    valid: (K,) bool -- entries beyond a row's num_ids are masked out.
    Returns new tensors; the given state is not modified, and no graph is
    kept.

    The entries are taken in order on the device, as the JAX ``lax.scan``
    takes them: entry j reads its id's current rows, which an earlier entry
    with the same id has already moved, and writes them back unless it is
    masked.  Nothing waits for the host, so the update can be captured in a
    CUDA graph.
    """
    m = cfg.momentum
    with torch.no_grad():
        emb = state.id_embeddings.clone()
        coeff = state.id_coefficients.clone()
        zs = pred_z.detach().to(emb.dtype)
        cs = pred_coeff.detach().to(coeff.dtype)
        ids = ids.long()
        for j in range(ids.shape[0]):
            idx, ok = ids[j:j + 1], valid[j]
            for table, pred in ((emb, zs), (coeff, cs)):
                cur = table.index_select(0, idx)
                upd = m * cur + (1 - m) * pred[j:j + 1]
                table.index_copy_(0, idx, torch.where(ok, upd, cur))
    return ManagerState(emb, coeff)


_PLACEHOLDER_IDS: dict = {}


def _placeholder_ids(cfg: ManagerConfig, device) -> torch.Tensor:
    """The placeholder token ids on `device`, made once per device: a copy
    from the host inside a captured CUDA graph is refused."""
    key = (cfg.placeholder_token_ids, str(torch.device(device)))
    ids = _PLACEHOLDER_IDS.get(key)
    if ids is None:
        with torch.inference_mode(False):
            ids = _PLACEHOLDER_IDS[key] = torch.tensor(
                cfg.placeholder_token_ids, dtype=torch.int64, device=device)
    return ids


def train_inject(cfg: ManagerConfig, state: ManagerState,
                 tokens: torch.Tensor, embeds: torch.Tensor,
                 pred_z: torch.Tensor, pred_coeff: torch.Tensor,
                 ids: torch.Tensor, num_ids: torch.Tensor,
                 update_rows=None) -> Tuple[torch.Tensor, ManagerState]:
    """Training-path inject + dictionary update.

    tokens/embeds: (B, L)/(B, L, D); pred_z: (B, k, es*h, D) MetaIdNet output
    per face slot (placeholder p takes slot p's prediction); ids: (B, k);
    num_ids: (B,) in {1..k}.  Returns (new_embeds (B, L, D), new_state).

    ``update_rows`` = (pred_z, pred_coeff, ids, num_ids) of the global batch
    when the batch is split over data-parallel ranks: the momentum update
    then runs over every rank's rows in global order, so that each rank
    holds the state the one-process step would.
    """
    B, k = ids.shape
    id_vectors = pred_z.reshape(B, k * cfg.reps, -1)
    new_embeds = inject_batch(tokens, embeds, id_vectors,
                              _placeholder_ids(cfg, tokens.device), num_ids,
                              cfg.reps)
    if update_rows is not None:
        pred_z, pred_coeff, ids, num_ids = update_rows
        B = ids.shape[0]
    slot_idx = torch.arange(k, device=ids.device)[None, :]
    valid = (slot_idx < num_ids[:, None]).reshape(-1)
    new_state = momentum_update(
        cfg, state, pred_z.reshape(B * k, cfg.reps, -1),
        pred_coeff.reshape(B * k, cfg.num_es, cfg.heads, cfg.inner_dim),
        ids.reshape(-1), valid)
    return new_embeds, new_state


def reconstruct_z(cfg: ManagerConfig, coefficients: torch.Tensor,
                  basis: torch.Tensor) -> torch.Tensor:
    """coeff (..., es, h, inner) x basis (es, 1+inner, D) -> (..., es*h, D)."""
    mean, pca = basis[:, 0], basis[:, 1:]
    z = torch.einsum("...ehk,ekc->...ehc", coefficients, pca)
    z = z + mean[:, None, :]
    return z.reshape(z.shape[:-3] + (cfg.reps, z.shape[-1]))


def test_inject(cfg: ManagerConfig, state: ManagerState | None,
                basis: torch.Tensor, tokens: torch.Tensor,
                embeds: torch.Tensor, ids: torch.Tensor,
                num_ids: torch.Tensor, pred_z: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Inference-path injection.

    ids: (B, k) identity indices appearing in each prompt.
    mode 'coefficient': z = saved_coeff[id] . P + mean;
    mode 'embedding':   z = saved id_embeddings[id];
    mode 'image':       z = pred_z (live predictions, caller-supplied).
    """
    B, k = ids.shape
    if cfg.test_mode == "coefficient":
        z = reconstruct_z(cfg, state.id_coefficients[ids.reshape(-1)], basis)
        z = z.reshape(B, k, cfg.reps, -1)
    elif cfg.test_mode == "embedding":
        z = state.id_embeddings[ids.reshape(-1)].reshape(B, k, cfg.reps, -1)
    elif cfg.test_mode == "image":
        if pred_z is None:
            raise ValueError("test_mode='image' needs live predictions")
        z = pred_z
    else:
        raise ValueError(f"unknown test_mode {cfg.test_mode!r}")
    id_vectors = z.reshape(B, k * cfg.reps, -1)
    return inject_batch(tokens, embeds, id_vectors,
                        _placeholder_ids(cfg, tokens.device), num_ids,
                        cfg.reps)


test_inject.__test__ = False      # a library function, not a pytest case


# -- auxiliary losses ---------------------------------------------------------

def coefficient_reg_loss(loss_type: str, coeff: torch.Tensor) -> torch.Tensor:
    """l1_reg / l2_reg, weight 1e-6, over the **es axis** of
    (N', es, h, inner) coefficients (``torch.norm(cef, dim=1, p=.).mean()``
    semantics)."""
    if coeff.ndim != 4:
        raise ValueError(f"expected (N', es, h, inner), got {coeff.shape}")
    if loss_type == "l1_reg":
        return coeff.abs().sum(dim=1).mean() * 1e-6
    if loss_type == "l2_reg":
        return torch.sqrt((coeff ** 2).sum(dim=1) + 1e-12).mean() * 1e-6
    return coeff.new_zeros(())


def cosine_id_loss(meta1: torch.Tensor, meta2s: Sequence[torch.Tensor],
                   meta3: torch.Tensor) -> torch.Tensor:
    """Same-id attract / different-id repel cosine loss;
    ``torch.cosine_similarity(a, b)`` semantics: reduction over dim 1 (the
    es*h axis of (N, es*h, D) metas), eps 1e-8 per operand norm, then a
    global mean."""
    def cos(a, b):
        num = (a * b).sum(dim=1)
        na = a.norm(dim=1).clamp_min(1e-8)
        nb = b.norm(dim=1).clamp_min(1e-8)
        return num / (na * nb)
    loss = 1 - cos(meta1, meta3)
    for m2 in meta2s:
        loss = loss + cos(meta1, m2)
    return loss.mean()


VALID_LOSS_TYPES = ("none", "l1_reg", "l2_reg", "cosine", "contra")


def id_neg_loss(loss_type: str, metas: torch.Tensor, cefs: torch.Tensor,
                gnet=None):
    """The reference's ``_calc_id_neg_loss`` as a pure function, added into
    the training loss.

    metas: (B, k, es*h, D) per-face-slot meta embeddings; cefs:
    (B, k, es, h, inner) coefficients.  The reference's final sum is
    ``loss_cosine*0 + loss_cls*0 + loss_reg*1 + loss_contra*1``:
    'cosine' is computed and logged but weighted 0 (the reference's own
    weight); 'l1_reg'/'l2_reg' regularise the coefficients (weight 1e-6);
    'contra' adds 1e-2 x InfoNCE through the trainable g-net over the
    flattened (es*h*D) metas.  Returns (loss, logs).
    """
    if loss_type not in VALID_LOSS_TYPES:
        raise ValueError(f"unknown loss_type {loss_type!r}; "
                         f"expected one of {VALID_LOSS_TYPES}")
    B, k = metas.shape[:2]
    logs = {}
    loss = coefficient_reg_loss(loss_type,
                                cefs.reshape((-1,) + cefs.shape[2:]))
    logs["loss_reg"] = loss
    if loss_type == "cosine":
        meta2s = [metas[:, i] for i in range(1, k - 1)]
        logs["loss_cosine"] = cosine_id_loss(metas[:, 0], meta2s,
                                             metas[:, -1])
        loss = loss + 0.0 * logs["loss_cosine"]   # the reference's x0 weight
    if loss_type == "contra":
        from celebbasis_tpu_torch.core.losses import contrastive_loss
        if gnet is None:
            raise ValueError("loss_type='contra' needs the trainable g-net")
        contra = contrastive_loss(gnet, metas.reshape(B, k, -1)) * 1e-2
        logs["loss_contra"] = contra
        loss = loss + contra
    return loss, logs


# -- checkpoint interop -------------------------------------------------------

def save_checkpoint(cfg: ManagerConfig, state: ManagerState, path: str,
                    meta_net=None) -> None:
    """Reference-schema ``.pt``: per-id lists under ``id_coefficients`` or
    ``id_embeddings`` (fp16 with ``save_fp16``), or the MetaIdNet's
    state_dict under ``meta_id_net`` in mode ``image``."""
    cast = torch.float16 if cfg.save_fp16 else torch.float32
    per_id = lambda x: [x[i].detach().to("cpu", cast).clone()
                        for i in range(cfg.max_ids)]
    if cfg.test_mode == "coefficient":
        save_dict = {"id_coefficients": per_id(state.id_coefficients)}
    elif cfg.test_mode == "embedding":
        save_dict = {"id_embeddings": per_id(state.id_embeddings)}
    elif cfg.test_mode == "image":
        if meta_net is None:
            raise ValueError("test_mode='image' saves the MetaIdNet")
        save_dict = {"meta_id_net": {k: v.detach().cpu().clone() for k, v
                                     in meta_net.state_dict().items()}}
    else:
        raise ValueError(f"unknown test_mode {cfg.test_mode!r}")
    save_pt(save_dict, path)


def load_checkpoint(cfg: ManagerConfig, path: str,
                    state: ManagerState | None = None,
                    device: torch.device | str = "cpu") -> ManagerState:
    """Reads a reference- or self-produced ``.pt`` (lists of per-id tensors
    under ``id_coefficients`` and/or ``id_embeddings``)."""
    ckpt = load_pt(path)
    if state is None:
        state = ManagerState(
            torch.zeros((cfg.max_ids, cfg.reps, cfg.token_dim)),
            torch.zeros((cfg.max_ids, cfg.num_es, cfg.heads, cfg.inner_dim)))
    emb, coeff = state
    if ckpt.get("id_coefficients") is not None:
        coeff = torch.stack([torch.as_tensor(c).float()
                             for c in ckpt["id_coefficients"]])
    if ckpt.get("id_embeddings") is not None:
        emb = torch.stack([torch.as_tensor(e).float().reshape(
            cfg.reps, cfg.token_dim) for e in ckpt["id_embeddings"]])
    return ManagerState(emb.to(device), coeff.to(device))
