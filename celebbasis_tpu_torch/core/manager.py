"""Identity embedding manager: functional state on tensors.

Counterpart of the inference side of ``celebbasis_tpu/core/manager.py``.  The
momentum dictionaries of the reference's EmbeddingManagerId are a pair of
stacked tensors (``ManagerState``).  At test time the injected vectors come
from the saved coefficients reconstructed against the basis (mode
``coefficient``), the saved raw embeddings (mode ``embedding``), or
caller-supplied live predictions (mode ``image``).  Checkpoints are read in
the reference's ``.pt`` schema ``{"id_coefficients": [max_ids x (es, h,
inner)]}``.

The training side (``train_inject``, ``momentum_update``, the auxiliary
losses, ``save_checkpoint``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from celebbasis_tpu_torch.core.injection import inject_batch


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
    ph = torch.tensor(cfg.placeholder_token_ids, dtype=torch.int64,
                      device=tokens.device)
    return inject_batch(tokens, embeds, id_vectors, ph, num_ids, cfg.reps)


test_inject.__test__ = False      # a library function, not a pytest case


def load_checkpoint(cfg: ManagerConfig, path: str,
                    state: ManagerState | None = None,
                    device: torch.device | str = "cpu") -> ManagerState:
    """Reads a reference- or self-produced ``.pt`` (lists of per-id tensors
    under ``id_coefficients`` and/or ``id_embeddings``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
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
