"""The textual-inversion baseline: learned vectors looked up in place of a
placeholder token.

Counterpart of ``celebbasis_tpu/core/textual_inversion.py`` (the reference's
``EmbeddingManager`` on its ``main.py`` / ``v1-finetune.yaml`` path): each
placeholder string owns ``num_vectors_per_token`` directly learned vectors,
initialised from an initializer word's token embedding; when a prompt is
encoded, the placeholder's position is replaced (and widened, through the
shared fixed-shape injection of ``core.injection``) by those vectors, which
take gradients through the frozen diffusion stack.

The state is one ``(P, V, D)`` float32 tensor, the only thing the TI train
step trains.  Checkpoints use the reference's ``{"string_to_token": {...},
"string_to_param": {...}}`` ``.pt`` schema, written and read by
``utils.pt_io`` (the JAX package reads what this module writes, and the
reverse).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from celebbasis_tpu_torch.core.injection import inject_batch
from celebbasis_tpu_torch.text.tokenizer import token_for_string
from celebbasis_tpu_torch.utils.pt_io import load_pt, save_pt


@dataclass(frozen=True)
class TIConfig:
    placeholder_strings: Tuple[str, ...] = ("*",)
    num_vectors_per_token: int = 1
    token_dim: int = 768


def init_ti_params(cfg: TIConfig, tokenizer, token_table: np.ndarray,
                   initializer_words: Sequence[str] = ()) -> torch.Tensor:
    """(P, V, D) float32 vectors on the CPU: N(0, 0.01) from a numpy
    generator seeded with 0 (the JAX package's draw), then each placeholder
    with an initializer word set to that word's token embedding."""
    P, V, D = (len(cfg.placeholder_strings), cfg.num_vectors_per_token,
               cfg.token_dim)
    out = np.random.default_rng(0).normal(0, 0.01, (P, V, D)).astype(
        np.float32)
    for i, word in enumerate(initializer_words[:P]):
        tok = tokenizer.tokenize(word)[0]
        out[i] = np.broadcast_to(token_table[tok], (V, D))
    return torch.from_numpy(out)


def placeholder_token_ids(cfg: TIConfig, tokenizer) -> Tuple[int, ...]:
    return tuple(token_for_string(tokenizer, s)
                 for s in cfg.placeholder_strings)


def ti_inject(cfg: TIConfig, ti_params: torch.Tensor, ph_ids: torch.Tensor,
              tokens: torch.Tensor, embeds: torch.Tensor) -> torch.Tensor:
    """Replace the placeholder positions of a batch with the learned
    vectors; differentiable in ``ti_params``."""
    B = tokens.shape[0]
    id_vectors = ti_params.reshape(1, -1, cfg.token_dim).expand(
        B, ti_params.shape[0] * ti_params.shape[1], cfg.token_dim)
    num_active = torch.full((B,), len(cfg.placeholder_strings),
                            dtype=torch.int64, device=tokens.device)
    return inject_batch(tokens, embeds, id_vectors, ph_ids, num_active,
                        cfg.num_vectors_per_token)


def embedding_reg_loss(ti_params: torch.Tensor,
                       init_vectors: torch.Tensor) -> torch.Tensor:
    """The coarse-embedding regulariser: pull the learned vectors toward
    their initialisers (mean squared difference)."""
    return ((ti_params - init_vectors) ** 2).mean()


# -- checkpoint schema ------------------------------------------------------

def save_ti_checkpoint(cfg: TIConfig, ti_params, ph_ids, path: str) -> None:
    arr = torch.as_tensor(ti_params).detach().float().cpu()
    save_pt({
        "string_to_token": {s: torch.tensor(int(t), dtype=torch.int64)
                            for s, t in zip(cfg.placeholder_strings, ph_ids)},
        "string_to_param": {s: arr[i].clone()
                            for i, s in enumerate(cfg.placeholder_strings)},
    }, path)


def load_ti_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """-> {placeholder: (V, D) float32 vectors}; reads the reference's TI
    checkpoints too."""
    out = {}
    for key, val in load_pt(path)["string_to_param"].items():
        arr = torch.as_tensor(val).float().numpy()
        out[key] = arr.reshape(-1, arr.shape[-1])
    return out


def merge_ti_checkpoints(paths: Sequence[str], rename: Dict[str, str] | None
                         = None) -> Dict[str, np.ndarray]:
    """Merge several TI checkpoints; a placeholder that two files share must
    be renamed (``rename`` maps ``'path:placeholder'`` to the new name), or
    this raises."""
    merged: Dict[str, np.ndarray] = {}
    rename = rename or {}
    for path in paths:
        for key, val in load_ti_checkpoint(path).items():
            name = rename.get(f"{path}:{key}", key)
            if name in merged:
                raise ValueError(
                    f"placeholder collision {name!r} from {path}; pass a "
                    f"rename for '{path}:{key}'")
            merged[name] = val
    return merged
