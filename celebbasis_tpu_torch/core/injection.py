"""Placeholder expansion + identity-embedding injection as fixed-shape ops.

Counterpart of ``celebbasis_tpu/core/injection.py``.  The reference mutates
one (77, 768) row at a time in a Python loop; here the shift is a fixed-shape
gather.  For each sequence position ``i`` let ``off(i) = (reps - 1) *
#placeholders strictly before i``.  Every original token moves to
``i + off(i)``; each placeholder's span of ``reps`` output slots reads from an
id-vector bank instead.  (src_index, slot_id) maps are built with cumsum +
scatter, then one gather and one ``where`` give the final embeddings.  All
functions are batched over a leading axis; no host loop over rows, no
device-to-host sync.

Semantics match the reference, including 77-truncation of the shifted tail
and several occurrences of one placeholder.  Writes that fall beyond the
sequence go to slot ``L`` of a length ``L + 1`` buffer whose last slot is
thrown away (the JAX scatter's ``mode="drop"``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_shift_maps(tokens: torch.Tensor, placeholder_ids: torch.Tensor,
                     num_active: torch.Tensor, reps: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather maps for a batch of sequences.

    tokens: (B, L) integer token ids.
    placeholder_ids: (P,) placeholder token ids.
    num_active: (B,) how many of the P placeholders are live for each row.
    reps: embedding slots per placeholder.

    Returns:
      src:  (B, L) int64 -- output position o reads original position src[o];
      slot: (B, L) int64 -- flat id-vector index ``p * reps + r`` for injected
            positions, -1 elsewhere.
    """
    B, L = tokens.shape
    P = placeholder_ids.shape[0]
    dev = tokens.device
    pos = torch.arange(L, device=dev).expand(B, L)

    matches = tokens[:, None, :] == placeholder_ids.to(dev)[None, :, None]
    active = torch.arange(P, device=dev)[None, :] < num_active.to(dev)[:, None]
    matches = matches & active[:, :, None]                      # (B, P, L)
    ph_which = torch.where(matches.any(1),
                           matches.to(torch.int64).argmax(1), -1)
    is_ph = (ph_which >= 0).to(torch.int64)

    before = torch.cumsum(is_ph, dim=1) - is_ph      # strictly-before count
    new_pos = pos + (reps - 1) * before

    # original tokens scatter to their shifted positions; slot L is dropped
    valid = new_pos < L
    src = torch.zeros((B, L + 1), dtype=torch.int64, device=dev)
    src.scatter_(1, torch.where(valid, new_pos, L), pos)
    slot = torch.full((B, L + 1), -1, dtype=torch.int64, device=dev)
    # each placeholder occupies new_pos .. new_pos + reps - 1 in the output
    for r in range(reps):
        tgt = new_pos + r
        ok = (ph_which >= 0) & (tgt < L)
        idx = torch.where(ok, tgt, L)
        slot.scatter_(1, idx, torch.where(ok, ph_which * reps + r, -1))
        # injected spans still need src defined (overwritten by slot anyway)
        src.scatter_(1, idx, torch.where(ok, pos, 0))
    return src[:, :L], slot[:, :L]


def inject_embeddings(tokens: torch.Tensor, embeds: torch.Tensor,
                      id_vectors: torch.Tensor, placeholder_ids: torch.Tensor,
                      num_active: torch.Tensor, reps: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-sequence injection.

    tokens (L,), embeds (L, D), id_vectors (P*reps, D) (placeholder p, slot r
    at row p*reps + r), num_active scalar.  Returns (new_embeds (L, D),
    slot (L,)).
    """
    out, slot = _inject(tokens[None], embeds[None], id_vectors[None],
                        placeholder_ids,
                        torch.as_tensor(num_active).reshape(1), reps)
    return out[0], slot[0]


def _inject(tokens, embeds, id_vectors, placeholder_ids, num_active, reps):
    src, slot = build_shift_maps(tokens, placeholder_ids, num_active, reps)
    D = embeds.shape[-1]
    shifted = torch.gather(embeds, 1, src[:, :, None].expand(-1, -1, D))
    bank = slot.clamp(0, id_vectors.shape[1] - 1)
    injected = torch.gather(id_vectors, 1, bank[:, :, None].expand(-1, -1, D))
    out = torch.where((slot >= 0)[:, :, None], injected, shifted)
    return out, slot


def inject_batch(tokens: torch.Tensor, embeds: torch.Tensor,
                 id_vectors: torch.Tensor, placeholder_ids: torch.Tensor,
                 num_active: torch.Tensor, reps: int) -> torch.Tensor:
    """Batched injection: tokens (B, L), embeds (B, L, D),
    id_vectors (B, P*reps, D), num_active (B,) -> (B, L, D)."""
    return _inject(tokens, embeds, id_vectors, placeholder_ids, num_active,
                   reps)[0]


# -- host-side reference implementation (for tests / tooling) ---------------

def inject_reference_numpy(tokens: np.ndarray, embeds: np.ndarray,
                           id_vectors: np.ndarray, placeholder_ids: list,
                           num_active: int, reps: int) -> np.ndarray:
    """Direct transcription of the reference algorithm's *semantics* (shift +
    per-position overwrite) in numpy: the golden model for the gather
    formulation."""
    L, D = embeds.shape
    out = embeds.copy()
    ph = list(placeholder_ids[:num_active])
    pos_list = [np.where(tokens == p)[0] for p in ph]
    all_pos = np.concatenate(pos_list) if pos_list else np.array([], np.int64)
    offset = np.zeros(L, np.int64)
    for p in all_pos:
        offset[p + 1:] += reps - 1
    r_cnt = len(all_pos)
    target = (np.arange(L) + offset)[: L - r_cnt * (reps - 1)]
    out[target] = out[np.arange(len(target))]
    final = target[all_pos].repeat(reps) + np.tile(np.arange(reps), r_cnt)
    lo = 0
    for pi, positions in enumerate(pos_list):
        for _ in range(len(positions)):
            for r in range(reps):
                fp = final[lo]
                if fp < L:
                    out[fp] = id_vectors[pi * reps + r]
                lo += 1
    return out
