"""BERT-path text encoder of the legacy txt2img-1p4B configs.

Counterpart of ``celebbasis_tpu/models/bert_text.py``: the reference's
``BERTEmbedder``, an x-transformers ``TransformerWrapper`` + ``Encoder`` in
its default configuration: pre-LN blocks of [LayerNorm -> Attention (8 heads
of 64, biasless q/k/v) -> residual; LayerNorm -> FeedForward (exact GELU,
mult 4) -> residual], learned absolute position embeddings, a final
LayerNorm, and the embeddings returned (no logits head).

As in the reference, no padding mask: padded positions attend like real
tokens, so the 77-token attention is unmasked and goes to the flash kernel
on a card (``ops.attention``).  The textual-inversion hook ``inject(ids,
embedded)`` runs right after the token-table lookup, before the position
embeddings are added.

Attribute names follow the flax tree (``token_emb``, ``pos_emb``,
``attn_ln_0``, ``attn_0.to_q``, ``ff_0.fc1``, ``norm_out``), so weights are
carried over by ``utils.bridge.from_jax_params``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebbasis_tpu_torch.ops.attention import attention
from celebbasis_tpu_torch.ops.basic import Dense, LayerNorm


@dataclass(frozen=True)
class BERTTextConfig:
    vocab_size: int = 30522
    max_seq_len: int = 77
    dim: int = 1280
    depth: int = 32
    heads: int = 8
    dim_head: int = 64

    @staticmethod
    def ldm_1p4b() -> "BERTTextConfig":
        """txt2img-1p4B-*.yaml: n_embed 1280, n_layer 32."""
        return BERTTextConfig()

    @staticmethod
    def tiny() -> "BERTTextConfig":
        return BERTTextConfig(vocab_size=211, dim=64, depth=2, heads=4,
                              dim_head=16)


class _XAttention(nn.Module):
    """Biasless q/k/v projections to heads * dim_head, biased out
    projection, unmasked attention."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        inner = heads * dim_head
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x):
        out = attention(self.to_q(x), self.to_k(x), self.to_v(x),
                        num_heads=self.heads)
        return self.to_out(out)


class _XFeedForward(nn.Module):
    """Linear -> exact GELU -> Linear, mult 4."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, dim * 4, dtype=dtype)
        self.fc2 = Dense(dim * 4, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class BERTTextEncoder(nn.Module):
    """``TransformerWrapper(return_embeddings=True)``: (B, L) ids ->
    (B, L, dim) float32 embeddings."""

    def __init__(self, cfg: BERTTextConfig,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_emb = nn.Parameter(
            torch.randn(cfg.vocab_size, cfg.dim) * 0.02)
        self.pos_emb = nn.Parameter(
            torch.randn(cfg.max_seq_len, cfg.dim) * 0.02)
        for i in range(cfg.depth):
            setattr(self, f"attn_ln_{i}", LayerNorm(cfg.dim))
            setattr(self, f"attn_{i}", _XAttention(cfg.dim, cfg.heads,
                                                   cfg.dim_head, dtype))
            setattr(self, f"ff_ln_{i}", LayerNorm(cfg.dim))
            setattr(self, f"ff_{i}", _XFeedForward(cfg.dim, dtype))
        self.norm_out = LayerNorm(cfg.dim)

    def token_embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The token-table lookup alone (the textual-inversion hook
        point)."""
        return self.token_emb[ids]

    def forward(self, ids: torch.Tensor,
                inject: Optional[Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor]] = None
                ) -> torch.Tensor:
        """``inject(ids, embedded)`` is the reference's
        ``embedding_manager(x, embedded_x)`` hook."""
        x = self.token_embed(ids)
        if inject is not None:
            x = inject(ids, x)
        L = ids.shape[1]
        x = (x + self.pos_emb[None, :L]).to(self.dtype)
        for i in range(self.cfg.depth):
            x = x + getattr(self, f"attn_{i}")(getattr(self,
                                                       f"attn_ln_{i}")(x))
            x = x + getattr(self, f"ff_{i}")(getattr(self, f"ff_ln_{i}")(x))
        return self.norm_out(x).float()


class ClassEmbedder(nn.Embedding):
    """Class-conditional embedder: (B,) int labels -> (B, 1, embed_dim)
    cross-attention context."""

    def __init__(self, n_classes: int, embed_dim: int):
        super().__init__(n_classes, embed_dim)
        self.n_classes = n_classes

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.weight[labels][:, None, :]
