"""CLIP ViT-L/14 text encoder with a native embedding-injection hook.

Counterpart of ``celebbasis_tpu/models/clip_text.py``.  The model exposes the
two stages that personalisation needs apart:

* ``token_embed(input_ids)`` -- the raw token-table lookup (used by the
  celeb-basis construction and by the injection path);
* ``encode(inputs_embeds)`` -- position embeddings + causal transformer +
  final LayerNorm.

The personalisation layer is a pure function between the two
(``celebbasis_tpu_torch.core.injection``).  ``forward`` composes both.

Architecture (openai/clip-vit-large-patch14 text tower): vocab 49408, width
768, 12 layers, 12 heads, MLP 3072, quick-GELU, pre-LN, causal mask, eps 1e-5.
Attribute names follow the flax tree (``layer_0.q_proj`` ...), so weights are
carried over by one generic walk (``utils.bridge.from_jax_params``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from celebbasis_tpu_torch.ops.attention import attention, causal_mask
from celebbasis_tpu_torch.ops.basic import Dense, LayerNorm, quick_gelu


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_length: int = 77

    @staticmethod
    def sd_v1() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        """Small config for tests: same structure, toy sizes."""
        return CLIPTextConfig(vocab_size=1024, width=64, layers=2, heads=4,
                              mlp_dim=128, max_length=77)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.heads = cfg.heads
        w = cfg.width
        self.ln1 = LayerNorm(w)
        self.q_proj = Dense(w, w, dtype=dtype)
        self.k_proj = Dense(w, w, dtype=dtype)
        self.v_proj = Dense(w, w, dtype=dtype)
        self.out_proj = Dense(w, w, dtype=dtype)
        self.ln2 = LayerNorm(w)
        self.fc1 = Dense(w, cfg.mlp_dim, dtype=dtype)
        self.fc2 = Dense(cfg.mlp_dim, w, dtype=dtype)

    def forward(self, x, mask):
        h = self.ln1(x)
        a = attention(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                      num_heads=self.heads, mask=mask)
        x = x + self.out_proj(a)
        h = self.fc1(self.ln2(x))
        return x + self.fc2(quick_gelu(h))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Parameter(
            torch.randn(cfg.max_length, cfg.width) * 0.01)
        for i in range(cfg.layers):
            setattr(self, f"layer_{i}", _EncoderLayer(cfg, dtype))
        self.final_ln = LayerNorm(cfg.width)

    def token_embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> (B, L, width) raw token-table embeddings."""
        return self.token_embedding(input_ids)

    def encode(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        """(B, L, width) token embeddings -> (B, L, width) final hidden
        states, float32."""
        L = inputs_embeds.shape[1]
        x = (inputs_embeds + self.position_embedding[None, :L]).to(self.dtype)
        mask = causal_mask(L, device=x.device)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.final_ln(x).float()

    def forward(self, input_ids: torch.Tensor,
                inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.token_embed(input_ids)
        return self.encode(inputs_embeds)
