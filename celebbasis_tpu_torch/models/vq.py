"""VQ autoencoder, the legacy-LDM first stage: bf16-or-fp32 compute.

Counterpart of ``celebbasis_tpu/models/vq.py``:

* ``VectorQuantizer``: nearest-codebook quantisation (taming's
  ``VectorQuantizer2`` as the reference uses it: beta 0.25, no remap, the
  legacy loss order), straight-through gradient;
* ``VQModel``: encoder -> quant_conv -> quantize -> post_quant_conv ->
  decoder, on the same backbone as the KL VAE (``models/vae.py``);
* ``VQModelInterface``: the first stage as the ``*-ldm-vq-*`` latent
  diffusion configs use it: ``encode`` stops before the quantizer, and
  ``decode`` quantizes first unless ``force_not_quantize``.

The nearest-code search is the distance ``|z|^2 - 2 z.e + |e|^2`` in float32
and its argmin (the first index of the least distance, as ``jnp.argmin``
takes).  The product ``z.e`` runs with TF32 off (``utils.precision
.no_tf32`` around it): a TF32 product rounds z and e to 10-bit mantissas and
moves distances by far more than the gaps between near codes.  A distance
computed in another summation order can still flip an index where two codes
lie within rounding of each other; ``chip_smoke.py`` counts such flips
against the CPU and checks that each is such a near-tie.

``encode``/``decode`` take and return channels-last ``(B, H, W, C)``.  The
codebook is the parameter ``quantize.weight`` (the flax leaf ``embedding``,
which ``utils.bridge.from_jax_params`` names so).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from celebbasis_tpu_torch.models.vae import Decoder, Encoder, VAEConfig
from celebbasis_tpu_torch.ops.basic import Conv, to_nchw, to_nhwc
from celebbasis_tpu_torch.utils.precision import no_tf32


class VectorQuantizer(nn.Module):
    """loss = mean((sg(z_q) - z)^2) + beta * mean((z_q - sg(z))^2)."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.weight = nn.Parameter(
            (torch.rand(n_embed, embed_dim) * 2 - 1) / n_embed)

    def distances(self, z: torch.Tensor) -> torch.Tensor:
        """(..., C) -> (prod(...), n_embed) float32 squared distances."""
        flat = z.float().reshape(-1, self.embed_dim)
        emb = self.weight.float()
        with no_tf32():
            dot = flat @ emb.t()
        return (flat.square().sum(1, keepdim=True) - 2.0 * dot
                + emb.square().sum(1)[None, :])

    def forward(self, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z: (B, H, W, C) -> (z_q, loss, indices (B, H, W))."""
        z = z.float()
        idx = self.distances(z).argmin(dim=1)
        z_q = self.weight.float()[idx].reshape(z.shape)
        loss = ((z_q.detach() - z).square().mean()
                + self.beta * (z_q - z.detach()).square().mean())
        z_q = z + (z_q - z).detach()       # straight-through
        return z_q, loss, idx.reshape(z.shape[:-1])

    def embed_code(self, idx: torch.Tensor) -> torch.Tensor:
        """(...,) int indices -> (..., embed_dim)."""
        return self.weight[idx]


class VQModel(nn.Module):
    """encode -> (z_q, emb_loss, indices); decode(z_q) -> image."""

    def __init__(self, cfg: VAEConfig, n_embed: int,
                 dtype: torch.dtype = torch.bfloat16, beta: float = 0.25):
        super().__init__()
        if cfg.double_z:
            raise ValueError("VQ first stages use double_z=False")
        self.cfg, self.dtype, self.n_embed = cfg, dtype, n_embed
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.quantize = VectorQuantizer(n_embed, cfg.embed_dim, beta)
        self.quant_conv = Conv(cfg.z_channels, cfg.embed_dim, 1, dtype=dtype)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, 1,
                                    dtype=dtype)

    def encode_to_prequant(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [-1, 1] -> (B, h, w, embed_dim) float32."""
        return to_nhwc(self.quant_conv(self.encoder(to_nchw(x)))).float()

    def encode(self, x: torch.Tensor):
        return self.quantize(self.encode_to_prequant(x))

    def _decode(self, quant: torch.Tensor) -> torch.Tensor:
        h = self.post_quant_conv(to_nchw(quant.to(self.dtype)))
        return to_nhwc(self.decoder(h))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        return self._decode(quant)

    def decode_code(self, code: torch.Tensor) -> torch.Tensor:
        return self._decode(self.quantize.embed_code(code))

    def forward(self, x: torch.Tensor):
        quant, emb_loss, idx = self.quantize(self.encode_to_prequant(x))
        return self._decode(quant), emb_loss, idx


class VQModelInterface(VQModel):
    """``encode`` returns the continuous pre-quant latent; ``decode``
    quantizes first unless ``force_not_quantize``."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_to_prequant(x)

    def decode(self, h: torch.Tensor,
               force_not_quantize: bool = False) -> torch.Tensor:
        if not force_not_quantize:
            h, _, _ = self.quantize(h.float())
        return self._decode(h)
