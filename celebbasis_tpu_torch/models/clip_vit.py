"""OpenAI CLIP ViT image tower and projected text tower (the evaluation's
scorer models).

Counterpart of ``celebbasis_tpu/models/clip_vit.py``.  The reference's
evaluation uses ``clip.load("ViT-B/32")`` for image-image and text-image
similarity; here are the two towers:

* ``CLIPVisionEncoder`` -- ViT-B/32: a 32x32 patch conv (no bias), class
  token, learned positions, pre-LN transformer (12 x 768, quick-GELU,
  unmasked attention through ``ops.attention``: the flash kernel on a CUDA
  tensor), ``ln_post`` on the class token, projection to the shared 512-d
  space;
* ``CLIPTextTower`` -- ``CLIPTextEncoder`` (width 512 for B/32) with the
  EOT-token pooling and the text projection.

The attribute names are the flax tree's, so ``utils.bridge.from_jax_params``
carries weights across.  ``convert_openai_clip`` and ``convert_hf_clip``
read an OpenAI (``visual.*``, fused ``in_proj_weight``) or HuggingFace
``CLIPModel`` state dict onto those names.  The image preprocessing
(``preprocess_images``) is the JAX package's numpy arithmetic: torchvision's
tensor bicubic resize as separable weight matrices, centre crop, CLIP
normalisation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Set, Tuple

import numpy as np
import torch
import torch.nn as nn

from celebbasis_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                   CLIPTextEncoder)
from celebbasis_tpu_torch.ops.attention import attention
from celebbasis_tpu_torch.ops.basic import (Conv, Dense, LayerNorm,
                                            quick_gelu, to_nchw)
from celebbasis_tpu_torch.utils.bridge import _Reader, convert_clip_text

CLIP_IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    proj_dim: int = 512

    @staticmethod
    def vit_b32() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, width=64,
                                layers=2, heads=4, proj_dim=32)


def text_config_b32() -> CLIPTextConfig:
    """The text tower of ViT-B/32: width 512, 12 layers, 8 heads."""
    return CLIPTextConfig(width=512, layers=12, heads=8, mlp_dim=2048)


class _VitBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        w, self.heads = cfg.width, cfg.heads
        self.ln1 = LayerNorm(w)
        self.q_proj = Dense(w, w, dtype=dtype)
        self.k_proj = Dense(w, w, dtype=dtype)
        self.v_proj = Dense(w, w, dtype=dtype)
        self.out_proj = Dense(w, w, dtype=dtype)
        self.ln2 = LayerNorm(w)
        self.fc1 = Dense(w, 4 * w, dtype=dtype)
        self.fc2 = Dense(4 * w, w, dtype=dtype)

    def forward(self, x):
        h = self.ln1(x)
        x = x + self.out_proj(attention(self.q_proj(h), self.k_proj(h),
                                        self.v_proj(h), num_heads=self.heads))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig.vit_b32(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        w, p = cfg.width, cfg.patch_size
        self.patch_embed = Conv(3, w, p, stride=p, padding=0, dtype=dtype,
                                bias=False)
        tokens = (cfg.image_size // p) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.randn(w) * 0.02)
        self.position_embedding = nn.Parameter(torch.randn(tokens, w) * 0.02)
        self.ln_pre = LayerNorm(w)
        for i in range(cfg.layers):
            setattr(self, f"layer_{i}", _VitBlock(cfg, dtype))
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.randn(w, cfg.proj_dim) * 0.02)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, S, S, 3) already CLIP-normalised -> (B, proj_dim)
        float32."""
        B, dt = images.shape[0], self.dtype
        x = self.patch_embed(to_nchw(images).to(dt))          # (B, w, h, w')
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.cfg.width)
        cls = self.class_embedding.to(dt).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None].to(dt)
        x = self.ln_pre(x)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.ln_post(x[:, 0]).float() @ self.proj


class CLIPTextTower(nn.Module):
    """Text encoder + EOT pooling + projection (the CLIP scoring head)."""

    def __init__(self, cfg: CLIPTextConfig, proj_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = CLIPTextEncoder(cfg, dtype)
        self.proj = nn.Parameter(torch.randn(cfg.width, proj_dim) * 0.02)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        hidden = self.encoder(input_ids)                    # (B, L, width)
        # CLIP pools at the EOT token, the largest token id
        eot = input_ids.argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0]), eot]
        return pooled @ self.proj


def _bicubic_weight_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic weights of torch's
    F.interpolate(mode='bicubic', antialias=False, align_corners=False):
    half-pixel source centres, Keys cubic A=-0.75, border-clamped taps."""
    # fp32 scale and index arithmetic: torch keeps the scale in scalar_t, so
    # the fractional offsets (and hence the weights) carry fp32 rounding
    A = np.float32(-0.75)
    one, half = np.float32(1), np.float32(0.5)
    scale = np.float32(n_in) / np.float32(n_out)
    src = (np.arange(n_out, dtype=np.float32) + half) * scale - half
    f = np.floor(src)
    t = src - f

    def cub1(x):  # |x| <= 1
        return ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one

    def cub2(x):  # 1 < |x| < 2
        return (((x - np.float32(5)) * x + np.float32(8)) * x
                - np.float32(4)) * A

    w = np.stack([cub2(one + t), cub1(t), cub1(one - t), cub2(
        np.float32(2) - t)], axis=1)
    idx = np.clip(f[:, None] + np.arange(-1, 3)[None], 0,
                  n_in - 1).astype(int)
    W = np.zeros((n_out, n_in))
    np.add.at(W, (np.arange(n_out)[:, None], idx), w)
    return W


def bicubic_resize_torch(x: np.ndarray, out_hw) -> np.ndarray:
    """torch's tensor bicubic resize (no antialias) for (B, H, W, C) float
    arrays -- the torchvision Resize the reference's evaluation applies to
    image tensors -- as separable weight products; float32 out."""
    oh, ow = out_hw
    B, H, W, C = x.shape
    wh = _bicubic_weight_matrix(oh, H)
    ww = _bicubic_weight_matrix(ow, W)
    y = np.einsum("oh,bhwc->bowc", wh, x.astype(np.float64))
    y = np.einsum("ow,bhwc->bhoc", ww, y)
    return y.astype(np.float32)


def preprocess_images(images_minus1_1: np.ndarray, size: int = 224
                      ) -> np.ndarray:
    """[-1, 1] NHWC float images -> CLIP-normalised (B, size, size, 3).

    The evaluation's arithmetic: back to [0, 1] as float (no uint8 round
    trip), then CLIP's preprocessing without ToTensor: the short side to
    ``size`` by bicubic resize without antialias, centre crop, mean/std."""
    x = (np.asarray(images_minus1_1, np.float32) + 1.0) / 2.0
    B, H, W, C = x.shape
    if min(H, W) != size:
        if H <= W:
            nh, nw = size, int(size * W / H)
        else:
            nh, nw = int(size * H / W), size
        x = bicubic_resize_torch(x, (nh, nw))
        H, W = nh, nw
    top = int(round((H - size) / 2.0))
    left = int(round((W - size) / 2.0))
    x = x[:, top:top + size, left:left + size]
    return ((x - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD).astype(np.float32)


# -- state-dict readers ------------------------------------------------------

def _float_tensors(state: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in state.items()
            if hasattr(v, "shape")}


def convert_openai_clip(state: Mapping, vision_cfg: CLIPVisionConfig,
                        text_cfg: CLIPTextConfig,
                        used: Optional[Set[str]] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """An OpenAI CLIP ``.pt`` state dict -> (``CLIPVisionEncoder``'s,
    ``CLIPTextTower``'s state dict), float32; the keys taken are added to
    ``used``."""
    state = _float_tensors(state)
    used = set() if used is None else used
    rv = _Reader(state, "", used)
    rv.put("patch_embed.weight", rv.take("visual.conv1.weight"))
    rv.put("class_embedding", rv.take("visual.class_embedding"))
    rv.put("position_embedding", rv.take("visual.positional_embedding"))
    rv.norm("ln_pre", "visual.ln_pre")
    for i in range(vision_cfg.layers):
        _map_resblock(rv, f"visual.transformer.resblocks.{i}", f"layer_{i}",
                      vision_cfg.width)
    rv.norm("ln_post", "visual.ln_post")
    rv.put("proj", rv.take("visual.proj"))

    rt = _Reader(state, "", used)
    rt.put("encoder.token_embedding.weight", rt.take("token_embedding.weight"))
    rt.put("encoder.position_embedding", rt.take("positional_embedding"))
    for i in range(text_cfg.layers):
        _map_resblock(rt, f"transformer.resblocks.{i}", f"encoder.layer_{i}",
                      text_cfg.width)
    rt.norm("encoder.final_ln", "ln_final")
    rt.put("proj", rt.take("text_projection"))
    return rv.out, rt.out


def convert_hf_clip(state: Mapping, vision_cfg: CLIPVisionConfig,
                    text_cfg: CLIPTextConfig,
                    used: Optional[Set[str]] = None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """A HuggingFace ``CLIPModel`` state dict (``vision_model.*`` with
    separate q/k/v projections, ``text_model.*``, ``visual_projection`` /
    ``text_projection`` Linear weights, transposed against OpenAI's
    matrices) -> (vision, text tower) state dicts."""
    state = _float_tensors(state)
    used = set() if used is None else used
    rv = _Reader(state, "vision_model.", used)
    rv.put("patch_embed.weight",
           rv.take("embeddings.patch_embedding.weight"))
    rv.put("class_embedding", rv.take("embeddings.class_embedding"))
    rv.put("position_embedding",
           rv.take("embeddings.position_embedding.weight"))
    rv.norm("ln_pre", "pre_layrnorm")
    for i in range(vision_cfg.layers):
        s, d = f"encoder.layers.{i}", f"layer_{i}"
        rv.norm(f"{d}.ln1", f"{s}.layer_norm1")
        rv.norm(f"{d}.ln2", f"{s}.layer_norm2")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rv.weight(f"{d}.{proj}", f"{s}.self_attn.{proj}")
        rv.weight(f"{d}.fc1", f"{s}.mlp.fc1")
        rv.weight(f"{d}.fc2", f"{s}.mlp.fc2")
    rv.norm("ln_post", "post_layernorm")
    root = _Reader(state, "", used)
    vision = dict(rv.out, proj=root.take("visual_projection.weight").T
                  .contiguous())
    text = {f"encoder.{k}": v for k, v in convert_clip_text(
        state, text_cfg.layers, prefix="", used=used).items()}
    text["proj"] = root.take("text_projection.weight").T.contiguous()
    return vision, text


def _map_resblock(rd: _Reader, src: str, dst: str, width: int) -> None:
    rd.norm(f"{dst}.ln1", f"{src}.ln_1")
    rd.norm(f"{dst}.ln2", f"{src}.ln_2")
    _split_in_proj(rd, src, dst, width)
    rd.weight(f"{dst}.out_proj", f"{src}.attn.out_proj")
    rd.weight(f"{dst}.fc1", f"{src}.mlp.c_fc")
    rd.weight(f"{dst}.fc2", f"{src}.mlp.c_proj")


def _split_in_proj(rd: _Reader, src: str, dst: str, width: int) -> None:
    """The fused ``in_proj_weight`` (3w, w) and bias -> q / k / v."""
    w = rd.take(f"{src}.attn.in_proj_weight")
    b = rd.take(f"{src}.attn.in_proj_bias")
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        rd.put(f"{dst}.{name}.weight", w[i * width:(i + 1) * width].clone())
        rd.put(f"{dst}.{name}.bias", b[i * width:(i + 1) * width].clone())
