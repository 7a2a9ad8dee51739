"""Weights carried across from the JAX package's trees.

``from_jax_params(tree)`` turns a flax params tree (nested dicts of numpy
arrays; the caller hands over ``jax.tree_util.tree_map(np.asarray, params)``)
into a PyTorch ``state_dict``.  The port's modules take the attribute names
of the flax tree, so the converter is one generic walk and not a key map per
model:

* a conv kernel HWIO ``(kh, kw, in, out)`` -> OIHW ``(out, in, kh, kw)``;
* a dense kernel ``(in, out)`` -> ``(out, in)``;
* ``scale`` -> ``weight`` (norms, FrozenBN), ``embedding`` -> ``weight`` (the
  token table, the VQ codebook, ``ClassEmbedder``); ``bias``,
  ``position_embedding``, FrozenBN's ``mean`` / ``var`` (buffers in the
  port), PReLU's ``alpha``, ``coef_table``, the CLIP towers'
  ``class_embedding`` and ``proj`` (used as ``x @ proj`` on both sides),
  BERT's ``token_emb`` / ``pos_emb`` (and the attention pool's ``pos_emb``),
  ActNorm's ``loc``, the KL loss's ``logvar``, the LPIPS heads ``lin_0`` ...
  ``lin_4``, and the leaves ``keep`` names (as
  ``utils.bridge_xt`` does for the x-transformers leaves) as they are;
  a leaf already called ``weight`` (EqualLinear) is stored ``(out, in)`` in
  both packages and is **not** transposed;
* IResNet's ``fc`` follows a flatten in ``(H, W, C)`` order in both packages
  (the port keeps channels-last there), so its kernel is only transposed;
* the extra nesting of the JAX wrappers (``GroupNorm_0`` / ``LayerNorm_0``
  under ``ops.basic``'s norms, ``Conv_0`` under ``ZeroConv``) and flax's
  top-level ``params`` and ``batch_stats`` collections are dropped from the
  path (a BatchNorm's ``mean`` / ``var`` and ``scale`` / ``bias`` meet under
  one module).

``load_jax_params(module, tree)`` loads with ``strict=True``: every leaf of
the tree is consumed and every parameter of the module is filled, or it
raises.

The pretrained checkpoints map straight onto the port's names (torch's
layouts are the port's, so nothing is transposed): ``convert_unet`` and
``convert_vae`` read the CompVis keys of ``sd-v1-4.ckpt``
(``model.diffusion_model.*``, ``first_stage_model.*``) and of the legacy
latent-diffusion checkpoints (the ``AttentionBlock``'s 1x1 conv1d ``qkv`` and
``proj_out`` become ``Dense`` weights, residual resampling blocks, in-level
first-stage attention), ``convert_vq`` a ``VQModel(Interface)`` first stage
with its codebook, ``convert_bert_text`` the x-transformers
``TransformerWrapper`` of ``BERTEmbedder``
(``cond_stage_model.transformer.*``), ``convert_clip_text``
the HF CLIP text keys (``cond_stage_model.transformer.[text_model.]*``),
``convert_iresnet`` an insightface ``backbone.pth``,
``convert_encoder_unet`` the classifier trunk (``EncoderUNetModel``, every
pooling head), ``convert_vgg16`` / ``convert_lpips`` torchvision's VGG16
and the LPIPS heads; ``load_sd_checkpoint`` and ``load_iresnet_checkpoint``
read the files (``utils.pt_io.load_pt``) and report the keys they did not
use.  The maps are written once for both ways: ``export_unet``,
``export_vae``, ``export_vq``, ``export_bert_text`` and
``export_encoder_unet`` walk them over the port's state dict and write the
reference's keys (what the legacy trainers' ``--export-torch`` writes),
raising on an entry they did not write.  A key the module needs and the file lacks
raises; values come back float32 (the CosFace file is fp16), and
``load_state_dict(strict=True)`` refuses a shape that differs.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch
import torch.nn as nn

from celebbasis_tpu_torch.core.manager import ManagerState
from celebbasis_tpu_torch.models.clip_text import CLIPTextConfig
from celebbasis_tpu_torch.models.unet import UNetConfig
from celebbasis_tpu_torch.models.vae import VAEConfig
from celebbasis_tpu_torch.utils.pt_io import load_pt

_WRAPPER_LEVELS = ("GroupNorm_0", "LayerNorm_0", "Conv_0")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "position_embedding": "position_embedding",
               "weight": "weight", "mean": "mean", "var": "var",
               "alpha": "alpha", "coef_table": "coef_table",
               "class_embedding": "class_embedding", "proj": "proj",
               "token_emb": "token_emb", "pos_emb": "pos_emb",
               # ActNorm's shift, the KL loss's logvar, the LPIPS heads
               "loc": "loc", "logvar": "logvar",
               **{f"lin_{i}": f"lin_{i}" for i in range(5)}}
_COLLECTIONS = ("params", "batch_stats")


def _convert_leaf(path, name: str, value) -> torch.Tensor:
    arr = np.asarray(value)
    if name == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)        # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T                            # (in, out) -> (out, in)
        else:
            raise ValueError(f"{'.'.join(path)}: kernel of rank {arr.ndim}")
    return torch.from_numpy(np.array(arr))      # a writable, contiguous copy


def from_jax_params(tree: Mapping,
                    keep: Callable[[str], bool] = lambda key: False
                    ) -> Dict[str, torch.Tensor]:
    """Flax params tree -> state_dict.  A tree of several models
    (``{"unet": ..., "vae": ..., "clip": ...}``) gives keys prefixed by the
    model's name, which is what ``CelebBasisPipeline.state_dict()`` has.
    A leaf name for which ``keep`` is true is taken as it is."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                skip = key in _WRAPPER_LEVELS or key in _COLLECTIONS
                walk(val, path if skip else path + (key,))
                continue
            leaf = _LEAF_NAMES.get(key) or (key if keep(key) else None)
            if leaf is None:
                raise KeyError(f"{'.'.join(path + (key,))}: unknown leaf "
                               f"name {key!r}")
            name = ".".join(path + (leaf,))
            if name in out:
                raise KeyError(f"two leaves map to {name!r}")
            out[name] = _convert_leaf(path, key, val)

    walk(tree, ())
    return out


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Strict load: raises on a leaf without a parameter, a parameter without
    a leaf, or a shape that differs.  Values are cast to each parameter's
    storage type."""
    module.load_state_dict(from_jax_params(tree), strict=True)
    return module


def manager_state_from_jax(state) -> ManagerState:
    """A JAX ``ManagerState`` (any pair of array-likes in its field order)
    -> the port's."""
    emb, coeff = state
    as_t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return ManagerState(as_t(emb), as_t(coeff))


def manager_state_to_numpy(state: ManagerState):
    """The way back: ``(id_embeddings, id_coefficients)`` as float32 numpy
    arrays, in the JAX ``ManagerState``'s field order."""
    return tuple(t.detach().float().cpu().numpy() for t in state)


def basis_from_jax(basis) -> torch.Tensor:
    return torch.from_numpy(np.array(basis, np.float32))


# -- pretrained checkpoints ---------------------------------------------------

class _Reader:
    """Copies checkpoint tensors (as float32) onto the port's parameter
    names and records the checkpoint keys it took in ``used``."""

    def __init__(self, state: Mapping[str, torch.Tensor], prefix: str = "",
                 used: Optional[Set[str]] = None):
        self.state, self.prefix = state, prefix
        self.used = set() if used is None else used
        self.out: Dict[str, torch.Tensor] = {}

    def has(self, key: str) -> bool:
        return self.prefix + key in self.state

    def take(self, key: str) -> torch.Tensor:
        full = self.prefix + key
        if full not in self.state:
            raise KeyError(f"checkpoint missing key: {full}")
        self.used.add(full)
        return self.state[full].float()

    def put(self, dst: str, value: torch.Tensor) -> None:
        self.out[dst] = value

    def weight(self, dst: str, src: str, bias: bool = True) -> None:
        """A conv or linear layer: weight, and its bias where the file has
        one."""
        self.put(f"{dst}.weight", self.take(f"{src}.weight"))
        if bias and self.has(f"{src}.bias"):
            self.put(f"{dst}.bias", self.take(f"{src}.bias"))

    def norm(self, dst: str, src: str) -> None:
        self.put(f"{dst}.weight", self.take(f"{src}.weight"))
        self.put(f"{dst}.bias", self.take(f"{src}.bias"))

    def bn(self, dst: str, src: str) -> None:
        """BatchNorm -> FrozenBN: the affine and the running statistics."""
        self.norm(dst, src)
        self.put(f"{dst}.mean", self.take(f"{src}.running_mean"))
        self.put(f"{dst}.var", self.take(f"{src}.running_var"))

    # the calls the maps shared with ``_Writer`` make
    def copy(self, dst: str, src: str) -> None:
        self.put(dst, self.take(src))

    def has_layer(self, dst: str, src: str) -> bool:
        """Whether the optional layer ``src`` (a skip conv) is there."""
        return self.has(f"{src}.weight")

    def conv1d(self, dst: str, src: str) -> None:
        """A 1x1 conv1d (out, in, 1) held as a ``Dense`` (out, in)."""
        self.put(f"{dst}.weight", self.take(f"{src}.weight")[:, :, 0])
        self.put(f"{dst}.bias", self.take(f"{src}.bias"))

    def transposed(self, dst: str, src: str) -> None:
        self.put(dst, self.take(src).t().contiguous())


class _Writer:
    """The way back: the maps that read a checkpoint into the port's names
    (``_map_unet``, ``_map_ldm_backbone``, ...) walked over the port's state
    dict, writing the checkpoint's keys (under ``prefix``) as float32 CPU
    tensors.  ``finish`` raises unless every entry of the state was
    written."""

    def __init__(self, state: Mapping[str, torch.Tensor], prefix: str = ""):
        self.state, self.prefix = state, prefix
        self.used: Set[str] = set()
        self.out: Dict[str, torch.Tensor] = {}

    def _get(self, dst: str) -> torch.Tensor:
        self.used.add(dst)
        return self.state[dst].detach().float().cpu().clone()

    def copy(self, dst: str, src: str) -> None:
        self.out[self.prefix + src] = self._get(dst)

    def has_layer(self, dst: str, src: str) -> bool:
        return f"{dst}.weight" in self.state

    def weight(self, dst: str, src: str, bias: bool = True) -> None:
        self.copy(f"{dst}.weight", f"{src}.weight")
        if bias and f"{dst}.bias" in self.state:
            self.copy(f"{dst}.bias", f"{src}.bias")

    def norm(self, dst: str, src: str) -> None:
        self.copy(f"{dst}.weight", f"{src}.weight")
        self.copy(f"{dst}.bias", f"{src}.bias")

    def conv1d(self, dst: str, src: str) -> None:
        self.out[f"{self.prefix}{src}.weight"] = \
            self._get(f"{dst}.weight")[:, :, None]
        self.copy(f"{dst}.bias", f"{src}.bias")

    def transposed(self, dst: str, src: str) -> None:
        self.out[self.prefix + src] = self._get(dst).t().contiguous()

    def finish(self) -> Dict[str, torch.Tensor]:
        left = sorted(set(self.state) - self.used)
        if left:
            raise KeyError(f"not exported: {left[:8]}")
        return self.out


def _map_resblock(rd: _Reader, dst: str, src: str) -> None:
    rd.norm(f"{dst}.norm1", f"{src}.in_layers.0")
    rd.weight(f"{dst}.conv1", f"{src}.in_layers.2")
    rd.weight(f"{dst}.emb_proj", f"{src}.emb_layers.1")
    rd.norm(f"{dst}.norm2", f"{src}.out_layers.0")
    rd.weight(f"{dst}.conv2", f"{src}.out_layers.3")
    if rd.has_layer(f"{dst}.skip", f"{src}.skip_connection"):
        rd.weight(f"{dst}.skip", f"{src}.skip_connection")


def _map_attnblock(rd: _Reader, dst: str, src: str) -> None:
    """The legacy ``AttentionBlock``: its 1x1 conv1d ``qkv`` and ``proj_out``
    (out, in, 1) are ``Dense`` weights (out, in) here."""
    rd.norm(f"{dst}.norm", f"{src}.norm")
    for p in ("qkv", "proj_out"):
        rd.conv1d(f"{dst}.{p}", f"{src}.{p}")


def _map_spatial(rd: _Reader, dst: str, src: str, depth: int) -> None:
    rd.norm(f"{dst}.norm", f"{src}.norm")
    rd.weight(f"{dst}.proj_in", f"{src}.proj_in")
    for d in range(depth):
        b_src, b_dst = f"{src}.transformer_blocks.{d}", f"{dst}.block_{d}"
        for n in (1, 2, 3):
            rd.norm(f"{b_dst}.norm{n}", f"{b_src}.norm{n}")
        for a in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                rd.weight(f"{b_dst}.{a}.{p}", f"{b_src}.{a}.{p}", bias=False)
            rd.weight(f"{b_dst}.{a}.to_out", f"{b_src}.{a}.to_out.0")
        rd.weight(f"{b_dst}.ff.proj_in", f"{b_src}.ff.net.0.proj")
        rd.weight(f"{b_dst}.ff.proj_out", f"{b_src}.ff.net.2")
    rd.weight(f"{dst}.proj_out", f"{src}.proj_out")


def convert_unet(state: Mapping[str, torch.Tensor],
                 cfg: UNetConfig = UNetConfig.sd_v1(),
                 prefix: str = "model.diffusion_model.",
                 used: Optional[Set[str]] = None) -> Dict[str, torch.Tensor]:
    """CompVis ``openaimodel.UNetModel`` keys -> ``models.unet.UNetModel``'s
    state dict; the keys taken are added to ``used``."""
    rd = _Reader(state, prefix, used)
    _map_unet(rd, cfg)
    return rd.out


def export_unet(state: Mapping[str, torch.Tensor],
                cfg: UNetConfig = UNetConfig.sd_v1(),
                prefix: str = "model.diffusion_model."
                ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_unet`: a ``UNetModel``'s state dict ->
    the CompVis keys."""
    wr = _Writer(state, prefix)
    _map_unet(wr, cfg)
    return wr.finish()


def _map_encoder_half(rd, cfg: UNetConfig, attn) -> None:
    """The time embedding, the input blocks and the middle block, shared by
    the UNet and the classifier trunk."""
    rd.weight("time_fc1", "time_embed.0")
    rd.weight("time_fc2", "time_embed.2")
    rd.weight("conv_in", "input_blocks.0.0")
    levels = len(cfg.channel_mult)
    idx, ds = 1, 1
    for level in range(levels):
        for j in range(cfg.num_res_blocks):
            _map_resblock(rd, f"down_{level}_res_{j}", f"input_blocks.{idx}.0")
            if ds in cfg.attention_resolutions:
                attn(f"down_{level}_attn_{j}", f"input_blocks.{idx}.1")
            idx += 1
        if level != levels - 1:
            if cfg.resblock_updown:
                _map_resblock(rd, f"down_{level}_downsample",
                              f"input_blocks.{idx}.0")
            else:
                rd.weight(f"down_{level}_downsample",
                          f"input_blocks.{idx}.0.op")
            idx += 1
            ds *= 2
    _map_resblock(rd, "mid_res_0", "middle_block.0")
    attn("mid_attn", "middle_block.1")
    _map_resblock(rd, "mid_res_1", "middle_block.2")


def _map_unet(rd, cfg: UNetConfig) -> None:
    def attn(dst, src):
        if cfg.use_spatial_transformer:
            _map_spatial(rd, dst, src, cfg.transformer_depth)
        else:
            _map_attnblock(rd, dst, src)

    _map_encoder_half(rd, cfg, attn)
    levels = len(cfg.channel_mult)
    ds = 2 ** (levels - 1)
    idx = 0
    for level in reversed(range(levels)):
        for j in range(cfg.num_res_blocks + 1):
            _map_resblock(rd, f"up_{level}_res_{j}", f"output_blocks.{idx}.0")
            sub = 1
            if ds in cfg.attention_resolutions:
                attn(f"up_{level}_attn_{j}", f"output_blocks.{idx}.{sub}")
                sub += 1
            if j == cfg.num_res_blocks and level != 0:
                if cfg.resblock_updown:
                    _map_resblock(rd, f"up_{level}_upsample",
                                  f"output_blocks.{idx}.{sub}")
                else:
                    rd.weight(f"up_{level}_upsample",
                              f"output_blocks.{idx}.{sub}.conv")
                ds //= 2
            idx += 1
    rd.norm("norm_out", "out.0")
    rd.weight("conv_out", "out.2")


def convert_encoder_unet(state: Mapping[str, torch.Tensor], cfg: UNetConfig,
                         pool: str = "adaptive", prefix: str = "model.",
                         used: Optional[Set[str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """An ``EncoderUNetModel`` checkpoint (the reference's classifier trunk)
    -> ``models.unet.EncoderUNetModel``'s state dict: the UNet's encoder
    half with plain ``AttentionBlock``s, then the pooling head (the
    attention pool's ``positional_embedding`` (C, T) taken as (T, C), its
    1x1 conv1d projections as ``Dense`` weights)."""
    rd = _Reader(state, prefix, used)
    _map_encoder_unet(rd, cfg, pool)
    return rd.out


def export_encoder_unet(state: Mapping[str, torch.Tensor], cfg: UNetConfig,
                        pool: str = "adaptive", prefix: str = "model."
                        ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_encoder_unet`."""
    wr = _Writer(state, prefix)
    _map_encoder_unet(wr, cfg, pool)
    return wr.finish()


def _map_encoder_unet(rd, cfg: UNetConfig, pool: str) -> None:
    _map_encoder_half(rd, cfg, lambda dst, src: _map_attnblock(rd, dst, src))
    if pool in ("adaptive", "attention"):
        rd.norm("norm_out", "out.0")
    if pool == "adaptive":
        rd.weight("conv_out", "out.3")
    elif pool == "attention":
        rd.transposed("attn_pool.pos_emb", "out.2.positional_embedding")
        rd.conv1d("attn_pool.qkv", "out.2.qkv_proj")
        rd.conv1d("attn_pool.c_proj", "out.2.c_proj")
    elif pool == "spatial":
        rd.weight("fc1", "out.0")
        rd.weight("fc2", "out.2")
    elif pool == "spatial_v2":
        rd.weight("fc1", "out.0")
        rd.norm("fc_norm", "out.1")
        rd.weight("fc2", "out.3")
    else:
        raise NotImplementedError(f"Unexpected {pool} pooling")


# conv indices inside torchvision's vgg16().features (ReLUs and pools
# interleave)
_VGG16_FEATURE_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def convert_vgg16(state: Mapping[str, torch.Tensor], prefix: str = "",
                  used: Optional[Set[str]] = None
                  ) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16()`` keys (``features.{i}``) ->
    ``models.lpips.VGG16Features``' state dict; the classifier head is not
    read (LPIPS never uses it)."""
    rd = _Reader(state, prefix, used)
    for j, i in enumerate(_VGG16_FEATURE_IDX):
        rd.weight(f"conv_{j}", f"features.{i}")
    return rd.out


def convert_lpips(state: Mapping[str, torch.Tensor],
                  vgg_state: Mapping[str, torch.Tensor], prefix: str = "",
                  used: Optional[Set[str]] = None
                  ) -> Dict[str, torch.Tensor]:
    """A taming / LPIPS checkpoint (heads ``lin{i}.model.1.weight``, 1x1
    no-bias convs (1, C, 1, 1)) and a torchvision VGG16 state dict ->
    ``models.lpips.LPIPS``' state dict: each head a per-channel weight
    vector (the same contraction)."""
    rd = _Reader(state, prefix, used)
    for i in range(5):
        rd.put(f"lin_{i}", rd.take(f"lin{i}.model.1.weight")[0, :, 0, 0])
    out = dict(rd.out)
    out.update({f"vgg.{k}": v for k, v in convert_vgg16(vgg_state).items()})
    return out


def _map_vae_res(rd: _Reader, dst: str, src: str) -> None:
    rd.norm(f"{dst}.norm1", f"{src}.norm1")
    rd.weight(f"{dst}.conv1", f"{src}.conv1")
    rd.norm(f"{dst}.norm2", f"{src}.norm2")
    rd.weight(f"{dst}.conv2", f"{src}.conv2")
    if rd.has_layer(f"{dst}.nin_shortcut", f"{src}.nin_shortcut"):
        rd.weight(f"{dst}.nin_shortcut", f"{src}.nin_shortcut")


def _map_vae_attn(rd: _Reader, dst: str, src: str) -> None:
    rd.norm(f"{dst}.norm", f"{src}.norm")
    for p in ("q", "k", "v", "proj_out"):
        rd.weight(f"{dst}.{p}", f"{src}.{p}")


def _map_vae_mid(rd: _Reader, side: str, cfg: VAEConfig) -> None:
    """The mid block of the encoder or the decoder: res, attention (unless
    ``attn_type`` is 'none'), res."""
    _map_vae_res(rd, f"{side}.mid_res_0", f"{side}.mid.block_1")
    if cfg.attn_type != "none":
        _map_vae_attn(rd, f"{side}.mid_attn", f"{side}.mid.attn_1")
    _map_vae_res(rd, f"{side}.mid_res_1", f"{side}.mid.block_2")


def _map_ldm_backbone(rd: _Reader, cfg: VAEConfig) -> None:
    """The ldm Encoder / Decoder shared by the KL and VQ first stages, with
    the in-level attention of ``attn_resolutions``."""
    n_levels = len(cfg.ch_mult)
    rd.weight("encoder.conv_in", "encoder.conv_in")
    for lv in range(n_levels):
        for j in range(cfg.num_res_blocks):
            _map_vae_res(rd, f"encoder.down_{lv}_res_{j}",
                         f"encoder.down.{lv}.block.{j}")
            if cfg.level_attn(lv):
                _map_vae_attn(rd, f"encoder.down_{lv}_attn_{j}",
                              f"encoder.down.{lv}.attn.{j}")
        if lv != n_levels - 1:
            rd.weight(f"encoder.down_{lv}_downsample",
                      f"encoder.down.{lv}.downsample.conv")
    _map_vae_mid(rd, "encoder", cfg)
    rd.norm("encoder.norm_out", "encoder.norm_out")
    rd.weight("encoder.conv_out", "encoder.conv_out")
    rd.weight("decoder.conv_in", "decoder.conv_in")
    _map_vae_mid(rd, "decoder", cfg)
    for lv in range(n_levels):        # torch's ``up`` is indexed by level
        for j in range(cfg.num_res_blocks + 1):
            _map_vae_res(rd, f"decoder.up_{lv}_res_{j}",
                         f"decoder.up.{lv}.block.{j}")
            if cfg.level_attn(lv):
                _map_vae_attn(rd, f"decoder.up_{lv}_attn_{j}",
                              f"decoder.up.{lv}.attn.{j}")
        if lv != 0:
            rd.weight(f"decoder.up_{lv}_upsample",
                      f"decoder.up.{lv}.upsample.conv")
    rd.norm("decoder.norm_out", "decoder.norm_out")
    rd.weight("decoder.conv_out", "decoder.conv_out")
    rd.weight("quant_conv", "quant_conv")
    rd.weight("post_quant_conv", "post_quant_conv")


def convert_vae(state: Mapping[str, torch.Tensor],
                cfg: VAEConfig = VAEConfig.sd_v1(),
                prefix: str = "first_stage_model.",
                used: Optional[Set[str]] = None) -> Dict[str, torch.Tensor]:
    """CompVis ``AutoencoderKL`` keys (``ldm.modules.diffusionmodules.model``
    Encoder / Decoder) -> ``models.vae.AutoencoderKL``'s state dict."""
    rd = _Reader(state, prefix, used)
    _map_ldm_backbone(rd, cfg)
    return rd.out


def export_vae(state: Mapping[str, torch.Tensor],
               cfg: VAEConfig = VAEConfig.sd_v1(),
               prefix: str = "first_stage_model.") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_vae`."""
    wr = _Writer(state, prefix)
    _map_ldm_backbone(wr, cfg)
    return wr.finish()


def convert_vq(state: Mapping[str, torch.Tensor], cfg: VAEConfig,
               prefix: str = "first_stage_model.",
               used: Optional[Set[str]] = None) -> Dict[str, torch.Tensor]:
    """A ``VQModel(Interface)`` first stage -> ``models.vq.VQModel``'s state
    dict: the KL backbone's keys plus the codebook
    (``quantize.embedding.weight``, taming's ``VectorQuantizer2``)."""
    rd = _Reader(state, prefix, used)
    _map_vq(rd, cfg)
    return rd.out


def export_vq(state: Mapping[str, torch.Tensor], cfg: VAEConfig,
              prefix: str = "first_stage_model.") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_vq`."""
    wr = _Writer(state, prefix)
    _map_vq(wr, cfg)
    return wr.finish()


def _map_vq(rd, cfg: VAEConfig) -> None:
    _map_ldm_backbone(rd, cfg)
    rd.copy("quantize.weight", "quantize.embedding.weight")


def convert_bert_text(state: Mapping[str, torch.Tensor], depth: int,
                      prefix: str = "cond_stage_model.transformer.",
                      used: Optional[Set[str]] = None
                      ) -> Dict[str, torch.Tensor]:
    """x-transformers ``TransformerWrapper`` keys (``BERTEmbedder``) ->
    ``models.bert_text.BERTTextEncoder``'s state dict.  The layer list
    alternates attention and feed-forward entries, each a ``ModuleList([norm,
    block, residual])``; ``to_logits`` is not read (the embedder returns
    embeddings)."""
    rd = _Reader(state, prefix, used)
    _map_bert(rd, depth)
    return rd.out


def export_bert_text(state: Mapping[str, torch.Tensor], depth: int,
                     prefix: str = "cond_stage_model.transformer."
                     ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_bert_text`."""
    wr = _Writer(state, prefix)
    _map_bert(wr, depth)
    return wr.finish()


def _map_bert(rd, depth: int) -> None:
    rd.copy("token_emb", "token_emb.weight")
    rd.copy("pos_emb", "pos_emb.emb.weight")
    for i in range(depth):
        a, f = f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}"
        rd.norm(f"attn_ln_{i}", f"{a}.0")
        for p in ("to_q", "to_k", "to_v"):
            rd.weight(f"attn_{i}.{p}", f"{a}.1.{p}", bias=False)
        rd.weight(f"attn_{i}.to_out", f"{a}.1.to_out")
        rd.norm(f"ff_ln_{i}", f"{f}.0")
        rd.weight(f"ff_{i}.fc1", f"{f}.1.net.0.0")
        rd.weight(f"ff_{i}.fc2", f"{f}.1.net.2")
    rd.norm("norm_out", "norm")


def convert_clip_text(state: Mapping[str, torch.Tensor],
                      layers: int = 12,
                      prefix: str = "cond_stage_model.transformer.",
                      used: Optional[Set[str]] = None
                      ) -> Dict[str, torch.Tensor]:
    """HF ``CLIPTextModel`` keys, with or without the ``text_model.`` level
    -> ``models.clip_text.CLIPTextEncoder``'s state dict."""
    if any(k.startswith(prefix + "text_model.") for k in state):
        prefix += "text_model."
    rd = _Reader(state, prefix, used)
    rd.put("token_embedding.weight",
           rd.take("embeddings.token_embedding.weight"))
    rd.put("position_embedding",
           rd.take("embeddings.position_embedding.weight"))
    for i in range(layers):
        s, d = f"encoder.layers.{i}", f"layer_{i}"
        rd.norm(f"{d}.ln1", f"{s}.layer_norm1")
        rd.norm(f"{d}.ln2", f"{s}.layer_norm2")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rd.weight(f"{d}.{p}", f"{s}.self_attn.{p}")
        rd.weight(f"{d}.fc1", f"{s}.mlp.fc1")
        rd.weight(f"{d}.fc2", f"{s}.mlp.fc2")
    rd.norm("final_ln", "final_layer_norm")
    return rd.out


def convert_iresnet(state: Mapping[str, torch.Tensor],
                    layers: Sequence[int] = (3, 13, 30, 3),
                    used: Optional[Set[str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """insightface ``iresnet`` keys -> ``models.iresnet.IResNet``'s state
    dict: BatchNorm statistics into FrozenBN's buffers, PReLU ``weight`` into
    ``alpha``, and ``fc``'s input dimension reordered from insightface's
    channel-major flatten (C, H, W) to the port's (H, W, C)."""
    rd = _Reader(state, "", used)
    rd.weight("stem_conv", "conv1")
    rd.bn("stem_bn", "bn1")
    rd.put("stem_prelu.alpha", rd.take("prelu.weight"))
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            s, d = f"layer{li + 1}.{bi}", f"layer{li + 1}_block{bi}"
            rd.bn(f"{d}.bn1", f"{s}.bn1")
            rd.weight(f"{d}.conv1", f"{s}.conv1")
            rd.bn(f"{d}.bn2", f"{s}.bn2")
            rd.put(f"{d}.prelu.alpha", rd.take(f"{s}.prelu.weight"))
            rd.weight(f"{d}.conv2", f"{s}.conv2")
            rd.bn(f"{d}.bn3", f"{s}.bn3")
            if rd.has(f"{s}.downsample.0.weight"):
                rd.weight(f"{d}.down_conv", f"{s}.downsample.0")
                rd.bn(f"{d}.down_bn", f"{s}.downsample.1")
    rd.bn("head_bn", "bn2")
    fc_w = rd.take("fc.weight")                   # (out, C * H * W)
    C = rd.out["head_bn.mean"].shape[0]
    side = int(round((fc_w.shape[1] // C) ** 0.5))
    if C * side * side != fc_w.shape[1]:
        raise ValueError(f"fc.weight {tuple(fc_w.shape)} does not follow a "
                         f"square map of {C} channels")
    rd.put("fc.weight", fc_w.reshape(-1, C, side, side).permute(0, 2, 3, 1)
           .reshape(fc_w.shape[0], -1).contiguous())
    rd.put("fc.bias", rd.take("fc.bias"))
    rd.bn("features", "features")
    return rd.out


def _tensors(tree) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in tree.items() if isinstance(v, torch.Tensor)}


def load_sd_checkpoint(path: str, unet_cfg: UNetConfig = UNetConfig.sd_v1(),
                       vae_cfg: VAEConfig = VAEConfig.sd_v1(),
                       clip_cfg: CLIPTextConfig = CLIPTextConfig.sd_v1()
                       ) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                  List[str]]:
    """An ``sd-v1-4.ckpt`` -> ``({"unet", "vae", "clip"} state dicts, the
    keys not used)``.  The unused keys of the real file are the DDPM buffers
    (``betas``, ``alphas_cumprod``, ...), ``model_ema.*`` and the like."""
    ckpt = load_pt(path)
    state = _tensors(ckpt.get("state_dict", ckpt))
    used: Set[str] = set()
    out = {"unet": convert_unet(state, unet_cfg, used=used),
           "vae": convert_vae(state, vae_cfg, used=used),
           "clip": convert_clip_text(state, clip_cfg.layers, used=used)}
    return out, sorted(set(state) - used)


def load_iresnet_checkpoint(path: str, layers: Sequence[int] = (3, 13, 30, 3)
                            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A CosFace ``backbone.pth`` -> (the IResNet's state dict, the keys not
    used: ``num_batches_tracked``)."""
    state = _tensors(load_pt(path))
    used: Set[str] = set()
    out = convert_iresnet(state, layers, used=used)
    return out, sorted(set(state) - used)
