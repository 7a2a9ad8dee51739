"""The x-transformers library in its full generality.

Counterpart of ``celebbasis_tpu/models/xtransformer.py``: the reference's
stripped x-transformers copy with every knob, not only the default path that
``BERTEmbedder`` uses (that one is ``models/bert_text.py``, on the flash
kernel).  A ``TransformerWrapper(Encoder(...))`` of any configuration gives
the same numbers here.

Knobs: LayerNorm / ScaleNorm / RMSNorm / Rezero norms (the rezero gate
wraps attention layers only, FF layers run ungated with an identity norm, as
in the reference); the default, cross_attend and only_cross layer plans,
custom_layers, par_ratio PAR blocks and sandwich_coef; macaron (the intended
semantics, a 0.5-scaled pre-block FF; the reference's own macaron path
raises); talking heads, sparse_topk, num_mem_kv memory key/values, on_attn
GLU output, causal masking with a memory offset, input and context masks,
residual_attn / cross_residual_attn pre-softmax accumulation, shortformer
per-layer ``mems``, position-infused sinusoidal embeddings; pre_norm=False,
gate_residual GRU gating; and in the wrapper emb_dim != dim projection,
tie_embedding logits, num_memory_tokens, use_pos_emb=False,
return_embeddings / return_mems (max_mem_len truncation) / return_attn, and
the embedding_manager hook right after the token lookup.

Several knobs need the explicit score matrix (talking heads, sparse_topk,
residual_attn, the attention maps), so this library keeps plain fp32
einsum attention, as the JAX module does; sequences are short (77 tokens).
Attribute names follow the flax tree (``attn_layers.layers_0_attn.to_q``,
``attn_layers.layers_0_norm``, ``attn_layers.layers_0_rezero_g`` ...), so
``utils.bridge.from_jax_params`` carries weights across;
``utils.bridge_xt.convert_xtransformer`` reads the reference's state dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_DIM_HEAD = 64
_MASK_VALUE = -torch.finfo(torch.float32).max


def compute_layer_types(depth: int,
                        cross_attend: bool = False,
                        only_cross: bool = False,
                        macaron: bool = False,
                        custom_layers: Optional[Sequence[str]] = None,
                        par_ratio: Optional[int] = None,
                        sandwich_coef: Optional[int] = None
                        ) -> Tuple[str, ...]:
    """The reference's layer-plan resolution."""
    if cross_attend and not only_cross:
        default_block: Tuple[str, ...] = ("a", "c", "f")
    elif cross_attend and only_cross:
        default_block = ("c", "f")
    else:
        default_block = ("a", "f")
    if macaron:
        default_block = ("f",) + default_block

    if custom_layers is not None:
        return tuple(custom_layers)
    if par_ratio is not None:
        par_depth = depth * len(default_block)
        assert 1 < par_ratio <= par_depth, "par ratio out of range"
        default_block = tuple(t for t in default_block if t != "f")
        par_attn = par_depth // par_ratio
        depth_cut = par_depth * 2 // 3  # the PAR paper's 2/3 attention cut
        par_width = (depth_cut + depth_cut // par_attn) // par_attn
        assert len(default_block) <= par_width, \
            "default block is too large for par_ratio"
        par_block = default_block + ("f",) * (par_width - len(default_block))
        par_head = par_block * par_attn
        return tuple(par_head) + ("f",) * (par_depth - len(par_head))
    if sandwich_coef is not None:
        assert 0 < sandwich_coef <= depth, \
            "sandwich coefficient should be less than the depth"
        return (("a",) * sandwich_coef
                + default_block * (depth - sandwich_coef)
                + ("f",) * sandwich_coef)
    return default_block * depth


@dataclass(frozen=True)
class XTConfig:
    """AttentionLayers knobs and the attn_ / ff_ kwargs."""
    dim: int
    depth: int
    heads: int = 8
    dim_head: int = DEFAULT_DIM_HEAD
    causal: bool = False
    cross_attend: bool = False
    only_cross: bool = False
    use_scalenorm: bool = False
    use_rmsnorm: bool = False
    use_rezero: bool = False
    position_infused_attn: bool = False
    custom_layers: Optional[Tuple[str, ...]] = None
    sandwich_coef: Optional[int] = None
    par_ratio: Optional[int] = None
    residual_attn: bool = False
    cross_residual_attn: bool = False
    macaron: bool = False
    pre_norm: bool = True
    gate_residual: bool = False
    talking_heads: bool = False
    sparse_topk: Optional[int] = None
    num_mem_kv: int = 0
    on_attn: bool = False
    ff_mult: int = 4
    ff_glu: bool = False

    @property
    def layer_types(self) -> Tuple[str, ...]:
        return compute_layer_types(
            self.depth, self.cross_attend, self.only_cross, self.macaron,
            self.custom_layers, self.par_ratio, self.sandwich_coef)

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for t in self.layer_types if t == "a")


# -- norms --------------------------------------------------------------------

class ScaleNorm(nn.Module):
    """Scalar-g L2 norm with an eps clamp."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        norm = x.norm(dim=-1, keepdim=True) * x.shape[-1] ** -0.5
        return x / norm.clamp_min(self.eps) * self.g


class RMSNorm(nn.Module):
    """Per-dim g, the same clamped-norm formula."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        norm = x.norm(dim=-1, keepdim=True) * x.shape[-1] ** -0.5
        return x / norm.clamp_min(self.eps) * self.g


def _sinusoid(n: int, dim: int, offset: int, device) -> torch.Tensor:
    """FixedPositionalEmbedding: [sin | cos], (1, n, dim)."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=device) / dim))
    t = torch.arange(n, dtype=torch.float32, device=device) + offset
    sin_inp = torch.einsum("i,j->ij", t, inv_freq)
    return torch.cat([sin_inp.sin(), sin_inp.cos()], dim=-1)[None]


# -- blocks -------------------------------------------------------------------

class XTFeedForward(nn.Module):
    """Linear -> exact GELU -> Linear, or GEGLU when ``glu``."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False):
        super().__init__()
        self.glu = glu
        inner = int(dim * mult)
        if glu:
            self.proj = nn.Linear(dim, inner * 2)
        else:
            self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x):
        if self.glu:
            h, gate = self.proj(x).chunk(2, dim=-1)
            h = h * F.gelu(gate)
        else:
            h = F.gelu(self.fc1(x))
        return self.fc2(h)


class XTAttention(nn.Module):
    """Attention with every extra; returns (out, pre-softmax scores,
    post-softmax attention)."""

    def __init__(self, cfg: XTConfig, causal: bool = False):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        h, dh, d = cfg.heads, cfg.dim_head, cfg.dim
        inner = h * dh
        self.to_q = nn.Linear(d, inner, bias=False)
        self.to_k = nn.Linear(d, inner, bias=False)
        self.to_v = nn.Linear(d, inner, bias=False)
        self.to_out = nn.Linear(inner, 2 * d if cfg.on_attn else d)
        if cfg.num_mem_kv > 0:
            self.mem_k = nn.Parameter(torch.randn(h, cfg.num_mem_kv, dh))
            self.mem_v = nn.Parameter(torch.randn(h, cfg.num_mem_kv, dh))
        if cfg.talking_heads:
            self.pre_softmax_proj = nn.Parameter(torch.randn(h, h))
            self.post_softmax_proj = nn.Parameter(torch.randn(h, h))

    def forward(self, x, context=None, mask=None, context_mask=None,
                pia_emb: bool = False, prev_attn=None, mem=None):
        cfg = self.cfg
        h, dh = cfg.heads, cfg.dim_head
        b, n, d = x.shape
        kv_input = x if context is None else context
        q_input, k_input, v_input = x, kv_input, kv_input
        if mem is not None:
            k_input = torch.cat([mem, k_input], dim=-2)
            v_input = torch.cat([mem, v_input], dim=-2)
        if pia_emb:
            offset = k_input.shape[-2] - q_input.shape[-2]
            q_input = q_input + _sinusoid(q_input.shape[1], d, offset,
                                          x.device)
            k_input = k_input + _sinusoid(k_input.shape[1], d, 0, x.device)

        split = lambda t: t.reshape(b, t.shape[1], h, dh).transpose(1, 2)
        q = split(self.to_q(q_input))
        k = split(self.to_k(k_input))
        v = split(self.to_v(v_input))

        input_mask = None
        if mask is not None or context_mask is not None:
            q_mask = (torch.ones((b, n), dtype=torch.bool, device=x.device)
                      if mask is None else mask)
            k_mask = q_mask if context is None else context_mask
            if k_mask is None:
                k_mask = torch.ones((b, k.shape[-2]), dtype=torch.bool,
                                    device=x.device)
            input_mask = q_mask[:, None, :, None] & k_mask[:, None, None, :]

        if cfg.num_mem_kv > 0:
            k = torch.cat([self.mem_k.expand(b, -1, -1, -1), k], dim=-2)
            v = torch.cat([self.mem_v.expand(b, -1, -1, -1), v], dim=-2)
            if input_mask is not None:
                input_mask = F.pad(input_mask, (cfg.num_mem_kv, 0),
                                   value=True)

        dots = torch.einsum("bhid,bhjd->bhij", q, k) * (dh ** -0.5)
        if prev_attn is not None:
            dots = dots + prev_attn
        pre_softmax = dots
        if cfg.talking_heads:
            dots = torch.einsum("bhij,hk->bkij", dots, self.pre_softmax_proj)
        if input_mask is not None:
            dots = dots.masked_fill(~input_mask, _MASK_VALUE)
        if self.causal:
            i, j = dots.shape[-2:]
            r_i = torch.arange(i, device=x.device)[:, None]
            r_j = torch.arange(j, device=x.device)[None, :]
            dots = dots.masked_fill(((r_j - (j - i)) > r_i)[None, None],
                                    _MASK_VALUE)
        if cfg.sparse_topk is not None and cfg.sparse_topk < dots.shape[-1]:
            vk = dots.topk(cfg.sparse_topk, dim=-1).values[..., -1:]
            dots = dots.masked_fill(dots < vk, _MASK_VALUE)

        attn = dots.softmax(dim=-1)
        post_softmax = attn
        if cfg.talking_heads:
            attn = torch.einsum("bhij,hk->bkij", attn, self.post_softmax_proj)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))
        if cfg.on_attn:
            a, g = out.chunk(2, dim=-1)
            out = a * torch.sigmoid(g)
        return out, pre_softmax, post_softmax


class _GRUGate(nn.Module):
    """GRUGating: ``torch.nn.GRUCell(out, residual)`` arithmetic."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.randn(3 * dim, dim) * dim ** -0.5)
        self.weight_hh = nn.Parameter(torch.randn(3 * dim, dim) * dim ** -0.5)
        self.bias_ih = nn.Parameter(torch.zeros(3 * dim))
        self.bias_hh = nn.Parameter(torch.zeros(3 * dim))

    def forward(self, x, residual):
        gi = x @ self.weight_ih.t() + self.bias_ih
        gh = residual @ self.weight_hh.t() + self.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        nst = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * nst + z * residual


class XTAttentionLayers(nn.Module):
    """AttentionLayers: the whole layer plan with every knob."""

    def __init__(self, cfg: XTConfig):
        super().__init__()
        self.cfg = cfg
        for ind, lt in enumerate(cfg.layer_types):
            if cfg.use_rezero:
                norm = None
            elif cfg.use_rmsnorm:
                norm = RMSNorm(cfg.dim)
            elif cfg.use_scalenorm:
                norm = ScaleNorm()
            else:
                norm = nn.LayerNorm(cfg.dim, eps=1e-5)
            if norm is not None:
                setattr(self, f"layers_{ind}_norm", norm)
            if lt == "a":
                block = XTAttention(cfg, causal=cfg.causal)
            elif lt == "c":
                block = XTAttention(cfg, causal=False)
            elif lt == "f":
                block = XTFeedForward(cfg.dim, cfg.ff_mult, cfg.ff_glu)
            else:
                raise ValueError(f"invalid layer type {lt}")
            setattr(self, f"layers_{ind}_{'ff' if lt == 'f' else 'attn'}",
                    block)
            if lt in ("a", "c") and cfg.use_rezero:
                setattr(self, f"layers_{ind}_rezero_g",
                        nn.Parameter(torch.zeros(1)))
            if cfg.gate_residual:
                setattr(self, f"layers_{ind}_gru", _GRUGate(cfg.dim))

    def _norm(self, ind: int, x):
        norm = getattr(self, f"layers_{ind}_norm", None)
        return x if norm is None else norm(x)

    def forward(self, x, context=None, mask=None, context_mask=None,
                mems: Optional[List[Optional[torch.Tensor]]] = None,
                return_hiddens: bool = False):
        cfg = self.cfg
        layer_types = cfg.layer_types
        mems = list(mems) if mems is not None \
            else [None] * cfg.num_attn_layers
        hiddens, attn_maps = [], []
        prev_attn = prev_cross_attn = None
        for ind, lt in enumerate(layer_types):
            is_last = ind == len(layer_types) - 1
            layer_mem = None
            if lt == "a":
                hiddens.append(x)
                layer_mem = mems.pop(0)
            residual = x
            if cfg.pre_norm:
                x = self._norm(ind, x)
            if lt == "a":
                out, pre, post = getattr(self, f"layers_{ind}_attn")(
                    x, mask=mask, pia_emb=cfg.position_infused_attn,
                    prev_attn=prev_attn, mem=layer_mem)
            elif lt == "c":
                out, pre, post = getattr(self, f"layers_{ind}_attn")(
                    x, context=context, mask=mask, context_mask=context_mask,
                    prev_attn=prev_cross_attn)
            else:
                out = getattr(self, f"layers_{ind}_ff")(x)
                if cfg.macaron:
                    out = out * 0.5
            if lt in ("a", "c") and cfg.use_rezero:
                out = out * getattr(self, f"layers_{ind}_rezero_g")
            if cfg.gate_residual:
                x = getattr(self, f"layers_{ind}_gru")(out, residual)
            else:
                x = out + residual
            if lt == "a":
                attn_maps.append(post)
                if cfg.residual_attn:
                    prev_attn = pre
            elif lt == "c":
                attn_maps.append(post)
                if cfg.cross_residual_attn:
                    prev_cross_attn = pre
            if not cfg.pre_norm and not is_last:
                x = self._norm(ind, x)
        if return_hiddens:
            return x, (hiddens, attn_maps)
        return x


class XTEncoder(XTAttentionLayers):
    """Encoder: causal must stay False."""

    def __init__(self, cfg: XTConfig):
        assert not cfg.causal, "cannot set causality on encoder"
        super().__init__(cfg)


@dataclass(frozen=True)
class XTWrapperConfig:
    """TransformerWrapper knobs."""
    num_tokens: int
    max_seq_len: int
    emb_dim: Optional[int] = None
    max_mem_len: int = 0
    num_memory_tokens: int = 0
    tie_embedding: bool = False
    use_pos_emb: bool = True


class XTransformerWrapper(nn.Module):
    """TransformerWrapper, every return mode and the TI hook; float32."""

    def __init__(self, wcfg: XTWrapperConfig, cfg: XTConfig):
        super().__init__()
        self.wcfg, self.cfg = wcfg, cfg
        emb_dim = wcfg.emb_dim if wcfg.emb_dim is not None else cfg.dim
        self.token_emb = nn.Parameter(
            torch.randn(wcfg.num_tokens, emb_dim) * 0.02)
        if wcfg.use_pos_emb and not cfg.position_infused_attn:
            self.pos_emb = nn.Parameter(
                torch.randn(wcfg.max_seq_len, emb_dim) * 0.02)
        if emb_dim != cfg.dim:
            self.project_emb = nn.Linear(emb_dim, cfg.dim)
        if wcfg.num_memory_tokens > 0:
            self.memory_tokens = nn.Parameter(
                torch.randn(wcfg.num_memory_tokens, cfg.dim))
        self.attn_layers = XTAttentionLayers(cfg)
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-5)
        if not wcfg.tie_embedding:
            self.to_logits = nn.Linear(cfg.dim, wcfg.num_tokens)

    def forward(self, ids: torch.Tensor, return_embeddings: bool = False,
                mask=None, context=None, context_mask=None,
                mems: Optional[List[torch.Tensor]] = None,
                return_mems: bool = False, return_attn: bool = False,
                inject: Optional[Callable] = None):
        w = self.wcfg
        b, n = ids.shape
        x = self.token_emb[ids]
        if inject is not None:
            x = inject(ids, x)
        if hasattr(self, "pos_emb"):
            x = x + self.pos_emb[None, :n]
        if hasattr(self, "project_emb"):
            x = self.project_emb(x)
        if w.num_memory_tokens > 0:
            x = torch.cat([self.memory_tokens.expand(b, -1, -1), x], dim=1)
            if mask is not None:
                mask = F.pad(mask, (w.num_memory_tokens, 0), value=True)
        x, (hiddens, maps) = self.attn_layers(
            x, context=context, mask=mask, context_mask=context_mask,
            mems=mems, return_hiddens=True)
        x = self.norm(x)[:, w.num_memory_tokens:]
        if return_embeddings:
            out = x
        elif w.tie_embedding:
            out = x @ self.token_emb.t()
        else:
            out = self.to_logits(x)
        if return_mems:
            new_mems = ([torch.cat(pair, dim=-2)
                         for pair in zip(mems, hiddens)]
                        if mems is not None else hiddens)
            return out, [t[..., -w.max_mem_len:, :].detach()
                         for t in new_mems]
        if return_attn:
            return out, maps
        return out
