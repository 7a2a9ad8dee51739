"""x-transformers (full generality) state dict -> the port's
``models.xtransformer.XTransformerWrapper``.

Counterpart of ``celebbasis_tpu/utils/bridge_xt.py``: maps a reference
``TransformerWrapper`` state dict of any knob combination onto the port's
names, resolving the same layer plan the reference builds (rezero's
``.1.fn`` nesting, macaron's ``Scale`` nesting, the norms' parameters, GRU
residual cells, talking-heads and memory key/value extras,
``to_logits`` / ``memory_tokens``).  torch's layouts are the port's, so
nothing is transposed.  The BERT default path keeps its own converter
(``bridge.convert_bert_text``).  ``from_jax_params`` is
``bridge.from_jax_params`` that also knows the module's own leaves.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from celebbasis_tpu_torch.models.xtransformer import XTConfig, XTWrapperConfig
from celebbasis_tpu_torch.utils import bridge
from celebbasis_tpu_torch.utils.bridge import _Reader

# leaves stored as torch stores them: norm gains, the attention's memory
# key/values and talking-heads projections, memory tokens, the GRU cells,
# and the rezero gates, whose names carry their layer
_LEAVES = {"g", "mem_k", "mem_v", "pre_softmax_proj", "post_softmax_proj",
           "memory_tokens", "weight_ih", "weight_hh", "bias_ih", "bias_hh"}
_REZERO = re.compile(r"layers_\d+_rezero_g")


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``XTransformerWrapper`` params tree -> the port's state
    dict."""
    return bridge.from_jax_params(
        tree, keep=lambda key: key in _LEAVES or bool(_REZERO.fullmatch(key)))


def convert_xtransformer(state: Mapping[str, torch.Tensor],
                         wcfg: XTWrapperConfig, cfg: XTConfig,
                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """-> the wrapper's state dict; raises on a key the plan does not
    read."""
    state = {k: v for k, v in state.items() if k.startswith(prefix)}
    rd = _Reader(state, prefix)
    rd.put("token_emb", rd.take("token_emb.weight"))
    if wcfg.use_pos_emb and not cfg.position_infused_attn:
        rd.put("pos_emb", rd.take("pos_emb.emb.weight"))
    emb_dim = wcfg.emb_dim if wcfg.emb_dim is not None else cfg.dim
    if emb_dim != cfg.dim:
        rd.weight("project_emb", "project_emb")
    if wcfg.num_memory_tokens > 0:
        rd.put("memory_tokens", rd.take("memory_tokens"))
    if cfg.position_infused_attn:
        # a fixed buffer, recomputed by the module
        rd.take("attn_layers.pia_pos_emb.inv_freq")
    rd.norm("norm", "norm")
    if rd.has("to_logits.weight"):        # absent under tie_embedding
        rd.weight("to_logits", "to_logits")

    for ind, lt in enumerate(cfg.layer_types):
        t, dst = f"attn_layers.layers.{ind}", f"attn_layers.layers_{ind}"
        if cfg.use_rezero:
            pass                          # identity norm, no parameters
        elif cfg.use_scalenorm or cfg.use_rmsnorm:
            rd.put(f"{dst}_norm.g", rd.take(f"{t}.0.g"))
        else:
            rd.norm(f"{dst}_norm", f"{t}.0")
        blk = f"{t}.1"
        if lt in ("a", "c"):
            if cfg.use_rezero:
                rd.put(f"{dst}_rezero_g", rd.take(f"{blk}.g"))
                blk = f"{blk}.fn"
            for p in ("to_q", "to_k", "to_v"):
                rd.weight(f"{dst}_attn.{p}", f"{blk}.{p}", bias=False)
            rd.weight(f"{dst}_attn.to_out",
                      f"{blk}.to_out.0" if cfg.on_attn else f"{blk}.to_out")
            extras = (("pre_softmax_proj", "post_softmax_proj")
                      if cfg.talking_heads else ()) + \
                (("mem_k", "mem_v") if cfg.num_mem_kv > 0 else ())
            for p in extras:
                rd.put(f"{dst}_attn.{p}", rd.take(f"{blk}.{p}"))
        else:
            if cfg.macaron:
                blk = f"{blk}.fn"
            if cfg.ff_glu:
                rd.weight(f"{dst}_ff.proj", f"{blk}.net.0.proj")
            else:
                rd.weight(f"{dst}_ff.fc1", f"{blk}.net.0.0")
            rd.weight(f"{dst}_ff.fc2", f"{blk}.net.2")
        if cfg.gate_residual:
            for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                rd.put(f"{dst}_gru.{p}", rd.take(f"{t}.2.gru.{p}"))

    leftover = sorted(set(state) - rd.used)
    if leftover:
        raise ValueError(f"unmapped x_transformer keys: {leftover[:8]}")
    return rd.out
