"""Run assembly: spec + checkpoints -> pipeline, basis, manager state.

Counterpart of ``celebbasis_tpu/loader.py``: builds the model bundle on the
asked device (random-init from a seed; the pretrained weights are not
vendored), constructs/caches the celeb basis from the float32 token table
before any storage cast, and sets up the manager state.

``device`` defaults to ``"cuda"``.  With no card and no explicit
``device="cpu"`` this raises: nothing carries on on the CPU by itself.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from celebbasis_tpu_torch.core import manager as mgr
from celebbasis_tpu_torch.core.basis import (build_celeb_basis,
                                             build_celeb_basis_cached)
from celebbasis_tpu_torch.pipeline import CelebBasisPipeline, PipelineConfig
from celebbasis_tpu_torch.text.tokenizer import (CLIPTokenizer,
                                                 default_tokenizer)
from celebbasis_tpu_torch.utils.config import RunSpec
from celebbasis_tpu_torch.utils.precision import cast_float_params

# fallback names when the celeb list file is absent (offline test envs)
_FALLBACK_NAMES = [
    "Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
    "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson",
    "Leonardo DiCaprio", "Oprah Winfrey", "Keanu Reeves", "Rihanna",
    "Tom Hanks", "Beyonce Knowles", "Morgan Freeman", "Natalie Portman",
    "Will Smith", "Angelina Jolie", "Denzel Washington", "Meryl Streep",
]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise; raises when CUDA is asked for (or defaulted to) without a
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "celebbasis_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' (--device cpu) to run on the CPU "
            "on purpose")
    return dev


@dataclass
class Assembled:
    spec: RunSpec
    tokenizer: CLIPTokenizer
    pipeline: CelebBasisPipeline
    basis: torch.Tensor              # (es, 1+inner, width)
    meta_net: None                   # MetaIdNet: not ported yet
    manager_state: mgr.ManagerState
    device: torch.device


def pipeline_config_from_spec(spec: RunSpec, dtype=torch.bfloat16
                              ) -> PipelineConfig:
    return PipelineConfig(
        unet=spec.unet, vae=spec.vae, clip=spec.clip, basis=spec.basis,
        placeholder_strings=spec.placeholder_strings,
        scale_factor=spec.scale_factor, timesteps=spec.timesteps,
        linear_start=spec.linear_start, linear_end=spec.linear_end,
        dtype=dtype)


def init_weights(module: nn.Module, generator: torch.Generator,
                 zero_convs: bool = True) -> nn.Module:
    """Random-init from ``generator`` (whose device the draws are made on),
    in the spirit of the flax initialisers: LeCun-normal kernels, zero
    biases, unit norm scales, N(0, 0.01) position table, N(0, 1) token
    table.  ``zero_convs=True`` keeps the reference's zero-initialised output
    convs (with them a random-init UNet predicts eps = 0);
    ``zero_convs=False`` draws them like any other kernel, for smoke runs in
    which every layer should matter."""
    from celebbasis_tpu_torch.ops.basic import ZeroConv

    zero = set()
    if zero_convs:
        for m in module.modules():
            if isinstance(m, ZeroConv):
                zero.update(id(p) for p in m.parameters())
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if id(p) in zero or leaf == "bias":
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                if leaf == "position_embedding":
                    std = 0.01
                elif name.endswith("token_embedding.weight"):
                    std = 1.0
                else:
                    std = (p[0].numel()) ** -0.5       # fan_in
                draw = torch.randn(p.shape, generator=generator,
                                   device=generator.device) * std
                p.copy_(draw.to(device=p.device, dtype=p.dtype))
    return module


def assemble(spec: RunSpec, *, sd_ckpt: Optional[str] = None,
             vocab_path: Optional[str] = None,
             embedding_ckpt: Optional[str] = None,
             image_size: int = 512, seed: int = 0,
             dtype=torch.bfloat16,
             cache_dir: Optional[str] = ".cache/celeb_basis",
             param_dtype=None, device=None) -> Assembled:
    """``param_dtype=torch.bfloat16`` casts the frozen SD weights to bf16
    *storage* (inference only).  The celeb basis is always built from the
    float32 token table before that cast."""
    dev = resolve_device(device)
    if sd_ckpt:
        raise NotImplementedError(
            "loading CompVis/HF checkpoints is not ported yet; the port "
            "runs on random-init weights or on weights carried over with "
            "utils.bridge.load_jax_params")
    tokenizer = default_tokenizer(vocab_path)
    if tokenizer.vocab_size != spec.clip.vocab_size:
        # offline synthetic fallback must match the model's embedding table
        tokenizer = CLIPTokenizer.synthetic(spec.clip.vocab_size)
    with torch.device(dev):      # parameters are created on the device
        pipe = CelebBasisPipeline(pipeline_config_from_spec(spec, dtype),
                                  tokenizer)
    pipe.requires_grad_(False).eval()
    pipe.manager_cfg = manager_config_from_spec(spec, pipe)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_weights(pipe, gen)

    # celeb basis (cached), from the float32 table
    table = pipe.token_table()
    if os.path.exists(spec.celeb_txt):
        basis = build_celeb_basis_cached(spec.celeb_txt, tokenizer, table,
                                         spec.basis, cache_dir=cache_dir)
    else:
        print(f"[loader] celeb list {spec.celeb_txt!r} not found -- "
              f"using builtin fallback names")
        basis = build_celeb_basis(_FALLBACK_NAMES, tokenizer, table,
                                  spec.basis)

    # manager state, optionally from a trained embeddings_gs-*.pt
    m_cfg = pipe.manager_cfg
    init_emb = None
    if spec.initializer_words:
        tok_id = tokenizer.tokenize(spec.initializer_words[0])[0]
        init_emb = torch.from_numpy(table[tok_id].copy())
    state = mgr.init_state(m_cfg, gen, init_emb, device=dev)
    if embedding_ckpt:
        state = mgr.load_checkpoint(m_cfg, embedding_ckpt, state, device=dev)
        print(f"[loader] loaded personalization checkpoint {embedding_ckpt}")

    if param_dtype is not None:
        cast_float_params(pipe, param_dtype)

    return Assembled(spec, tokenizer, pipe,
                     torch.from_numpy(basis).to(dev), None, state, dev)


def manager_config_from_spec(spec: RunSpec, pipe: CelebBasisPipeline
                             ) -> mgr.ManagerConfig:
    return mgr.ManagerConfig(
        placeholder_token_ids=pipe.manager_cfg.placeholder_token_ids,
        max_ids=spec.max_ids, num_es=spec.num_embeds_per_token,
        heads=spec.meta_heads, inner_dim=spec.meta_inner_dim,
        token_dim=spec.clip.width, momentum=spec.momentum,
        test_mode=spec.test_mode, loss_type=spec.loss_type,
        save_fp16=spec.save_fp16)
