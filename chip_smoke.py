#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once each at full Stable Diffusion v1 width on
random weights -- serving (``celebbasis_tpu_torch.cli.serve``, txt2img and
live faces), personalisation training (``celebbasis_tpu_torch.train``, and
``cli/train.py`` from synthetic checkpoints in the real files' formats),
generation through the CLIs (``cli/{txt2img,img2img,build_basis,extract}``,
and the DDPM chain), the textual-inversion baseline (``cli/train_ti``,
``cli/merge``, ``txt2img --ti_embedding``), the evaluation
(``cli/gen_imgs``, ``cli/eval_imgs``), face alignment (``cli/align``), the
landmark trainers (``cli/preprocess_pipnet``, ``cli/train_pipnet``,
``cli/train_pipnet_gssl``) and the legacy latent-diffusion family
(``cli/evaluate_model``, ``cli/sample_diffusion``, ``cli/inpaint``, and its
training side: ``cli/train_legacy``, ``cli/train_ae``, the noisy-latent
classifier) -- and
holds every hand-written kernel against its plain PyTorch version.  Phases:

1. ``env``     the card, its power limit, torch / CUDA / nvcc versions;
2. ``build``   builds the kernel libraries from ``celebbasis_tpu_torch/csrc``,
               one ``nvcc`` per source, all started together, and records
               the bf16 forward's and backward's instantiations at each
               padded head dim and the bf16 GEGLU kernel's at each SD v1
               width (tiles or cluster, registers, spills, HGMMA and HMMA in
               the SASS), and the int8 library's kernels (IGMMA and IMMA,
               registers, spills) with its plan at each timed shape;
3. ``kernels`` the inference forward (both entry points) at the serving
               path's shapes, and the training forward (with logsumexp), dq
               and dk/dv kernels at the train step's shapes, against their
               plain versions (the error limit scales with the values
               compared), with device times, bounds and a library yardstick
               (``F.scaled_dot_product_attention`` and autograd through it,
               called here and nowhere in the port), and the forward's grid
               (blocks and waves) at each timed shape; the two GEGLU kernels
               (FF sub-block with and without LN and residual) at the
               serving and training shapes in bf16 and fp32, and
               ``int8_matmul`` at the UNet's projection shapes and two ragged
               ones, in every mode that can run each shape, bit for bit, and
               on every bf16 value its quantisation tells apart; the
               packed forward at the scorer's ViT-B/32 shape (12 heads, 50
               tokens, D = 64; batches 2 and 32; fp32 and bf16, timed); and
               both forward entries at the legacy family's shapes (timed):
               the CelebA-HQ UNet's AttentionBlocks (D = 32, 14, 21 and 28
               heads at 1024, 256 and 64 tokens; the per-head entry on
               strided slices of one interleaved qkv projection, as the
               block hands them over, here and below), BERT's attention (8
               heads, D = 64, 77 tokens) and the tiny inpainting UNet's
               mid-block AttentionBlock (one image, 8 heads, D = 8, 64
               tokens), with a peaked softmax too at 21 heads and at D = 8;
               and the training forward, dq and dk/dv at the legacy train
               steps' shapes (timed): the CelebA-HQ AttentionBlocks' views
               at batch 48 (interleaved q/k/v, the incoming gradient a
               per-head view too), BERT's 77 tokens and the 1p4B UNet's
               self- and cross-attention at each level at batch 4, with a
               peaked softmax at 21 heads, and the tiny classifier's
               AttentionBlock and AttentionPool2d (untimed); each split
               dk/dv launching its reduction;
4. ``parity``  the norms' bf16 branch with float32 parameters against the
               float32 formula rounded once (within one bf16 unit); the tiny
               pipeline in fp32 through the kernel route and through the
               plain route (attention, then GEGLU): pixels agree within one
               level; the tiny PLMS chain (5 steps, every order) and the
               tiny live-face function on both attention routes: float
               images within 1e-3, pixels within one level;
5. ``train_parity`` the tiny train step in fp32: loss and MLP gradients with
               attention, then GEGLU, on the kernel route against the plain
               route;
6. ``serve``   ``TxtToImgService`` on ``configs/aigc_id.yaml`` (bf16, 512x512,
               batch 2) behind the real ``ThreadingHTTPServer``: requests
               alone, co-batched, repeated, in both attention layouts, and
               with the GEGLU kernel route, and two ``/faces2img`` requests
               (two 512x512 crops, two images, the same bytes for the same
               seed); the kernels' launch counters must account for every
               UNet call; the warm-up captures the two routes' CUDA graphs
               (seconds each), a changed layout or GEGLU route captures its
               own (its warm-up's launches counted); then both routes on
               their graphs and eagerly in turns (graph, eager, eager,
               graph): the same bytes, the same launches a request, request
               ms and peak memory each way; and the DDIM chain alone,
               captured and eagerly: the final latents bit for bit;
7. ``align``   W0 at full width through ``cli/align.py``: synthetic
               ``FaceBoxesV2.pth`` and ``epoch59.pth`` (PIPNet ResNet-101,
               WFLW) of every key of their manifests, the detector's
               face-class biases set from the photos' logits (a quarter of
               the anchors pass 0.6, the best scores below 0.99), eight
               512x512 photos, ``--workers 4`` and ``--workers 1``: crops
               byte equal, the pickle read into a batch by
               ``data/face_id``, no hand-written kernel launched; one photo
               on the card against the CPU (boxes within 0.05 px before the
               integer cast, landmarks within 1 px); the C++ NMS against
               the numpy one; the OpenCV resampler copy against cv2 where
               cv2 imports; ms per photo by stage, NMS ms, peak memory;
8. ``align_train`` W0's training side at full width: synthetic raw WFLW,
               300W, CelebA and COFW layouts in the datasets' formats through
               ``cli/preprocess_pipnet.py`` (WFLW, CELEBA,
               data_300W_CELEBA); ``cli/train_pipnet.py`` on PIPNet
               ResNet-101 (98 landmarks, 10 neighbours, 256x256, stride 32,
               batch 16) for two epochs, whose ``epoch1.pth`` holds every
               key and shape of the PIPNet manifest; ``cli/align.py`` reading
               that file (its net equal to the trained state) on the align
               phase's photos; ``cli/train_pipnet_gssl.py`` on ResNet-18 (68
               landmarks, batch 16, the warmup and five curriculum rounds
               with augmentation); one step of each trainer from one state
               on the card against the CPU (loss, every leaf's gradient, the
               parameters after Adam); no hand-written kernel launched; ms a
               step, images per second, peak memory, walls;
9. ``checkpoint`` a synthetic ``sd-v1-4.ckpt`` (every key and shape of
               ``manifests/sd-v1-4.json``, fp32 from a seed, DDPM buffers,
               LitEma keys, Lightning callback objects of a class that cannot
               be imported when the file is read) and a synthetic fp16
               CosFace ``backbone.pth`` (``manifests/cosface_r100.json``),
               written, read (``utils/pt_io``), converted
               (``utils/bridge``) and loaded through ``loader.assemble``:
               every manifest key used, the extras reported, parameters read
               back equal to what was written; sizes, seconds, peak memory;
10. ``train``  ``Trainer.fit`` on ``configs/aigc_id.yaml`` (bf16 compute,
               512x512 images, batch 2, two 512x512 faces per sample,
               synthetic batches): a few uncached steps and two cached ones;
               losses, what moved and what stayed frozen, launch counters,
               the checkpoint, and one step's MLP gradient against the plain
               attention route; then the same gradient and a few uncached
               and cached steps with the GEGLU kernel route (every
               trainer's first step captures its graph: one step's launches
               more); the uncached, cached and eval steps on their graphs and
               eagerly in turns, four steps a run: losses, MLP gradients,
               MLP parameters after AdamW and the manager state bit for bit,
               launches, ms a step and peak memory each way; then
               ``cli/train.py`` from the checkpoint phase's files on a
               synthetic aligned-face pickle of 512x512 PNGs: six uncached
               steps (validation, TensorBoard, ``DeviceMonitor``, a sample
               grid) and six cached ones, with ms per step, ms each step
               waits on the loader, launches and peak memory;
11. ``generate`` the generation CLIs in process on ``configs/aigc_id.yaml``
               (bf16, 512x512, two samples, the output convs drawn): a
               20-step PLMS txt2img (21 UNet calls), txt2img on two face
               crops, a masked img2img at strength 0.5, each one graph; on
               one assembly img2img masked and plain on its graph and
               eagerly in turns (``graph_turns``), and ``DDPMChain`` over
               the full 1000-step schedule with guidance on its 20-step
               segment graph against one eager chain (latents and pixels
               bit for bit, launches a replay); ``build_basis`` and
               ``extract`` on the CLI training run's checkpoint (the
               files' shapes as the JAX package writes them).  Each with
               its wall time, peak memory, UNet calls and flash launches;
12. ``ti``     ``cli/train_ti.py`` at full width from the checkpoint
               phase's ``sd-v1-4.ckpt`` on three random-pixel 512x512 PNGs:
               six steps, each timed to a sync, peak memory and launches;
               the loss finite, the vectors moved, the UNet, CLIP and VAE
               unchanged and without gradients; the step on its graph and
               eagerly in turns (losses, gradient, vectors after AdamW bit
               for bit; ms a step each way); one step's loss and vector
               gradient on the kernel route against the plain route (cosine
               >= 0.99, |diff| / |grad| <= 0.1); ``cli/merge.py`` on its
               checkpoint and a renamed copy, and a 20-step
               ``txt2img --ti_embedding`` on the merged file (640 packed
               launches);
13. ``evaluate`` ``cli/gen_imgs.py`` at 512x512 (2 ids x 2 prompts x 2
               samples, 20 steps, output convs drawn) on the CLI training
               run's checkpoint, then ``cli/eval_imgs.py --fid
               --inception_ckpt`` from synthetic CLIP ViT-B/32 (OpenAI
               layout; its reader equal to the HF layout's), sphere20 and
               FID Inception files of the manifests' keys, fp32: scores
               finite, cosines in [-1, 1], every scorer forward with TF32
               off (allowed before the call, allowed again after), 12
               packed launches a ViT forward; the ViT's image features on
               the kernel route within 2e-5 (relative) of the plain route;
               each scorer forward (ViT at two batches, the text tower,
               the warp and sphere20, Inception at two batches) on its
               graph and eagerly in turns; ``eval_imgs`` once more with
               its forwards uncaptured (the wall the graphs save);
               then ``eval_imgs`` with ``--detector_ckpt`` / ``--pipnet_ckpt``
               (the align phase's files): scores finite, the cropper
               launching no hand-written kernel;
14. ``legacy`` the legacy family at full width, bf16, random weights from a
               seed with the output convs drawn: ``cli/evaluate_model.py`` on
               ``txt2img-1p4B-eval.yaml`` (BERT 32 x 1280, 4 samples, CFG
               5.0, 50 DDIM steps, a textual-inversion vector injected into
               BERT, random ViT-B/32 CLIP scoring in fp32),
               ``cli/sample_diffusion.py`` on ``celebahq-ldm-vq-4.yaml``
               (VQ-f4, 4 samples, 50 DDIM steps; each of its three
               attention levels' AttentionBlock in fp32 against the
               reference's arithmetic written out), ``--vanilla`` (the
               1000-step DDPM chain on its segment graph: the CLI's pixels
               a replay's, the replay the eager chain's bits) and ``cli/inpaint.py`` at
               the tiny concat configuration: wall, peak memory, launches
               of the flash forward per chain, per UNet call and per BERT
               encode, device ms per (guided) UNet forward, the CLI's images
               equal to a replay of its graph, the captured chain's bits
               equal to the eager chain's, the unmasked pixels of the
               inpainting bit for bit, the card's VQ indices against the
               CPU quantizer's (the share that differs, each a near-tie);
               and the tiny fp32 legacy configs on the kernel route against
               the plain route (float images within 1e-3, pixels within one
               level);
15. ``legacy_train`` the legacy family's training side: ``cli/train_legacy.py
               --fake-data`` on ``celebahq-ldm-vq-4.yaml`` at full width and
               the published batch (48), bf16 compute over float32
               parameters, the output convs drawn: three steps on the step's
               CUDA graph (the VQ-f4 encode, q_sample, the UNet with its 16
               AttentionBlocks, the eps MSE, AdamW, EMA), a 5-step sample
               grid, the export read back by ``load_reference_checkpoint``
               bit for bit; launches a step equal to the prediction
               (``celebahq_step_launches``, the dk/dv split reductions
               included), capture seconds, peak memory;
               the step on its graph and eagerly in turns (losses, UNet
               after AdamW and EMA bit for bit, ms a step); one step's UNet
               gradient on the kernel route against the plain route at
               batch 8 (cosine >= 0.99, |diff| / |grad| <= 0.1); the tiny
               fp32 configs' step (AttentionBlocks; BERT trainable) kernel
               route against plain route (loss 1e-5, gradients 1e-4 of the
               largest entry); the tiny step with dropout on its graph
               (two replays from one state draw other masks);
               ``cli/train_legacy.py`` on
               ``txt2img-1p4B-eval.yaml`` with BERT trainable (batch 4, two
               steps and two timed, remat on; launches a step equal to
               ``step_1p4b_launches``); ``cli/train_ae.py`` on
               ``autoencoder_kl_32x32x4.yaml`` at 256^2 (batch 12, the
               step on its graph), then one step of the same model with the
               discriminator on (``disc_start`` 0: its loss positive, its
               parameters moved, the adaptive weight below its clamp and
               equal to its value recomputed from the same pass), the step
               on its graph and eagerly in turns before and after
               ``disc_start`` (logs and both modules after Adam bit for
               bit), the VQ-f4 first stage (batch 4) the same way; a tiny
               noisy-latent classifier's train step (#3-#5 launched) and
               noise sweep on their graphs, and both against their eager
               runs in turns;
16. ``warmup`` ``python -m celebbasis_tpu_torch.cli.warmup`` at its defaults
               in a process of its own: the kernel libraries built, the
               train-step and txt2img graphs captured, seconds of each;
17. ``mesh``   the mesh paths at full width through ``torchrun``
               (``torch_scripts/mesh_ranks.py``, random weights from the
               CLIs' seed, the output convs drawn, 512x512 PNG faces):
               over NCCL at world size 1 on the graphs, ``cli/train.py
               --mesh 1`` and ``--mesh 1 --fsdp`` (three uncached steps)
               give the one-process losses, MLP, first gradient and manager
               state bit for bit, and ``cli/txt2img.py --mesh 1 --tp 1``
               its pixels; over gloo with two ranks on the one card,
               uncaptured, ``--mesh 2`` and ``--mesh 2 --fsdp`` (two steps
               at global batch 4) hold the one-process run at the same
               learning rate within 1e-3 and 3e-3 of the steps' losses, its
               first gradient to cosine >= 0.99 and |diff| / |grad| <= 0.1,
               that gradient within 1e-3 of one process's mean over the
               batch's halves each run alone (the witness of bf16 rounding
               at a rank's batch), the MLP's change over the run to cosine
               >= 0.98 and |diff| / |change| <= 0.25, both ranks' manager
               state and MLP equal, ``--mesh 2 --fsdp`` stores on each rank
               exactly the frozen bytes the rule predicts, ``txt2img --mesh
               2`` in float32 (TF32 off) the one-process pixels within one
               level, in bf16 within one level of one process sampling one
               image a call and within 1.5x the plain attention route's
               mean distance of the two-image run, and ``--tp 2``
               (4 local heads, 32 packed launches a UNet call a rank)
               within a mean of 8 levels (beside it the distance of the
               one-process run on the plain attention route); tensor
               parallelism beyond the CLIs' flags (``mesh_ranks.TP_EXTRA``):
               the W2 step on a (1, 2) mesh with TP-sharded frozen weights,
               with and without ``conv_tp``, against one process at a
               rank's batch and rate (the limits above, both ranks equal,
               #3/#4/#5 at 4 local heads; with ``conv_tp`` also in float32,
               TF32 off, against one float32 process: losses 1e-5,
               gradient |diff| / |grad| 1e-3), ``txt2img --tp 2`` with
               ``conv_tp`` in bf16 (mean 8 levels) and float32 (one
               level), ``--tp 2`` on the GEGLU kernel route (#6 on each
               rank's blocks, 16 launches a UNet call) and one FF block of
               it against the whole plain block (float32, 2e-5 of the
               largest output); ms a step by rank, peak memory, seconds in
               gloo's collectives.

The generation, training and scoring paths run as CUDA graphs
(``utils/graphs.py``):
a graph's warm-up and capture run its Python (hooks that count UNet calls
see both), its warm-up and each replay launch its kernels (the launch
counts hold both), and the checks count them so.

Exits non-zero if any phase fails or if there is no CUDA device.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line before
it is the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import base64
import ctypes
import json
import os
import pickle
import resource
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch

from celebbasis_tpu_torch.ops import attention as attn_ops
from celebbasis_tpu_torch.ops import cuda_build
from celebbasis_tpu_torch.ops import flash_attention as fa
from celebbasis_tpu_torch.ops import geglu
from celebbasis_tpu_torch.ops import quant
from celebbasis_tpu_torch.utils import graphs
from celebbasis_tpu_torch.utils.precision import no_tf32
from celebbasis_tpu_torch.utils.timing import replay_ms as time_ms

REPO = os.path.dirname(os.path.abspath(__file__))
DDIM_STEPS = 20
ATTN_PER_UNET = 32           # 16 transformer blocks x (self + cross)
# per train step: the first block's self-attention sees nothing that requires
# grad (inference forward, no backward); its cross-attention needs dk and dv
# only; the other 30 calls need all three gradients
TRAIN_LAUNCHES = {"flash_attention_nhd": 1, "flash_attention": 0,
                  "fwd_lse": ATTN_PER_UNET - 1, "dq": ATTN_PER_UNET - 2,
                  "dkv": ATTN_PER_UNET - 1}
TRAIN_STEPS, CACHED_STEPS = 6, 2
GEGLU_TRAIN_STEPS = 3        # uncached steps with the GEGLU kernel route
TOL = {torch.float32: 2e-5,  # summation order only
       torch.bfloat16: 2e-2}  # bf16 rounding of p and of the output, for
                              # outputs of unit scale; the binding limit for
                              # bf16 is fa.bf16_error_ratio <= 1, which
                              # scales with the outputs that are compared
PEAK_FLOPS = {torch.bfloat16: 989e12,   # H100 SXM dense tensor-core rate
              torch.float32: 67e12}     # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3

# (N, D) of the SD v1 UNet levels at 512x512; each also with M = 77
SERVE_LEVELS = ((4096, 40), (1024, 80), (256, 160), (64, 160))
B_SERVE, H_SERVE = 4, 8      # batch 2 doubled by classifier-free guidance
B_TRAIN = 2                  # the train step has no guidance rows

KERNELS = {
    "flash_attention_nhd": "celebbasis_tpu/ops/flash_attention.py:402",
    "flash_attention": "celebbasis_tpu/ops/flash_attention.py:158",
}
FWD_SOURCE = "celebbasis_tpu_torch/csrc/flash_attention_fwd.cu"
BWD_SOURCE = "celebbasis_tpu_torch/csrc/flash_attention_bwd.cu"
# counter -> (source, TPU kernel replaced, products per W = B*H*N*M*D)
TRAIN_KERNELS = {
    "fwd_lse": (FWD_SOURCE, "celebbasis_tpu/ops/flash_attention.py:147", 4),
    "dq": (BWD_SOURCE, "celebbasis_tpu/ops/flash_attention.py:282", 6),
    "dkv": (BWD_SOURCE, "celebbasis_tpu/ops/flash_attention.py:299", 8),
}
# the bf16 kernels' padded head dims; at each, the forward's (inference and
# LSE) and the backward's dq and dk/dv kernels are wgmma instantiations
HEAD_DIMS_PADDED = (48, 80, 160, 256)
# fp32 gradients and lse differ from the plain version by summation order:
# 1e-4 of the largest entry (sums over up to 4096 terms); bf16 outputs are
# held to fa.bf16_error_ratio <= 1 and bf16 gradients to
# fa.bf16_grad_error_ratio <= 1 (see their docstrings)
F32_REL_TOL = 1e-4
LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}

GEGLU_SOURCE = "celebbasis_tpu_torch/csrc/geglu.cu"
INT8_SOURCE = "celebbasis_tpu_torch/csrc/int8_matmul.cu"
# counter -> TPU kernel replaced
GEGLU_KERNELS = {"geglu_block": "celebbasis_tpu/ops/geglu.py:233",
                 "geglu_ffn": "celebbasis_tpu/ops/geglu.py:126"}
INT8_REPLACES = "celebbasis_tpu/ops/quant.py:82"
GEGLU_PER_UNET = 16          # one FF sub-block per transformer block
# (rows, C) of the FF sub-blocks at 512x512: 64^2, 32^2, 16^2 latents and the
# 8^2 mid block; serving has 4 rows of batch (2 x guidance), training 2
GEGLU_SERVE_SHAPES = ((16384, 320), (4096, 640), (1024, 1280), (256, 1280))
GEGLU_TRAIN_SHAPES = ((8192, 320), (2048, 640), (512, 1280), (128, 1280))
# (rows, C, inner or None for 4C): a padding row tile at every cluster width
# (K = 1 to 4, K = 3 at C = 768 and 960), with inner splits at K = 4; inner
# widths that end inside a block's share of the last chunk (C = 640) and
# that leave two of its four blocks no columns at all (C = 1280)
GEGLU_RAGGED_SHAPES = ((100, 320, None), (300, 640, None),
                       (1100, 1280, None), (200, 960, None),
                       (100, 768, None), (300, 640, 1000),
                       (200, 1280, 4744))
# the serving shapes at --tp 2: a rank's half of the inner width, no output
# bias (models.unet.FeedForwardGEGLU on the "cuda" route under TP)
GEGLU_TP_SHAPES = ((16384, 320, 640), (4096, 640, 1280), (1024, 1280, 2560),
                   (256, 1280, 2560))
# fp32: summation order only, over up to 5120 terms
GEGLU_F32_REL_TOL = 2e-5
# bf16: geglu.bf16_mean_error of the outputs against the plain version; on
# an H100 right kernels read at most 0.018 (the widest level), the exact erf
# GELU in place of the tanh form 0.117-0.121 (torch_scripts/mutation_check.sh)
GEGLU_BF16_MEAN_ERR = 0.05
# (M, K, N): the UNet's projections at batch 4 -- q/k/v/out at 64^2, FF in,
# FF out at 64^2, q/k/v/out at 32^2 and 16^2, FF out at 32^2 and 16^2 (K
# beyond a resident row tile) -- and two ragged cases (M, K and N off the
# kernel's 128-wide tiles)
INT8_SHAPES = ((16384, 320, 320), (16384, 320, 2560), (16384, 1280, 320),
               (4096, 640, 640), (1024, 1280, 1280), (4096, 2560, 640),
               (1024, 5120, 1280), (100, 300, 77), (1000, 1300, 200))
INT8_TIMED = INT8_SHAPES[:7]
PEAK_INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core rate

# the synthetic sd-v1-4.ckpt: every key of the manifest, and what the real
# file holds beside them -- the DDPM schedule buffers, LitEma copies (keys
# with the dots taken out) and Lightning callback state
SD_MANIFEST = os.path.join(REPO, "manifests", "sd-v1-4.json")
FR_MANIFEST = os.path.join(REPO, "manifests", "cosface_r100.json")
DDPM_BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                "posterior_log_variance_clipped", "posterior_mean_coef1",
                "posterior_mean_coef2", "logvar")
EMA_KEYS = {"model_ema.decay": (), "model_ema.num_updates": (),
            "model_ema.diffusion_modeltime_embed0weight": (1280, 320),
            "model_ema.diffusion_modelout2bias": (4,)}
# the CLI runs of the train phase: steps, validation every VAL_EVERY steps
# over VAL_BATCHES batches, a sample grid (ImageLogger, 20 DDIM steps) at the
# last uncached step, and the cached run's cache
CLI_STEPS, CLI_VAL_EVERY, CLI_VAL_BATCHES, CLI_CACHE = 6, 3, 2, 3
# the ti phase: cli/train_ti.py steps (a step's flash launches are
# TRAIN_LAUNCHES: the vectors reach the UNet through the context, as the MLP's
# identities do)
TI_STEPS = 6
# the CLIP ViT-B/32 image tower's attention: 7x7 patches and the class
# token, 12 heads of 64, no mask; batches of the evaluate phase's samples (2)
# and of the FID scorer (32)
VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM, VIT_LAYERS = 12, 50, 64, 12
VIT_BATCHES = (2, 32)
VIT_REL_TOL = 2e-5           # fp32 image features, kernel vs plain route
# the evaluate phase: gen_imgs over EVAL_IDS identities x two prompts x
# EVAL_SAMPLES samples; the scorers' files from these manifests
EVAL_IDS, EVAL_SAMPLES = 2, 2
CLIP_MANIFEST = os.path.join(REPO, "manifests", "clip_vit_b32.json")
SPHERE_MANIFEST = os.path.join(REPO, "manifests", "sphere20.json")
INCEPTION_MANIFEST = os.path.join(REPO, "manifests", "fid_inception.json")
# the align phase: synthetic photos, the nets' manifests, and how far the
# card's boxes (pixels, before the integer cast) may be from the CPU's
ALIGN_PHOTOS, ALIGN_PHOTO = 8, 512
FB_MANIFEST = os.path.join(REPO, "manifests", "faceboxesv2.json")
PIP_MANIFEST = os.path.join(REPO, "manifests", "pipnet_wflw_r101.json")
ALIGN_BOX_TOL = 0.05
# the align_train phase: synthetic raw WFLW (images, train rows, test rows),
# the labeled 300W rows and unlabeled CelebA crops of data_300W_CELEBA, the
# trainers' batch (the reference's 16), and how far one step on the card
# may be from the same step on the CPU (fp32, TF32 off): the loss
# (relative), the leaves' gradients (relative L2, the median over the
# leaves and the worst leaf: one entry of a leaf that is a sum with heavy
# cancellation, such as a BatchNorm mean's, differs by up to 3e-3 of the
# leaf's largest entry), and the parameters after the first Adam update in
# units of lr.  That update is lr * g / (|g| + 1e-8), lr * sign(g) wherever
# |g| >> 1e-8, so an entry whose gradient is within rounding of 0 moves by
# up to lr either way: the largest difference is bounded by 2 * lr (a wrong
# rate or schedule exceeds it), and the mean and the share of entries over
# lr / 2 say how many flipped.  torch_scripts/align_train_tf32_probe.py
# measures both steps with TF32 off and with TF32 left on for the card: on
# an H100 the limits pass the first and refuse the second
ALIGN_TRAIN_WFLW = (12, 48, 4)
ALIGN_TRAIN_LABELED, ALIGN_TRAIN_UNLABELED = 32, 16
ALIGN_TRAIN_BATCH = 16
ALIGN_TRAIN_TOL = {"loss": 1e-4, "grad_rel_l2_median": 1e-3,
                   "grad_rel_l2_max": 1e-2, "param_lr_max": 2.01,
                   "param_lr_mean": 1e-3, "param_share_over_half_lr": 1e-3}
# the legacy phase: the legacy family's full-width configurations, and each
# CLI run's samples, DDIM steps and guidance
LEGACY_CONFIGS = os.path.join(REPO, "celebbasis_tpu_torch", "configs")
LEGACY_SAMPLES, LEGACY_STEPS, LEGACY_SCALE = 4, 50, 5.0
BERT_ATTN = 32               # one attention a layer of BERT's 32
CELEBAHQ_ATTN = 16           # AttentionBlocks of the CelebA-HQ UNet
# (B, H, N = M, D) of the legacy paths: the CelebA-HQ AttentionBlocks at 32^2,
# 16^2 and 8^2 latents (D = 32 padded to 48) and BERT's 77-token attention
# (D = 64 padded to 80), at the CLIs' batch of 4; the tiny inpainting UNet's
# mid-block AttentionBlock (one image, 8 heads of 8 padded to 48, 8^2 tokens)
LEGACY_ATTN_SHAPES = ((4, 14, 1024, 32), (4, 21, 256, 32), (4, 28, 64, 32),
                      (4, 8, 77, 64), (1, 8, 64, 8))
# head dims of the legacy AttentionBlocks, which hand the per-head entry
# strided slices of their interleaved q/k/v projection
LEGACY_BLOCK_HEAD_DIMS = (32, 8)
# the legacy_train phase: the CelebA-HQ step at the published batch
# (celebahq-ldm-vq-4.yaml's data.params.batch_size), its runs graph against
# eager, the 1p4B step's batch (its config has no data block) and steps, the
# KL-f8 autoencoder's batch (the published 12) at 256^2
LEGACY_TRAIN_BATCH, LEGACY_TRAIN_STEPS = 48, 3
LEGACY_1P4B_BATCH, LEGACY_AE_BATCH = 4, 12
# the batch of the full-width kernel-route vs plain-route step: the plain
# route keeps every (B, H, N, N) fp32 attention matrix for its backward
LEGACY_PARITY_BATCH = 8
# (tokens, head dim, SpatialTransformers) of the 1p4B UNet's attention
# levels at its 32^2 latents: two down and three up at 32^2, 16^2 and 8^2,
# the middle block at 4^2; 8 heads each, self-attention and cross-attention
# against BERT's 77 tokens
LEGACY_1P4B_LEVELS = ((1024, 40, 5), (256, 80, 5), (64, 160, 5), (16, 160, 1))
BERT_HEADS, BERT_HEAD_DIM, BERT_TOKENS = 8, 64, 77
# (B, H, N, M, D, layout) of the legacy train steps' attention: the CelebA-HQ
# AttentionBlocks at 32^2, 16^2 and 8^2 latents (interleaved views, D = 32
# padded to 48) at the step's batch; at the 1p4B step's, BERT's and the
# UNet's levels (packed)
LEGACY_TRAIN_SHAPES = (
    (LEGACY_TRAIN_BATCH, 14, 1024, 1024, 32, "interleaved"),
    (LEGACY_TRAIN_BATCH, 21, 256, 256, 32, "interleaved"),
    (LEGACY_TRAIN_BATCH, 28, 64, 64, 32, "interleaved"),
    (LEGACY_1P4B_BATCH, BERT_HEADS, BERT_TOKENS, BERT_TOKENS, BERT_HEAD_DIM,
     "nhd"),
    *((LEGACY_1P4B_BATCH, 8, N, M, D, "nhd")
      for N, D, _ in LEGACY_1P4B_LEVELS for M in (N, BERT_TOKENS)))
# the tiny classifier step's (legacy_train_classifier, batch 4): its
# AttentionBlock at 8^2 (4 heads of 32, interleaved) and its AttentionPool2d
# (8^2 tokens and their mean; q, k and v column chunks of one projection)
CLASSIFIER_TRAIN_SHAPES = ((4, 4, 64, 64, 32, "interleaved"),
                           (4, 4, 65, 65, 32, "chunked"))
# a VQ index on the card may differ from the CPU quantizer's only where the
# two codes' float32 distances lie within this of the row's largest distance
VQ_TIE_REL = 1e-5
SCORE_KEYS = {"image_sim", "text_sim", "id_cos_sim", "id_mse_dist",
              "id_l2_dist", "num_has_face", "num_no_face", "n_items",
              "n_id_items", "fid"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


# -- phase 1 ------------------------------------------------------------------

def phase_env() -> str:
    card = smi_line()
    log("env", card)
    log("env", f"python {sys.version.split()[0]}  torch {torch.__version__}  "
               f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout.strip()
    log("env", "nvcc: " + nvcc.splitlines()[-2].strip())
    have = []
    for mod in ("regex", "yaml", "PIL", "cv2"):
        try:
            __import__(mod)
            have.append(f"{mod}=yes")
        except ImportError:
            have.append(f"{mod}=no")
    log("env", "optional modules: " + " ".join(have))
    return card


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    paths = cuda_build.build_all(fa.LIBRARIES + geglu.LIBRARIES
                                 + quant.LIBRARIES)
    log("build", f"{len(paths)} libraries in "
                 f"{time.perf_counter() - t0:.1f} s (built in parallel)")
    for name, path in paths.items():
        log("build", f"{os.path.relpath(path, REPO)}: ptxas "
                     f"{json.dumps(cuda_build.ptxas_report(name))}")
    for module in (fa, geglu, quant):
        for entry in module.ENTRIES.values():
            entry.bind()    # load, so a bad library fails here
    return {"fwd": fwd_instantiations(), **bwd_instantiations(),
            "geglu": geglu_instantiations(), "int8": int8_instantiations()}


def _sass_and_ptxas(library):
    """(HGMMA counts, HMMA counts, ptxas records) per kernel of a library."""
    sass = {op: cuda_build.sass_counts(library, op)
            for op in ("HGMMA", "HMMA")}
    return sass["HGMMA"], sass["HMMA"], cuda_build.ptxas_kernels(library)


def fwd_instantiations():
    """What the bf16 forward kernels are at each padded head dim: for the
    main key tile and the short one, the head dim's consumer warpgroups and
    one, the inference and the LSE instantiation -- tiles, threads and
    shared bytes (as the library reports them), registers at launch (blocks
    of several warpgroups raise their consumers' to `consumer_registers`)
    and spills (ptxas), and the HGMMA (wgmma) and HMMA (mma.sync)
    instructions in the built library's SASS.  Fails unless every one holds
    HGMMA and no HMMA, spills nothing and keeps its wgmma asynchronous (no
    ptxas note that it serialised them), and no kernel of the library holds
    HMMA.  Which of them a launch takes, and on how many blocks, the library
    decides (``fwd_grid`` reads it)."""
    lib = cuda_build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd_config
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
    hgmma, hmma, ptxas = _sass_and_ptxas("flash_attention_fwd")
    if any(hmma.values()):
        raise RuntimeError(f"mma.sync (HMMA) in the forward library: "
                           f"{ {k: v for k, v in hmma.items() if v} }")
    records, seen = [], set()
    for dp in HEAD_DIMS_PADDED:
        cfg = (ctypes.c_int * 14)()
        if fn(dp, cfg) != 0 or cfg[0] != dp:
            raise RuntimeError(f"flash_attention_fwd_config({dp}) failed")
        keys, short, wgs = cfg[1], cfg[2] or None, cfg[4]
        for wg, (rows, threads, smem, smem_short) in ((wgs, cfg[6:10]),
                                                      (1, cfg[10:14])):
            for bn, nbytes in ((keys, smem), (short, smem_short)):
                if bn is None:
                    continue
                for lse in (0, 1):
                    pattern = f"flash_fwd_wgmmaILi{dp}ELi{bn}ELi{wg}ELb{lse}E"
                    names = [n for n in hgmma if pattern in n]
                    if len(names) != 1:
                        raise RuntimeError(f"no single kernel {pattern} in "
                                           f"the library: {names}")
                    seen.add(names[0])
                    rec = {"head_dim_padded": dp, "keys_per_tile": bn,
                           "query_rows": rows, "consumer_warpgroups": wg,
                           "lse": bool(lse), "threads": threads,
                           "smem_bytes": nbytes, "stages": cfg[3],
                           "consumer_registers": cfg[5] if wg > 1 else 0,
                           "hgmma": hgmma[names[0]], "hmma": hmma[names[0]],
                           "ptxas": ptxas.get(names[0],
                                              "not built by this process")}
                    log("build", f"fwd {json.dumps(rec)}")
                    built = rec["ptxas"] if isinstance(rec["ptxas"],
                                                       dict) else {}
                    spills = built.get("spill_bytes", 0)
                    serial = built.get("wgmma_serialized", 0)
                    if not rec["hgmma"] or rec["hmma"] or spills or serial:
                        raise RuntimeError(
                            f"{pattern}: {rec['hgmma']} HGMMA, {rec['hmma']} "
                            f"HMMA instructions, {spills} spilled bytes, "
                            f"wgmma serialised: {bool(serial)}")
                    records.append(rec)
    stray = [n for n in hgmma if "flash_fwd_wgmma" in n and n not in seen]
    if stray:
        raise RuntimeError(f"forward kernels no configuration names: {stray}")
    return records


def bwd_instantiations():
    """What the bf16 dq and dk/dv kernels are at each padded head dim: tiles,
    threads and shared bytes (as the library reports them), registers at
    launch (the consumer warpgroups raise theirs where `consumer_registers`
    is not 0) and spills (ptxas), and the HGMMA (wgmma) and HMMA (mma.sync)
    instructions in the built library's SASS.  Fails unless every one holds
    HGMMA and no HMMA, and the wrapper's split plan uses the kernel's
    tiles."""
    lib = cuda_build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_config
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
    hgmma, hmma, ptxas = _sass_and_ptxas("flash_attention_bwd")
    records = {"dq": [], "dkv": []}
    for dp in HEAD_DIMS_PADDED:
        cfg = (ctypes.c_int * 11)()
        if fn(dp, cfg) != 0 or cfg[0] != dp:
            raise RuntimeError(f"flash_attention_bwd_config({dp}) failed")
        tiles = {"dq": {"query_rows": cfg[1], "keys_per_tile": cfg[2],
                        "threads": cfg[3], "smem_bytes": cfg[4],
                        "consumer_registers": cfg[5]},
                 "dkv": {"keys": cfg[6], "query_rows_per_tile": cfg[7],
                         "threads": cfg[8], "smem_bytes": cfg[9],
                         "consumer_registers": cfg[10]}}
        if fa.dkv_tiles(dp) != (cfg[6], cfg[7]):
            raise RuntimeError(f"dkv_tiles({dp}) = {fa.dkv_tiles(dp)}, the "
                               f"kernel's are {(cfg[6], cfg[7])}")
        for kernel in ("dq", "dkv"):
            pattern = f"flash_bwd_{kernel}_wgmmaILi{dp}E"
            names = [n for n in hgmma if pattern in n]
            if len(names) != 1:
                raise RuntimeError(f"no single kernel {pattern} in the "
                                   f"library: {names}")
            rec = {"head_dim_padded": dp, **tiles[kernel],
                   "hgmma": hgmma[names[0]],
                   "hmma": hmma[names[0]],
                   "ptxas": ptxas.get(names[0], "not built by this process")}
            rec["instantiation"] = "wgmma" if rec["hgmma"] else "no wgmma"
            log("build", f"bwd {kernel} {json.dumps(rec)}")
            if not rec["hgmma"] or rec["hmma"]:
                raise RuntimeError(f"{pattern}: {rec['hgmma']} HGMMA and "
                                   f"{rec['hmma']} HMMA instructions")
            records[kernel].append(rec)
    return records


def geglu_instantiations():
    """What the bf16 GEGLU kernels are at the SD v1 widths (320, 640, 1280),
    as the library's plan picks them (``geglu.plan``): cluster, rows,
    threads, shared bytes and ring stages; registers at launch (the consumer
    warpgroups raise theirs to 224) and spills (ptxas); HGMMA (wgmma) and HMMA (mma.sync) in the
    built library's SASS.  Fails on any HMMA in the library, a bf16 kernel
    without HGMMA, a spill, ptxas's note that it serialised the wgmmas, or a
    bf16 kernel that no width takes."""
    hgmma, hmma, ptxas = _sass_and_ptxas("geglu")
    if any(hmma.values()):
        raise RuntimeError(f"mma.sync (HMMA) in the GEGLU library: "
                           f"{ {k: v for k, v in hmma.items() if v} }")
    records, seen = [], set()
    for rows, C in GEGLU_SERVE_SHAPES[:3]:
        how = geglu.plan(torch.device("cuda"), torch.bfloat16, rows, C,
                         4 * C)
        pattern = f"geglu_bf16ILi{how['variant']}EE"
        names = [n for n in hgmma if pattern in n]
        if len(names) != 1:
            raise RuntimeError(f"no single kernel {pattern} in the library: "
                               f"{names}")
        seen.add(names[0])
        built = ptxas.get(names[0], "not built by this process")
        rec = {"C": C, **{k: how[k] for k in (
                   "cluster", "partners", "rows", "threads", "smem_bytes",
                   "stages")},
               "hgmma": hgmma[names[0]], "hmma": hmma[names[0]],
               "ptxas": built}
        log("build", f"geglu {json.dumps(rec)}")
        built = built if isinstance(built, dict) else {}
        spills = built.get("spill_bytes", 0)
        serial = built.get("wgmma_serialized", 0)
        if not rec["hgmma"] or spills or serial:
            raise RuntimeError(f"{pattern}: {rec['hgmma']} HGMMA, {spills} "
                               f"spilled bytes, wgmma serialised: "
                               f"{bool(serial)}")
        records.append(rec)
    stray = [n for n in hgmma if "geglu_bf16" in n and n not in seen]
    if stray:
        raise RuntimeError(f"GEGLU kernels no width takes: {stray}")
    return records


def int8_instantiations():
    """What the int8 matmul library holds: per kernel, registers and spills
    (ptxas), IGMMA (s8 wgmma) and IMMA (mma.sync) instructions in the
    SASS, and the ptxas note that it serialised the wgmmas.  The product
    kernels are int8_gemm<dtype, streamed>: two a dtype, fused and
    streamed; quantize_rows is the streamed mode's first pass.  Fails on any
    IMMA in the library, a product kernel without IGMMA or not four of
    them, a spill, or serialised wgmmas; and records the plan
    (``quant.plan``) at each timed shape."""
    sass = {op: cuda_build.sass_counts("int8_matmul", op)
            for op in ("IGMMA", "IMMA")}
    ptxas = cuda_build.ptxas_kernels("int8_matmul")
    if any(sass["IMMA"].values()):
        raise RuntimeError(f"mma.sync (IMMA) in the int8 library: "
                           f"{ {k: v for k, v in sass['IMMA'].items() if v} }")
    records = []
    for name in sass["IGMMA"]:
        built = ptxas.get(name, "not built by this process")
        rec = {"kernel": name, "igmma": sass["IGMMA"][name],
               "imma": sass["IMMA"][name], "ptxas": built}
        log("build", f"int8 {json.dumps(rec)}")
        built = built if isinstance(built, dict) else {}
        gemm = "int8_gemm" in name
        if (gemm and not rec["igmma"]) or built.get("spill_bytes", 0) \
                or built.get("wgmma_serialized", 0):
            raise RuntimeError(f"{name}: {rec['igmma']} IGMMA, "
                               f"{built.get('spill_bytes', 0)} spilled bytes, "
                               f"wgmma serialised: "
                               f"{bool(built.get('wgmma_serialized', 0))}")
        records.append(rec)
    if sum("int8_gemm" in r["kernel"] for r in records) != 4:
        raise RuntimeError(f"the int8 library holds not four product "
                           f"kernels: {[r['kernel'] for r in records]}")
    plans = {f"{M}x{K}->{N}": quant.plan(torch.device("cuda"),
                                          torch.bfloat16, M, N, K)
             for M, K, N in INT8_TIMED}
    log("build", f"int8 plans (bf16) {json.dumps(plans)}")
    return {"kernels": records, "plans": plans}


# -- phase 3 ------------------------------------------------------------------

def bound(B, H, N, M, D, dtype):
    """Least time for the work: each input read once, the output written
    once, against the products' operations at the type's peak rate."""
    flops = 4.0 * B * H * N * M * D
    nbytes = (2.0 * B * N * H * D + 2.0 * B * M * H * D) * \
        torch.empty((), dtype=dtype).element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_shape(entry, B, H, N, M, D, dtype, timed, q_scale=1.0,
                interleaved=False):
    """`q_scale` 1 gives logits of unit variance (a nearly flat softmax over
    many keys, outputs of a few hundredths); 4 gives a peaked softmax and
    outputs of unit scale at any M.  `interleaved` (the per-head entry, N =
    M) hands over q, k and v as the legacy UNet's AttentionBlock does:
    strided slices of one (B, N, H, 3, D) projection."""
    g = torch.Generator(device="cuda").manual_seed(N * 131 + M * 7 + D)
    if interleaved:
        if entry != "flash_attention" or N != M:
            raise ValueError("interleaved q/k/v: per-head entry, N = M")
        gain = torch.tensor([q_scale, 1.0, 1.0], device="cuda")[:, None]
        qkv = (torch.randn(B, N, H, 3, D, device="cuda", generator=g)
               * gain).to(dtype)
        q4, k4, v4 = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    else:
        mk = lambda L, scale=1.0: (torch.randn(B, L, H * D, device="cuda",
                                               generator=g) * scale).to(dtype)
        q, k, v = mk(N, q_scale), mk(M), mk(M)
        heads = lambda x: x.reshape(B, x.shape[1], H, D).permute(0, 2, 1, 3)
        q4, k4, v4 = heads(q), heads(k), heads(v)
    if entry == "flash_attention_nhd":
        run = lambda: fa.flash_attention_nhd(q, k, v, H)
        plain = lambda: fa.flash_attention_nhd_plain(q, k, v, H)
    else:
        run = lambda: fa.flash_attention(q4, k4, v4)
        plain = lambda: fa.flash_attention_plain(q4, k4, v4)
    before = fa.launch_count(entry)
    out = run()
    torch.cuda.synchronize()
    if fa.launch_count(entry) != before + 1:
        raise RuntimeError(f"{entry}: the wrapper did not launch its kernel")
    ref = plain()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{entry}: shape/dtype {out.shape} {out.dtype} "
                           f"vs plain {ref.shape} {ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    rec = {"B": B, "H": H, "N": N, "M": M, "D": D, "q_scale": q_scale,
           "interleaved": interleaved,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": TOL[dtype],
           "ref_rms": ref.float().square().mean().sqrt().item(),
           "ref_max": ref.float().abs().max().item()}
    ok = np.isfinite(err) and err <= TOL[dtype]
    if dtype == torch.bfloat16:
        rec["err_ratio"] = fa.bf16_error_ratio(out, ref)
        ok = ok and rec["err_ratio"] <= 1.0
    if timed:
        bms, bby = bound(B, H, N, M, D, dtype)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4)
        iters = 10 if N * M >= 1 << 22 else 50
        (rec["kernel_ms"], rec["kernel_ms_min"]) = time_ms(run, iters)
        (rec["plain_ms"], rec["plain_ms_min"]) = time_ms(plain, 3)
        (rec["library_ms"], rec["library_ms_min"]) = time_ms(sdpa, iters)
        rec.update(bound_ms=bms, bound_by=bby)
        if dtype == torch.bfloat16:
            rec["grid"] = fwd_grid(B, H, N, M, D)
    log("kernels", f"{entry} {json.dumps(rec)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{entry} disagrees with its plain version at "
                           f"{rec}")
    return rec


def fwd_grid(B, H, N, M, D):
    """The bf16 forward's grid at a shape, as the library's launch picks it
    (``flash_attention_fwd_plan``, the function the launch itself calls):
    query rows a block, keys a tile, query tiles of 64 rows, blocks, and
    waves (the blocks' worth of query tiles over the SMs)."""
    fn = cuda_build.load("flash_attention_fwd").flash_attention_fwd_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 7)()
    if fn(B, H, N, M, D, out) != 0:
        raise RuntimeError(f"flash_attention_fwd_plan{(B, H, N, M, D)} "
                           f"failed")
    _, keys, wgs, tiles, _, blocks, sms = out
    return {"query_rows": 64 * wgs, "keys_per_tile": keys,
            "query_tiles": tiles, "blocks": blocks,
            "waves": tiles / wgs / sms}


def phase_kernels():
    records = {}
    for entry in KERNELS:
        shapes = []
        for N, D in SERVE_LEVELS:
            for M in (N, 77):
                shapes.append(check_shape(entry, B_SERVE, H_SERVE, N, M, D,
                                          torch.bfloat16, timed=True))
        # ragged query and key tiles, padded head dim, fp32 products
        shapes.append(check_shape(entry, 2, 3, 100, 77, 40, torch.float32,
                                  timed=False))
        shapes.append(check_shape(entry, 2, 3, 100, 77, 40, torch.bfloat16,
                                  timed=False))
        shapes.append(check_shape(entry, 1, 2, 200, 300, 256, torch.float32,
                                  timed=False))
        # ragged query rows and a ragged last key tile of 128: on blocks of
        # one consumer warpgroup (2 heads fill few SMs), of three (D = 40)
        # and of two (D = 80)
        for B, H, D in ((1, 2, 40), (4, 8, 40), (4, 8, 80)):
            shapes.append(check_shape(entry, B, H, 1100, 333, D,
                                      torch.bfloat16, timed=False))
        # head dims that run at a wider padded width (64 in 80), and the limit
        shapes.append(check_shape(entry, 2, 3, 100, 77, 64, torch.bfloat16,
                                  timed=False))
        shapes.append(check_shape(entry, 1, 2, 200, 300, 256, torch.bfloat16,
                                  timed=False))
        # peaked softmax: outputs of unit scale through many K/V tiles, so
        # that every stage of the tile pipeline shows in the result
        for N, D in SERVE_LEVELS[:2]:
            shapes.append(check_shape(entry, B_SERVE, H_SERVE, N, N, D,
                                      torch.bfloat16, timed=False,
                                      q_scale=4.0))
        if entry == "flash_attention_nhd":
            # the scorer's ViT-B/32 (evaluate phase): D = 64 padded to 80,
            # one ragged tile of 50 keys, fp32 as it scores and bf16
            with no_tf32():
                for B in VIT_BATCHES:
                    for dtype in (torch.float32, torch.bfloat16):
                        shapes.append(check_shape(
                            entry, B, VIT_HEADS, VIT_TOKENS, VIT_TOKENS,
                            VIT_HEAD_DIM, dtype, timed=True))
        # the legacy phase's shapes: the per-head entry on the
        # AttentionBlocks' interleaved slices, as they hand them over; and
        # once each with a peaked softmax
        for B, H, N, D in LEGACY_ATTN_SHAPES:
            shapes.append(check_shape(
                entry, B, H, N, N, D, torch.bfloat16, timed=True,
                interleaved=entry == "flash_attention"
                and D in LEGACY_BLOCK_HEAD_DIMS))
        for B, H, N, D in ((4, 21, 256, 32), (1, 8, 64, 8)):
            shapes.append(check_shape(
                entry, B, H, N, N, D, torch.bfloat16, timed=False,
                q_scale=4.0, interleaved=entry == "flash_attention"))
        records[entry] = shapes
    return records


def train_bound(kernel, B, H, N, M, D, dtype):
    """As `bound`, for the training kernels: fwd_lse reads q, k, v and writes
    o and lse; dq reads q, k, v, dO, lse, delta and writes dq; dkv reads the
    same and writes dk and dv."""
    es = torch.empty((), dtype=dtype).element_size()
    rows_q, rows_k = B * H * N, B * H * M
    nbytes = {"fwd_lse": (2 * rows_q + 2 * rows_k) * D * es + rows_q * 4,
              "dq": (3 * rows_q + 2 * rows_k) * D * es + rows_q * 8,
              "dkv": (2 * rows_q + 4 * rows_k) * D * es + rows_q * 8}[kernel]
    flops = TRAIN_KERNELS[kernel][2] * float(B) * H * N * M * D
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _agreement(name, got, ref, dtype, rec):
    """Records error figures of one tensor; returns whether it agrees.  bf16:
    the output by fa.bf16_error_ratio, a gradient by
    fa.bf16_grad_error_ratio (the rms term per row: see its docstring)."""
    err = (got.float() - ref.float()).abs().max().item()
    rec[f"{name}_max_abs_err"] = err
    if dtype == torch.bfloat16:
        ratio = fa.bf16_error_ratio if name == "o" else \
            fa.bf16_grad_error_ratio
        rec[f"{name}_err_ratio"] = ratio(got, ref)
        return np.isfinite(err) and rec[f"{name}_err_ratio"] <= 1.0
    limit = F32_REL_TOL * ref.float().abs().max().item()
    return np.isfinite(err) and err <= limit


def check_train_shape(layout, B, H, N, M, D, dtype, timed, q_scale=1.0):
    """The training forward (o, lse), dq and dk/dv against their plain
    versions on one shape, `layout` "nhd" (packed), "bhnd" (per-head views
    of packed buffers), "interleaved" (N = M: q, k and v per-head views of
    one (B, N, H, 3, D) projection and the incoming gradient a per-head view
    of a (B, N, H, D) buffer, as the legacy UNet's AttentionBlock hands them
    over forward and backward) or "chunked" (N = M: q, k and v packed column
    chunks of one (B, N, 3 H D) projection, as AttentionPool2d hands them
    over).  The backward is compared on the kernels' own o and lse, run
    twice (the bits must repeat), and o must equal the inference forward's
    bit for bit; each dk/dv launch whose query stream ``dkv_split_plan``
    splits must launch the split reduction too."""
    g = torch.Generator(device="cuda").manual_seed(N * 131 + M * 7 + D + 1)
    mk = lambda L, scale=1.0: (torch.randn(B, L, H * D, device="cuda",
                                           generator=g) * scale).to(dtype)
    q, k, v, do = mk(N, q_scale), mk(M), mk(M), mk(N)
    heads = H
    if layout == "bhnd":
        q, k, v, do = (fa._split(x, H) for x in (q, k, v, do))
        heads = None
    elif layout == "interleaved":
        if N != M:
            raise ValueError("interleaved q/k/v: N = M")
        gain = torch.tensor([q_scale, 1.0, 1.0], device="cuda")[:, None]
        qkv = (torch.randn(B, N, H, 3, D, device="cuda", generator=g)
               * gain).to(dtype)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
        do = fa._split(do, H)
        heads = None
    elif layout == "chunked":
        if N != M:
            raise ValueError("chunked q/k/v: N = M")
        gain = torch.tensor([q_scale, 1.0, 1.0], device="cuda")
        qkv = (torch.randn(B, N, 3, H * D, device="cuda", generator=g)
               * gain[:, None]).to(dtype).flatten(2)
        q, k, v = qkv.chunk(3, dim=-1)
    to4 = (lambda x: x) if heads is None else (lambda x: fa._split(x, H))
    rec = {"layout": layout, "B": B, "H": H, "N": N, "M": M, "D": D,
           "q_scale": q_scale, "dtype": str(dtype).replace("torch.", "")}

    before, reduces = fa.launch_counts(), fa.reduce_launch_count()
    o, lse = fa.flash_attention_lse(q, k, v, heads)
    infer = fa.flash_attention_nhd(q, k, v, H) if heads else \
        fa.flash_attention(q, k, v)
    delta = fa.flash_attention_delta(o, do, heads)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, heads, delta=delta)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, heads)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    launched = {n: after[n] - before[n] for n in TRAIN_KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = dtype == torch.bfloat16 \
        and fa.dkv_split_plan(B, H, N, M, D, sms)[0] > 1
    launched["dkv_reduce"] = fa.reduce_launch_count() - reduces
    if launched != {"fwd_lse": 1, "dq": 2, "dkv": 2,
                    "dkv_reduce": 2 if split else 0}:
        raise RuntimeError(f"the wrappers did not launch their kernels: "
                           f"{launched}")
    rec["dkv_reduce_launches"] = launched["dkv_reduce"]
    o_ref, lse_ref = fa.flash_attention_lse_plain(to4(q), to4(k), to4(v))
    refs = fa.flash_attention_bwd_plain(to4(q), to4(k), to4(v), to4(o), lse,
                                        to4(do))
    ok = _agreement("o", to4(o), o_ref, dtype, rec)
    rec["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    ok = ok and rec["lse_max_abs_err"] <= LSE_TOL[dtype]
    rec["o_equals_inference_forward"] = torch.equal(o, infer)
    rec["bits_repeat"] = all(torch.equal(a, b) for a, b in zip(grads, again))
    ok = ok and rec["o_equals_inference_forward"] and rec["bits_repeat"]
    for name, got, ref, like in zip(("dq", "dk", "dv"), grads, refs,
                                    (q, k, v)):
        if got.shape != like.shape or got.dtype != like.dtype:
            raise RuntimeError(f"{name}: {got.shape} {got.dtype} for an input "
                               f"{like.shape} {like.dtype}")
        ok = _agreement(name, to4(got), ref, dtype, rec) and ok
        rec[f"{name}_rms"] = ref.float().square().mean().sqrt().item()
    if timed:
        F = torch.nn.functional
        iters = 10 if N * M >= 1 << 22 else 50
        runs = {
            "fwd_lse": lambda: fa.flash_attention_lse(q, k, v, heads),
            "dq": lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, heads, need_dkv=False, delta=delta),
            "dkv": lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, heads, need_dq=False, delta=delta),
        }
        q4, k4, v4, do4 = to4(q), to4(k), to4(v), to4(do)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q4, k4, v4)]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves)
            torch.autograd.grad(out, leaves, do4)

        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                          iters)[0]
        lib_bwd = time_ms(sdpa_fwd_bwd, iters)[0] - lib_fwd
        plain = {"fwd_lse": time_ms(lambda: fa.flash_attention_lse_plain(
                     q4, k4, v4), 3)[0]}
        plain["dq"] = plain["dkv"] = time_ms(
            lambda: fa.flash_attention_bwd_plain(q4, k4, v4, to4(o), lse,
                                                 do4), 3)[0]
        rec["delta_ms"] = time_ms(
            lambda: fa.flash_attention_delta(o, do, heads), iters)[0]
        for name, run in runs.items():
            ms, ms_min = time_ms(run, iters)
            bms, bby = train_bound(name, B, H, N, M, D, dtype)
            rec[name] = {"kernel_ms": ms, "kernel_ms_min": ms_min,
                         "plain_ms": plain[name], "bound_ms": bms,
                         "bound_by": bby,
                         # the library computes dq, dk and dv in one call
                         "library_ms": lib_fwd if name == "fwd_lse"
                         else lib_bwd}
        if dtype == torch.bfloat16:
            rec["fwd_lse"]["grid"] = fwd_grid(B, H, N, M, D)
            rec["dq"]["instantiation"] = rec["dkv"]["instantiation"] = "wgmma"
            rec["dkv"]["splits"] = fa.dkv_split_plan(B, H, N, M, D, sms)[0]
    log("kernels", f"train {json.dumps(rec)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"a training kernel disagrees with its plain "
                           f"version at {rec}")
    return rec


def phase_train_kernels():
    shapes = []
    for N, D in SERVE_LEVELS:            # the UNet's levels, batch 2
        for M in (N, 77):
            shapes.append(check_train_shape("nhd", B_TRAIN, H_SERVE, N, M, D,
                                            torch.bfloat16, timed=True))
            shapes.append(check_train_shape("bhnd", B_TRAIN, H_SERVE, N, M,
                                            D, torch.bfloat16, timed=False))
            for layout in ("nhd", "bhnd"):
                shapes.append(check_train_shape(layout, B_TRAIN, H_SERVE, N,
                                                M, D, torch.float32,
                                                timed=False))
    for layout in ("nhd", "bhnd"):
        # ragged query and key tiles, every padded width, both types
        for dtype in (torch.float32, torch.bfloat16):
            # (2, 8, 1100, 77, 40): a dk/dv query split whose ranges differ
            # in length (9 query tiles over 8 splits at D = 40)
            for B, H, N, M, D in ((2, 3, 100, 77, 40), (1, 2, 200, 300, 256),
                                  (1, 2, 1100, 333, 40), (2, 3, 100, 77, 64),
                                  (2, 8, 1100, 77, 40)):
                shapes.append(check_train_shape(layout, B, H, N, M, D, dtype,
                                                timed=False))
    # peaked softmax: p and ds of unit scale through many tiles, and a delta
    # that matters
    for N, D in SERVE_LEVELS[:3]:
        shapes.append(check_train_shape("nhd", B_TRAIN, H_SERVE, N, N, D,
                                        torch.bfloat16, timed=False,
                                        q_scale=4.0))
    # the legacy train steps' attention: the CelebA-HQ AttentionBlocks'
    # interleaved views, BERT's and the 1p4B UNet's packed levels, timed;
    # peaked once; the tiny classifier's
    for B, H, N, M, D, layout in LEGACY_TRAIN_SHAPES:
        shapes.append(check_train_shape(layout, B, H, N, M, D,
                                        torch.bfloat16, timed=True))
    B, H, N, M, D, layout = LEGACY_TRAIN_SHAPES[1]
    shapes.append(check_train_shape(layout, B, H, N, M, D, torch.bfloat16,
                                    timed=False, q_scale=4.0))
    for B, H, N, M, D, layout in CLASSIFIER_TRAIN_SHAPES:
        shapes.append(check_train_shape(layout, B, H, N, M, D,
                                        torch.bfloat16, timed=False))
    return shapes


def geglu_inputs(rows, C, dtype, seed, inner=None):
    """x, LN scale and bias, W1, b1, W2, b2 of one FF sub-block (inner = 4C
    unless given), the weights drawn like the UNet's nn.Linear ones and
    handed over as the module hands them: transposed views of (out, in)
    buffers in `dtype`, biases fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    inner = inner or 4 * C
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)
    x = rnd(rows, C).to(dtype)
    ln = (1 + 0.1 * rnd(C), 0.1 * rnd(C))
    w1 = (rnd(2 * inner, C) * C ** -0.5).to(dtype).t()
    w2 = (rnd(C, inner) * inner ** -0.5).to(dtype).t()
    return x, ln, w1, 0.05 * rnd(2 * inner), w2, 0.05 * rnd(C)


def geglu_bound(rows, C, dtype):
    """24 rows C^2 operations (both products, inner = 4C) against x, out and
    the weights once (biases and LN vectors in fp32)."""
    es = torch.empty((), dtype=dtype).element_size()
    flops = 24.0 * rows * C * C
    nbytes = 2.0 * rows * C * es + 12.0 * C * C * es + 12.0 * C * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_geglu(entry, rows, C, dtype, timed, inner=None, bias=True):
    """One GEGLU kernel (`entry` "geglu_block" or "geglu_ffn") against its
    plain version (inner = 4C unless given; without ``bias`` no output bias,
    as a tensor-parallel rank's partial product): fp32 within
    GEGLU_F32_REL_TOL of the largest output; bf16 by fa.bf16_error_ratio <=
    1 and geglu.bf16_mean_error <= GEGLU_BF16_MEAN_ERR."""
    inner = inner or 4 * C
    x, (lns, lnb), w1, b1, w2, b2 = geglu_inputs(rows, C, dtype,
                                                 rows * 7 + C, inner)
    if not bias:
        b2 = None
    if entry == "geglu_block":
        run = lambda: geglu.geglu_block(x, lns, lnb, w1, b1, w2, b2,
                                        impl="cuda")
        plain = lambda: geglu.geglu_block_plain(x, lns, lnb, w1, b1, w2, b2)
        xla = lambda: geglu.geglu_block_xla(x, lns, lnb, w1, b1, w2, b2)
    else:
        run = lambda: geglu.geglu_ffn(x, w1, b1, w2, b2, impl="cuda")
        plain = lambda: geglu.geglu_ffn_plain(x, w1, b1, w2, b2)
        xla = lambda: geglu.geglu_xla(x, w1, b1, w2, b2)
    before = geglu.launch_counts()[entry]
    out = run()
    torch.cuda.synchronize()
    if geglu.launch_counts()[entry] != before + 1:
        raise RuntimeError(f"{entry}: the wrapper did not launch its kernel")
    ref = plain()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{entry}: shape/dtype {out.shape} {out.dtype} "
                           f"vs plain {ref.shape} {ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    how = geglu.plan(x.device, dtype, rows, C, inner)
    rec = {"rows": rows, "C": C, "inner": inner, "bias": bias,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "ref_max": ref.float().abs().max().item(),
           "splits": how["splits"], "cluster": how["cluster"],
           "partners": how["partners"], "row_tiles": how["row_tiles"]}
    if dtype == torch.bfloat16:
        rec["err_ratio"] = fa.bf16_error_ratio(out, ref)
        rec["mean_err"] = geglu.bf16_mean_error(out, ref)
        ok = np.isfinite(err) and rec["err_ratio"] <= 1.0 \
            and rec["mean_err"] <= GEGLU_BF16_MEAN_ERR
    else:
        ok = np.isfinite(err) and err <= GEGLU_F32_REL_TOL * rec["ref_max"]
    if timed:
        F = torch.nn.functional
        u = torch.randn(rows, C, device="cuda").to(dtype)
        y = torch.randn(rows, inner, device="cuda").to(dtype)
        w1t, w2t = w1.t(), w2.t()
        iters = 10 if rows * C >= 1 << 22 else 50
        (rec["kernel_ms"], rec["kernel_ms_min"]) = time_ms(run, iters)
        rec["plain_ms"] = time_ms(plain, 3)[0]
        rec["xla_route_ms"] = time_ms(xla, iters)[0]
        # no PyTorch call computes a GEGLU block: the two products alone
        rec["library_ms"] = time_ms(lambda: (F.linear(u, w1t), F.linear(
            y, w2t)), iters)[0]
        rec["bound_ms"], rec["bound_by"] = geglu_bound(rows, C, dtype)
    log("kernels", f"{entry} {json.dumps(rec)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{entry} disagrees with its plain version at "
                           f"{rec}")
    return rec


def phase_geglu_kernels():
    """Both GEGLU kernels at the serving and training shapes in bf16 and
    fp32, and at GEGLU_RAGGED_SHAPES; the serving shapes in bf16 are
    timed; ``geglu_ffn`` also at GEGLU_TP_SHAPES without an output bias
    (the tensor-parallel FF block's call)."""
    records = {}
    for entry in GEGLU_KERNELS:
        shapes = []
        for dtype in (torch.bfloat16, torch.float32):
            for rows, C in GEGLU_SERVE_SHAPES + GEGLU_TRAIN_SHAPES:
                shapes.append(check_geglu(entry, rows, C, dtype,
                                          timed=dtype == torch.bfloat16))
            for rows, C, inner in GEGLU_RAGGED_SHAPES:
                shapes.append(check_geglu(entry, rows, C, dtype, False,
                                          inner))
            if entry == "geglu_ffn":
                for rows, C, inner in GEGLU_TP_SHAPES:
                    shapes.append(check_geglu(entry, rows, C, dtype, False,
                                              inner, bias=False))
        records[entry] = shapes
    return records


def int8_bound(M, K, N, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    ops = 2.0 * M * N * K
    nbytes = M * K * es + K * N + N * 4 + M * N * es
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_int8(M, K, N, dtype, timed):
    """int8_matmul against its plain version, equal bit for bit: the plan's
    own choice of mode and every mode that can run the shape forced
    (``quant._forced_plan``, ``quant._int8_matmul_mode``), each launched
    once; ``launches`` is what the counter of ``quant.launch_counts()`` saw
    of these launches."""
    g = torch.Generator(device="cuda").manual_seed(M + 3 * K + 7 * N)
    w = torch.randn(K, N, device="cuda", generator=g) * K ** -0.5
    w_q, w_s = quant.quantize_per_channel(w)
    x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    ref = quant.int8_matmul_plain(x, w_q, w_s)
    how = quant.plan(x.device, dtype, M, N, K)
    rec = {"M": M, "K": K, "N": N, "dtype": str(dtype).replace("torch.", ""),
           "plan": how, "ref_max": ref.float().abs().max().item(),
           "max_abs_err": 0.0, "equal": True, "variants": {},
           "launches": 0}
    for variant in (None, "fused", "streamed"):
        if variant is not None:
            try:
                quant._forced_plan(x.device, dtype, M, N, K, variant)
            except ValueError:
                continue        # a mode that cannot run the shape
        before = quant.launch_counts()["int8_matmul"]
        out = quant.int8_matmul(x, w_q, w_s) if variant is None \
            else quant._int8_matmul_mode(x, w_q, w_s, variant)
        torch.cuda.synchronize()
        launched = quant.launch_counts()["int8_matmul"] - before
        if launched != 1:
            raise RuntimeError(f"int8_matmul: the wrapper counted {launched} "
                               f"launches of its kernel, not 1")
        rec["launches"] += launched
        err = (out.float() - ref.float()).abs().max().item()
        equal = out.shape == ref.shape and out.dtype == ref.dtype \
            and torch.equal(out, ref)
        rec["variants"][variant or "plan"] = equal
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["equal"] = rec["equal"] and equal
    if timed:
        iters = 10 if M * N >= 1 << 24 else 50
        (rec["kernel_ms"], rec["kernel_ms_min"]) = time_ms(
            lambda: quant.int8_matmul(x, w_q, w_s), iters)
        rec["plain_ms"] = time_ms(
            lambda: quant.int8_matmul_plain(x, w_q, w_s), 3)[0]
        # the library's int8 product alone, on x already quantised: no
        # quantisation, no dequantisation
        xq = quant._quantize_rows(x)[0].to(torch.int8)
        try:
            rec["library_int_mm_ms"] = time_ms(
                lambda: torch._int_mm(xq, w_q), iters)[0]
        except RuntimeError as e:
            rec["library_int_mm_ms"] = None
            rec["library_error"] = str(e).splitlines()[0][:120]
        rec["bound_ms"], rec["bound_by"] = int8_bound(M, K, N, dtype)
    log("kernels", f"int8_matmul {json.dumps(rec)} "
                   f"{'ok' if rec['equal'] else 'FAIL'}")
    if not rec["equal"]:
        raise RuntimeError(f"int8_matmul differs from its plain version at "
                           f"{rec}")
    return rec


def quotient_rows():
    """bf16 rows that hold, beside their absmax, every bf16 value the
    quantisation can tell apart from 0: for each of the 128 bf16
    significands of the absmax (at an exponent that moves from row group
    to row group), every bf16 value of either sign down to 2^-13 of it; and
    one group whose absmax is below the 1e-8 floor of the scale.  (K = 512
    columns, which both modes of the kernel take; zeros where a group's
    values run out.)"""
    K = 512
    bits = lambda e, m: np.uint32(((127 + e) << 23) | (m << 16))
    rows = []
    groups = [(m, (m * 7) % 41 - 20) for m in range(128)] + [(0, -30)]
    for m_a, e_a in groups:
        amax = np.array([bits(e_a, m_a)]).view(np.float32)[0]
        vals = [np.array([bits(e, m)]).view(np.float32)[0]
                for e in range(e_a - 13 if m_a else -45, e_a + 1)
                for m in range(128)]
        vals = [v for v in vals if v <= amax]
        vals = np.array(vals + [-v for v in vals], np.float32)
        for i in range(0, len(vals), K - 1):
            row = np.zeros(K, np.float32)
            row[0] = amax
            row[1:1 + len(vals[i:i + K - 1])] = vals[i:i + K - 1]
            rows.append(row)
    return np.stack(rows)


def check_int8_quotients():
    """The bf16 quantisation divides by the row's scale through its
    reciprocal and one exact residual step (csrc/int8_matmul.cu,
    ``quotient``); here every mode of the kernel is held bit for bit to the
    plain version (an IEEE division) on every bf16 value that matters
    (``quotient_rows``), against the identity matrix, so that each
    quantised value reaches the output on its own.  ``launches`` is what
    the counter of ``quant.launch_counts()`` saw."""
    x = torch.from_numpy(quotient_rows()).cuda().to(torch.bfloat16)
    M, K = x.shape
    w_q, w_s = quant.quantize_per_channel(torch.eye(K, device="cuda"))
    ref = quant.int8_matmul_plain(x, w_q, w_s)
    res = {"M": M, "K": K, "N": K, "launches": 0}
    for variant in ("fused", "streamed"):
        before = quant.launch_counts()["int8_matmul"]
        out = quant._int8_matmul_mode(x, w_q, w_s, variant)
        torch.cuda.synchronize()
        launched = quant.launch_counts()["int8_matmul"] - before
        if launched != 1:
            raise RuntimeError(f"int8_matmul: the wrapper counted {launched} "
                               f"launches of its kernel, not 1")
        res["launches"] += launched
        res[variant] = int((out != ref).sum().item())
    log("kernels", f"int8_matmul bf16 quotients, elements that differ from "
                   f"the plain version: {json.dumps(res)}")
    if res["fused"] or res["streamed"]:
        raise RuntimeError(f"int8_matmul: bf16 quotients differ {res}")
    return res


def phase_int8_kernels():
    recs = [check_int8(M, K, N, dtype, timed=dtype == torch.bfloat16
                       and (M, K, N) in INT8_TIMED)
            for dtype in (torch.bfloat16, torch.float32)
            for M, K, N in INT8_SHAPES]
    return recs, check_int8_quotients()


# -- phase 4 ------------------------------------------------------------------

def check_norm_affine():
    """The norms' bf16 branch with float32 parameters (the train step's
    case: fp32 storage, bf16 compute), scale ~ N(1, 0.2) and bias ~ N(0, 0.1)
    so that rounding them to bf16 would show, against the float32 formula
    rounded once (the JAX norms' arithmetic): every element within one bf16
    unit (``basic.bf16_ulps``).  GroupNorm on a channels_last (2, 320, 64, 64)
    tensor, LayerNorm on (2, 4096, 320)."""
    from celebbasis_tpu_torch.ops import basic
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(12)
    C, res = 320, {}
    for name in ("GroupNorm", "LayerNorm"):
        if name == "GroupNorm":
            x = torch.randn(2, C, 64, 64, device="cuda", generator=g).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            mod = basic.GroupNorm(C).cuda()
            formula = lambda: F.group_norm(x.float(), mod.num_groups,
                                           mod.weight, mod.bias, mod.epsilon)
        else:
            x = torch.randn(2, 4096, C, device="cuda", generator=g).to(
                torch.bfloat16)
            mod = basic.LayerNorm(C).cuda()
            formula = lambda: F.layer_norm(x.float(), (C,), mod.weight,
                                           mod.bias, mod.epsilon)
        with torch.no_grad():
            mod.weight.copy_(1 + 0.2 * torch.randn(C, device="cuda",
                                                   generator=g))
            mod.bias.copy_(0.1 * torch.randn(C, device="cuda", generator=g))
            out = mod(x)
            ref = formula().to(torch.bfloat16)
        d = basic.bf16_ulps(out, ref)
        res[name] = {"dtype": str(out.dtype).replace("torch.", ""),
                     "max_ulps": d.max().item(),
                     "beyond_one_ulp": (d > 1).float().mean().item()}
    log("parity", f"norms, bf16 input and float32 parameters, against the "
                  f"float32 formula rounded once: {json.dumps(res)}")
    if any(r["max_ulps"] > 1 or r["dtype"] != "bfloat16"
           for r in res.values()):
        raise RuntimeError(f"parity: a norm is not the float32 formula "
                           f"rounded once: {res}")


def phase_parity():
    """Tiny pipeline, fp32, 4 DDIM steps, given x_T: kernel route vs plain
    route.  TF32 is switched off for both so that only the attention core
    differs."""
    from celebbasis_tpu_torch.core import manager as mgr
    from celebbasis_tpu_torch.core.basis import build_celeb_basis
    from celebbasis_tpu_torch.loader import _FALLBACK_NAMES, init_weights
    from celebbasis_tpu_torch.pipeline import (CelebBasisPipeline,
                                               PipelineConfig, finish_images)
    from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer

    check_norm_affine()
    log("parity", "cudnn.allow_tf32 = matmul.allow_tf32 = False")
    cfg = PipelineConfig.tiny()
    tok = CLIPTokenizer.synthetic(cfg.clip.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.device("cuda"):
        pipe = CelebBasisPipeline(cfg, tok)
    pipe.requires_grad_(False).eval()
    init_weights(pipe, gen, zero_convs=False)
    basis = torch.from_numpy(build_celeb_basis(
        _FALLBACK_NAMES, tok, pipe.token_table(), cfg.basis)).cuda()
    state = mgr.init_state(pipe.manager_cfg, gen, device="cuda")
    size, B = 64, 2
    fn = pipe.make_txt2img_fn(num_steps=4, guidance_scale=10.0,
                              image_size=size, output="float")
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).cuda()
    tokens = dev(tok(["a photo of a sks person", "a ks person and a dog"]))
    uncond = dev(tok([""] * B))
    k = len(pipe.manager_cfg.placeholder_token_ids)
    ids = dev([[0, 1] + [0] * (k - 2), [1, 0] + [0] * (k - 2)])
    num_ids = dev([2, 2])
    lat = size // pipe.latent_factor
    x_T = torch.randn(B, lat, lat, 4, device="cuda", generator=gen)
    img_k, n_kernel, img_p, n_plain = kernel_vs_plain(
        lambda: fn(state, basis, tokens, uncond, ids, num_ids, None, x_T=x_T))
    u8_k = finish_images(img_k, "uint8").int()
    u8_p = finish_images(img_p, "uint8").int()
    dfloat = (img_k - img_p).abs().max().item()
    dpix = (u8_k - u8_p).abs().max().item()
    log("parity", f"tiny fp32 {size}x{size} 4 steps: kernel launches "
                  f"{n_kernel} (plain route {n_plain}), max |float diff| "
                  f"{dfloat:.3e}, max pixel diff {dpix} levels, image std "
                  f"{img_k.std().item():.3f}")
    if not torch.isfinite(img_k).all() or img_k.std().item() < 1e-3:
        raise RuntimeError("parity: the image is not finite or is constant")
    if n_kernel == 0 or n_plain != 0:
        raise RuntimeError("parity: the routes did not go where they should")
    if dpix > 1:
        raise RuntimeError(f"parity: pixels differ by {dpix} levels (> 1)")
    # the same with the FF sub-blocks on the GEGLU kernel route
    geglu.set_default_impl("cuda")
    try:
        with no_tf32():
            fn(state, basis, tokens, uncond, ids, num_ids, None, x_T=x_T)
            geglu.reset_launch_count()
            img_g = fn(state, basis, tokens, uncond, ids, num_ids, None,
                       x_T=x_T)
            torch.cuda.synchronize()
            n_geglu = geglu.launch_counts()
    finally:
        geglu.set_default_impl(None)
    n_ff = ff_blocks(pipe.unet)
    dpix = (finish_images(img_g, "uint8").int() - u8_k).abs().max().item()
    log("parity", f"GEGLU kernel route vs plain route: launches {n_geglu} "
                  f"({n_ff} FF sub-blocks per UNet call), max |float diff| "
                  f"{(img_g - img_k).abs().max().item():.3e}, max pixel diff "
                  f"{dpix} levels")
    if n_geglu["geglu_ffn"] or not n_geglu["geglu_block"] \
            or n_geglu["geglu_block"] % n_ff:
        raise RuntimeError("parity: the GEGLU route did not go where it "
                           "should")
    if not torch.isfinite(img_g).all() or dpix > 1:
        raise RuntimeError(f"parity: the GEGLU routes differ by {dpix} "
                           f"levels (> 1)")
    check_generation_parity(pipe, basis, state, tokens, uncond, ids, num_ids,
                            x_T, gen, size, n_kernel)


def kernel_vs_plain(run):
    """``run()`` with TF32 off, on the attention kernel route and then on the
    plain route -> (kernel image, its flash launches, plain image, its flash
    launches).  Each route's first call captures its graph (the route is
    part of the signature); the image and the launches are a second call's,
    a replay's."""
    with no_tf32():
        run()
        fa.reset_launch_count()
        img_k = run()
        n_k = fa.launch_count()
        attn_ops.set_default_impl("xla")
        try:
            run()
            fa.reset_launch_count()
            img_p = run()
            n_p = fa.launch_count()
        finally:
            attn_ops.set_default_impl(None)
        torch.cuda.synchronize()
    return img_k, n_k, img_p, n_p


def check_generation_parity(pipe, basis, state, tokens, uncond, ids, num_ids,
                            x_T, gen, size, n_txt2img):
    """The tiny fp32 PLMS chain (5 steps: first to fourth order, 6 UNet
    calls) and the tiny live-face function (a tiny MetaIdNet on two crops a
    row, 4 DDIM steps), kernel route against plain route: float images
    within 1e-3, pixels within one level (the pipeline tests' limits).
    ``n_txt2img``: the kernel launches of the 4-step txt2img run, 4 UNet
    calls and the tiny VAE decode's one attention."""
    import dataclasses

    from celebbasis_tpu_torch.core.meta_net import MetaIdNet, MetaNetConfig
    from celebbasis_tpu_torch.loader import init_weights
    from celebbasis_tpu_torch.pipeline import finish_images

    cfg, B = pipe.cfg, tokens.shape[0]
    with torch.inference_mode():              # one guided UNet call
        fa.reset_launch_count()
        pipe.unet(torch.cat([x_T, x_T]),
                  torch.full((2 * B,), 500, device="cuda"),
                  torch.zeros(2 * B, cfg.clip.max_length, cfg.clip.width,
                              device="cuda"))
        per_call = fa.launch_count()
    plms = pipe.make_txt2img_fn(num_steps=5, guidance_scale=10.0,
                                image_size=size, sampler="plms",
                                output="float")
    m_cfg = dataclasses.replace(MetaNetConfig.tiny(),
                                inner_dim=cfg.basis.n_components,
                                token_dim=cfg.clip.width)
    with torch.device("cuda"):
        meta = MetaIdNet(m_cfg, dtype=torch.float32)
    init_weights(meta.requires_grad_(False).eval(), gen)
    faces = torch.rand(B, 2, size, size, 3, device="cuda",
                       generator=gen) * 2 - 1
    faces_fn = pipe.make_txt2img_faces_fn(meta, num_steps=4,
                                          guidance_scale=10.0,
                                          image_size=size, output="float")
    face_ids = torch.arange(2, device="cuda").expand(B, 2)
    face_num = torch.tensor([2, 1], device="cuda")
    cases = {
        "plms": (6, lambda: plms(state, basis, tokens, uncond, ids, num_ids,
                                 None, x_T=x_T)),
        "faces": (4, lambda: faces_fn(basis, tokens, uncond, faces, face_ids,
                                      face_num, None, x_T=x_T)),
    }
    for name, (calls, run) in cases.items():
        img_k, n_k, img_p, n_p = kernel_vs_plain(run)
        dfloat = (img_k - img_p).abs().max().item()
        dpix = (finish_images(img_k, "uint8").int()
                - finish_images(img_p, "uint8").int()).abs().max().item()
        log("parity", f"tiny fp32 {name} {size}x{size}: kernel launches "
                      f"{n_k} ({calls} UNet calls; plain route {n_p}), max "
                      f"|float diff| {dfloat:.3e}, max pixel diff {dpix} "
                      f"levels, image std {img_k.std().item():.3f}")
        if not torch.isfinite(img_k).all() or img_k.std().item() < 1e-3:
            raise RuntimeError(f"parity: the {name} image is not finite or "
                               f"is constant")
        want = n_txt2img + (calls - 4) * per_call
        if n_k != want or n_p != 0:
            raise RuntimeError(f"parity: {name} launched {n_k} / {n_p}; "
                               f"expected {want} / 0")
        if dfloat > 1e-3 or dpix > 1:
            raise RuntimeError(f"parity: {name} routes differ by {dfloat:.3e}"
                               f" (> 1e-3) or {dpix} levels (> 1)")


def ff_blocks(unet) -> int:
    from celebbasis_tpu_torch.models.unet import FeedForwardGEGLU
    return sum(isinstance(m, FeedForwardGEGLU) for m in unet.modules())


# -- phase 5 ------------------------------------------------------------------

def synthetic_batch(tokenizer, size, face_size, seed, device):
    """A training batch from a numpy seed: batch 2, two face slots; images
    and faces uniform in [-1, 1], channels-last; prompts with one and two
    placeholders; identities 0 (row 0) and 2, 1 (row 1)."""
    r = np.random.default_rng(seed)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return {
        "image": dev(r.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)),
        "tokens": dev(np.asarray(tokenizer(
            ["face of sks person", "a photo of sks person and ks person"]),
            np.int64)),
        "faces": dev(r.uniform(-1, 1, (2, 2, face_size, face_size, 3)).astype(
            np.float32)),
        "ids": dev(np.array([[0, 1], [2, 1]], np.int64)),
        "num_ids": dev(np.array([1, 2], np.int64)),
    }


def loss_and_mlp_grad(loss_fn, meta_net, mstate, basis, batch, seed):
    """One forward and backward with the draws of a generator seeded with
    `seed`; returns (loss, flat MLP gradient, launch counters)."""
    for p in meta_net.parameters():
        p.grad = None
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fa.reset_launch_count()
    geglu.reset_launch_count()
    loss, _ = loss_fn(mstate, basis, batch, gen)
    loss.backward()
    torch.cuda.synchronize()
    grad = torch.cat([p.grad.flatten().float()
                      for p in meta_net.mlp.parameters()])
    return loss.item(), grad, {**fa.launch_counts(), **geglu.launch_counts()}


def phase_train_parity():
    """Tiny pipeline and MetaIdNet, fp32, on the card: loss and MLP gradient
    with attention on the kernel route against the plain route, the same
    draws.  TF32 off for both, so that only the attention core differs."""
    import dataclasses

    from celebbasis_tpu_torch.core import manager as mgr
    from celebbasis_tpu_torch.core.basis import build_celeb_basis
    from celebbasis_tpu_torch.core.meta_net import MetaIdNet, MetaNetConfig
    from celebbasis_tpu_torch.loader import _FALLBACK_NAMES, init_weights
    from celebbasis_tpu_torch.pipeline import (CelebBasisPipeline,
                                               PipelineConfig)
    from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
    from celebbasis_tpu_torch.train import step as tstep

    with no_tf32():
        cfg = PipelineConfig.tiny()
        tok = CLIPTokenizer.synthetic(cfg.clip.vocab_size)
        gen = torch.Generator(device="cuda").manual_seed(4)
        with torch.device("cuda"):
            pipe = CelebBasisPipeline(cfg, tok)
            meta = MetaIdNet(dataclasses.replace(
                MetaNetConfig.tiny(), inner_dim=cfg.basis.n_components,
                token_dim=cfg.clip.width), dtype=torch.float32)
        pipe.requires_grad_(False).eval()
        meta.requires_grad_(False).eval()
        init_weights(pipe, gen, zero_convs=False)
        init_weights(meta, gen)
        basis = torch.from_numpy(build_celeb_basis(
            _FALLBACK_NAMES, tok, pipe.token_table(), cfg.basis)).cuda()
        mstate = mgr.init_state(pipe.manager_cfg, gen, device="cuda")
        batch = synthetic_batch(tok, 64, 40, 6, "cuda")
        tstep.build_trainable(meta)
        loss_fn = tstep.make_loss_fn(pipe, meta)
        loss_k, grad_k, n_k = loss_and_mlp_grad(loss_fn, meta, mstate, basis,
                                                batch, 7)
        attn_ops.set_default_impl("xla")
        try:
            loss_p, grad_p, n_p = loss_and_mlp_grad(loss_fn, meta, mstate,
                                                    basis, batch, 7)
        finally:
            attn_ops.set_default_impl(None)
    rel = ((grad_k - grad_p).abs().max() / grad_p.abs().max()).item()
    log("train_parity", f"tiny fp32 64x64: loss {loss_k:.6f} (kernel route) "
                        f"{loss_p:.6f} (plain route); MLP gradient max "
                        f"|diff| / max |grad| {rel:.3e}, max |grad| "
                        f"{grad_p.abs().max().item():.3e}; launches {n_k} "
                        f"(plain route {n_p})")
    if not np.isfinite(loss_k) or grad_p.abs().max().item() == 0.0:
        raise RuntimeError("train_parity: no finite loss or no gradient")
    if min(n_k["fwd_lse"], n_k["dq"], n_k["dkv"]) == 0 or sum(n_p.values()):
        raise RuntimeError("train_parity: the routes did not go where they "
                           "should")
    # fp32 on both routes: summation order only, through a UNet backward
    if abs(loss_k - loss_p) > 1e-5 or rel > 1e-4:
        raise RuntimeError(f"train_parity: kernel and plain routes differ "
                           f"(loss {abs(loss_k - loss_p):.2e}, gradient "
                           f"{rel:.2e})")
    # the FF sub-blocks on the GEGLU kernel route (attention on its kernel
    # route on both sides); the backward recomputes through the plain path
    geglu.set_default_impl("cuda")
    try:
        with no_tf32():
            loss_g, grad_g, n_g = loss_and_mlp_grad(loss_fn, meta, mstate,
                                                    basis, batch, 7)
    finally:
        geglu.set_default_impl(None)
    rel = ((grad_g - grad_k).abs().max() / grad_k.abs().max()).item()
    log("train_parity", f"GEGLU kernel route vs plain route: loss "
                        f"{loss_g:.6f} vs {loss_k:.6f}; MLP gradient max "
                        f"|diff| / max |grad| {rel:.3e}; geglu_block "
                        f"launches {n_g['geglu_block']} "
                        f"({ff_blocks(pipe.unet)} FF sub-blocks)")
    if n_g["geglu_block"] != ff_blocks(pipe.unet) or n_k["geglu_block"]:
        raise RuntimeError("train_parity: the GEGLU route did not go where "
                           "it should")
    if abs(loss_g - loss_k) > 1e-5 or rel > 1e-4:
        raise RuntimeError(f"train_parity: the GEGLU routes differ (loss "
                           f"{abs(loss_g - loss_k):.2e}, gradient {rel:.2e})")


# -- phase 6 ------------------------------------------------------------------

def decode_png(data: bytes) -> np.ndarray:
    """Decoder for the PNGs the service writes (8-bit RGB, filter type 0)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError("bad PNG checksum")
        if tag == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if (depth, colour) != (8, 2):
                raise ValueError("expected 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("expected filter type 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def post(url, obj, path="/txt2img"):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        return json.loads(r.read())


def face_crops(size, seed, k=2):
    """k random-pixel (size, size, 3) uint8 crops from a numpy seed."""
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(k)]


def phase_serve():
    from http.server import ThreadingHTTPServer

    from celebbasis_tpu_torch.cli.serve import (TxtToImgService,
                                                build_argparser, encode_png,
                                                make_handler)
    from celebbasis_tpu_torch.loader import init_weights
    from celebbasis_tpu_torch.utils.config import RunSpec, load_run_spec
    from celebbasis_tpu_torch.utils.precision import cast_float_params

    config = os.path.join(REPO, "configs", "aigc_id.yaml")
    try:
        spec = load_run_spec([config])
        log("serve", f"config: {os.path.relpath(config, REPO)} (yaml)")
    except ImportError:
        spec = RunSpec.sd_v1()
        log("serve", "config: typed defaults RunSpec.sd_v1() (no yaml module)")
    spec.celeb_txt = os.path.join(REPO, "infer_images", "wiki_names_v2.txt")
    args = build_argparser().parse_args([
        "--config", config, "--H", "512", "--batch", "2", "--ddim_steps",
        str(DDIM_STEPS), "--precision", "bf16", "--ids", "0", "1"])
    t0 = time.perf_counter()
    service = TxtToImgService(args, spec=spec)
    # draw the zero-initialised output convs too, so that every layer (and
    # every attention call) shows in the pixels of this random-weight run
    pipe = service.asm.pipeline
    init_weights(pipe.unet, torch.Generator(device="cuda").manual_seed(5),
                 zero_convs=False)
    cast_float_params(pipe, torch.bfloat16)
    n_params = sum(p.numel() for p in pipe.parameters())
    log("serve", f"assembled in {time.perf_counter() - t0:.1f} s: "
                 f"{n_params / 1e6:.0f} M parameters, "
                 f"{next(pipe.unet.parameters()).dtype}, basis "
                 f"{tuple(service.asm.basis.shape)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    service.warmup()
    capture_s = {"txt2img": list(service.fn.captured.capture_s.values()),
                 "faces2img": list(
                     service.faces_fn.captured.capture_s.values())}
    log("serve", f"warm-up (captures the /txt2img and /faces2img graphs at "
                 f"batch 2): {time.perf_counter() - t0:.1f} s; seconds to "
                 f"warm, capture and replay each {json.dumps(capture_s)}")
    if [len(v) for v in capture_s.values()] != [1, 1]:
        raise RuntimeError(f"serve: warm-up captured {capture_s}")

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results = {}

    def ask(name, prompt, seed, n=1):
        code, body = post(url, {"prompt": prompt, "seed": seed,
                                "n_samples": n})
        if code != 200:
            raise RuntimeError(f"request {name}: HTTP {code} {body}")
        imgs = [decode_png(base64.b64decode(b)) for b in body["images"]]
        results[name] = (imgs, body["ms"])
        log("serve", f"request {name}: {body['ms']:.1f} ms, {n} image(s), "
                     f"{DDIM_STEPS} steps")

    p_a, p_b = "a photo of a sks person", "a portrait of a ks person"
    try:
        os.environ.pop("CELEBBASIS_FLASH_LAYOUT", None)
        fa.reset_launch_count()
        calls0 = healthz(url)["batched_calls"]
        ask("alone", p_a, 11)
        old_window, service.window = service.window, 2.0
        errors = []

        def guarded(*a):
            try:
                ask(*a)
            except Exception as e:           # noqa: BLE001 -- re-raised below
                errors.append(e)

        threads = [threading.Thread(target=guarded, args=("cobatched", p_a, 11)),
                   threading.Thread(target=guarded, args=("other", p_b, 22))]
        [t.start() for t in threads]
        [t.join() for t in threads]
        service.window = old_window
        if errors:
            raise errors[0]
        calls_pair = healthz(url)["batched_calls"] - calls0 - 1
        ask("repeat", p_a, 11)
        code, body = post(url, {"prompt": "x", "n_samples": 3})
        if code != 400:
            raise RuntimeError(f"oversized request answered {code}, not 400")
        calls_packed = healthz(url)["batched_calls"] - calls0
        n_packed = fa.launch_count("flash_attention_nhd")
        n_other = fa.launch_count("flash_attention")

        # the layout is part of a graph's signature: this request captures
        # the per-head graph, whose warm-up launches #2 as the replay does
        caps0 = graphs.captures()
        os.environ["CELEBBASIS_FLASH_LAYOUT"] = "bhnd"
        ask("per_head_layout", p_a, 11)
        os.environ.pop("CELEBBASIS_FLASH_LAYOUT")
        caps_per_head = graphs.captures() - caps0
        calls_total = healthz(url)["batched_calls"] - calls0
        n_per_head = fa.launch_count("flash_attention")
        h = healthz(url)

        # live faces: two 512x512 crops, two samples, outside the batcher
        faces_req = {"prompt": "a photo of a sks person and a ks person",
                     "seed": 41, "n_samples": 2,
                     "faces": [base64.b64encode(encode_png(c)).decode()
                               for c in face_crops(512, 31)]}
        face_bodies = []
        fa.reset_launch_count()
        for name in ("faces", "faces_repeat"):
            code, body = post(url, faces_req, path="/faces2img")
            if code != 200:
                raise RuntimeError(f"request {name}: HTTP {code} {body}")
            results[name] = ([decode_png(base64.b64decode(b))
                              for b in body["images"]], body["ms"])
            face_bodies.append(body["images"])
            log("serve", f"request {name}: {body['ms']:.1f} ms, 2 crops, 2 "
                         f"images, {DDIM_STEPS} steps")
        n_faces = {n: c for n, c in fa.launch_counts().items() if c}
        code, body = post(url, dict(faces_req, faces=[]), path="/faces2img")
        if code != 400:
            raise RuntimeError(f"/faces2img without faces answered {code}")

        # the FF sub-blocks on the GEGLU kernel route
        geglu.set_default_impl("cuda")
        h_geglu = healthz(url)
        calls_g0 = h_geglu["batched_calls"]
        geglu.reset_launch_count()
        caps0 = graphs.captures()
        ask("geglu_cuda", p_a, 11)
        ask("geglu_cuda_repeat", p_a, 11)
        caps_geglu = graphs.captures() - caps0
        calls_geglu = healthz(url)["batched_calls"] - calls_g0
        n_geglu = geglu.launch_counts()
        geglu.set_default_impl(None)
        both_ways = serve_graph_vs_eager(service, ask, results, faces_req,
                                         url)
    finally:
        geglu.set_default_impl(None)
        os.environ.pop("CELEBBASIS_FLASH_LAYOUT", None)
        httpd.shutdown()
        httpd.server_close()
        service.stop()
        thread.join(timeout=10)
    peak = torch.cuda.max_memory_allocated()
    log("serve", f"healthz: {json.dumps(h)}")
    log("serve", f"device calls: {calls_packed} packed + "
                 f"{calls_total - calls_packed} per-head; launches "
                 f"flash_attention_nhd {n_packed}, flash_attention "
                 f"{n_per_head}; peak memory {peak / 2**30:.2f} GiB")

    if calls_pair != 1:
        raise RuntimeError(f"the two concurrent requests took {calls_pair} "
                           f"device calls, not 1")
    log("serve", f"/faces2img: launches {json.dumps(n_faces)} over two "
                 f"requests; sampler {h['sampler']!r}")
    if n_faces != {"flash_attention_nhd": 2 * ATTN_PER_UNET * DDIM_STEPS}:
        raise RuntimeError(f"/faces2img launched {n_faces}; expected "
                           f"{ATTN_PER_UNET * DDIM_STEPS} packed a request")
    if len(results["faces"][0]) != 2 or face_bodies[0] != face_bodies[1]:
        raise RuntimeError("/faces2img: not two images, or not the same "
                           "bytes for the same seed")
    if h["sampler"] != "ddim":
        raise RuntimeError(f"/healthz names the sampler {h['sampler']!r}")
    want = ATTN_PER_UNET * DDIM_STEPS
    if n_packed != want * calls_packed or n_other != 0:
        raise RuntimeError(
            f"flash_attention_nhd launched {n_packed} times (and "
            f"flash_attention {n_other}) over {calls_packed} device calls; "
            f"expected {want} per call")
    if caps_per_head != 1 or n_per_head != want * (
            calls_total - calls_packed + caps_per_head):
        raise RuntimeError(f"flash_attention launched {n_per_head} times in "
                           f"the per-head layout over one capture "
                           f"({caps_per_head} made); expected {want} for the "
                           f"warm-up and {want} for the request")
    for name, (imgs, _) in results.items():
        for im in imgs:
            if im.shape != (512, 512, 3) or im.dtype != np.uint8:
                raise RuntimeError(f"{name}: image {im.shape} {im.dtype}")
            if im.std() < 1.0:
                raise RuntimeError(f"{name}: constant image")
    ref = results["alone"][0][0]
    for name in ("cobatched", "repeat"):
        if not np.array_equal(results[name][0][0], ref):
            raise RuntimeError(f"request {name!r} differs from the same seed "
                               f"served alone")
    if np.array_equal(results["other"][0][0], ref):
        raise RuntimeError("another prompt and seed gave the same image")
    d = np.abs(results["per_head_layout"][0][0].astype(int)
               - ref.astype(int)).max()
    log("serve", f"per-head layout vs packed layout: max pixel diff {d}")
    if d > 1:
        raise RuntimeError(f"the two layouts differ by {d} levels")

    img_g = results["geglu_cuda"][0][0]
    dg = np.abs(img_g.astype(int) - ref.astype(int))
    log("serve", f"GEGLU route: healthz geglu={h_geglu['geglu']!r} (default "
                 f"{h['geglu']!r}); launches {json.dumps(n_geglu)} over "
                 f"{calls_geglu} device calls; request ms "
                 f"{results['geglu_cuda'][1]:.1f} / "
                 f"{results['geglu_cuda_repeat'][1]:.1f} (xla route: alone "
                 f"{results['alone'][1]:.1f}, repeat "
                 f"{results['repeat'][1]:.1f}); pixels vs the xla route: max "
                 f"diff {dg.max()}, mean {dg.mean():.3f} levels (bf16 rounds "
                 f"at other places on the two routes)")
    if h["geglu"] != "xla" or h_geglu["geglu"] != "cuda":
        raise RuntimeError(f"/healthz names the GEGLU route {h['geglu']!r} / "
                           f"{h_geglu['geglu']!r}")
    if n_geglu != {"geglu_block": GEGLU_PER_UNET * DDIM_STEPS
                   * (calls_geglu + caps_geglu), "geglu_ffn": 0} \
            or calls_geglu != 2 or caps_geglu != 1:
        raise RuntimeError(f"GEGLU launches {n_geglu} over {calls_geglu} "
                           f"device calls and {caps_geglu} captures; "
                           f"expected {GEGLU_PER_UNET} per UNet call")
    if not np.array_equal(results["geglu_cuda_repeat"][0][0], img_g):
        raise RuntimeError("the GEGLU route does not repeat its pixels")
    return ({"flash_attention_nhd": n_packed
             + n_faces["flash_attention_nhd"]
             + both_ways.pop("launches"),
             "flash_attention": n_per_head,
             "geglu_block": n_geglu["geglu_block"]},
            {**{name: ms for name, (_, ms) in results.items()},
             "capture_s": capture_s, "graph_vs_eager": both_ways})


def serve_graph_vs_eager(service, ask, results, faces_req, url):
    """The same /txt2img and /faces2img requests through the daemon on its
    graphs and on the eager functions (``fn.eager``), in turns (graph,
    eager, eager, graph): every image the same bytes (/txt2img's also those
    of the request served alone at the phase's start), one request's
    launches the same both ways, request ms and peak memory of each way.
    -> a record (``launches``: all launched here, for the kernels line)."""
    real = service.fn, service.faces_fn
    rec, launches = {}, 0
    try:
        for i, way in enumerate(("graph", "eager", "eager", "graph")):
            service.fn, service.faces_fn = (
                real if way == "graph" else (real[0].eager, real[1].eager))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_count()
            ask(f"{way}{i}", "a photo of a sks person", 11)
            n_txt = fa.launch_count()
            code, body = post(url, faces_req, path="/faces2img")
            if code != 200:
                raise RuntimeError(f"/faces2img {way}: HTTP {code} {body}")
            torch.cuda.synchronize()
            n_all = fa.launch_count()
            launches += n_all
            r = rec.setdefault(way, {"txt2img_ms": [], "faces2img_ms": [],
                                     "launches": [], "peak_gib": [],
                                     "peak_reserved_gib": []})
            imgs, ms = results.pop(f"{way}{i}")
            if not np.array_equal(imgs[0], results["alone"][0][0]):
                raise RuntimeError(f"serve: /txt2img on the {way} path "
                                   f"gives other pixels than the request "
                                   f"served alone")
            r["txt2img_ms"].append(ms)
            r["faces2img_ms"].append(body["ms"])
            r["launches"].append((n_txt, n_all - n_txt))
            r["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            r["peak_reserved_gib"].append(
                torch.cuda.max_memory_reserved() / 2**30)
            rec.setdefault("images", []).append(body["images"])
    finally:
        service.fn, service.faces_fn = real
    ref = rec.pop("images")
    log("serve", f"graph vs eager, in turns: /txt2img ms "
                 f"{rec['graph']['txt2img_ms']} vs "
                 f"{rec['eager']['txt2img_ms']}, /faces2img ms "
                 f"{rec['graph']['faces2img_ms']} vs "
                 f"{rec['eager']['faces2img_ms']}; flash launches a request "
                 f"{rec['graph']['launches']} vs {rec['eager']['launches']}; "
                 f"peak allocated GiB {rec['graph']['peak_gib']} vs "
                 f"{rec['eager']['peak_gib']}, reserved "
                 f"{rec['graph']['peak_reserved_gib']} vs "
                 f"{rec['eager']['peak_reserved_gib']}")
    if any(images != ref[0] for images in ref):
        raise RuntimeError("serve: /faces2img gives other bytes on its graph "
                           "than eagerly")
    want = (ATTN_PER_UNET * DDIM_STEPS, ATTN_PER_UNET * DDIM_STEPS)
    if any(n != want for way in ("graph", "eager")
           for n in rec[way]["launches"]):
        raise RuntimeError(f"serve: launches a request graph "
                           f"{rec['graph']['launches']}, eager "
                           f"{rec['eager']['launches']}; expected {want}")
    rec["latents"], n = chain_graph_vs_eager(service)
    rec["launches"] = launches + n
    return rec


def chain_graph_vs_eager(service):
    """The daemon's DDIM chain alone (DDIM_STEPS guided steps from given
    x_T over its conditioning at batch 2, bf16), captured and eagerly: the
    final latents bit for bit, and the launches of one replay equal to one
    eager chain's.  -> (record, packed launches made here)."""
    from celebbasis_tpu_torch.diffusion.sampler import (SamplerConfig,
                                                        ddim_sample)
    from celebbasis_tpu_torch.diffusion.schedules import make_ddim_schedule

    asm = service.asm
    pipe = asm.pipeline
    ddim = make_ddim_schedule(pipe.schedule, DDIM_STEPS, 0.0)
    scfg = SamplerConfig(guidance_scale=10.0)
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).cuda()

    def chain(cond, uncond, x_T):
        return ddim_sample(pipe.eps_model(), ddim, generators=None,
                           shape=tuple(x_T.shape), cond=cond, uncond=uncond,
                           cfg=scfg, x_T=x_T)

    captured = graphs.Captured(chain)
    with torch.inference_mode():
        cond = pipe.conditioning(
            as_dev(asm.tokenizer(["a photo of a sks person"] * 2)),
            asm.manager_state, asm.basis, as_dev([[0, 1]] * 2),
            as_dev([2, 2]))
        uncond = pipe.conditioning(as_dev(asm.tokenizer([""] * 2)))
        x_T = torch.randn(2, 64, 64, 4, device="cuda", generator=torch.
                          Generator(device="cuda").manual_seed(17))
        fa.reset_launch_count()
        eager = chain(cond, uncond, x_T)
        n_eager = fa.launch_count("flash_attention_nhd")
        captured(cond, uncond, x_T)
        fa.reset_launch_count()
        graph = captured(cond, uncond, x_T)
        torch.cuda.synchronize()
        n_graph = fa.launch_count("flash_attention_nhd")
    same = torch.equal(graph, eager)
    diff = (graph - eager).abs().max().item()
    log("serve", f"the DDIM chain alone ({DDIM_STEPS} steps, batch 2), "
                 f"graph vs eager: final latents bit for bit {same} "
                 f"(largest difference {diff:.3e}), std "
                 f"{eager.std().item():.3f}; packed launches a chain "
                 f"{n_graph} vs {n_eager}")
    if not same or n_graph != n_eager or n_eager != ATTN_PER_UNET * \
            DDIM_STEPS or not torch.isfinite(eager).all():
        raise RuntimeError("serve: the captured DDIM chain does not give "
                           "its eager latents or launches")
    # launched here: the eager chain, the capture's warm-up, two replays
    return {"equal": same, "launches": n_graph}, 4 * n_eager


# -- phase 7 ------------------------------------------------------------------

def align_photos(folder, n, seed, size=ALIGN_PHOTO):
    """``n`` size x size PNG "photos": smooth random colour fields with
    noise, from a numpy seed.  -> their paths."""
    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    r = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        coarse = r.integers(0, 256, (size // 32 + 1, size // 32 + 1, 3),
                            dtype=np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((size, size),
                                                        Image.BILINEAR),
                         np.int16)
        img = np.clip(img + r.integers(-24, 25, img.shape), 0, 255)
        paths.append(os.path.join(folder, f"photo_{i}.png"))
        Image.fromarray(img.astype(np.uint8)).save(paths[-1])
    return paths


def face_logits(detector, rgbs):
    """The face-minus-background logit of every anchor on each image."""
    out = []
    with torch.inference_mode(), no_tf32():
        for rgb in rgbs:
            x = torch.from_numpy(rgb[None].copy()).cuda().float() \
                - detector._means
            _, conf = detector.net(x)
            out.append((conf[0, :, 1].log() - conf[0, :, 0].log()).cpu()
                       .numpy())
    return out


def write_align_files(work, photos):
    """Synthetic ``FaceBoxesV2.pth`` and ``epoch59.pth`` with every key and
    shape of their manifests (``synthetic_value``, seeded on the card) and a
    jittered-grid meanface file.  The face-class biases of the ``conf.*``
    heads are then set from the photos' logits: a quarter of the anchors
    pass the 0.6 threshold, and where the logits spread so far that the
    best scores would reach 0.999, the class heads are scaled down first
    (the scale is reported).  -> (paths, calibration record)."""
    from PIL import Image

    from celebbasis_tpu_torch.align.faceboxes import FaceBoxesDetector
    from celebbasis_tpu_torch.utils.bridge_align import convert_faceboxes
    gen = torch.Generator(device="cuda").manual_seed(77)
    states = {}
    for name, manifest in (("fb", FB_MANIFEST), ("pip", PIP_MANIFEST)):
        with open(manifest) as f:
            keys = json.load(f)["keys"]
        states[name] = {k: synthetic_value(k, tuple(s), gen)
                        for k, s in keys.items()}
    fb = states["fb"]
    rgbs = [np.asarray(Image.open(p).convert("RGB")) for p in photos]
    det = FaceBoxesDetector(convert_faceboxes(fb), device="cuda")
    d = np.concatenate(face_logits(det, rgbs))
    q75, top = float(np.quantile(d, 0.75)), float(d.max())
    # logit of the threshold score 0.6; the best scores stay below 0.99
    thr, ceiling = float(np.log(0.6 / 0.4)), float(np.log(0.99 / 0.01))
    scale = min(1.0, 0.8 * (ceiling - thr) / max(top - q75, 1e-6))
    bias = thr - scale * q75
    for i in range(3):
        fb[f"conf.{i}.weight"] = fb[f"conf.{i}.weight"] * scale
        b = fb[f"conf.{i}.bias"] * scale
        b[1::2] += bias
        fb[f"conf.{i}.bias"] = b
    paths = {"fb": os.path.join(work, "FaceBoxesV2.pth"),
             "pip": os.path.join(work, "epoch59.pth"),
             "meanface": os.path.join(work, "meanface.txt")}
    torch.save(fb, paths["fb"])
    torch.save(states["pip"], paths["pip"])
    g = np.stack(np.meshgrid(np.linspace(0.1, 0.9, 10),
                             np.linspace(0.1, 0.9, 10)), -1).reshape(-1, 2)
    mf = g[:98] + np.random.default_rng(78).normal(0, 0.01, (98, 2))
    with open(paths["meanface"], "w") as f:
        f.write(" ".join(f"{v:.6f}" for v in mf.ravel()) + "\n")
    return paths, {"logit_q75": q75, "logit_max": top, "head_scale": scale,
                   "face_bias": bias}


def check_resampler_against_cv2():
    """Where OpenCV imports, ``align.cv_resample`` bit for bit against it
    (resize to a size and by a factor, warpAffine leaving the image, the
    warp of the installed generation: OpenCV 4 or 5).  -> cv2's version or
    None."""
    try:
        import cv2
    except ImportError:
        return None
    from celebbasis_tpu_torch.align import cv_resample
    version = 4 if int(cv2.__version__.split(".")[0]) < 5 else 5
    if cv_resample.default_warp_version() != version:
        raise RuntimeError(f"align: OpenCV {cv2.__version__} imports but the "
                           f"resampler's default warp is OpenCV "
                           f"{cv_resample.default_warp_version()}'s")
    r = np.random.default_rng(5)
    for _ in range(20):
        h, w = (int(v) for v in r.integers(20, 700, 2))
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        size = int(r.integers(16, 600))
        scale = float(r.choice([0.5, 600.0 / min(h, w), r.uniform(0.3, 2)]))
        ang, s = r.uniform(-0.6, 0.6), r.uniform(0.3, 3)
        M = np.array([[s * np.cos(ang), -s * np.sin(ang), r.uniform(-99, 99)],
                      [s * np.sin(ang), s * np.cos(ang), r.uniform(-99, 99)]])
        pairs = [(cv_resample.resize_linear(img, (size, size)),
                  cv2.resize(img, (size, size)))]
        if round(h * scale) >= 1 and round(w * scale) >= 1:
            pairs.append((cv_resample.resize_scale(img, scale),
                          cv2.resize(img, None, fx=scale, fy=scale)))
        pairs.append((cv_resample.warp_affine(img, M, (size, size),
                                              version),
                      cv2.warpAffine(img, M, (size, size), borderValue=0)))
        for ours, theirs in pairs:
            if ours.shape != theirs.shape or not np.array_equal(ours, theirs):
                raise RuntimeError(f"align: the resampler differs from "
                                   f"OpenCV {cv2.__version__} at {(h, w)} -> "
                                   f"{size}, scale {scale}")
    return cv2.__version__


def stage_times(photos, det, land, crop_size):
    """Each photo through the CLI's stages one at a time, timed (the nets
    warm, the anchors made): decode, FaceBoxes forward (to a sync), the
    best anchors' copy to the host,
    threshold + sort + NMS, landmarks (box crop, resize, net, copy),
    crop and save.  -> (ms per photo by stage, candidate sets for NMS)."""
    from PIL import Image

    from celebbasis_tpu_torch.cli.align import aligned_crop
    out = tempfile.mkdtemp(prefix="chip_smoke_stage_")
    ms = {k: [] for k in ("decode", "faceboxes_forward", "topk_copy",
                          "nms_host", "landmarks", "crop_save")}
    candidates = []
    try:
        for path in photos:
            t0 = time.perf_counter()
            rgb = np.asarray(Image.open(path).convert("RGB"))
            t1 = time.perf_counter()
            x = torch.from_numpy(rgb[None].copy()).cuda()
            boxes, scores = det.forward(x, det.priors(rgb.shape[:2]))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            boxes, scores = boxes.cpu().numpy(), scores.cpu().numpy()
            t3 = time.perf_counter()
            dets = det.postprocess(boxes, scores, rgb.shape[:2], 1.0)
            t4 = time.perf_counter()
            lmk = land.landmarks_for_box(rgb, dets[0])
            t5 = time.perf_counter()
            Image.fromarray(aligned_crop(rgb, lmk, crop_size)).save(
                os.path.join(out, os.path.basename(path)))
            t6 = time.perf_counter()
            for k, a, b in (("decode", t0, t1), ("faceboxes_forward", t1, t2),
                            ("topk_copy", t2, t3), ("nms_host", t3, t4),
                            ("landmarks", t4, t5), ("crop_save", t5, t6)):
                ms[k].append((b - a) * 1e3)
            s = rgb.shape[:2]
            keep = scores > det.thresh
            order = scores[keep].argsort()[::-1]
            cand = boxes[keep][order] * np.float32([s[1], s[0], s[1], s[0]])
            candidates.append(np.hstack([cand, scores[keep][order, None]])
                              .astype(np.float32))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return {k: float(np.median(v)) for k, v in ms.items()}, candidates


def phase_align(work):
    """W0 at full width through ``cli/align.py``: FaceBoxesV2 and PIPNet
    ResNet-101 (WFLW, 98 landmarks, 10 neighbours, 256x256 input) from
    synthetic files of their manifests' keys, on ALIGN_PHOTOS synthetic
    512x512 photos, with ``--workers 4`` and ``--workers 1``: crops byte
    equal, a pickle of every photo that ``data/face_id`` reads into a
    batch, no hand-written kernel launched; the card against the CPU on one
    photo (boxes before the integer cast within 0.05 px, landmarks within
    1 px); the C++ NMS against the numpy one on the largest candidate set;
    the resampler against OpenCV where it imports; ms per photo by stage.
    -> (record, the weight files)."""
    from PIL import Image

    from celebbasis_tpu_torch.align import nms
    from celebbasis_tpu_torch.align.faceboxes import decode_boxes, prior_boxes
    from celebbasis_tpu_torch.cli import align as align_cli
    from celebbasis_tpu_torch.data.face_id import (FaceIdDataset,
                                                   FaceIdDatasetConfig,
                                                   PrefetchLoader)
    from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer

    cv2_version = check_resampler_against_cv2()
    log("align", "resampler vs OpenCV: " + (
        f"bit for bit (cv2 {cv2_version})" if cv2_version
        else "cv2 not installed here, not compared"))
    photos = align_photos(os.path.join(work, "align_photos"), ALIGN_PHOTOS, 41)
    t0 = time.perf_counter()
    files, calib = write_align_files(work, photos)
    files_s = time.perf_counter() - t0
    common = ["--in_folder", os.path.dirname(photos[0]), "--detector_ckpt",
              files["fb"], "--pipnet_ckpt", files["pip"], "--meanface",
              files["meanface"]]
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the first run builds the host C++ and warms the nets; then one run
    # with 4 threads and one with 1, timed
    for workers in (4, 4, 1):
        out = os.path.join(work, f"aligned_{len(runs)}")
        for module in (fa, geglu, quant):
            module.reset_launch_count()
        t0 = time.perf_counter()
        n = align_cli.main([*common, "--out_folder", out, "--workers",
                            str(workers)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fa.launch_counts(), **geglu.launch_counts(),
                    **quant.launch_counts()}
        with open(out + ".pickle", "rb") as f:
            listed = pickle.load(f)
        crops = {}
        for p in listed:
            with open(p, "rb") as f:
                crops[os.path.basename(p)] = f.read()
        runs.append({"workers": workers, "n": n, "wall_s": wall,
                     "listed": listed, "crops": crops,
                     "launches": launches, "pickle": out + ".pickle"})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (all(r["n"] == len(r["listed"]) == ALIGN_PHOTOS for r in runs)
            and runs[0]["crops"] == runs[1]["crops"] == runs[2]["crops"]):
        raise RuntimeError(f"align: faces {[r['n'] for r in runs]}, paths "
                           f"listed {[len(r['listed']) for r in runs]}, "
                           f"crops equal across worker counts "
                           f"{runs[1]['crops'] == runs[2]['crops']}")
    if any(any(r["launches"].values()) for r in runs):
        raise RuntimeError(f"align: launched hand-written kernels "
                           f"{[r['launches'] for r in runs]}")

    # the W0 -> W2 contract: the training data reads the pickle
    ds = FaceIdDataset(FaceIdDatasetConfig(
        pickle_path=runs[2]["pickle"],
        num_ids=ALIGN_PHOTOS, image_size=512, repeats=1))
    batch = next(iter(PrefetchLoader(ds, CLIPTokenizer.synthetic(), 2,
                                     face_size=112, shuffle=False)))
    if batch["image"].shape != (2, 512, 512, 3) or batch["faces"].shape[
            1:] != (2, 112, 112, 3) or not np.isfinite(batch["image"]).all():
        raise RuntimeError(f"align: face_id batch {batch['image'].shape} "
                           f"{batch['faces'].shape}")

    # stage by stage, on the card's nets
    det = align_cli._init_detector(files["fb"], device="cuda")
    land = align_cli._init_landmarker(files["pip"], files["meanface"],
                                      device="cuda")
    with no_tf32():
        stage_ms, candidates = stage_times(photos, det, land, 512)
    passing = [len(c) for c in candidates]
    biggest = max(candidates, key=len)
    keep_c = nms.greedy_nms(biggest, det.nms_thresh)
    keep_n = nms.greedy_nms_numpy(biggest, det.nms_thresh)
    # the same boxes kept, in the same order of score (two boxes of equal
    # score may come in either order: std::sort is not numpy's argsort)
    same_nms = set(keep_c.tolist()) == set(keep_n.tolist()) and \
        np.array_equal(biggest[keep_c, 4], biggest[keep_n, 4])
    if not same_nms or not 1 <= min(passing) or max(passing) > det.max_pre:
        raise RuntimeError(f"align: NMS C++ kept {len(keep_c)}, numpy "
                           f"{len(keep_n)}; anchors passing {passing}")
    nms_ms = {name: 1e3 * min(_time_host(lambda: fn(biggest,
                                                      det.nms_thresh))
                              for _ in range(3))
              for name, fn in (("cpp", nms.greedy_nms),
                               ("numpy", nms.greedy_nms_numpy))}

    # the card against the CPU on one photo
    rgb = np.asarray(Image.open(photos[0]).convert("RGB"))
    cdet = align_cli._init_detector(files["fb"], device="cpu")
    cland = align_cli._init_landmarker(files["pip"], files["meanface"],
                                       device="cpu")
    priors = torch.from_numpy(prior_boxes(rgb.shape[:2]))
    scale = torch.tensor([rgb.shape[1], rgb.shape[0]] * 2)
    boxes, scores = {}, {}
    for name, d in (("cuda", det), ("cpu", cdet)):
        x = torch.from_numpy(rgb[None]).to(d.device).float() - d._means
        with torch.inference_mode(), no_tf32():
            loc, conf = d.net(x)
            boxes[name] = (decode_boxes(loc[0], priors.to(d.device))
                           .cpu() * scale)
        scores[name] = conf[0, :, 1].cpu()
    passed = scores["cuda"] > det.thresh
    box_err = float((boxes["cuda"] - boxes["cpu"])[passed].abs().max())
    with no_tf32():
        dets_g, dets_c = det.detect(rgb, 1.0), cdet.detect(rgb, 1.0)
        lm_g = land.landmarks_for_box(rgb, dets_g[0])
        lm_c = cland.landmarks_for_box(rgb, dets_g[0])
    lm_err = int(np.abs(lm_g - lm_c).max())
    if not box_err <= ALIGN_BOX_TOL or lm_err > 1 or len(dets_g) != \
            len(dets_c):
        raise RuntimeError(f"align: card vs CPU boxes {box_err:.4f} px, "
                           f"landmarks {lm_err} px, detections "
                           f"{len(dets_g)} vs {len(dets_c)}")
    rec = {"photos": ALIGN_PHOTOS, "files_s": files_s, "calibration": calib,
           "anchors_passing": passing,
           "wall_s": {"workers_4": runs[1]["wall_s"],
                      "workers_1": runs[2]["wall_s"],
                      "first_run_workers_4": runs[0]["wall_s"]},
           "stage_ms_per_photo": stage_ms,
           "nms_candidates": len(biggest), "nms_kept": len(keep_c),
           "nms_ms": nms_ms, "peak_gib": peak, "box_err_px": box_err,
           "landmark_err_px": lm_err, "detections": len(dets_g),
           "cv2": cv2_version}
    log("align", f"{ALIGN_PHOTOS} photos of {ALIGN_PHOTO}^2 through "
                 f"cli/align.py (FaceBoxesV2, PIPNet ResNet-101, 98 "
                 f"landmarks): {json.dumps(rec['wall_s'])} s wall (the "
                 f"first run built the host C++); crops byte-equal at 4 "
                 f"and 1 workers; pickle of {len(runs[2]['listed'])} paths "
                 f"read by FaceIdDataset; no kernel launched; peak "
                 f"{peak:.2f} GiB")
    log("align", f"ms per photo by stage {json.dumps(stage_ms)}; anchors "
                 f"passing 0.6 per photo {passing} (head scale "
                 f"{calib['head_scale']:.3f}, face bias "
                 f"{calib['face_bias']:.3f}); NMS on {len(biggest)} "
                 f"candidates (kept {len(keep_c)}): C++ "
                 f"{nms_ms['cpp']:.3f} ms, numpy {nms_ms['numpy']:.3f} ms, "
                 f"the same boxes kept")
    log("align", f"card vs CPU on one photo: boxes {box_err:.5f} px "
                 f"(limit {ALIGN_BOX_TOL}), landmarks {lm_err} px, "
                 f"{len(dets_g)} detections each; synthetic files made in "
                 f"{files_s:.1f} s")
    return rec, files


def _time_host(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# -- phase 8 ------------------------------------------------------------------

def _smooth_image(r, h, w):
    """A smooth random colour field with noise, (h, w, 3) uint8."""
    import cv2
    coarse = r.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), np.uint8)
    img = cv2.resize(coarse, (w, h)).astype(np.int16)
    return np.clip(img + r.integers(-24, 25, img.shape), 0, 255
                   ).astype(np.uint8)


def _template(n, r):
    """``n`` landmark positions in the unit square: a jittered grid."""
    side = int(np.ceil(np.sqrt(n)))
    g = np.stack(np.meshgrid(np.linspace(0.15, 0.85, side),
                             np.linspace(0.15, 0.85, side)), -1)
    return g.reshape(-1, 2)[:n] + r.normal(0, 0.01, (n, 2))


def _face(r, tmpl, h, w):
    """A box inside an (h, w) image and the template's landmarks in it:
    (x0, y0, x1, y1), (n, 2) pixel coordinates."""
    bw = r.uniform(0.45, 0.7) * w
    bh = r.uniform(0.45, 0.7) * h
    x0, y0 = r.uniform(0.05 * w, w - bw - 0.05 * w), r.uniform(
        0.05 * h, h - bh - 0.05 * h)
    pts = tmpl + r.normal(0, 0.01, tmpl.shape)
    return (x0, y0, x0 + bw, y0 + bh), np.stack(
        [x0 + pts[:, 0] * bw, y0 + pts[:, 1] * bh], -1)


def write_pipnet_raw(root, seed):
    """Synthetic raw layouts in the public datasets' formats, for
    ``cli/preprocess_pipnet``: WFLW (ALIGN_TRAIN_WFLW images, the train and
    test annotation lists: 98 landmarks, detector box, six attributes, image
    name), and the raw inputs of data_300W_CELEBA: 300W (image + 68-point
    ``.pts`` pairs; ALIGN_TRAIN_LABELED rows in the train folders, two in
    each test folder), CelebA (ALIGN_TRAIN_UNLABELED images and
    ``celeba_bboxes.txt``), COFW's test ``.mat`` and the 68-point COFW test
    boxes and annotations."""
    import cv2
    import scipy.io
    r = np.random.default_rng(seed)
    t98, t68 = _template(98, r), _template(68, r)
    wdir = os.path.join(root, "WFLW")
    adir = os.path.join(wdir, "WFLW_annotations",
                        "list_98pt_rect_attr_train_test")
    os.makedirs(adir)
    os.makedirs(os.path.join(wdir, "WFLW_images"))
    sizes = {}
    for i in range(ALIGN_TRAIN_WFLW[0]):
        name = f"{i:02d}_Crowd_{i}.jpg"
        h, w = (int(v) for v in r.integers(320, 480, 2))
        cv2.imwrite(os.path.join(wdir, "WFLW_images", name),
                    _smooth_image(r, h, w))
        sizes[name] = (h, w)
    names = sorted(sizes)
    for split, n in (("train", ALIGN_TRAIN_WFLW[1]),
                     ("test", ALIGN_TRAIN_WFLW[2])):
        rows = []
        for j in range(n):
            name = names[j % len(names)]
            box, pts = _face(r, t98, *sizes[name])
            rows.append(" ".join(f"{v:.3f}" for v in pts.ravel()) + " "
                        + " ".join(f"{v:.0f}" for v in box)
                        + " 0 0 0 0 0 0 " + name)
        with open(os.path.join(adir, f"list_98pt_rect_attr_{split}.txt"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")
    n_lab = ALIGN_TRAIN_LABELED
    for folder, n in (("afw", n_lab - 2 * (n_lab // 3)),
                      ("helen/trainset", n_lab // 3),
                      ("lfpw/trainset", n_lab // 3), ("helen/testset", 2),
                      ("lfpw/testset", 2), ("ibug", 2)):
        d = os.path.join(root, "data_300W", folder)
        os.makedirs(d)
        for i in range(n):
            h, w = (int(v) for v in r.integers(300, 420, 2))
            box, pts = _face(r, t68, h, w)
            cv2.imwrite(os.path.join(d, f"image_{i:03d}.jpg"),
                        _smooth_image(r, h, w))
            with open(os.path.join(d, f"image_{i:03d}.pts"), "w") as f:
                f.write("version: 1\nn_points: 68\n{\n")
                f.writelines(f"{x:.3f} {y:.3f}\n" for x, y in pts)
                f.write("}\n")
    cdir = os.path.join(root, "CELEBA", "img_celeba")
    os.makedirs(cdir)
    with open(os.path.join(root, "CELEBA", "celeba_bboxes.txt"), "w") as f:
        for i in range(ALIGN_TRAIN_UNLABELED):
            h, w = (int(v) for v in r.integers(300, 420, 2))
            box, _ = _face(r, t68, h, w)
            name = f"{i + 1:06d}.jpg"
            cv2.imwrite(os.path.join(cdir, name), _smooth_image(r, h, w))
            f.write(name + " " + " ".join(f"{v:.0f}" for v in box) + "\n")
    n_cofw = 2
    cells = np.empty((n_cofw, 1), object)
    boxes, annos = [], []
    for i in range(n_cofw):
        h, w = 300, 280
        img = _smooth_image(r, h, w)[:, :, ::-1]           # RGB in the .mat
        cells[i, 0] = img[:, :, 0] if i % 2 else np.ascontiguousarray(img)
        box, pts = _face(r, t68, h, w)
        boxes.append([box[0], box[1], box[2] - box[0], box[3] - box[1]])
        annos.append(pts)
    os.makedirs(os.path.join(root, "COFW"))
    scipy.io.savemat(os.path.join(root, "COFW", "COFW_test_color.mat"),
                     {"IsT": cells, "bboxesT": np.asarray(boxes),
                      "phisT": np.zeros((n_cofw, 87))})
    tdir = os.path.join(root, "data_300W_CELEBA")
    os.makedirs(os.path.join(tdir, "cofw68_test_annotations"))
    scipy.io.savemat(os.path.join(tdir, "cofw68_test_bboxes.mat"),
                     {"bboxes": np.asarray(boxes)})
    for i, pts in enumerate(annos):
        scipy.io.savemat(os.path.join(tdir, "cofw68_test_annotations",
                                      f"{i + 1}_points.mat"),
                         {"Points": pts})


def _normalised_crops(folder, rows):
    """The ImageNet-normalised crops of label rows and their (L, 2)
    landmarks, as the trainers feed them (without augmentation)."""
    from PIL import Image

    from celebbasis_tpu_torch.align.pipnet import IMAGENET_MEAN, IMAGENET_STD
    x = np.stack([(np.asarray(Image.open(os.path.join(folder, n))
                              .convert("RGB"), np.float32) / 255.0
                   - IMAGENET_MEAN) / IMAGENET_STD for n, _ in rows])
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(np.clip(np.stack([t.reshape(-1, 2)
                                               for _, t in rows]), 0, 1)))


def step_parity(kind, images, lms, meanface, task=None):
    """One step of a trainer from one seeded state, on the card and on the
    CPU: ``kind`` "pipnet" (PIPNet ResNet-101, 98 landmarks) or "gssl"
    (PIPNetGSSL ResNet-18, 68 landmarks, ``task`` per row).  -> relative
    loss difference, the relative L2 difference of the leaves' gradients
    (median over the leaves, and the largest and its leaf), and the
    parameters' difference after Adam in units of lr: largest, mean, and
    the share of entries over lr / 2."""
    from celebbasis_tpu_torch.align import pipnet_gssl as pg
    from celebbasis_tpu_torch.align import pipnet_train as pt
    from celebbasis_tpu_torch.align.pipnet import PIPNet, PIPNetConfig
    from celebbasis_tpu_torch.loader import init_weights

    L = meanface.shape[0]
    if kind == "pipnet":
        cfg, net_cls = PIPNetConfig.resnet101(num_lms=L), PIPNet
    else:
        cfg, net_cls = PIPNetConfig.resnet18(num_lms=L), pg.PIPNetGSSL
    tcfg = pt.PIPTrainConfig(num_lms=L, num_nb=cfg.num_nb,
                             input_size=cfg.input_size,
                             net_stride=cfg.net_stride,
                             batch_size=len(images))
    state = init_weights(net_cls(cfg), torch.Generator().manual_seed(5)
                         ).state_dict()
    nb_idx = pt.forward_neighbors(meanface, tcfg.num_nb)
    out = {}
    for dev in ("cuda", "cpu"):
        params = pt.leaf_state(state, dev)
        opt = pt.make_optimizer(tcfg, 3, params.values())
        args = (params, images.to(dev), lms.to(dev))
        if kind == "pipnet":
            total, _ = pt.make_train_step(net_cls(cfg), opt, nb_idx,
                                          tcfg)(*args)
        else:
            total, _ = pg.make_gssl_train_step(
                net_cls(cfg), opt, nb_idx, tcfg)(*args, task.to(dev))
        out[dev] = (float(total),
                    {k: v.grad.cpu() for k, v in params.items()},
                    {k: v.detach().cpu() for k, v in params.items()})
    (lg, gg, pg_), (lc, gc, pc) = out["cuda"], out["cpu"]
    rel_l2 = {k: float((gg[k] - gc[k]).norm()
                       / gc[k].norm().clamp_min(1e-30)) for k in gc}
    worst = max(rel_l2, key=rel_l2.get)
    diffs = torch.cat([(pg_[k] - pc[k]).abs().flatten()
                       for k in pc]) / tcfg.init_lr
    return {"loss": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
            "grad_rel_l2_median": float(np.median(list(rel_l2.values()))),
            "grad_rel_l2_max": rel_l2[worst], "grad_worst_leaf": worst,
            "leaves": len(gc), "param_err_lr_max": float(diffs.max()),
            "param_err_lr_mean": float(diffs.mean()),
            "param_share_over_half_lr": float((diffs > 0.5).float().mean())}


def per_step(result, wall_s):
    """A trainer CLI's result -> ms a step (median after the first, each
    step timed to a sync), images per second at that median, the run's wall
    and peak device memory."""
    ms = float(np.median(result["step_s"][1:])) * 1e3
    return {"steps": len(result["step_s"]), "median_ms": ms,
            "first_ms": result["step_s"][0] * 1e3,
            "images_per_s": ALIGN_TRAIN_BATCH / ms * 1e3, "wall_s": wall_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_align_train(work, align_files, t_smoke):
    """W0's training side at full width (module docstring, phase 8).
    -> record."""
    import cv2         # the preprocessing's codecs; fail here without it

    from celebbasis_tpu_torch.align import pipnet_gssl as pg
    from celebbasis_tpu_torch.cli import align as align_cli
    from celebbasis_tpu_torch.cli import (preprocess_pipnet, train_pipnet,
                                          train_pipnet_gssl)
    from celebbasis_tpu_torch.cli.train_pipnet import (load_labels,
                                                       load_meanface)

    t_phase = time.perf_counter()
    for module in (fa, geglu, quant):
        module.reset_launch_count()
    root = os.path.join(work, "pipnet_data")
    t0 = time.perf_counter()
    write_pipnet_raw(root, 51)
    t1 = time.perf_counter()
    for name in ("WFLW", "CELEBA", "data_300W_CELEBA"):
        preprocess_pipnet.main([name, "--root", root, "--quiet"])
    preprocess_s = (t1 - t0, time.perf_counter() - t1)
    wflw = os.path.join(root, "WFLW")
    gssl_dir = os.path.join(root, "data_300W_CELEBA")
    n_wflw = len(load_labels(os.path.join(wflw, "train.txt")))
    n_lab = len(load_labels(os.path.join(gssl_dir, "train_300W.txt")))
    with open(os.path.join(gssl_dir, "train_CELEBA.txt")) as f:
        n_unl = len(f.read().split())
    if (n_wflw, n_lab, n_unl) != ALIGN_TRAIN_WFLW[1:2] + (
            ALIGN_TRAIN_LABELED, ALIGN_TRAIN_UNLABELED):
        raise RuntimeError(f"align_train: preprocessing gave {n_wflw} WFLW, "
                           f"{n_lab} labeled and {n_unl} unlabeled rows")

    # supervised, the reference's pip_32_16_60_r101_l2_l1_10_1_nb10
    snap = os.path.join(work, "pipnet_snapshots")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sup = train_pipnet.main([
        "--data_dir", wflw, "--save_dir", snap, "--backbone", "resnet101",
        "--num_nb", "10", "--input_size", "256", "--net_stride", "32",
        "--batch_size", str(ALIGN_TRAIN_BATCH), "--epochs", "2",
        "--save_interval", "2"])
    sup_rec = per_step(sup, time.perf_counter() - t0)
    ckpt = os.path.join(snap, "epoch1.pth")
    saved = torch.load(ckpt, weights_only=True)
    with open(PIP_MANIFEST) as f:
        manifest = json.load(f)["keys"]
    if sorted(os.listdir(snap)) != ["epoch1.pth"] or {
            k: list(v.shape) for k, v in saved.items()} != manifest:
        raise RuntimeError(f"align_train: {sorted(os.listdir(snap))} "
                           f"written; keys and shapes equal the manifest's: "
                           f"{sorted(saved) == sorted(manifest)}")
    if not np.isfinite(sup["history"]).all():
        raise RuntimeError(f"align_train: losses {sup['history']}")

    # the aligner reads what the trainer wrote
    land = align_cli._init_landmarker(ckpt, os.path.join(wflw,
                                                         "meanface.txt"),
                                      device="cuda")
    got = land.net.state_dict()
    if sorted(got) != sorted(sup["params"]) or not all(
            torch.equal(got[k], v.detach()) for k, v in sup["params"].items()):
        raise RuntimeError("align_train: the aligner's PIPNet differs from "
                           "the trained state")
    del land, got
    photos = os.path.join(work, "align_photos")
    t0 = time.perf_counter()
    n = align_cli.main(["--in_folder", photos, "--out_folder",
                        os.path.join(work, "aligned_trained"),
                        "--detector_ckpt", align_files["fb"],
                        "--pipnet_ckpt", ckpt, "--meanface",
                        os.path.join(wflw, "meanface.txt"), "--workers", "1"])
    align_wall = time.perf_counter() - t0
    if n != ALIGN_PHOTOS:
        raise RuntimeError(f"align_train: cli/align.py with the trained "
                           f"checkpoint cropped {n} of {ALIGN_PHOTOS}")

    # GSSL, the reference's ResNet-18 curriculum (warmup + 5 rounds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gssl = train_pipnet_gssl.main([
        "--data_dir", gssl_dir, "--save_dir",
        os.path.join(work, "gssl_snapshots"), "--num_nb", "10",
        "--input_size", "256", "--batch_size", str(ALIGN_TRAIN_BATCH),
        "--epochs", "1"])
    gssl_rec = per_step(gssl, time.perf_counter() - t0)
    losses = gssl["init_history"] + sum(gssl["history"], [])
    if len(gssl["history"]) != 5 or not np.isfinite(losses).all():
        raise RuntimeError(f"align_train: GSSL losses {losses}")
    del sup, gssl

    # the card against the CPU: one step of each trainer from one state
    rows = load_labels(os.path.join(wflw, "train.txt"))[:2]
    x, lms = _normalised_crops(os.path.join(wflw, "images_train"), rows)
    parity = {"pipnet": step_parity(
        "pipnet", x, lms, load_meanface(os.path.join(wflw, "meanface.txt")))}
    rows = load_labels(os.path.join(gssl_dir, "train_300W.txt"))[:4]
    x, lms = _normalised_crops(os.path.join(gssl_dir, "images_train"), rows)
    parity["gssl"] = step_parity(
        "gssl", x, lms, load_meanface(os.path.join(gssl_dir,
                                                   "meanface.txt")),
        task=torch.tensor([pg.TASK_STD, pg.TASK_CLS1, pg.TASK_CLS2,
                           pg.TASK_CLS3]))
    for name, p in parity.items():
        if not (p["loss_rel_err"] <= ALIGN_TRAIN_TOL["loss"]
                and p["grad_rel_l2_median"]
                <= ALIGN_TRAIN_TOL["grad_rel_l2_median"]
                and p["grad_rel_l2_max"] <= ALIGN_TRAIN_TOL["grad_rel_l2_max"]
                and p["param_err_lr_max"] <= ALIGN_TRAIN_TOL["param_lr_max"]
                and p["param_err_lr_mean"] <= ALIGN_TRAIN_TOL["param_lr_mean"]
                and p["param_share_over_half_lr"]
                <= ALIGN_TRAIN_TOL["param_share_over_half_lr"]):
            raise RuntimeError(f"align_train: {name} step, card vs CPU "
                               f"{json.dumps(p)} (limits "
                               f"{json.dumps(ALIGN_TRAIN_TOL)})")
    launches = {**fa.launch_counts(), **geglu.launch_counts(),
                **quant.launch_counts()}
    if any(launches.values()):
        raise RuntimeError(f"align_train: launched hand-written kernels "
                           f"{launches}")

    rec = {"rows": {"wflw_train": n_wflw, "gssl_labeled": n_lab,
                    "gssl_unlabeled": n_unl},
           "raw_write_s": preprocess_s[0], "preprocess_s": preprocess_s[1],
           "pipnet_r101": sup_rec, "gssl_r18": gssl_rec,
           "align_with_trained_s": align_wall, "step_parity": parity,
           "launches": launches,
           "phase_wall_s": time.perf_counter() - t_phase,
           "smoke_wall_s": time.perf_counter() - t_smoke}
    log("align_train", f"preprocess (cv2 {cv2.__version__}): raw layouts "
                       f"{rec['raw_write_s']:.1f} s, WFLW + CELEBA + "
                       f"data_300W_CELEBA {rec['preprocess_s']:.1f} s; "
                       f"rows {json.dumps(rec['rows'])}")
    for name in ("pipnet_r101", "gssl_r18"):
        r = rec[name]
        log("align_train", f"{name}: {r['steps']} steps of batch "
                           f"{ALIGN_TRAIN_BATCH} at 256^2, median "
                           f"{r['median_ms']:.1f} ms a step after the first "
                           f"({r['first_ms']:.1f} ms), "
                           f"{r['images_per_s']:.1f} images/s, run wall "
                           f"{r['wall_s']:.1f} s, peak {r['peak_gib']:.2f} "
                           f"GiB")
    log("align_train", f"epoch1.pth has every key and shape of "
                       f"{os.path.basename(PIP_MANIFEST)}; cli/align.py read "
                       f"it and cropped {n} photos in {align_wall:.2f} s")
    log("align_train", f"card vs CPU, one step: {json.dumps(parity)} "
                       f"(limits {json.dumps(ALIGN_TRAIN_TOL)}); kernel "
                       f"launches {sum(launches.values())}")
    log("align_train", f"phase {rec['phase_wall_s']:.1f} s, smoke "
                       f"{rec['smoke_wall_s']:.1f} s so far; {smi_line()}")
    return rec


# -- phase 9 ------------------------------------------------------------------

def synthetic_value(key, shape, gen):
    """A seeded value for a checkpoint key, drawn on the card: fan-in-scaled
    normal weights, small biases, norm scales near 1, positive BatchNorm
    variances, PReLU slopes of 0.25, a step counter for
    ``num_batches_tracked``."""
    if key.endswith("num_batches_tracked"):
        return torch.tensor(40000, dtype=torch.int64)
    draw = lambda: torch.randn(shape, generator=gen, device="cuda")
    if key.endswith("running_var"):
        value = 0.5 + torch.rand(shape, generator=gen, device="cuda")
    elif key.endswith("prelu.weight"):
        value = torch.full(shape, 0.25, device="cuda")
    elif len(shape) >= 2:
        value = draw() * float(np.prod(shape[1:])) ** -0.5
    elif key.endswith((".bias", "running_mean")):
        value = draw() * 0.02
    else:
        value = 1.0 + draw() * 0.02
    return value.cpu()


def phase_checkpoint(work):
    """A synthetic ``sd-v1-4.ckpt`` (fp32, every key and shape of
    ``manifests/sd-v1-4.json``, DDPM buffers, LitEma keys and Lightning
    callback objects of a class that cannot be imported when it is read)
    and a synthetic fp16 CosFace ``backbone.pth`` (every key of
    ``manifests/cosface_r100.json``), written to ``work`` and loaded through
    ``loader.assemble(sd_ckpt=..., fr_ckpt=...)`` at full width.  Every
    manifest key must land on a parameter or buffer, the extras must be
    reported, and parameters read back must equal what was written.
    -> ({"sd": path, "fr": path}, record)."""
    from celebbasis_tpu_torch.loader import assemble
    from celebbasis_tpu_torch.utils import bridge, pt_io
    from celebbasis_tpu_torch.utils.config import load_run_spec

    with open(SD_MANIFEST) as f:
        sd_keys = json.load(f)["keys"]
    with open(FR_MANIFEST) as f:
        fr_keys = json.load(f)["keys"]
    gen = torch.Generator(device="cuda").manual_seed(2024)
    t0 = time.perf_counter()
    state = {k: synthetic_value(k, tuple(shape), gen)
             for k, shape in sd_keys.items()}
    steps = torch.arange(1000, dtype=torch.float32)
    for i, name in enumerate(DDPM_BUFFERS):
        state[name] = (steps + i) * 1e-3
    for name, shape in EMA_KEYS.items():
        state[name] = torch.full(shape, 0.5)
    backbone = {k: synthetic_value(k, tuple(shape), gen).half()
                if not k.endswith("num_batches_tracked")
                else synthetic_value(k, (), gen)
                for k, shape in fr_keys.items()}
    make_s = time.perf_counter() - t0
    # Lightning pickles callback objects beside the weights; this class is
    # importable while the file is written and not when it is read
    lightning = types.ModuleType("chip_smoke_lightning")
    lightning.ModelCheckpoint = type("ModelCheckpoint", (), {
        "__module__": lightning.__name__})
    sys.modules[lightning.__name__] = lightning
    paths = {"sd": os.path.join(work, "sd-v1-4.ckpt"),
             "fr": os.path.join(work, "backbone.pth")}
    t0 = time.perf_counter()
    try:
        torch.save({"state_dict": state, "epoch": 6, "global_step": 470000,
                    "pytorch-lightning_version": "1.4.2",
                    "callbacks": {lightning.ModelCheckpoint: {
                        "best_model_score": None}},
                    "hyper_parameters": lightning.ModelCheckpoint()},
                   paths["sd"])
    finally:
        del sys.modules[lightning.__name__]
    torch.save(backbone, paths["fr"])
    write_s = time.perf_counter() - t0
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    written = {"unet": state["model.diffusion_model.input_blocks.0.0.weight"],
               "vae": state["first_stage_model.decoder.conv_out.weight"],
               "clip": state["cond_stage_model.transformer.text_model."
                             "embeddings.token_embedding.weight"],
               "fr_stem": backbone["conv1.weight"],
               "fr_fc": backbone["fc.weight"]}
    extras = sorted(list(DDPM_BUFFERS) + list(EMA_KEYS))
    del state, backbone

    # read, then convert, timed apart (the readers' own entry points)
    t0 = time.perf_counter()
    raw = pt_io.load_pt(paths["sd"])
    fr_raw = pt_io.load_pt(paths["fr"])
    read_s = time.perf_counter() - t0
    if raw["global_step"] != 470000 or not isinstance(
            raw["hyper_parameters"], pt_io.Stub) \
            or lightning.__name__ in sys.modules:
        raise RuntimeError("checkpoint: the Lightning objects were not "
                           "stubbed")
    t0 = time.perf_counter()
    spec = load_run_spec([os.path.join(REPO, "configs", "aigc_id.yaml")])
    used, fr_used = set(), set()
    state = raw["state_dict"]
    for convert in (lambda: bridge.convert_unet(state, spec.unet, used=used),
                    lambda: bridge.convert_vae(state, spec.vae, used=used),
                    lambda: bridge.convert_clip_text(state, spec.clip.layers,
                                                     used=used),
                    lambda: bridge.convert_iresnet(fr_raw, used=fr_used)):
        convert()
    convert_s = time.perf_counter() - t0
    if used != set(sd_keys) or sorted(set(state) - used) != extras:
        raise RuntimeError(f"checkpoint: {len(set(sd_keys) - used)} manifest "
                           f"keys not used, extras "
                           f"{sorted(set(state) - used)}")
    tracked = sorted(k for k in fr_keys if k.endswith("num_batches_tracked"))
    if fr_used != set(fr_keys) - set(tracked):
        raise RuntimeError("checkpoint: CosFace keys not used: "
                           f"{sorted(set(fr_keys) - fr_used)}")
    del raw, fr_raw, state

    spec.celeb_txt = os.path.join(REPO, "infer_images", "wiki_names_v2.txt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    asm = assemble(spec, sd_ckpt=paths["sd"], fr_ckpt=paths["fr"],
                   image_size=512, seed=1, cache_dir=None)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    if asm.unused_keys != {"sd": extras, "fr": tracked}:
        raise RuntimeError(f"checkpoint: assemble reported "
                           f"{asm.unused_keys}")
    fr = asm.meta_net.fr_net
    C = fr.head_bn.mean.shape[0]
    fc = written["fr_fc"].float()
    side = int(round((fc.shape[1] // C) ** 0.5))
    read_back = {
        "unet": asm.pipeline.unet.conv_in.weight,
        "vae": asm.pipeline.vae.decoder.conv_out.weight,
        "clip": asm.pipeline.clip.token_embedding.weight,
        "fr_stem": fr.stem_conv.weight, "fr_fc": fr.fc.weight}
    want = dict(written, fr_stem=written["fr_stem"].float(),
                fr_fc=fc.reshape(-1, C, side, side).permute(0, 2, 3, 1)
                .reshape(fc.shape[0], -1))
    for name, got in read_back.items():
        if got.dtype != torch.float32 or not torch.equal(got.cpu(),
                                                         want[name]):
            raise RuntimeError(f"checkpoint: {name} does not read back "
                               f"({got.dtype})")
    n_params = sum(p.numel() for p in asm.pipeline.parameters())
    rec = {"sizes_bytes": sizes, "make_s": make_s, "write_s": write_s,
           "read_s": read_s, "convert_s": convert_s,
           "assemble_s": assemble_s, "sd_keys": len(sd_keys),
           "fr_keys": len(fr_keys), "extras": len(extras),
           "pipeline_parameters": n_params,
           "device_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "host_peak_gib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
    del asm
    torch.cuda.empty_cache()
    log("checkpoint", f"sd-v1-4.ckpt {sizes['sd'] / 2**30:.3f} GiB "
                      f"({len(sd_keys)} manifest keys + {len(extras)} "
                      f"extras, fp32), backbone.pth {sizes['fr'] / 2**20:.1f} "
                      f"MiB ({len(fr_keys)} keys, fp16): made in "
                      f"{make_s:.1f} s, written in {write_s:.1f} s, read in "
                      f"{read_s:.1f} s, converted in {convert_s:.2f} s; "
                      f"assemble from both {assemble_s:.1f} s; every manifest "
                      f"key used, extras reported, parameters read back "
                      f"equal; peak memory device "
                      f"{rec['device_peak_gib']:.2f} GiB, host "
                      f"{rec['host_peak_gib']:.2f} GiB")
    return paths, rec


# -- phase 10 -----------------------------------------------------------------

def write_face_pickle(faces, config, size, seed=77):
    """Random-pixel aligned-face PNGs of ``size`` and their
    ``ffhq.pickle`` in the folder ``faces`` (made here), as many as
    ``config``'s training data asks for; -> the folder."""
    from celebbasis_tpu_torch.cli.serve import encode_png
    from celebbasis_tpu_torch.utils.config import load_run_spec

    data = load_run_spec([config]).train_data
    # the config picks identities by position (specific_ids), so the pickle
    # holds as many files as the highest position asked for, plus one
    n_files = max(data.specific_ids or [data.num_ids - 1]) + 1
    os.makedirs(faces)
    paths = []
    for i, img in enumerate(face_crops(size, seed, k=n_files)):
        paths.append(os.path.join(faces, f"{i:05d}.png"))
        with open(paths[-1], "wb") as f:
            f.write(encode_png(img))
    with open(os.path.join(faces, "ffhq.pickle"), "wb") as f:
        pickle.dump(paths, f)
    return faces


def train_cli(keep_dir, checkpoints):
    """``cli/train.main`` at 512x512 from the checkpoint phase's files, on a
    synthetic aligned-face pickle: six uncached steps with validation,
    TensorBoard, ``DeviceMonitor`` and a sample grid, then six cached steps
    over three cached batches.  Copies the uncached run's last checkpoint
    into ``keep_dir`` for the generate phase.  -> (launches by run, record
    by run)."""
    from celebbasis_tpu_torch.cli import train
    from celebbasis_tpu_torch.utils.config import load_run_spec
    from celebbasis_tpu_torch.utils.tb import read_scalars

    config = os.path.join(REPO, "configs", "aigc_id.yaml")
    data = load_run_spec([config]).train_data
    faces = write_face_pickle(os.path.join(keep_dir, "faces"), config, 512)
    logdir = os.path.join(keep_dir, "logs")
    common = ["--base", config, "--logdir", logdir, "--data_root", faces,
              "--actual_resume", checkpoints["sd"], "--fr_ckpt",
              checkpoints["fr"], "--image_size", "512", "--face_size", "512",
              "--max_steps", str(CLI_STEPS),
              f"lightning.trainer.val_check_interval={CLI_VAL_EVERY}",
              f"lightning.trainer.limit_val_batches={CLI_VAL_BATCHES}",
              "lightning.callbacks.device_monitor.params.every=1",
              "lightning.tensorboard=true",
              "lightning.trainer.log_every_n_steps=1",
              "data.params.validation.params.pickle_path=faces",
              f"data.params.validation.params.num_ids={data.num_ids}"]
    vals = CLI_STEPS // CLI_VAL_EVERY
    val_launches = vals * CLI_VAL_BATCHES * ATTN_PER_UNET
    runs = {"cli": (["--name", "cli", "lightning.callbacks.image_logger.params."
                     f"batch_frequency={CLI_STEPS}"],
                    DDIM_STEPS * ATTN_PER_UNET),
            "cli_cached": (["--name", "cli_cached", "--cache_latents",
                            str(CLI_CACHE)], 0)}
    launches, recs = {}, {}
    cwd = os.getcwd()
    os.chdir(REPO)                          # the config's relative paths
    try:
        for name, (extra, sample_launches) in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_count()
            caps0 = graphs.captures()
            t0 = time.perf_counter()
            run = train.main(common + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = fa.launch_counts()
            caps = graphs.captures() - caps0
            with open(os.path.join(run, "metrics.jsonl")) as f:
                lines = [json.loads(line) for line in f]
            steps = [r for r in lines if "loss" in r]
            val = [r["val_loss_simple"] for r in lines
                   if "val_loss_simple" in r]
            with open(os.path.join(run, "device_stats.jsonl")) as f:
                dev = [json.loads(line) for line in f]
            events = [os.path.join(run, "tensorboard", n) for n in
                      os.listdir(os.path.join(run, "tensorboard"))]
            tags = {t for e in events for _, t, _ in read_scalars(e)}
            step_ms = [r["step_time_s"] * 1e3 for r in steps]
            wait_ms = [r["data_wait_s"] * 1e3 for r in steps]
            rec = {"wall_s": wall, "step_ms": step_ms,
                   "median_step_ms": float(np.median(step_ms[1:])),
                   "data_wait_ms": wait_ms,
                   "median_data_wait_ms": float(np.median(wait_ms[1:])),
                   "losses": [r["loss"] for r in steps], "val_losses": val,
                   "launches": got,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            recs[name], launches[name] = rec, got
            log("train", f"cli/train.py {name}: {len(steps)} steps in "
                         f"{wall:.1f} s (assembly from the checkpoints "
                         f"included); ms per step "
                         f"{[round(x, 1) for x in step_ms]} (median of all "
                         f"but the first {rec['median_step_ms']:.1f}); ms "
                         f"waiting on the loader "
                         f"{[round(x, 2) for x in wait_ms]} (median "
                         f"{rec['median_data_wait_ms']:.2f}); losses "
                         f"{[round(x, 4) for x in rec['losses']]}, "
                         f"validation {[round(x, 4) for x in val]}; flash "
                         f"launches {json.dumps(got)} (a step: "
                         f"{got['fwd_lse'] / CLI_STEPS:g} #3, "
                         f"{got['dq'] / CLI_STEPS:g} #4, "
                         f"{got['dkv'] / CLI_STEPS:g} #5, the warm-up of its "
                         f"capture included; #1: "
                         f"{TRAIN_LAUNCHES['flash_attention_nhd'] * CLI_STEPS}"
                         f" in steps, {val_launches} in "
                         f"validation, {sample_launches} in the sample grid "
                         f"expected, each + one warm-up; {caps} graphs "
                         f"captured); peak memory {rec['peak_gib']:.2f} GiB")
            # one graph each for the train step, the eval step and the
            # sample grid's sampler; each capture's warm-up launched one
            # call's kernels besides the replays
            want_caps = 2 + bool(sample_launches)
            want = {n: c * (CLI_STEPS + 1) for n, c in TRAIN_LAUNCHES.items()}
            want["flash_attention_nhd"] += val_launches + ATTN_PER_UNET \
                + 2 * sample_launches
            ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
            if got != want or caps != want_caps:
                raise RuntimeError(f"train: {name} launched {got} over "
                                   f"{caps} captures; expected {want} over "
                                   f"{want_caps}")
            if len(steps) != CLI_STEPS or len(val) != vals \
                    or not np.isfinite(rec["losses"] + val).all():
                raise RuntimeError(f"train: {name} losses {rec['losses']}, "
                                   f"validation {val}")
            if ckpts != [f"embeddings_gs-{CLI_STEPS}.pt"] or tags != {
                    "train/loss", "train/loss_simple", "val/loss_simple"}:
                raise RuntimeError(f"train: {name} wrote {ckpts}, "
                                   f"TensorBoard tags {tags}")
            if [r["step"] for r in dev] != list(range(1, CLI_STEPS + 1)) \
                    or not all(r["peak_bytes_in_use"] for r in dev):
                raise RuntimeError(f"train: {name} device stats {dev}")
            if sample_launches and not os.path.exists(os.path.join(
                    run, "images", f"samples_gs-{CLI_STEPS:06d}.jpg")):
                raise RuntimeError(f"train: {name} wrote no sample grid")
            if name == "cli":
                shutil.copy(os.path.join(run, "checkpoints", ckpts[-1]),
                            keep_dir)
    finally:
        os.chdir(cwd)
    return launches, recs


def checksum(module) -> int:
    """An integer checksum of the bytes of a module's parameters and
    buffers: equal before and after means no byte changed."""
    total = 0
    for t in list(module.parameters()) + list(module.buffers()):
        as_int = t.detach().contiguous().view(
            {4: torch.int32, 2: torch.int16, 8: torch.int64}[t.element_size()])
        total += int(as_int.sum(dtype=torch.int64).item())
    return total


def phase_train():
    """``Trainer.fit`` at full width (module docstring, phase 10; the phase
    goes on with ``train_cli``)."""
    from celebbasis_tpu_torch.core import manager as mgr
    from celebbasis_tpu_torch.loader import assemble, init_weights
    from celebbasis_tpu_torch.train import step as tstep
    from celebbasis_tpu_torch.train.trainer import Trainer, TrainerConfig
    from celebbasis_tpu_torch.utils.config import RunSpec, load_run_spec

    config = os.path.join(REPO, "configs", "aigc_id.yaml")
    try:
        spec = load_run_spec([config])
    except ImportError:
        spec = RunSpec.sd_v1()
    spec.celeb_txt = os.path.join(REPO, "infer_images", "wiki_names_v2.txt")
    t0 = time.perf_counter()
    asm = assemble(spec, image_size=512, seed=1, dtype=torch.bfloat16,
                   cache_dir=None)
    pipe, meta = asm.pipeline, asm.meta_net
    # with its zero-initialised output convs a random-init UNet predicts
    # eps = 0 whatever the context, and no gradient reaches the MLP
    init_weights(pipe.unet, torch.Generator(device="cuda").manual_seed(5),
                 zero_convs=False)
    count = lambda m: sum(p.numel() for p in m.parameters()) / 1e6
    log("train", f"assembled in {time.perf_counter() - t0:.1f} s: pipeline "
                 f"{count(pipe):.0f} M parameters "
                 f"({next(pipe.unet.parameters()).dtype} storage, "
                 f"{pipe.cfg.dtype} compute), face net "
                 f"{count(meta.fr_net):.1f} M, MLP {count(meta.mlp):.3f} M")
    frozen = {"unet": pipe.unet, "vae": pipe.vae, "clip": pipe.clip,
              "fr_net": meta.fr_net}
    sums = {name: checksum(m) for name, m in frozen.items()}
    loader = [synthetic_batch(asm.tokenizer, 512, 512, 100 + i, "cuda")
              for i in range(TRAIN_STEPS)]
    run_root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        cfg = TrainerConfig(logdir=run_root, max_steps=TRAIN_STEPS,
                            ckpt_every=TRAIN_STEPS // 2, log_every=1,
                            loss_type="none", seed=23)
        trainer = Trainer(pipe, meta, asm.basis, loader, cfg)
        state = trainer.init_state(asm.manager_state)
        emb0 = state.manager_state.id_embeddings.clone()
        coef0 = state.manager_state.id_coefficients.clone()
        w0 = meta.mlp.layer_0.weight.detach().clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        caps0 = graphs.captures()
        state = trainer.fit(state)
        torch.cuda.synchronize()
        launches = fa.launch_counts()
        # the first step captures the step's graph: its warm-up launched a
        # step's kernels besides the replays
        caps = graphs.captures() - caps0
        peak = torch.cuda.max_memory_allocated()
        with open(trainer.metrics_path) as f:
            recs = [json.loads(line) for line in f]
        step_ms = [r["step_time_s"] * 1e3 for r in recs]
        losses = [r["loss"] for r in recs]
        per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
        log("train", f"{TRAIN_STEPS} uncached steps: ms per step "
                     f"{[round(x, 1) for x in step_ms]} (median of all but "
                     f"the first {float(np.median(step_ms[1:])):.1f}); "
                     f"losses {[round(x, 4) for x in losses]}; peak memory "
                     f"{peak / 2**30:.2f} GiB; launches per step "
                     f"{json.dumps(per_step)}")

        if len(recs) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise RuntimeError(f"train: losses {losses}")
        if caps != 1 or launches != {n: c * (TRAIN_STEPS + caps)
                                     for n, c in TRAIN_LAUNCHES.items()}:
            raise RuntimeError(f"train: launches {launches} over "
                               f"{TRAIN_STEPS} steps and {caps} captures; "
                               f"expected per step {TRAIN_LAUNCHES}")
        if torch.equal(meta.mlp.layer_0.weight, w0):
            raise RuntimeError("train: the MLP did not move")
        for name, m in frozen.items():
            if any(p.grad is not None or p.requires_grad
                   for p in m.parameters()):
                raise RuntimeError(f"train: {name} received a gradient")
            if checksum(m) != sums[name]:
                raise RuntimeError(f"train: the frozen {name} changed")
        used = torch.zeros(pipe.manager_cfg.max_ids, dtype=torch.bool)
        used[[0, 1, 2]] = True          # the ids of synthetic_batch
        new = state.manager_state
        moved_e = (new.id_embeddings - emb0).abs().amax(dim=(1, 2)).cpu() > 0
        moved_c = (new.id_coefficients - coef0).abs().amax(
            dim=(1, 2, 3)).cpu() > 0
        if not (torch.equal(moved_e, used) and torch.equal(moved_c, used)):
            raise RuntimeError(f"train: dictionaries moved at {moved_e} / "
                               f"{moved_c}, ids used {used}")
        ckpts = sorted(os.listdir(os.path.join(trainer.run_dir,
                                               "checkpoints")))
        want = [f"embeddings_gs-{TRAIN_STEPS // 2}.pt",
                f"embeddings_gs-{TRAIN_STEPS}.pt"]
        if ckpts != want:
            raise RuntimeError(f"train: checkpoints {ckpts}, expected {want}")
        back = mgr.load_checkpoint(
            pipe.manager_cfg,
            os.path.join(trainer.run_dir, "checkpoints", want[-1]),
            device="cuda")
        if not torch.equal(back.id_coefficients, new.id_coefficients):
            raise RuntimeError("train: the checkpoint does not read back")
        log("train", f"checkpoints {ckpts} read back; MLP moved by "
                     f"{(meta.mlp.layer_0.weight - w0).abs().max().item():.4f}"
                     f"; dictionaries moved at ids "
                     f"{moved_e.nonzero().flatten().tolist()} only; frozen "
                     f"modules unchanged, no gradients")

        # the cached variant: frozen VAE posteriors and face features made
        # once, then steps of UNet + CLIP + MLP
        ccfg = TrainerConfig(logdir=run_root, suffix="cached",
                             max_steps=CACHED_STEPS + 1, ckpt_every=100,
                             log_every=1, cache_latents=2, seed=23)
        ctrainer = Trainer(pipe, meta, asm.basis, loader, ccfg)
        cstate = ctrainer.init_state(new)
        fa.reset_launch_count()
        caps0 = graphs.captures()
        ctrainer.fit(cstate)
        torch.cuda.synchronize()
        c_launches = fa.launch_counts()
        c_caps = graphs.captures() - caps0
        with open(ctrainer.metrics_path) as f:
            crecs = [json.loads(line) for line in f]
        c_ms = [r["step_time_s"] * 1e3 for r in crecs]
        log("train", f"{len(crecs)} cached steps: ms per step "
                     f"{[round(x, 1) for x in c_ms]} (median of all but "
                     f"the first {float(np.median(c_ms[1:])):.1f}); losses "
                     f"{[round(r['loss'], 4) for r in crecs]}")
        # the cache's VAE encodes run no kernel of ours (head dim 512)
        if c_caps != 1 or c_launches != {
                n: c * (CACHED_STEPS + 1 + c_caps)
                for n, c in TRAIN_LAUNCHES.items()} \
                or not np.isfinite([r["loss"] for r in crecs]).all():
            raise RuntimeError(f"train: cached steps launched {c_launches}")

        # one full-width step's MLP gradient: kernel route vs plain route
        loss_fn = tstep.make_loss_fn(pipe, meta)
        mstate = new
        loss_k, grad_k, _ = loss_and_mlp_grad(loss_fn, meta, mstate,
                                              asm.basis, loader[0], 9)
        attn_ops.set_default_impl("xla")
        try:
            loss_p, grad_p, n_p = loss_and_mlp_grad(loss_fn, meta, mstate,
                                                    asm.basis, loader[0], 9)
        finally:
            attn_ops.set_default_impl(None)
        cos = torch.nn.functional.cosine_similarity(grad_k, grad_p,
                                                    dim=0).item()
        rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
        log("train", f"full-width step, kernel route vs plain route (512x512, "
                     f"bf16 compute): loss {loss_k:.5f} vs {loss_p:.5f}; MLP "
                     f"gradient cosine {cos:.5f}, |diff| / |grad| {rel:.4f}, "
                     f"|grad| {grad_p.norm().item():.3e}")
        # bf16 compute on both routes: the attention cores round at other
        # places, and 16 transformer blocks carry that to the loss
        if sum(n_p.values()) or not (cos >= 0.99 and rel <= 0.1
                                     and abs(loss_k - loss_p)
                                     <= 0.01 * abs(loss_p)):
            raise RuntimeError("train: the kernel route's gradient is not "
                               "the plain route's")

        # the FF sub-blocks on the GEGLU kernel route: the same step's MLP
        # gradient against the plain GEGLU route (attention on its kernel
        # route on both sides), then uncached and cached steps
        geglu.set_default_impl("cuda")
        try:
            loss_g, grad_g, n_g = loss_and_mlp_grad(loss_fn, meta, mstate,
                                                    asm.basis, loader[0], 9)
            cos = torch.nn.functional.cosine_similarity(grad_g, grad_k,
                                                        dim=0).item()
            rel = ((grad_g - grad_k).norm() / grad_k.norm()).item()
            log("train", f"full-width step, GEGLU kernel route vs plain "
                         f"route: loss {loss_g:.5f} vs {loss_k:.5f}; MLP "
                         f"gradient cosine {cos:.5f}, |diff| / |grad| "
                         f"{rel:.4f}; geglu_block launches "
                         f"{n_g['geglu_block']}")
            if n_g["geglu_block"] != GEGLU_PER_UNET or not (
                    cos >= 0.99 and rel <= 0.1
                    and abs(loss_g - loss_k) <= 0.01 * abs(loss_k)):
                raise RuntimeError("train: the GEGLU kernel route's gradient "
                                   "is not the plain route's")
            geglu_ms, geglu_launches = {}, 0
            for suffix, steps, cache in (("geglu", GEGLU_TRAIN_STEPS, 0),
                                         ("geglu_cached", CACHED_STEPS + 1,
                                          2)):
                gtrainer = Trainer(pipe, meta, asm.basis, loader,
                                   TrainerConfig(
                                       logdir=run_root, suffix=suffix,
                                       max_steps=steps, ckpt_every=100,
                                       log_every=1, cache_latents=cache,
                                       seed=23))
                gstate = gtrainer.init_state(new)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fa.reset_launch_count()
                geglu.reset_launch_count()
                caps0 = graphs.captures()
                gtrainer.fit(gstate)
                torch.cuda.synchronize()
                got = {**fa.launch_counts(), **geglu.launch_counts()}
                g_caps = graphs.captures() - caps0
                if not cache:
                    geglu_ms["geglu_peak_gib"] = \
                        torch.cuda.max_memory_allocated() / 2 ** 30
                with open(gtrainer.metrics_path) as f:
                    grecs = [json.loads(line) for line in f]
                g_ms = [r["step_time_s"] * 1e3 for r in grecs]
                geglu_ms[f"{suffix}_ms"] = float(np.median(g_ms[1:]))
                log("train", f"{len(grecs)} {suffix} steps (GEGLU kernel "
                             f"route): ms per step "
                             f"{[round(x, 1) for x in g_ms]}; losses "
                             f"{[round(r['loss'], 4) for r in grecs]}; "
                             f"launches {json.dumps(got)}")
                runs = steps + g_caps
                want = {**{n: c * runs for n, c in TRAIN_LAUNCHES.items()},
                        "geglu_block": GEGLU_PER_UNET * runs,
                        "geglu_ffn": 0}
                if got != want or len(grecs) != steps or g_caps != 1 \
                        or not np.isfinite([r["loss"] for r in grecs]).all():
                    raise RuntimeError(f"train: GEGLU route steps launched "
                                       f"{got}; expected {want}")
                geglu_launches += got["geglu_block"]
        finally:
            geglu.set_default_impl(None)
        log("train", f"xla vs GEGLU kernel route: uncached ms per step "
                     f"{float(np.median(step_ms[1:])):.1f} vs "
                     f"{geglu_ms['geglu_ms']:.1f}, cached "
                     f"{float(np.median(c_ms[1:])):.1f} vs "
                     f"{geglu_ms['geglu_cached_ms']:.1f}, peak memory "
                     f"{peak / 2**30:.2f} vs {geglu_ms['geglu_peak_gib']:.2f} "
                     f"GiB")
        # each trainer keeps its step graphs (and their memory) while it
        # lives
        del trainer, ctrainer, gtrainer
        torch.cuda.empty_cache()
        both_ways, both_launches = steps_graph_vs_eager(pipe, meta, asm,
                                                        loader[0])
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    for name, n in both_launches.items():
        launches[name] = launches.get(name, 0) + n
    return ({**launches, "geglu_block": geglu_launches},
            {"uncached_ms": float(np.median(step_ms[1:])),
             "cached_ms": float(np.median(c_ms[1:])),
             "peak_gib": peak / 2 ** 30, **geglu_ms,
             "graph_vs_eager": both_ways})


GRAPH_STEPS = 4              # steps a run, graph against eager


def steps_graph_vs_eager(pipe, meta, asm, batch):
    """The uncached, cached and eval steps (``train.step``), each run on its
    graph and eagerly (``.eager``) in turns (eager, graph, graph, eager),
    GRAPH_STEPS steps a run from the same MLP, optimizer state, manager
    state and generator: losses, MLP gradients, MLP parameters after AdamW
    and the manager state bit for bit; launches a step, ms a step (median of
    all but the first: a graph run's first step warms up and captures) and
    peak memory each way.  -> (record, launches by kernel)."""
    from celebbasis_tpu_torch.train import step as tstep

    start = [p.detach().clone() for p in meta.mlp.parameters()]
    cache = tstep.precompute_cache(pipe, meta, [batch], 1)[0]
    record, total = {}, {}

    def run(kind, way):
        with torch.no_grad():
            for p, p0 in zip(meta.mlp.parameters(), start):
                p.copy_(p0)
        trainable = tstep.build_trainable(meta)
        opt = tstep.make_optimizer(trainable, 1e-2)
        gen = torch.Generator(device="cuda").manual_seed(3)
        state = tstep.init_train_state(gen, trainable, opt, asm.manager_state)
        if kind == "eval":
            step = tstep.make_eval_step(pipe, meta)
            fn = step.eager if way == "eager" else step
            call = lambda: (state, fn(state, asm.basis, batch, gen))
        else:
            step = (tstep.make_cached_train_step if kind == "cached"
                    else tstep.make_train_step)(pipe, meta, opt)
            fn = step.eager if way == "eager" else step
            b = cache if kind == "cached" else batch
            call = lambda: fn(state, asm.basis, b)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        caps0 = graphs.captures()
        ms, outs = [], []
        for _ in range(GRAPH_STEPS):
            t0 = time.perf_counter()
            state, logs = call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(logs["loss"].clone())
        caps = graphs.captures() - caps0
        counts = fa.launch_counts()
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        if kind != "eval":
            outs += [p.grad.clone() for p in trainable["meta"]]
            outs += [p.detach().clone() for p in trainable["meta"]]
            outs += list(state.manager_state)
        return outs, {"ms": float(np.median(ms[1:])), "first_ms": ms[0],
                      "captures": caps,
                      "launches_per_step": {n: c / (GRAPH_STEPS + caps)
                                            for n, c in counts.items() if c},
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "peak_reserved_gib":
                          torch.cuda.max_memory_reserved() / 2**30}

    for kind in ("uncached", "cached", "eval"):
        outs, rec = {}, {"eager": [], "graph": []}
        for i, way in enumerate(("eager", "graph", "graph", "eager")):
            outs[i], r = run(kind, way)
            rec[way].append(r)
        same = all(len(outs[i]) == len(outs[0]) and all(
            torch.equal(a, b) for a, b in zip(outs[i], outs[0]))
            for i in range(1, 4))
        diff = max(float((a.float() - b.float()).abs().max())
                   for i in range(1, 4) for a, b in zip(outs[i], outs[0]))
        per_step = {way: [r["launches_per_step"] for r in rec[way]]
                    for way in rec}
        want = {n: float(c) for n, c in TRAIN_LAUNCHES.items() if c} \
            if kind != "eval" else {"flash_attention_nhd":
                                    float(ATTN_PER_UNET)}
        what = "losses" if kind == "eval" else (
            "losses, MLP gradients, MLP parameters after AdamW and the "
            "manager state")
        ms = {way: [round(r["ms"], 2) for r in rec[way]] for way in rec}
        peaks = {way: [(round(r["peak_gib"], 2),
                        round(r["peak_reserved_gib"], 2)) for r in rec[way]]
                 for way in rec}
        log("train", f"{kind} step, graph vs eager in turns: bit for bit "
                     f"{same} (largest difference {diff:.3e} over {what}); "
                     f"ms a step graph {ms['graph']} vs eager {ms['eager']} "
                     f"(a graph run's first step, warm-up and capture "
                     f"{[round(r['first_ms'], 1) for r in rec['graph']]}); "
                     f"launches a step {json.dumps(per_step['graph'][0])} vs "
                     f"{json.dumps(per_step['eager'][0])}; peak allocated / "
                     f"reserved GiB graph {peaks['graph']} vs eager "
                     f"{peaks['eager']}")
        if not same:
            raise RuntimeError(f"train: the {kind} step's graph does not "
                               f"give its eager bits ({diff:.3e})")
        if any(p != want for way in per_step for p in per_step[way]) or \
                [r["captures"] for r in rec["graph"]] != [1, 1]:
            raise RuntimeError(f"train: {kind} launches a step {per_step}; "
                               f"expected {want}")
        record[kind] = rec
    return record, total


# -- phase 11 -----------------------------------------------------------------

class DrawnAssemblies:
    """While entered, every ``loader.assemble`` (the one the CLIs call) draws
    its UNet's zero-initialised output convs, as the serve phase does (not
    with ``draw=False``: weights read from a checkpoint stay), and counts the
    UNet's calls; ``calls`` and ``assemble_s`` add up over all assemblies
    made inside."""

    def __init__(self, draw: bool = True):
        self.draw = draw

    def __enter__(self):
        from celebbasis_tpu_torch import loader
        from celebbasis_tpu_torch.utils.precision import cast_float_params

        self.calls, self.assemble_s = 0, 0.0
        self._loader, self._real = loader, loader.assemble

        def assemble(*args, **kw):
            t0 = time.perf_counter()
            asm = self._real(*args, **kw)
            if self.draw:
                loader.init_weights(
                    asm.pipeline.unet,
                    torch.Generator(device="cuda").manual_seed(5),
                    zero_convs=False)
                if kw.get("param_dtype") is not None:
                    cast_float_params(asm.pipeline, kw["param_dtype"])
            asm.pipeline.unet.register_forward_pre_hook(self._count)
            self.assemble_s += time.perf_counter() - t0
            return asm

        loader.assemble = assemble
        return self

    def _count(self, module, args):
        self.calls += 1

    def __exit__(self, *exc):
        self._loader.assemble = self._real


def measured(name, ctx, fn, phase="generate"):
    """Runs ``fn()`` with the flash counters at 0 and the peak memory reset;
    -> (its result, a record of wall and assembly ms, UNet calls, launches,
    peak GiB), logged under `phase`."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    calls0, asm0 = ctx.calls, ctx.assemble_s
    fa.reset_launch_count()
    caps0 = graphs.captures()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec = {"wall_ms": (time.perf_counter() - t0) * 1e3,
           "assemble_ms": (ctx.assemble_s - asm0) * 1e3,
           "unet_calls": ctx.calls - calls0,
           "captures": graphs.captures() - caps0,
           "launches": {n: c for n, c in fa.launch_counts().items() if c},
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(phase, f"{name}: wall {rec['wall_ms']:.1f} ms (assembly "
               f"{rec['assemble_ms']:.1f}), graphs captured "
               f"{rec['captures']}, UNet calls (Python) "
               f"{rec['unet_calls']}, flash launches "
               f"{json.dumps(rec['launches'])}, peak memory "
               f"{rec['peak_gib']:.2f} GiB")
    return out, rec


def kernel_counts():
    """Every hand-written kernel's launch counter that is not zero: flash
    (the dk/dv split reduction's among them), GEGLU and int8."""
    counts = {**flash_counts(), **geglu.launch_counts(),
              **quant.launch_counts()}
    return {n: c for n, c in counts.items() if c}


def reset_kernel_counts():
    for module in (fa, geglu, quant):
        module.reset_launch_count()


def graph_turns(phase, name, graph, eager, captured, reset=lambda: None,
                units=1):
    """A captured path against its eager run.  ``graph()`` and ``eager()``
    each run the path ``units`` times (a run of steps, a chain of segments)
    and return a list of tensors (outputs, and the state a training path
    writes); ``reset()`` puts back what they change.  The first ``graph()``
    captures (its seconds, warm-up and first replay included, are
    ``capture_s``); then the two run in turns (graph, eager, eager, graph),
    each to a sync.  Every turn must give the first call's bits, launch
    what every other turn launches (= a replay's launches, ``units`` times)
    and capture nothing.  -> a record: ms a unit, launches a unit,
    peak GiB allocated and reserved, for each turn; ``launches`` and
    ``wall_ms`` over all five runs.  ``captured``: the path's
    ``graphs.Captured``, which must hold a graph after the first call."""
    def run(fn):
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        caps0 = graphs.captures()
        t0 = time.perf_counter()
        out = [o.clone() for o in fn()]
        torch.cuda.synchronize()
        return out, {
            "ms": (time.perf_counter() - t0) * 1e3 / units,
            "captures": graphs.captures() - caps0,
            "launches": {n: c / units for n, c in kernel_counts().items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}

    first, cap = run(graph)
    rec = {"capture_s": cap["ms"] * units / 1e3,
           "capture_captures": cap["captures"], "graph": [], "eager": []}
    totals = {n: c * units for n, c in cap["launches"].items()}
    same = True
    for way in ("graph", "eager", "eager", "graph"):
        out, r = run(graph if way == "graph" else eager)
        same = same and len(out) == len(first) and all(
            torch.equal(a, b) for a, b in zip(out, first))
        rec[way].append(r)
        for n, c in r["launches"].items():
            totals[n] = totals.get(n, 0) + c * units
    reset()
    # every launch of the turns, the capture's warm-up included (the
    # kernels line's count), and their wall
    rec["launches"] = {n: int(round(c)) for n, c in totals.items()}
    rec["wall_ms"] = cap["ms"] * units + sum(
        r["ms"] * units for r in rec["graph"] + rec["eager"])
    turns = rec["graph"] + rec["eager"]
    rec["bits_equal"] = same
    rec["launches_per_unit"] = turns[0]["launches"]
    med = lambda xs: round(float(np.median(xs)), 3)
    rec["ms_graph"] = med([r["ms"] for r in rec["graph"]])
    rec["ms_eager"] = med([r["ms"] for r in rec["eager"]])
    log(phase, f"{name} graph vs eager in turns: bits equal {same}; "
               f"first call {rec['capture_s']:.2f} s (graphs captured "
               f"{cap['captures']}); ms a unit graph "
               f"{[round(r['ms'], 2) for r in rec['graph']]} eager "
               f"{[round(r['ms'], 2) for r in rec['eager']]}; launches a "
               f"unit {json.dumps(rec['launches_per_unit'])}; peak GiB "
               f"allocated / reserved graph "
               f"{[(round(r['peak_gib'], 2), round(r['peak_reserved_gib'], 2)) for r in rec['graph']]}"
               f" eager "
               f"{[(round(r['peak_gib'], 2), round(r['peak_reserved_gib'], 2)) for r in rec['eager']]}")
    if not same or not captured.capture_s \
            or any(r["launches"] != rec["launches_per_unit"]
                   or r["captures"] for r in turns):
        raise RuntimeError(f"{phase}: {name}'s graph does not give its eager "
                           f"bits or launches: {rec}")
    return rec


def check_images(name, imgs, n, size):
    if imgs.shape != (n, size, size, 3) or imgs.dtype != np.uint8:
        raise RuntimeError(f"generate: {name} gave {imgs.shape} {imgs.dtype}")
    if min(im.std() for im in imgs) < 1.0:
        raise RuntimeError(f"generate: {name} gave a constant image")


def phase_generate(work, ckpt):
    """The generation CLIs at full width (``configs/aigc_id.yaml``, bf16,
    512x512, batch 2, the output convs drawn) and the full DDPM chain."""
    from celebbasis_tpu_torch.cli import (build_basis, extract, img2img,
                                          txt2img)
    from celebbasis_tpu_torch.cli.serve import encode_png
    from celebbasis_tpu_torch import loader
    from celebbasis_tpu_torch.diffusion.sampler import sample_seed
    from celebbasis_tpu_torch.utils.config import load_run_spec

    config = os.path.join(REPO, "configs", "aigc_id.yaml")
    pictures = {}
    for name, img in zip(("face0", "face1", "init"),
                         face_crops(512, 51, k=3)):
        pictures[name] = os.path.join(work, f"{name}.png")
        with open(pictures[name], "wb") as f:
            f.write(encode_png(img))
    mask = np.zeros((512, 512, 3), np.uint8)
    mask[:, 256:] = 255                     # regenerate the right half
    pictures["mask"] = os.path.join(work, "mask.png")
    with open(pictures["mask"], "wb") as f:
        f.write(encode_png(mask))
    common = ["--config", config, "--n_samples", "2", "--precision", "bf16"]
    want = {}                               # name -> UNet calls
    recs = {}
    cwd = os.getcwd()
    os.chdir(REPO)                          # the config's relative paths
    try:
        with DrawnAssemblies() as ctx:
            runs = {
                "txt2img_plms": (DDIM_STEPS + 1, lambda: txt2img.main(
                    common + ["--plms", "--ddim_steps", str(DDIM_STEPS),
                              "--outdir", os.path.join(work, "plms")])),
                "txt2img_faces": (DDIM_STEPS, lambda: txt2img.main(
                    common + ["--ddim_steps", str(DDIM_STEPS), "--prompt",
                              "a photo of a sks person and a ks person",
                              "--outdir", os.path.join(work, "faces"),
                              "--faces", pictures["face0"],
                              pictures["face1"]])),
                "img2img_mask": (DDIM_STEPS // 2, lambda: img2img.main(
                    common + ["--ddim_steps", str(DDIM_STEPS), "--strength",
                              "0.5", "--init-img", pictures["init"],
                              "--mask", pictures["mask"], "--outdir",
                              os.path.join(work, "img2img")])),
            }
            for name, (calls, run) in runs.items():
                imgs, recs[name] = measured(name, ctx, run)
                check_images(name, imgs, 2, 512)
                want[name] = calls
            if [recs[n]["captures"] for n in runs] != [1, 1, 1]:
                raise RuntimeError(f"generate: captures "
                                   f"{[recs[n]['captures'] for n in runs]}; "
                                   f"expected one graph a CLI run")
            plms_files = sorted(os.listdir(os.path.join(
                work, "plms", os.listdir(os.path.join(work, "plms"))[0])))
            if plms_files != ["00000.jpg", "00001.jpg", "grid.jpg"]:
                raise RuntimeError(f"generate: txt2img wrote {plms_files}")

            # img2img (masked and not) and the ancestral chain over the
            # full 1000-step schedule, CFG, on one assembly
            spec = load_run_spec([config])
            asm = loader.assemble(spec, image_size=512, seed=7,
                                  param_dtype=torch.bfloat16)
            pipe = asm.pipeline
            as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).cuda()
            k = len(pipe.manager_cfg.placeholder_token_ids)
            tokens = as_dev(asm.tokenizer(["a photo of a sks person"] * 2))
            uncond_tokens = as_dev(asm.tokenizer([""] * 2))
            ids, num_ids = as_dev([[0, 1] + [0] * (k - 2)] * 2), as_dev([2, 2])
            gens = lambda: [torch.Generator(device="cuda").manual_seed(
                sample_seed(13, j)) for j in range(2)]
            recs.update(img2img_turns(asm, tokens, uncond_tokens, ids,
                                      num_ids, gens))
            recs.update(ddpm_graph_vs_eager(ctx, pipe, asm, tokens,
                                            uncond_tokens, ids, num_ids,
                                            gens))
            del asm, pipe

            basis_path = os.path.join(work, "weights", "celeb_basis.pt")
            _, recs["build_basis"] = measured(
                "build_basis", ctx,
                lambda: build_basis.main(["--config", config, "--out",
                                          basis_path]))
            _, recs["extract"] = measured(
                "extract", ctx,
                lambda: extract.main(["--config", config, "--embedding_path",
                                      ckpt, "--outdir",
                                      os.path.join(work, "ti")]))
    finally:
        os.chdir(cwd)
    for name, calls in want.items():
        got = recs[name]
        # a captured run's Python runs twice (warm-up, capture) and its
        # kernels twice (warm-up, replay)
        expected = (graphed_unet_calls(calls, got),
                    graphed_launches(calls, 1, got))
        if (got["unet_calls"], got["launches"]) != expected:
            raise RuntimeError(f"generate: {name} made {got['unet_calls']} "
                               f"UNet calls and launched {got['launches']}; "
                               f"expected {expected}")

    load = lambda *p: torch.load(os.path.join(work, *p), weights_only=True)
    saved = torch.load(ckpt, weights_only=True)["id_coefficients"]
    basis = load("weights", "celeb_basis.pt")
    shapes = {"celeb_basis": tuple(basis.shape)}
    for i in range(len(saved)):
        emb, coeff = (load("ti", f"id_embedding_{i}.pt"),
                      load("ti", f"id_coefficient_{i}.pt"))
        shapes[f"id_{i}"] = (tuple(emb.shape), tuple(coeff.shape))
        if emb.shape != (2, 768) or not torch.equal(coeff,
                                                    saved[i].float()):
            raise RuntimeError(f"extract: identity {i}: {emb.shape}, "
                               f"coefficients {coeff.shape}")
    if not torch.equal(load("ti", "celeb_basis.pt"), basis) \
            or basis.shape != (2, 513, 768) or not basis.isfinite().all():
        raise RuntimeError(f"build_basis / extract: basis {basis.shape}")
    log("generate", f"build_basis and extract: {json.dumps(shapes)}")
    return recs


def img2img_turns(asm, tokens, uncond_tokens, ids, num_ids, gens):
    """``make_img2img_fn`` at the CLI's settings (20 DDIM steps, strength
    0.5: 10 guided UNet calls), masked (the right half regenerated) and
    not, on its graph against its eager run (``graph_turns``).  -> the two
    records."""
    from celebbasis_tpu_torch.cli import img2img

    fn = img2img.make_img2img_fn(asm.pipeline, DDIM_STEPS, 0.5, 10.0, 512,
                                 output="uint8")
    init = torch.from_numpy(face_crops(512, 51, k=3)[2].astype(np.float32)
                            / 127.5 - 1.0).cuda()[None].expand(2, -1, -1, -1)
    mask = torch.zeros(1, 64, 64, 1, device="cuda")
    mask[:, :, 32:] = 1.0
    out = {}
    for name, m in (("img2img_mask_turns", mask),
                    ("img2img_plain_turns", None)):
        args = lambda: (asm.manager_state, asm.basis, init, m, tokens,
                        uncond_tokens, ids, num_ids, gens())
        out[name] = graph_turns("generate", name, lambda: [fn(*args())],
                                lambda: [fn.eager(*args())], fn.captured)
        want = {"flash_attention_nhd": ATTN_PER_UNET * DDIM_STEPS // 2}
        if fn.captured.launches_per_replay() != dict(
                (n, c * (1 + (m is None))) for n, c in want.items()) \
                or out[name]["launches_per_unit"] != want:
            raise RuntimeError(f"generate: {name} launched "
                               f"{out[name]['launches_per_unit']} a run; "
                               f"expected {want}")
    return out


def ddpm_graph_vs_eager(ctx, pipe, asm, tokens, uncond_tokens, ids, num_ids,
                        gens):
    """The ancestral chain over the full 1000-step schedule with guidance
    10 (``diffusion.sampler.DDPMChain``), then the VAE decode: once on its
    segment graph (one capture of DDPM_SEGMENT steps, replayed T /
    DDPM_SEGMENT times) and once eagerly.  The latents and pixels bit for
    bit, a replay's launches equal to a segment's eager launches, the UNet
    calls each way.  -> the two records."""
    from celebbasis_tpu_torch.diffusion.sampler import (DDPM_SEGMENT,
                                                        DDPMChain,
                                                        SamplerConfig)
    from celebbasis_tpu_torch.pipeline import finish_images

    T = pipe.schedule.num_timesteps
    with torch.inference_mode():
        cond = pipe.conditioning(tokens, asm.manager_state, asm.basis, ids,
                                 num_ids)
        uncond = pipe.conditioning(uncond_tokens)
    chain = DDPMChain(pipe.eps_model(), pipe.schedule,
                      SamplerConfig(guidance_scale=10.0))

    def ddpm(way):
        with torch.inference_mode():
            x = way(generators=gens(), shape=(2, 64, 64, 4), cond=cond,
                    uncond=uncond)
            img = pipe.vae.decode(x / pipe.cfg.scale_factor)
            return x, finish_images(img, "uint8")

    (x_g, imgs_g), graph = measured("ddpm_full_chain", ctx,
                                    lambda: ddpm(chain))
    (x_e, imgs_e), eager = measured("ddpm_full_chain_eager", ctx,
                                    lambda: ddpm(chain.eager))
    check_images("ddpm_full_chain", imgs_g.cpu().numpy(), 2, 512)
    per_unet = {"flash_attention_nhd": ATTN_PER_UNET}
    per_replay = {n: c * DDPM_SEGMENT for n, c in per_unet.items()}
    graph.update(bits_equal=bool(torch.equal(x_g, x_e)
                                 and torch.equal(imgs_g, imgs_e)),
                 launches_per_replay=chain.segment.launches_per_replay(),
                 capture_s=sum(chain.segment.capture_s.values()))
    log("generate", f"ddpm_full_chain: {T} steps on a {DDPM_SEGMENT}-step "
                    f"segment graph {graph['wall_ms']:.0f} ms (capture "
                    f"{graph['capture_s']:.2f} s, {graph['captures']} graphs)"
                    f" vs eager {eager['wall_ms']:.0f} ms; bits equal "
                    f"{graph['bits_equal']}; launches a replay "
                    f"{json.dumps(graph['launches_per_replay'])}")
    want = ((1, 2 * DDPM_SEGMENT, {n: c * (T + DDPM_SEGMENT)
                                   for n, c in per_unet.items()}),
            (0, T, {n: c * T for n, c in per_unet.items()}))
    got = tuple((r["captures"], r["unet_calls"], r["launches"])
                for r in (graph, eager))
    if not graph["bits_equal"] or got != want \
            or graph["launches_per_replay"] != per_replay:
        raise RuntimeError(f"generate: the DDPM chain's graph gave bits "
                           f"equal {graph['bits_equal']}, (captures, UNet "
                           f"calls, launches) {got}, expected {want}, "
                           f"{graph['launches_per_replay']} a replay")
    return {"ddpm_full_chain": graph, "ddpm_full_chain_eager": eager}


# -- phase 12 -----------------------------------------------------------------

def write_pngs(folder, names, seed):
    """Random-pixel 512x512 PNGs ``folder/<name>`` from a numpy seed."""
    from celebbasis_tpu_torch.cli.serve import encode_png
    os.makedirs(folder, exist_ok=True)
    for name, img in zip(names, face_crops(512, seed, k=len(names))):
        with open(os.path.join(folder, name), "wb") as f:
            f.write(encode_png(img))


def ti_route_parity(pipe, vectors):
    """One TI loss and vector gradient on the full-width pipeline, kernel
    route against plain route at the same draws (bf16 compute on both):
    -> (loss_k, loss_p, cosine, |diff| / |grad|, kernel-route launches,
    plain-route launches)."""
    from celebbasis_tpu_torch.cli import train_ti
    from celebbasis_tpu_torch.core import textual_inversion as ti

    cfg = ti.TIConfig(("*",), vectors.shape[0], pipe.cfg.clip.width)
    loss_fn = train_ti.make_ti_loss_fn(
        pipe, cfg, ti.placeholder_token_ids(cfg, pipe.tokenizer))
    r = np.random.default_rng(5)
    batch = {"image": torch.from_numpy(r.uniform(
        -1, 1, (2, 512, 512, 3)).astype(np.float32)).cuda(),
        "tokens": torch.from_numpy(np.asarray(pipe.tokenizer(
            ["a photo of a *", "a close-up photo of the *"]),
            np.int64)).cuda()}

    def loss_and_grad():
        p = torch.nn.Parameter(torch.from_numpy(vectors[None].copy()).cuda())
        fa.reset_launch_count()
        loss, _ = loss_fn(p, batch, torch.Generator(device="cuda")
                          .manual_seed(9))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), p.grad.flatten().float(), fa.launch_counts()

    loss_k, grad_k, n_k = loss_and_grad()
    attn_ops.set_default_impl("xla")
    try:
        loss_p, grad_p, n_p = loss_and_grad()
    finally:
        attn_ops.set_default_impl(None)
    cos = torch.nn.functional.cosine_similarity(grad_k, grad_p, dim=0).item()
    rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    return loss_k, loss_p, cos, rel, n_k, sum(n_p.values())


def phase_ti(work, checkpoints):
    """``cli/train_ti.py`` at full width (``configs/aigc_id.yaml``, bf16
    compute, 512x512, batch 2) from the checkpoint phase's ``sd-v1-4.ckpt``
    on three random-pixel PNGs: TI_STEPS steps, each timed to a sync; the
    loss finite, the vectors moved, the UNet, CLIP and VAE unchanged and
    without gradients, a step's flash launches TRAIN_LAUNCHES; one step's
    loss and vector gradient on the kernel route against the plain route;
    then ``cli/merge.py`` on its checkpoint and a renamed copy, and a
    20-step ``cli/txt2img.py --ti_embedding`` on the merged file.  -> a
    record."""
    from celebbasis_tpu_torch.cli import merge, train_ti, txt2img
    from celebbasis_tpu_torch.core import textual_inversion as ti

    config = os.path.join(REPO, "configs", "aigc_id.yaml")
    data = os.path.join(work, "ti_subject")
    write_pngs(data, [f"{i}.png" for i in range(3)], 31)
    steps, seen = [], {}
    real_make = train_ti.make_ti_train_step

    def make(pipe, *args, **kw):
        """The CLI's step, timed to a sync; keeps the pipeline, the frozen
        modules' checksums and the first vectors."""
        step = real_make(pipe, *args, **kw)
        seen["pipe"] = pipe
        seen["sums"] = {n: checksum(getattr(pipe, n))
                        for n in ("unet", "clip", "vae")}

        def timed(params, batch, generator):
            seen.setdefault("init", params.detach().cpu().numpy().copy())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = step(params, batch, generator)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3,
                          logs["loss"].item()))
            return logs

        return timed

    cwd = os.getcwd()
    os.chdir(REPO)                          # the config's relative paths
    train_ti.make_ti_train_step = make
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        t0 = time.perf_counter()
        run = train_ti.main([
            "--base", config, "--data_root", data, "--actual_resume",
            checkpoints["sd"], "--logdir", os.path.join(work, "ti_logs"),
            "--max_steps", str(TI_STEPS), "--image_size", "512"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        train_ti.make_ti_train_step = real_make
        os.chdir(cwd)
    step_ms = [ms for ms, _ in steps]
    losses = [loss for _, loss in steps]
    ckpt = os.path.join(run, "checkpoints", f"embeddings_gs-{TI_STEPS}.pt")
    vectors = ti.load_ti_checkpoint(ckpt)["*"]
    moved = float(np.abs(vectors - seen["init"][0]).max())
    pipe = seen.pop("pipe")
    rec = {"wall_s": wall, "step_ms": step_ms,
           "median_step_ms": float(np.median(step_ms[1:])), "losses": losses,
           "launches": launches, "peak_gib": peak, "vectors_moved": moved}
    log("ti", f"cli/train_ti.py: {len(steps)} steps in {wall:.1f} s "
              f"(assembly from the checkpoint included); ms per step "
              f"{[round(x, 1) for x in step_ms]} (median of all but the "
              f"first {rec['median_step_ms']:.1f}); losses "
              f"{[round(x, 4) for x in losses]}; vectors moved by "
              f"{moved:.4f}; flash launches {json.dumps(launches)} (a step: "
              f"{launches['fwd_lse'] / TI_STEPS:g} #3, "
              f"{launches['dq'] / TI_STEPS:g} #4, "
              f"{launches['dkv'] / TI_STEPS:g} #5); peak memory "
              f"{peak:.2f} GiB")
    # the first step captures the step's graph; its warm-up launched one
    # step's kernels besides the replays
    want = {n: c * (TI_STEPS + 1) for n, c in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise RuntimeError(f"ti: launched {launches}; expected {want}")
    if len(steps) != TI_STEPS or not np.isfinite(losses).all() \
            or not moved > 0:
        raise RuntimeError(f"ti: losses {losses}, vectors moved {moved}")
    for name, total in seen["sums"].items():
        module = getattr(pipe, name)
        if checksum(module) != total or any(
                p.grad is not None or p.requires_grad
                for p in module.parameters()):
            raise RuntimeError(f"ti: the frozen {name} changed or took a "
                               f"gradient")

    rec["graph_vs_eager"], rec["graph_vs_eager_launches"] = \
        ti_graph_vs_eager(pipe, vectors)
    loss_k, loss_p, cos, rel, n_k, n_p = ti_route_parity(pipe, vectors)
    rec.update(route_loss=(loss_k, loss_p), route_grad_cos=cos,
               route_grad_rel=rel)
    log("ti", f"full-width TI step, kernel route vs plain route: loss "
              f"{loss_k:.5f} vs {loss_p:.5f}; vector gradient cosine "
              f"{cos:.5f}, |diff| / |grad| {rel:.4f}")
    if n_k != TRAIN_LAUNCHES or n_p or not (
            cos >= 0.99 and rel <= 0.1
            and abs(loss_k - loss_p) <= 0.01 * abs(loss_p)):
        raise RuntimeError(f"ti: the kernel route ({n_k}) does not give the "
                           f"plain route's ({n_p} launches) gradient")
    del pipe, seen

    copy = os.path.join(work, "ti_copy.pt")
    shutil.copy(ckpt, copy)
    merged = os.path.join(work, "ti_merged.pt")
    names = merge.main(["--manager_ckpts", ckpt, copy, "--output_path",
                        merged, "--rename", f"{copy}:*=@"])
    if sorted(names) != ["*", "@"]:
        raise RuntimeError(f"ti: merged {sorted(names)}")
    os.chdir(REPO)
    try:
        with DrawnAssemblies(draw=False) as ctx:
            imgs, rec["txt2img"] = measured(
                "txt2img --ti_embedding", ctx, lambda: txt2img.main([
                    "--config", config, "--ckpt", checkpoints["sd"],
                    "--ti_embedding", merged, "--prompt",
                    "a photo of * and @", "--ddim_steps", str(DDIM_STEPS),
                    "--n_samples", "2", "--precision", "bf16", "--outdir",
                    os.path.join(work, "ti_samples")]), phase="ti")
    finally:
        os.chdir(cwd)
    check_images("ti txt2img", imgs, 2, 512)
    got = rec["txt2img"]
    if got["unet_calls"] != graphed_unet_calls(DDIM_STEPS, got) \
            or got["launches"] != graphed_launches(DDIM_STEPS, 1, got):
        raise RuntimeError(f"ti: txt2img made {got['unet_calls']} UNet calls "
                           f"and launched {got['launches']}")
    return rec


def ti_graph_vs_eager(pipe, vectors):
    """The TI step (``cli/train_ti.make_ti_train_step``) on its graph and
    eagerly in turns (eager, graph, graph, eager), GRAPH_STEPS steps a run
    from the same vectors and generator on one batch: losses, the vectors'
    gradient and the vectors after AdamW bit for bit; ms a step, launches a
    step and peak memory each way.  -> (record, launches by kernel)."""
    from celebbasis_tpu_torch.cli import train_ti
    from celebbasis_tpu_torch.core import textual_inversion as ti
    from celebbasis_tpu_torch.train.step import make_optimizer

    cfg = ti.TIConfig(("*",), vectors.shape[0], pipe.cfg.clip.width)
    ph = ti.placeholder_token_ids(cfg, pipe.tokenizer)
    r = np.random.default_rng(6)
    batch = {"image": torch.from_numpy(r.uniform(
        -1, 1, (2, 512, 512, 3)).astype(np.float32)).cuda(),
        "tokens": torch.from_numpy(np.asarray(pipe.tokenizer(
            ["a photo of a *", "a rendering of a *"]), np.int64)).cuda()}
    outs, rec, total = {}, {"eager": [], "graph": []}, {}
    for i, way in enumerate(("eager", "graph", "graph", "eager")):
        param = torch.nn.Parameter(torch.from_numpy(vectors[None].copy())
                                   .cuda())
        step = train_ti.make_ti_train_step(
            pipe, cfg, ph, make_optimizer({"ti": [param]}, lr=1e-2))
        fn = step.eager if way == "eager" else step
        gen = torch.Generator(device="cuda").manual_seed(4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        caps0 = graphs.captures()
        ms, losses = [], []
        for _ in range(GRAPH_STEPS):
            t0 = time.perf_counter()
            logs = fn(param, batch, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(logs["loss"].clone())
        runs = GRAPH_STEPS + graphs.captures() - caps0
        counts = {n: c for n, c in fa.launch_counts().items() if c}
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        outs[i] = losses + [param.grad.clone(), param.detach().clone()]
        rec[way].append({"ms": float(np.median(ms[1:])), "first_ms": ms[0],
                         "launches_per_step": {n: c / runs for n, c in
                                               counts.items()},
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "peak_reserved_gib":
                             torch.cuda.max_memory_reserved() / 2**30})
    same = all(torch.equal(a, b) for i in range(1, 4)
               for a, b in zip(outs[i], outs[0]))
    peaks = {way: [(round(x["peak_gib"], 2), round(x["peak_reserved_gib"], 2))
                   for x in rec[way]] for way in rec}
    log("ti", f"TI step, graph vs eager in turns: bit for bit {same} "
              f"(losses, the vectors' gradient, the vectors after AdamW); "
              f"ms a step graph {[round(x['ms'], 2) for x in rec['graph']]} "
              f"vs eager {[round(x['ms'], 2) for x in rec['eager']]} (a "
              f"graph run's first step "
              f"{[round(x['first_ms'], 1) for x in rec['graph']]}); launches "
              f"a step {json.dumps(rec['graph'][0]['launches_per_step'])} vs "
              f"{json.dumps(rec['eager'][0]['launches_per_step'])}; peak "
              f"allocated / reserved GiB graph {peaks['graph']} vs eager "
              f"{peaks['eager']}")
    want = {n: float(c) for n, c in TRAIN_LAUNCHES.items() if c}
    if not same or any(x["launches_per_step"] != want
                       for way in rec for x in rec[way]):
        raise RuntimeError("ti: the TI step's graph does not give its eager "
                           "bits or launches")
    return rec, total


def graphed_unet_calls(calls, rec):
    """UNet calls a hook counts over a window of captured generation: the
    warm-up and the capture run the Python (``calls`` each), replays do
    not."""
    return 2 * calls * rec["captures"]


def graphed_launches(calls, runs, rec):
    """Packed flash launches over a window of ``runs`` captured generation
    calls of ``calls`` UNet calls each: the replays' and the warm-ups'."""
    return {"flash_attention_nhd": ATTN_PER_UNET * calls
            * (runs + rec["captures"])}


# -- phase 13 -----------------------------------------------------------------

def openai_clip_from_hf(hf):
    """A HuggingFace ``CLIPModel`` state dict -> the same weights in OpenAI
    CLIP's layout (``visual.*``, fused ``in_proj``, projections as
    ``x @ proj`` matrices)."""
    out = {"logit_scale": hf["logit_scale"],
           "visual.conv1.weight": hf["vision_model.embeddings."
                                     "patch_embedding.weight"],
           "visual.class_embedding": hf["vision_model.embeddings."
                                        "class_embedding"],
           "visual.positional_embedding": hf["vision_model.embeddings."
                                             "position_embedding.weight"],
           "visual.proj": hf["visual_projection.weight"].T.contiguous(),
           "token_embedding.weight": hf["text_model.embeddings."
                                        "token_embedding.weight"],
           "positional_embedding": hf["text_model.embeddings."
                                      "position_embedding.weight"],
           "text_projection": hf["text_projection.weight"].T.contiguous()}
    for dst, src in (("visual.ln_pre", "vision_model.pre_layrnorm"),
                     ("visual.ln_post", "vision_model.post_layernorm"),
                     ("ln_final", "text_model.final_layer_norm")):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = hf[f"{src}.{leaf}"]
    for tower, dst in (("vision_model", "visual.transformer"),
                       ("text_model", "transformer")):
        i = 0
        while f"{tower}.encoder.layers.{i}.layer_norm1.weight" in hf:
            s, d = f"{tower}.encoder.layers.{i}.", f"{dst}.resblocks.{i}."
            for leaf in ("weight", "bias"):
                out[f"{d}attn.in_proj_{leaf}"] = torch.cat(
                    [hf[f"{s}self_attn.{p}_proj.{leaf}"] for p in "qkv"])
                for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                             ("attn.out_proj", "self_attn.out_proj"),
                             ("mlp.c_fc", "mlp.fc1"),
                             ("mlp.c_proj", "mlp.fc2")):
                    out[f"{d}{a}.{leaf}"] = hf[f"{s}{b}.{leaf}"]
            i += 1
    return out


def scorer_files(work):
    """Synthetic CLIP ViT-B/32 (OpenAI layout), sphere20 and FID Inception
    files with every key and shape of their manifests, values from a seed
    (``synthetic_value``; the Inception's conv weights He-scaled, so that
    pool3 does not fade through 94 ReLU layers).  The OpenAI-layout reader
    must give the HuggingFace reader's tensors exactly.  -> paths."""
    from celebbasis_tpu_torch.models.clip_vit import (CLIPVisionConfig,
                                                      convert_hf_clip,
                                                      convert_openai_clip,
                                                      text_config_b32)
    gen = torch.Generator(device="cuda").manual_seed(99)
    paths = {}
    for name, manifest, file in (
            ("clip", CLIP_MANIFEST, "ViT-B-32.pt"),
            ("sphere", SPHERE_MANIFEST, "sphere20.pth"),
            ("inception", INCEPTION_MANIFEST, "pt_inception.pth")):
        with open(manifest) as f:
            keys = json.load(f)["keys"]
        state = {k: synthetic_value(k, tuple(shape), gen)
                 for k, shape in keys.items()}
        if name == "inception":
            state = {k: v * 2 ** 0.5 if k.endswith("conv.weight") else v
                     for k, v in state.items()}
        if name == "clip":
            vcfg, tcfg = CLIPVisionConfig.vit_b32(), text_config_b32()
            ref = convert_hf_clip(state, vcfg, tcfg)
            state = openai_clip_from_hf(state)
            got = convert_openai_clip(state, vcfg, tcfg)
            if not all(sorted(g) == sorted(r) and all(
                    torch.equal(g[k], r[k]) for k in r)
                    for g, r in zip(got, ref)):
                raise RuntimeError("evaluate: the OpenAI and HF CLIP readers "
                                   "disagree")
        paths[name] = os.path.join(work, file)
        torch.save(state, paths[name])
    return paths


class ForwardProbe:
    """While entered, records for each forward of the given module classes
    its class name and whether TF32 was allowed (cuDNN, matmul)."""

    def __init__(self, *classes):
        self.classes, self.calls = classes, []

    def __enter__(self):
        self.saved = {cls: cls.forward for cls in self.classes}
        for cls in self.classes:
            def forward(module, *args, _real=cls.forward, _name=cls.__name__,
                        **kw):
                self.calls.append((_name, torch.backends.cudnn.allow_tf32,
                                   torch.backends.cuda.matmul.allow_tf32))
                return _real(module, *args, **kw)
            cls.forward = forward
        return self

    def __exit__(self, *exc):
        for cls, fwd in self.saved.items():
            cls.forward = fwd


class MethodCalls:
    """While entered, counts the calls of ``cls.<name>`` (``n``)."""

    def __init__(self, cls, name):
        self.cls, self.name, self.n = cls, name, 0

    def __enter__(self):
        self.saved = getattr(self.cls, self.name)

        def method(obj, *args, **kw):
            self.n += 1
            return self.saved(obj, *args, **kw)
        setattr(self.cls, self.name, method)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.saved)


def vit_launches(probe, image_calls):
    """The ViT's packed launches over a window of captured image features:
    each call replays (12), each capture's warm-up launches too; the probe
    sees a forward's Python twice a capture (warm-up and capture)."""
    forwards = sum(1 for c in probe.calls if c[0] == "CLIPVisionEncoder")
    if forwards % 2:
        raise RuntimeError(f"evaluate: {forwards} ViT forwards ran their "
                           f"Python: not two a capture")
    return VIT_LAYERS * (image_calls + forwards // 2)


def scorer_turns(files, imgs):
    """Each scorer forward of an evaluation at the shapes the smoke's
    evaluation gives it, on its graph and eagerly in turns
    (``graph_turns``; fresh scorers, cuDNN's deterministic algorithms, TF32
    off): the ViT at the generated batch and at one source image, the text
    tower on a prompt, the identity scorer's warp and sphere20 on the
    source and the samples, Inception at the flat folder's batch and the
    sources'.  -> {name: record}."""
    from celebbasis_tpu_torch.cli import eval_imgs
    from celebbasis_tpu_torch.eval.inception import load_inception, preprocess
    from celebbasis_tpu_torch.models.clip_vit import preprocess_images

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        idclip, clip_eval = eval_imgs.build_scorers(files["clip"],
                                                    files["sphere"])
        feat_fn, _ = load_inception(files["inception"], device="cuda")
        r = np.random.default_rng(5)
        u8 = lambda n: r.integers(0, 256, (n, 512, 512, 3), dtype=np.uint8)
        vit_in = torch.from_numpy(preprocess_images(
            imgs, clip_eval.size)).cuda()
        toks = torch.from_numpy(np.asarray(clip_eval.tokenizer(
            ["a photo of person"]), np.int64)).cuda()
        crops = torch.from_numpy(r.uniform(-1, 1, (1 + EVAL_SAMPLES, 512, 512,
                                                   3)).astype(np.float32))
        cases = {
            f"vit_b{len(imgs)}": (clip_eval._vision, vit_in),
            "vit_b1": (clip_eval._vision, vit_in[:1].clone()),
            "text_b1": (clip_eval._text, toks),
            f"sphere_b{1 + EVAL_SAMPLES}": (idclip.id._embed, crops.cuda()),
            "inception_b8": (feat_fn.captured,
                             preprocess(u8(8), device="cuda")),
            "inception_b2": (feat_fn.captured,
                             preprocess(u8(2), device="cuda"))}
        with torch.inference_mode(), no_tf32():
            for name, (fn, x) in cases.items():
                out[name] = graph_turns("evaluate", f"scorer {name}",
                                        lambda: [fn(x)],
                                        lambda: [fn.eager(x)], fn)
    finally:
        torch.backends.cudnn.deterministic = saved
    want = {"flash_attention_nhd": float(VIT_LAYERS)}
    if any(rec["launches_per_unit"] != (want if name.startswith("vit")
                                        else {})
           for name, rec in out.items()):
        raise RuntimeError(f"evaluate: scorer launches "
                           f"{ {n: r['launches_per_unit'] for n, r in out.items()} }")
    return out


def eager_evaluation(gen, files, scores):
    """``cli/eval_imgs.py --fid`` once more with every captured forward run
    as it is (``graphs.Captured`` patched to call ``eager``, for this run
    only): the wall an evaluation's graphs save, and whether the scores
    are the graphs' bits.  -> a record."""
    from celebbasis_tpu_torch.cli import eval_imgs

    real = graphs.Captured.__call__
    graphs.Captured.__call__ = lambda self, *args: self.eager(*args)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = eval_imgs.main([
            "--eval_folder", gen, "--clip_ckpt", files["clip"],
            "--sphere_ckpt", files["sphere"], "--fid", "--inception_ckpt",
            files["inception"], "--out", os.path.join(gen, "eager.json")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        graphs.Captured.__call__ = real
    rec = {"eager_scoring_s": wall, "eager_scores_equal": eager == scores}
    log("evaluate", f"eval_imgs with its forwards uncaptured: {wall:.1f} s; "
                    f"scores equal to the graphs' {rec['eager_scores_equal']}"
                    f" ({json.dumps(eager)})")
    return rec


def phase_evaluate(work, ckpt, align_files):
    """W4 at full width: ``cli/gen_imgs.py`` (512x512, EVAL_IDS identities
    x two prompts x EVAL_SAMPLES samples, DDIM_STEPS steps, output convs
    drawn) on the CLI training run's checkpoint, then ``cli/eval_imgs.py
    --fid --inception_ckpt`` with synthetic ViT-B/32, sphere20 and FID
    Inception files, fp32, TF32 allowed before the call: every score
    finite, cosines in [-1, 1], every scorer forward run with TF32 off and
    the setting restored after, the ViT's flash launches 12 a forward; the
    ViT's image features on the kernel route against the plain route.
    -> a record."""
    from celebbasis_tpu_torch.cli import eval_imgs, gen_imgs
    from celebbasis_tpu_torch.eval.evaluators import (CLIPEvaluator,
                                                      GeneratedEvalFolder)
    from celebbasis_tpu_torch.eval.inception import InceptionV3
    from celebbasis_tpu_torch.eval.sphere import SphereNet
    from celebbasis_tpu_torch.models.clip_vit import (CLIPTextTower,
                                                      CLIPVisionEncoder)

    config = os.path.join(REPO, "configs", "aigc_id.yaml")
    src = os.path.join(work, "eval_src")
    write_pngs(src, [f"face_id{j}_#0.png" for j in range(EVAL_IDS)], 61)
    prompts = os.path.join(work, "eval_two.txt")   # action-two templates
    with open(prompts, "w") as f:
        f.write("a photo of sks person\n"
                "a photo of sks person and ks person\n")
    gen = os.path.join(work, "eval_gen")
    items = EVAL_IDS * 2
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with DrawnAssemblies() as ctx:
            made, gen_rec = measured("gen_imgs", ctx, lambda: gen_imgs.main([
                "--config", config, "--embedding_path", ckpt, "--from-file",
                prompts, "--outdir", gen, "--ids",
                *map(str, range(EVAL_IDS)), "--src_folder", src,
                "--n_samples", str(EVAL_SAMPLES), "--ddim_steps",
                str(DDIM_STEPS), "--H", "512"]), phase="evaluate")
    finally:
        os.chdir(cwd)
    if made != items * EVAL_SAMPLES or gen_rec["captures"] != 1 \
            or gen_rec["unet_calls"] != graphed_unet_calls(DDIM_STEPS,
                                                           gen_rec) \
            or gen_rec["launches"] != graphed_launches(DDIM_STEPS, items,
                                                       gen_rec):
        raise RuntimeError(f"evaluate: gen_imgs made {made} images, "
                           f"{gen_rec['unet_calls']} UNet calls, launched "
                           f"{gen_rec['launches']}")

    t0 = time.perf_counter()
    files = scorer_files(work)
    files_s = time.perf_counter() - t0
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with ForwardProbe(CLIPVisionEncoder, CLIPTextTower, SphereNet,
                          InceptionV3) as probe, \
                MethodCalls(CLIPEvaluator, "image_features") as image_calls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_count()
            t0 = time.perf_counter()
            scores = eval_imgs.main([
                "--eval_folder", gen, "--clip_ckpt", files["clip"],
                "--sphere_ckpt", files["sphere"], "--fid",
                "--inception_ckpt", files["inception"]])
            torch.cuda.synchronize()
            scoring_s = time.perf_counter() - t0
            launches = {n: c for n, c in fa.launch_counts().items() if c}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    forwards = {}
    for name, *_ in probe.calls:
        forwards[name] = forwards.get(name, 0) + 1
    tf32_on = [c for c in probe.calls if c[1] or c[2]]
    vit = vit_launches(probe, image_calls.n)
    rec = {"gen_imgs": gen_rec, "files_s": files_s, "scoring_s": scoring_s,
           "scores": scores, "forwards": forwards,
           "image_feature_calls": image_calls.n,
           "vit_launches": vit, "launches": launches,
           "peak_gib": peak}
    log("evaluate", f"eval_imgs at full width (ViT-B/32, sphere20, "
                    f"Inception-v3; fp32): {scoring_s:.1f} s (scorer files "
                    f"made in {files_s:.1f} s); scores {json.dumps(scores)}; "
                    f"forwards run in Python (a graph's warm-up and capture) "
                    f"{json.dumps(forwards)}, {len(tf32_on)} with "
                    f"TF32 on, TF32 after {after}; flash launches "
                    f"{json.dumps(launches)}; peak memory {peak:.2f} GiB")
    if set(scores) != SCORE_KEYS or not all(
            np.isfinite(v) for v in scores.values()) or not all(
            -1.0 <= scores[k] <= 1.0
            for k in ("image_sim", "text_sim", "id_cos_sim")):
        raise RuntimeError(f"evaluate: scores {scores}")
    if tf32_on or after != (True, True) or set(forwards) != {
            "CLIPVisionEncoder", "CLIPTextTower", "SphereNet",
            "InceptionV3"}:
        raise RuntimeError(f"evaluate: TF32 on in {tf32_on}, after {after}, "
                           f"forwards {forwards}")
    if launches != {"flash_attention_nhd": vit}:
        raise RuntimeError(f"evaluate: launched {launches}; expected "
                           f"{vit} for the ViT's {image_calls.n} replays and "
                           f"its captures' warm-ups")

    # the ViT's features: kernel route against plain route, fp32
    _, clip_eval = eval_imgs.build_scorers(files["clip"], files["sphere"])
    _, _, imgs = GeneratedEvalFolder(gen)[items - 1]
    with no_tf32():
        fa.reset_launch_count()
        f_k = clip_eval.image_features(imgs)
        n_k = fa.launch_count("flash_attention_nhd")
        attn_ops.set_default_impl("xla")
        try:
            f_p = clip_eval.image_features(imgs)
        finally:
            attn_ops.set_default_impl(None)
    rel = float(np.abs(f_k - f_p).max() / np.abs(f_p).max())
    rec["vit_route_rel_err"] = rel
    log("evaluate", f"ViT-B/32 image features of {len(imgs)} images, kernel "
                    f"route ({n_k} launches: the capture's warm-up and the "
                    f"replay) vs plain route: max |diff| / max |feature| "
                    f"{rel:.3e} (limit {VIT_REL_TOL:g})")
    if n_k != 2 * VIT_LAYERS or not rel <= VIT_REL_TOL:
        raise RuntimeError(f"evaluate: the ViT's kernel route differs by "
                           f"{rel:.3e} ({n_k} launches)")

    rec["scorer_turns"] = scorer_turns(files, imgs)
    rec.update(eager_evaluation(gen, files, scores))

    # identity scored on crops: the align phase's nets as the cropper
    with ForwardProbe(CLIPVisionEncoder) as probe, \
            MethodCalls(CLIPEvaluator, "image_features") as image_calls:
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cropped = eval_imgs.main([
            "--eval_folder", gen, "--clip_ckpt", files["clip"],
            "--sphere_ckpt", files["sphere"], "--detector_ckpt",
            align_files["fb"], "--pipnet_ckpt", align_files["pip"],
            "--meanface", align_files["meanface"], "--out",
            os.path.join(work, "scores_cropped.json")])
        torch.cuda.synchronize()
        cropped_s = time.perf_counter() - t0
        launches = {**fa.launch_counts(), **geglu.launch_counts(),
                    **quant.launch_counts()}
    vit = vit_launches(probe, image_calls.n)
    # each item scores its source and its samples; the first image of an
    # item counts as a face whether or not one is found
    faces_in_gen = cropped["num_has_face"] - cropped["n_items"]
    rec.update({"cropped_scoring_s": cropped_s, "cropped_scores": cropped,
                "cropped_launches": launches})
    log("evaluate", f"eval_imgs with the FaceBoxes + PIPNet cropper: "
                    f"{cropped_s:.1f} s; faces found in {faces_in_gen} "
                    f"of the {items * EVAL_SAMPLES} generated images "
                    f"(has_face {cropped['num_has_face']}, no_face "
                    f"{cropped['num_no_face']}); scores "
                    f"{json.dumps(cropped)}; launches {json.dumps(launches)}")
    if set(cropped) != SCORE_KEYS - {"fid"} or not all(
            np.isfinite(v) for v in cropped.values()):
        raise RuntimeError(f"evaluate: cropped scores {cropped}")
    if {k: c for k, c in launches.items() if c} != {
            "flash_attention_nhd": vit}:
        raise RuntimeError(f"evaluate: the cropped run launched {launches}; "
                           f"the ViT's {image_calls.n} replays and its "
                           f"captures' warm-ups alone account for {vit}")
    return rec


# -----------------------------------------------------------------------------

def graph_summary(request_ms, train_ms, ti):
    """Medians of each path's ms on its graph and eagerly, from the serve,
    train and ti phases' turns."""
    med = lambda xs: round(float(np.median(xs)), 2)
    serve = request_ms["graph_vs_eager"]
    out = {f"{route}_{way}": med(serve[way][f"{route}_ms"])
           for route in ("txt2img", "faces2img") for way in ("graph", "eager")}
    for kind, rec in train_ms["graph_vs_eager"].items():
        for way in ("graph", "eager"):
            out[f"{kind}_step_{way}"] = med([r["ms"] for r in rec[way]])
    for way in ("graph", "eager"):
        out[f"ti_step_{way}"] = med([r["ms"] for r in
                                     ti["graph_vs_eager"][way]])
    return out


# -- phase 14 -----------------------------------------------------------------

class LegacyRuns:
    """While entered, every ``legacy.prepare`` (the one the legacy CLIs call)
    draws the UNet's zero-initialised output convs too (its random weights
    otherwise predict eps = 0) and counts the UNet's calls; the models it
    prepares and the sample functions they make are kept (``models``,
    ``samplers``); ``calls`` and ``assemble_s`` add up over the window."""

    def __enter__(self):
        import functools

        from celebbasis_tpu_torch import legacy
        self.calls, self.assemble_s = 0, 0.0
        self.models, self.samplers = [], []
        self._legacy = legacy
        self._saved = (legacy.init_weights, legacy.prepare,
                       legacy.LegacyLDM.make_sample_fn)
        real_init, real_prepare, real_make = self._saved
        legacy.init_weights = functools.partial(real_init, zero_convs=False)

        def prepare(*args, **kw):
            t0 = time.perf_counter()
            ldm = real_prepare(*args, **kw)
            ldm.unet.register_forward_pre_hook(self._count)
            self.models.append(ldm)
            self.assemble_s += time.perf_counter() - t0
            return ldm

        def make_sample_fn(ldm, *args, **kw):
            fn = real_make(ldm, *args, **kw)
            self.samplers.append(fn)
            return fn

        legacy.prepare = prepare
        legacy.LegacyLDM.make_sample_fn = make_sample_fn
        return self

    def _count(self, module, args):
        self.calls += 1

    def __exit__(self, *exc):
        legacy = self._legacy
        (legacy.init_weights, legacy.prepare,
         legacy.LegacyLDM.make_sample_fn) = self._saved


def legacy_gens(seed, n):
    from celebbasis_tpu_torch.diffusion.sampler import sample_seed
    return [torch.Generator(device="cuda").manual_seed(sample_seed(seed, j))
            for j in range(n)]


def legacy_unet_probe(ldm, x, ctx):
    """One UNet forward on (x, ctx) at t = 500: -> (its flash launches,
    device ms per forward on a replayed graph)."""
    t = torch.full((x.shape[0],), 500, device="cuda")
    with torch.inference_mode():
        fa.reset_launch_count()
        ldm.unet(x, t, ctx)
        torch.cuda.synchronize()
        launches = {n: c for n, c in fa.launch_counts().items() if c}
        ms = time_ms(lambda: ldm.unet(x, t, ctx), 5)[0]
    return launches, ms


def legacy_chain(name, rec, fn, cond, per_replay):
    """The CLI's sample function after its run: one replay's launches are
    ``per_replay``, the window held one capture of the chain (and the
    scorers' graphs, where it scored) and its launches were
    ``per_replay`` for the warm-up and for the replay, the UNet hook saw
    the warm-up's and the capture's calls; a replay and the same function
    uncaptured give the same bits.  -> the replayed images."""
    got = fn.captured.launches_per_replay()
    chains = len(fn.captured.capture_s)     # the scorers capture their own
    if chains != 1 or got != per_replay or rec["unet_calls"] \
            != graphed_unet_calls(LEGACY_STEPS, {"captures": chains}):
        raise RuntimeError(f"legacy: {name} captured {chains} chain "
                           f"graphs, {got} launches a replay (expected "
                           f"{per_replay}), {rec['unet_calls']} UNet calls")
    for entry, n in per_replay.items():
        if rec["launches"].get(entry, 0) < 2 * n:
            raise RuntimeError(f"legacy: {name} launched {rec['launches']}")
    replay = fn(cond, LEGACY_SAMPLES, legacy_gens(7, LEGACY_SAMPLES))
    eager = fn.eager(cond, LEGACY_SAMPLES, legacy_gens(7, LEGACY_SAMPLES))
    torch.cuda.synchronize()
    rec["graph_equals_eager"] = bool(torch.equal(replay, eager))
    log("legacy", f"{name}: {LEGACY_STEPS}-step chain on its graph and "
                  f"eagerly: bits equal {rec['graph_equals_eager']}")
    if not rec["graph_equals_eager"]:
        raise RuntimeError(f"legacy: {name}'s captured chain differs from "
                           f"the eager chain")
    return replay


def check_attention_block(block, side, batch=2):
    """One AttentionBlock of a UNet, copied to fp32, on the card (the
    per-head kernel entry) against the reference's arithmetic written out
    (openaimodel.py's QKVAttentionLegacy on the 1x1 projection's (B, 3C, T)
    output: reshaped to (B * heads, 3 dh, T) and split into q, k, v along
    the channels), TF32 off: within 1e-4 of the largest entry of the
    attention branch.  A wrong split of the interleaved channels keeps every
    shape; this check does not share the block's code for it.  -> a
    record."""
    import copy
    blk = copy.deepcopy(block).float()
    for m in blk.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    C, heads = blk.qkv.in_features, blk.heads
    dh, T = C // heads, side * side
    g = torch.Generator(device="cuda").manual_seed(C + side)
    x = torch.randn(batch, side, side, C, device="cuda",
                    generator=g).permute(0, 3, 1, 2)
    with no_tf32(), torch.inference_mode():
        before = fa.launch_count("flash_attention")
        got = blk(x) - x
        launched = fa.launch_count("flash_attention") - before
        h = blk.norm(x).permute(0, 2, 3, 1).reshape(batch, T, C)
        qkv = (h @ blk.qkv.weight.t() + blk.qkv.bias).transpose(1, 2)
        q, k, v = qkv.reshape(batch * heads, 3 * dh, T).split(dh, dim=1)
        s = dh ** -0.25
        w = torch.einsum("bct,bcs->bts", q * s, k * s).softmax(-1)
        a = torch.einsum("bts,bcs->bct", w, v).reshape(batch, C, T)
        ref = (a.transpose(1, 2) @ blk.proj_out.weight.t()
               + blk.proj_out.bias)
        ref = ref.reshape(batch, side, side, C).permute(0, 3, 1, 2)
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    rec = {"C": C, "heads": heads, "tokens": T, "rel_err": err,
           "launches": launched}
    log("legacy", f"AttentionBlock {C} channels, {heads} heads of {dh}, "
                  f"{T} tokens, fp32: relative error {err:.2e} against the "
                  f"reference's arithmetic ({launched} launch)")
    if launched != 1 or not err <= 1e-4:
        raise RuntimeError(f"legacy: AttentionBlock disagrees with the "
                           f"reference's arithmetic: {rec}")
    return rec


def celebahq_attention_blocks(ldm):
    """(block, latent side) of each attention level of the CelebA-HQ
    UNet: 32^2, 16^2 and the 8^2 mid block."""
    u = ldm.unet
    return [(u.down_1_attn_0, 32), (u.down_2_attn_0, 16), (u.mid_attn, 8)]


def vq_flips(ldm, images_u8):
    """The VQ quantizer on the card against the same quantizer on the CPU,
    on the pre-quant latents of `images_u8`: -> (rows, rows whose index
    differs, all of them near-ties)."""
    import copy
    with torch.inference_mode():
        x = torch.from_numpy(images_u8).cuda().float() / 127.5 - 1.0
        h = ldm.first_stage.encode(x)
        idx_card = ldm.first_stage.quantize(h)[2].reshape(-1).cpu()
        quant = copy.deepcopy(ldm.first_stage.quantize).cpu()
        d = quant.distances(h.cpu())
    idx_cpu = d.argmin(1)
    rows = torch.nonzero(idx_card != idx_cpu).flatten()
    gap = (d[rows, idx_card[rows]] - d[rows, idx_cpu[rows]]).abs()
    ties = bool((gap <= VQ_TIE_REL * d[rows].abs().amax(1)).all())
    return len(idx_cpu), len(rows), ties


def legacy_route_parity():
    """The tiny legacy configs in fp32 (``configs/tiny_legacy.yaml``: VQ
    first stage, AttentionBlocks of head dim 8 on the per-head entry;
    ``tiny_legacy_bert.yaml``: BERT on the packed entry, CFG 5), 3 DDIM
    steps, kernel route against plain route as ``check_generation_parity``
    holds txt2img: float images within 1e-3, pixels within one level.  The
    VQ config decodes without quantizing, so that a flipped code index
    does not stand for the attention routes' difference."""
    import yaml

    from celebbasis_tpu_torch import legacy
    from celebbasis_tpu_torch.pipeline import finish_images

    out = {}
    for name, scale in (("tiny_legacy", 1.0),
                        ("tiny_legacy_bert", LEGACY_SCALE)):
        with open(os.path.join(REPO, "configs", f"{name}.yaml")) as f:
            cfg = yaml.safe_load(f)
        with LegacyRuns():
            ldm = legacy.prepare(cfg, seed=3, device="cuda",
                                 precision="fp32")
        fn = ldm.make_sample_fn(num_steps=3, guidance_scale=scale,
                                force_not_quantize=True)
        cond = None if ldm.cond_kind == "uncond" else \
            ["a painting of a dog", "a photo of a cat"]
        x_T = torch.randn(2, ldm.image_size, ldm.image_size, ldm.channels,
                          device="cuda",
                          generator=torch.Generator("cuda").manual_seed(4))
        img_k, n_k, img_p, n_p = kernel_vs_plain(
            lambda: fn(cond, 2, None, x_T=x_T))
        dfloat = (img_k - img_p).abs().max().item()
        dpix = (finish_images(img_k, "uint8").int()
                - finish_images(img_p, "uint8").int()).abs().max().item()
        out[name] = {"kernel_launches": n_k, "plain_launches": n_p,
                     "max_float_diff": dfloat, "max_pixel_diff": dpix}
        log("legacy", f"{name} fp32, 3 steps: kernel route launches {n_k} "
                      f"(plain route {n_p}), max |float diff| {dfloat:.3e}, "
                      f"max pixel diff {dpix} levels, image std "
                      f"{img_k.std().item():.3f}")
        if not torch.isfinite(img_k).all() or img_k.std().item() < 1e-3:
            raise RuntimeError(f"legacy: the {name} image is not finite or "
                               f"is constant")
        if n_k == 0 or n_p != 0:
            raise RuntimeError(f"legacy: {name}'s routes did not go where "
                               f"they should ({n_k} / {n_p})")
        if dfloat > 1e-3 or dpix > 1:
            raise RuntimeError(f"legacy: {name}'s routes differ by "
                               f"{dfloat:.3e} (> 1e-3) or {dpix} levels (> 1)")
    return out


def legacy_evaluate_model(work):
    """``cli/evaluate_model.py`` on txt2img-1p4B-eval.yaml (module
    docstring, phase 14).  -> its record."""
    from celebbasis_tpu_torch.cli import evaluate_model
    from celebbasis_tpu_torch.pipeline import finish_images
    from celebbasis_tpu_torch.text.bert_tokenizer import \
        default_bert_tokenizer

    data = os.path.join(work, "legacy_subject")
    write_pngs(data, ["s0.png", "s1.png"], 71)
    emb = os.path.join(work, "legacy_ti.pt")
    star = default_bert_tokenizer().tokenize("*")[0]
    vec = torch.randn(1, 1280, generator=torch.Generator().manual_seed(8))
    torch.save({"string_to_token": {"*": torch.tensor(star)},
                "string_to_param": {"*": vec}}, emb)
    prompt = "a painting of a * monster playing guitar"
    out = os.path.join(work, "legacy_eval")
    with LegacyRuns() as runs:
        scores, rec = measured("evaluate_model", runs,
                               lambda: evaluate_model.main([
                                   "--config", os.path.join(
                                       LEGACY_CONFIGS,
                                       "txt2img-1p4B-eval.yaml"),
                                   "--data-dir", data, "--out-dir", out,
                                   "--embedding-path", emb, "--prompt",
                                   prompt, "--n-samples",
                                   str(LEGACY_SAMPLES), "--batch-size",
                                   str(LEGACY_SAMPLES), "--steps",
                                   str(LEGACY_STEPS), "--scale",
                                   str(LEGACY_SCALE)]), phase="legacy")
    (ldm,), fn = runs.models, runs.samplers[-1]
    folder = os.path.join(out, prompt.replace(" ", "-"))
    from PIL import Image
    pngs = np.stack([np.asarray(Image.open(os.path.join(folder,
                                                        f"{i:03}.png")))
                     for i in range(LEGACY_SAMPLES)])
    if pngs.shape != (LEGACY_SAMPLES, 256, 256, 3) \
            or min(im.std() for im in pngs) < 1.0 \
            or not all(np.isfinite(scores[k]) and -1 <= scores[k] <= 1
                       for k in ("sim_img", "sim_text")):
        raise RuntimeError(f"legacy: evaluate_model wrote {pngs.shape}, "
                           f"scores {scores}")
    chain = {"flash_attention_nhd": 2 * BERT_ATTN
             + LEGACY_STEPS * ATTN_PER_UNET}
    vit = rec["launches"].get("flash_attention_nhd", 0) \
        - 2 * chain["flash_attention_nhd"]
    if vit <= 0 or vit % VIT_LAYERS or rec["launches"].get("flash_attention"):
        raise RuntimeError(f"legacy: evaluate_model launched "
                           f"{rec['launches']}; the chain's warm-up and "
                           f"replay account for {chain} each")
    rec["vit_launches"] = vit
    replay = legacy_chain("evaluate_model", rec, fn,
                          [prompt] * LEGACY_SAMPLES, chain)
    # the CLI's images are its graph's: image j of batch 0 from
    # sample_seed(17, j), evaluate_model's default seed
    again = fn([prompt] * LEGACY_SAMPLES, LEGACY_SAMPLES,
               legacy_gens(17, LEGACY_SAMPLES))
    if not np.array_equal(finish_images(again, "uint8").cpu().numpy(),
                          pngs):
        raise RuntimeError("legacy: evaluate_model's images are not its "
                           "graph's")
    n = LEGACY_SAMPLES
    ids = ldm.conditioning_input([prompt] * n)
    with torch.inference_mode():
        fa.reset_launch_count()
        ctx = ldm.learned_conditioning(ids)
        torch.cuda.synchronize()
        rec["launches_per_bert"] = {k: c for k, c in fa.launch_counts()
                                    .items() if c}
        x = torch.randn(2 * n, 32, 32, 4, device="cuda")
        rec["launches_per_unet"], rec["unet_ms"] = legacy_unet_probe(
            ldm, x, torch.cat([ctx, ctx]))
    if rec["launches_per_bert"] != {"flash_attention_nhd": BERT_ATTN} \
            or rec["launches_per_unet"] != {
                "flash_attention_nhd": ATTN_PER_UNET}:
        raise RuntimeError(f"legacy: a BERT encode launched "
                           f"{rec['launches_per_bert']}, a UNet call "
                           f"{rec['launches_per_unet']}")
    rec.update(scores=scores, image_std=float(replay.std()))
    log("legacy", f"evaluate_model: a guided UNet forward (batch {2 * n}, "
                  f"32^2 latents, context 77x1280) {rec['unet_ms']:.3f} ms "
                  f"on the device; launches a UNet call "
                  f"{json.dumps(rec['launches_per_unet'])}, a BERT encode "
                  f"{json.dumps(rec['launches_per_bert'])}, the ViT scorer "
                  f"{vit}; scores {json.dumps(scores)}")
    del ldm, runs, fn
    return rec


def legacy_sample_diffusion(work):
    """``cli/sample_diffusion.py`` on celebahq-ldm-vq-4.yaml (module
    docstring, phase 14).  -> its record."""
    from celebbasis_tpu_torch.cli import sample_diffusion

    out = os.path.join(work, "legacy_samples")
    with LegacyRuns() as runs:
        imgs, rec = measured("sample_diffusion", runs,
                             lambda: sample_diffusion.main([
                                 "--config", os.path.join(
                                     LEGACY_CONFIGS,
                                     "celebahq-ldm-vq-4.yaml"),
                                 "--logdir", out, "-n", str(LEGACY_SAMPLES),
                                 "--batch-size", str(LEGACY_SAMPLES),
                                 "--custom-steps", str(LEGACY_STEPS)]),
                             phase="legacy")
    (ldm,), fn = runs.models, runs.samplers[-1]
    check_images("sample_diffusion", imgs, LEGACY_SAMPLES, 256)
    chain = {"flash_attention": LEGACY_STEPS * CELEBAHQ_ATTN}
    if rec["launches"] != {"flash_attention": 2 * chain["flash_attention"]}:
        raise RuntimeError(f"legacy: sample_diffusion launched "
                           f"{rec['launches']}; expected the chain's "
                           f"{chain} twice (warm-up and replay)")
    legacy_chain("sample_diffusion", rec, fn, None, chain)
    x = torch.randn(LEGACY_SAMPLES, 64, 64, 3, device="cuda")
    rec["launches_per_unet"], rec["unet_ms"] = legacy_unet_probe(ldm, x,
                                                                 None)
    if rec["launches_per_unet"] != {"flash_attention": CELEBAHQ_ATTN}:
        raise RuntimeError(f"legacy: a CelebA-HQ UNet call launched "
                           f"{rec['launches_per_unet']}")
    rec["attention_blocks"] = [check_attention_block(blk, side) for
                               blk, side in celebahq_attention_blocks(ldm)]
    rows, flips, ties = vq_flips(ldm, imgs)
    rec["vq"] = {"rows": rows, "flips": flips, "flip_share": flips / rows,
                 "all_near_ties": ties, "tie_rel": VQ_TIE_REL}
    log("legacy", f"sample_diffusion: a UNet forward (batch "
                  f"{LEGACY_SAMPLES}, 64^2x3 latents) {rec['unet_ms']:.3f} "
                  f"ms on the device; launches a UNet call "
                  f"{json.dumps(rec['launches_per_unet'])}; VQ indices on "
                  f"the card vs the CPU quantizer: {flips} of {rows} differ "
                  f"({flips / rows:.2e}), all near-ties {ties}")
    if not ties:
        raise RuntimeError("legacy: a VQ index differs from the CPU's "
                           "beyond a near-tie")
    del ldm, runs, fn
    return rec


def legacy_sample_vanilla(work):
    """``cli/sample_diffusion.py --vanilla`` on celebahq-ldm-vq-4.yaml: the
    1000-step ancestral chain (``DDPMChain``: one capture of DDPM_SEGMENT
    steps, replayed T / DDPM_SEGMENT times; #2 on the AttentionBlocks'
    views), then the VQ decode.  The CLI's pixels equal a replay's, and
    the replay the same chain run eagerly, bit for bit.  -> its record."""
    from celebbasis_tpu_torch.cli import sample_diffusion
    from celebbasis_tpu_torch.diffusion.sampler import DDPM_SEGMENT
    from celebbasis_tpu_torch.pipeline import finish_images

    n, T = LEGACY_SAMPLES, 1000
    out = os.path.join(work, "legacy_vanilla")
    with LegacyRuns() as runs:
        imgs, rec = measured("sample_diffusion_vanilla", runs,
                             lambda: sample_diffusion.main([
                                 "--config", os.path.join(
                                     LEGACY_CONFIGS,
                                     "celebahq-ldm-vq-4.yaml"),
                                 "--logdir", out, "-n", str(n),
                                 "--batch-size", str(n), "--vanilla",
                                 "--seed", "7"]), phase="legacy")
    (ldm,), fn = runs.models, runs.samplers[-1]
    check_images("sample_diffusion_vanilla", imgs, n, 256)
    per_unet = {"flash_attention": CELEBAHQ_ATTN}
    chain = fn.chains[True]
    got = (rec["captures"], rec["unet_calls"], rec["launches"],
           chain.segment.launches_per_replay())
    want = (1, 2 * DDPM_SEGMENT,
            {k: c * (T + DDPM_SEGMENT) for k, c in per_unet.items()},
            {k: c * DDPM_SEGMENT for k, c in per_unet.items()})
    if got != want:
        raise RuntimeError(f"legacy: sample_diffusion --vanilla (captures, "
                           f"UNet calls, launches, launches a replay) {got}, "
                           f"expected {want}")
    torch.cuda.synchronize()
    fa.reset_launch_count()
    t0 = time.perf_counter()
    replay = fn(None, n, legacy_gens(7, n))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    replay_launches = flash_counts()
    fa.reset_launch_count()
    eager = fn.eager(None, n, legacy_gens(7, n))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rec.update(
        replay_ms=(t1 - t0) * 1e3, eager_ms=(t2 - t1) * 1e3,
        replay_launches=replay_launches, eager_launches=flash_counts(),
        capture_s=sum(chain.segment.capture_s.values()),
        cli_is_replay=bool(np.array_equal(
            finish_images(replay, "uint8").cpu().numpy(), imgs)),
        graph_equals_eager=bool(torch.equal(replay, eager)))
    log("legacy", f"sample_diffusion --vanilla: {T} steps, chain and decode "
                  f"on the segment graph {rec['replay_ms']:.0f} ms (capture "
                  f"{rec['capture_s']:.2f} s) vs eager "
                  f"{rec['eager_ms']:.0f} ms; the CLI's images a replay's "
                  f"{rec['cli_is_replay']}, graph bits = eager bits "
                  f"{rec['graph_equals_eager']}; eager launches "
                  f"{json.dumps(rec['eager_launches'])}")
    chain_launches = {k: c * T for k, c in per_unet.items()}
    if not (rec["cli_is_replay"] and rec["graph_equals_eager"]) \
            or rec["eager_launches"] != chain_launches \
            or rec["replay_launches"] != chain_launches:
        raise RuntimeError(f"legacy: sample_diffusion --vanilla {rec}")
    # the CLI's, the replay's and the eager chain's, for the kernels line
    rec["launches"] = {k: c + rec["replay_launches"][k]
                       + rec["eager_launches"][k]
                       for k, c in rec["launches"].items()}
    del ldm, runs, fn
    return rec


def legacy_inpaint(work):
    """``cli/inpaint.py`` at the tiny concat configuration (module
    docstring, phase 14).  -> its record."""
    import yaml

    from celebbasis_tpu_torch.cli import inpaint
    from celebbasis_tpu_torch.pipeline import finish_images

    z = 3
    cfg = {"model": {"params": {
        "linear_start": 0.0015, "linear_end": 0.0195, "timesteps": 16,
        "image_size": 16, "channels": z, "concat_mode": True,
        "cond_stage_config": "__is_first_stage__",
        "unet_config": {"params": {
            "in_channels": 2 * z + 1, "out_channels": z,
            "model_channels": 32, "attention_resolutions": [],
            "num_res_blocks": 1, "channel_mult": [1, 2],
            "num_head_channels": 8}},
        "first_stage_config": {
            "target": "ldm.models.autoencoder.VQModelInterface",
            "params": {"embed_dim": z, "n_embed": 32, "ddconfig": {
                "double_z": False, "z_channels": z, "resolution": 32,
                "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                "num_res_blocks": 1, "attn_resolutions": [],
                "attn_type": "none"}}}}}}
    config = os.path.join(work, "inpaint_tiny.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    indir = os.path.join(work, "legacy_inpaint_in")
    from celebbasis_tpu_torch.cli.serve import encode_png
    os.makedirs(indir, exist_ok=True)
    photo = face_crops(32, 91, k=1)[0]
    mask = np.zeros((32, 32, 3), np.uint8)
    mask[8:24, 4:28] = 255
    for name, img in (("a.png", photo), ("a_mask.png", mask)):
        with open(os.path.join(indir, name), "wb") as f:
            f.write(encode_png(img))
    with LegacyRuns() as runs:
        (got,), rec = measured("inpaint", runs, lambda: inpaint.main([
            "--indir", indir, "--outdir", os.path.join(work, "legacy_inp"),
            "--config", config, "--steps", str(LEGACY_STEPS)]),
            phase="legacy")
    (ldm,) = runs.models
    batch = {k: torch.from_numpy(v).cuda() for k, v in inpaint.make_batch(
        os.path.join(indir, "a.png"), os.path.join(indir, "a_mask.png"))
        .items()}
    src = finish_images(batch["image"], "uint8")[0].cpu().numpy()
    keep = mask[..., 0] == 0
    fn = inpaint.make_inpaint_fn(ldm, steps=LEGACY_STEPS)
    args = (batch["image"], batch["mask"], batch["masked_image"])
    replay = fn(*args, legacy_gens(42, 1))
    eager = fn.eager(*args, legacy_gens(42, 1))
    rec.update(
        unmasked_equal=bool(np.array_equal(got[keep], src[keep])),
        masked_changed=bool((got[~keep] != src[~keep]).any()),
        cli_is_replay=bool(np.array_equal(replay[0].cpu().numpy(), got)),
        graph_equals_eager=bool(torch.equal(replay, eager)))
    log("legacy", f"inpaint: unmasked pixels bit for bit "
                  f"{rec['unmasked_equal']}, masked pixels generated "
                  f"{rec['masked_changed']}, the CLI's image a replay's "
                  f"{rec['cli_is_replay']}, graph bits = eager bits "
                  f"{rec['graph_equals_eager']}")
    # the mid block's AttentionBlock (8 heads of 8) is the UNet's only
    # attention: one per-head launch a call, for the warm-up and the replay
    if not all(rec[k] for k in ("unmasked_equal", "masked_changed",
                                "cli_is_replay", "graph_equals_eager")) \
            or rec["captures"] != 1 \
            or rec["launches"] != {"flash_attention": 2 * LEGACY_STEPS}:
        raise RuntimeError(f"legacy: inpaint {rec}")
    return rec


def legacy_summary(legacy):
    """The legacy phase's walls, device ms per UNet forward and peaks."""
    out = {"phase_s": round(legacy["phase_wall_s"], 1)}
    for name in ("evaluate_model", "sample_diffusion",
                 "sample_diffusion_vanilla", "inpaint"):
        rec = legacy[name]
        out[name] = {k: round(rec[k], 3) for k in (
            "wall_ms", "unet_ms", "peak_gib", "replay_ms", "eager_ms",
            "capture_s") if k in rec}
    out["vq_flip_share"] = legacy["sample_diffusion"]["vq"]["flip_share"]
    return out


def phase_legacy(work):
    """The legacy family at full width (module docstring, phase 14)."""
    import gc
    t0 = time.perf_counter()
    out = {"route_parity": legacy_route_parity()}
    for name, run in (("evaluate_model", legacy_evaluate_model),
                      ("sample_diffusion", legacy_sample_diffusion),
                      ("sample_diffusion_vanilla", legacy_sample_vanilla),
                      ("inpaint", legacy_inpaint)):
        gc.collect()                  # the last run's model and graphs
        torch.cuda.empty_cache()
        out[name] = run(work)
    out["phase_wall_s"] = time.perf_counter() - t0
    log("legacy", f"phase {out['phase_wall_s']:.1f} s")
    return out


# -- phase 15 -----------------------------------------------------------------

class DrawnOutputConvs:
    """While entered, ``init_weights`` as the module ``module`` (a trainer
    CLI) calls it draws the zero-initialised output convs too: a random UNet
    with zero output convs predicts eps = 0, and its attention then gets no
    gradient in the backward."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        import functools
        self.saved = self.module.init_weights
        self.module.init_weights = functools.partial(self.saved,
                                                     zero_convs=False)
        return self

    def __exit__(self, *exc):
        self.module.init_weights = self.saved


def flash_counts():
    """The flash launch counters that are not zero, the dk/dv split
    reduction's (``dkv_reduce``) among them."""
    counts = {**fa.launch_counts(), "dkv_reduce": fa.reduce_launch_count()}
    return {n: c for n, c in counts.items() if c}


def splits_of(calls):
    """How many of the bf16 dk/dv calls (B, H, N, M, D, calls) split their
    query stream (``dkv_split_plan`` on this card), each launching the
    split reduction besides."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(n for B, H, N, M, D, n in calls
               if fa.dkv_split_plan(B, H, N, M, D, sms)[0] > 1)


def celebahq_step_launches(batch):
    """The predicted flash launches of one CelebA-HQ train step: each of the
    16 AttentionBlocks (5 at 32^2 with 14 heads, 5 at 16^2 with 21, 6 at
    8^2 with 28; D = 32) runs the training forward once and the backward's
    dq and dk/dv once (every q, k and v requires grad: the UNet trains);
    the first stage's one-head D = 512 attention takes the plain core.  ->
    the counters that are not zero, as ``flash_counts``."""
    levels = ((14, 1024, 5), (21, 256, 5), (28, 64, 6))
    blocks = sum(n for _, _, n in levels)
    want = {"fwd_lse": blocks, "dq": blocks, "dkv": blocks,
            "dkv_reduce": splits_of([(batch, h, tok, tok, 32, n)
                                     for h, tok, n in levels])}
    return {n: c for n, c in want.items() if c}


def step_1p4b_launches(batch):
    """The predicted flash launches of one 1p4B train step with BERT
    trainable: the UNet's 16 SpatialTransformers (LEGACY_1P4B_LEVELS) each
    run self-attention and cross-attention; with ``use_checkpoint`` the
    backward recomputes each block's forward, so 64 training forwards, and
    32 dq and dk/dv; BERT's 32 layers one training forward, dq and dk/dv
    each (every q, k and v requires grad).  -> the counters that are not
    zero, as ``flash_counts``."""
    unet = [(batch, 8, N, M, D, n) for N, D, n in LEGACY_1P4B_LEVELS
            for M in (N, BERT_TOKENS)]
    bert = [(batch, BERT_HEADS, BERT_TOKENS, BERT_TOKENS, BERT_HEAD_DIM,
             BERT_ATTN)]
    calls = sum(c[-1] for c in unet)
    want = {"fwd_lse": 2 * calls + BERT_ATTN, "dq": calls + BERT_ATTN,
            "dkv": calls + BERT_ATTN, "dkv_reduce": splits_of(unet + bert)}
    return {n: c for n, c in want.items() if c}


def train_snapshot(tr):
    """What a legacy train step writes, and the generator's state."""
    return ([t.detach().clone() for t in tr.written_in_place()],
            tr.generator.get_state(), tr.steps_done)


def train_restore(tr, snap):
    """Back to a snapshot, in place (a captured step reads these tensors
    where they lie)."""
    with torch.no_grad():
        for t, s in zip(tr.written_in_place(), snap[0], strict=True):
            t.copy_(s)
    tr.generator.set_state(snap[1])
    tr.steps_done = snap[2]


def flat_grads(optimizer):
    """Every gradient of an optimizer's parameters, as one flat fp32
    tensor."""
    return torch.cat([p.grad.float().flatten()
                      for g in optimizer.param_groups for p in g["params"]])


def legacy_graph_vs_eager(tr, images, want):
    """The CelebA-HQ step from one state on its graph and eagerly in turns
    (graph, eager, eager, graph), LEGACY_TRAIN_STEPS steps a run: losses,
    UNet parameters after AdamW and the EMA copies bit for bit, launches a
    step, split reductions included (= ``want``), ms a step to a sync and
    peak memory each way."""
    snap = train_snapshot(tr)
    outs, rec = [], {"graph": [], "eager": []}
    unet = tr.ldm.unet
    for way in ("graph", "eager", "eager", "graph"):
        train_restore(tr, snap)
        fn = tr.step if way == "graph" else tr.step.eager
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        caps0 = graphs.captures()
        ms, losses = [], []
        for _ in range(LEGACY_TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(fn(images).clone())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = flash_counts()
        with torch.no_grad():
            outs.append(losses + [
                torch.cat([p.flatten() for p in unet.parameters()]),
                torch.cat([e.flatten() for e in tr.ema.params.values()])])
        rec[way].append({
            "ms": ms, "captures": graphs.captures() - caps0,
            "launches_per_step": {n: c / LEGACY_TRAIN_STEPS
                                  for n, c in counts.items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30})
    train_restore(tr, snap)
    same = all(torch.equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))
    per_step = [r["launches_per_step"] for way in rec for r in rec[way]]
    log("legacy_train", f"celebahq step graph vs eager in turns: bit for bit "
                        f"{same} (losses, UNet after AdamW, EMA); ms a step "
                        f"graph {[[round(x, 2) for x in r['ms']] for r in rec['graph']]}"
                        f" vs eager {[[round(x, 2) for x in r['ms']] for r in rec['eager']]}; "
                        f"launches a step {json.dumps(per_step[0])}; peak "
                        f"allocated / reserved GiB graph "
                        f"{[(round(r['peak_gib'], 2), round(r['peak_reserved_gib'], 2)) for r in rec['graph']]}"
                        f" eager "
                        f"{[(round(r['peak_gib'], 2), round(r['peak_reserved_gib'], 2)) for r in rec['eager']]}")
    if not same:
        raise RuntimeError("legacy_train: the CelebA-HQ step's graph does "
                           "not give its eager bits")
    want = {n: float(c) for n, c in want.items()}
    if any(p != want for p in per_step) or \
            any(r["captures"] for r in rec["graph"]):
        raise RuntimeError(f"legacy_train: launches a step {per_step}, "
                           f"expected {want}")
    rec["bits_equal"] = same
    return rec


def legacy_step_route_parity(tr, images, cond=None):
    """One eager step from the trainer's state on the kernel route and on
    the plain route (the state put back after each): -> [(loss, flat
    gradient of every trained parameter)] for the two routes; the kernel
    route must launch flash kernels and the plain route none."""
    snap = train_snapshot(tr)
    results = []
    for impl in (None, "xla"):
        train_restore(tr, snap)
        attn_ops.set_default_impl(impl)
        try:
            fa.reset_launch_count()
            loss = tr.step.eager(images, cond)
            torch.cuda.synchronize()
            n = fa.launch_count()
        finally:
            attn_ops.set_default_impl(None)
        if (impl is None) != (n > 0):
            raise RuntimeError(f"legacy_train: the {impl or 'kernel'} route "
                               f"launched {n} flash kernels")
        results.append((float(loss), flat_grads(tr.optimizer)))
    train_restore(tr, snap)
    return results


def legacy_train_celebahq(work):
    """``cli/train_legacy.py --fake-data`` on celebahq-ldm-vq-4.yaml (module
    docstring, phase 15).  -> its record."""
    import yaml

    from celebbasis_tpu_torch import legacy
    from celebbasis_tpu_torch.cli import train_legacy

    cfg_path = os.path.join(LEGACY_CONFIGS, "celebahq-ldm-vq-4.yaml")
    ckpt = os.path.join(work, "celebahq_trained.ckpt")
    want = celebahq_step_launches(LEGACY_TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    caps0 = graphs.captures()
    t0 = time.perf_counter()
    with DrawnOutputConvs(train_legacy):
        run = train_legacy.main([
            "--config", cfg_path, "--fake-data", str(LEGACY_TRAIN_BATCH),
            "--batch-size", str(LEGACY_TRAIN_BATCH),
            "--max-steps", str(LEGACY_TRAIN_STEPS), "--log-every", "1",
            "--logdir", os.path.join(work, "legacy_train"),
            "--export-torch", ckpt, "--image-every", str(LEGACY_TRAIN_STEPS),
            "--image-steps", "5"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts()
    tr, ldm = run["trainer"], run["ldm"]
    rec = {"batch": LEGACY_TRAIN_BATCH, "steps": LEGACY_TRAIN_STEPS,
           "wall_s": wall, "losses": run["losses"], "launches": counts,
           "captures": graphs.captures() - caps0,
           "capture_s": list(tr.step.captured.capture_s.values()),
           "launches_per_step": tr.step.captured.launches_per_replay(),
           "predicted_per_step": want,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    sample_calls = 5 * CELEBAHQ_ATTN     # the image log's 5-step DDIM chain
    expect = {n: (LEGACY_TRAIN_STEPS + 1) * c for n, c in want.items()}
    expect["flash_attention"] = 2 * sample_calls
    log("legacy_train", f"celebahq cli/train_legacy.py: batch "
                        f"{LEGACY_TRAIN_BATCH}, {LEGACY_TRAIN_STEPS} steps "
                        f"and a sample grid in {wall:.1f} s; losses "
                        f"{json.dumps(run['losses'])}; capture s "
                        f"{[round(x, 2) for x in rec['capture_s']]}; launches "
                        f"{json.dumps(counts)} (expected {json.dumps(expect)}); "
                        f"a step's {json.dumps(rec['launches_per_step'])} "
                        f"(predicted {json.dumps(want)}); peak allocated / "
                        f"reserved GiB "
                        f"{rec['peak_gib']:.2f} / {rec['peak_reserved_gib']:.2f}")
    if not all(np.isfinite(v) for v in run["losses"].values()):
        raise RuntimeError("legacy_train: a CelebA-HQ loss is not finite")
    if rec["launches_per_step"] != want or counts != expect:
        raise RuntimeError(f"legacy_train: the CelebA-HQ run launched "
                           f"{counts}, a step {rec['launches_per_step']}; "
                           f"expected {expect}, a step {want}")
    # the export, read back by the port's reader of CompVis checkpoints
    with open(cfg_path) as f:
        fresh = legacy.build_legacy_ldm(yaml.safe_load(f), torch.float32,
                                        device="cuda")
    rec["export_unused_keys"] = legacy.load_reference_checkpoint(fresh, ckpt)
    rec["export_equal"] = all(
        torch.equal(p, tr.ema.params[n])
        for n, p in fresh.unet.named_parameters()) and all(
        torch.equal(v, ldm.first_stage.state_dict()[k])
        for k, v in fresh.first_stage.state_dict().items())
    del fresh
    log("legacy_train", f"celebahq export read back by "
                        f"load_reference_checkpoint: EMA UNet and VQ first "
                        f"stage bit for bit {rec['export_equal']}, unused "
                        f"keys {rec['export_unused_keys']}")
    if not rec["export_equal"] or rec["export_unused_keys"]:
        raise RuntimeError("legacy_train: the exported checkpoint does not "
                           "read back")
    data = train_legacy.fake_dataset(ldm, LEGACY_TRAIN_BATCH)[0]
    images = torch.from_numpy(data).cuda()
    rec["graph_vs_eager"] = legacy_graph_vs_eager(tr, images, want)
    tr.step.captured._graphs.clear()          # free the graph's pool
    torch.cuda.empty_cache()
    # full width, bf16: one step's UNet gradient on the kernel route and on
    # the plain route, at a batch the plain attention fits in
    b = LEGACY_PARITY_BATCH
    (loss_k, g_k), (loss_p, g_p) = legacy_step_route_parity(tr, images[:b])
    cos = float(torch.dot(g_k, g_p) / (g_k.norm() * g_p.norm()))
    rel = float((g_k - g_p).norm() / g_p.norm())
    rec["route_parity"] = {"batch": b, "loss_kernel": loss_k,
                           "loss_plain": loss_p, "grad_cosine": cos,
                           "grad_rel_diff": rel}
    log("legacy_train", f"celebahq step at batch {b}, bf16, kernel vs plain "
                        f"route: loss {loss_k:.6f} / {loss_p:.6f}, UNet "
                        f"gradient cosine {cos:.6f}, |diff|/|grad| {rel:.4f}")
    if not (cos >= 0.99 and rel <= 0.1):
        raise RuntimeError(f"legacy_train: the routes' gradients differ "
                           f"(cosine {cos}, relative {rel})")
    del run, tr, ldm
    return rec


def legacy_train_tiny_parity():
    """The tiny legacy configs' train step in fp32 with TF32 off
    (``configs/tiny_legacy.yaml``: AttentionBlocks of head dim 8 on the
    per-head entry; ``tiny_legacy_bert.yaml`` with BERT trainable: the
    packed entry, dk/dv through the context), eager, kernel route against
    plain route: loss within 1e-5 (relative), the UNet's and BERT's
    gradients within 1e-4 of the largest entry."""
    import yaml

    from celebbasis_tpu_torch import legacy
    from celebbasis_tpu_torch.cli import train_legacy
    from celebbasis_tpu_torch.loader import init_weights

    out = {}
    for name in ("tiny_legacy", "tiny_legacy_bert"):
        with open(os.path.join(REPO, "configs", f"{name}.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["model"]["params"]["cond_stage_trainable"] = True
        ldm = legacy.build_legacy_ldm(cfg, torch.float32, device="cuda")
        init_weights(ldm, torch.Generator("cuda").manual_seed(2),
                     zero_convs=False)
        tr = train_legacy.make_legacy_trainer(
            ldm, cfg, 2, ema=train_legacy.make_ema(ldm.unet),
            generator=torch.Generator("cuda").manual_seed(3))
        data, labels, caps, conds = train_legacy.fake_dataset(ldm, 2)
        cond = train_legacy.cond_batch(ldm, labels, caps, conds)
        with no_tf32():
            (lk, gk), (lp, gp) = legacy_step_route_parity(
                tr, torch.from_numpy(data).cuda(), cond)
        top = float(gp.abs().max())
        err = float((gk - gp).abs().max())
        out[name] = {"loss_kernel": lk, "loss_plain": lp,
                     "grad_max_abs_err": err, "grad_top": top}
        log("legacy_train", f"{name} fp32 step (cond stage trainable "
                            f"{tr.cond_trainable}), kernel vs plain route: "
                            f"loss {lk:.7f} / {lp:.7f}, gradients max |diff| "
                            f"{err:.3e} (largest entry {top:.3e})")
        if abs(lk - lp) > 1e-5 * abs(lp) or err > 1e-4 * top:
            raise RuntimeError(f"legacy_train: {name}'s routes differ: "
                               f"{out[name]}")
    return out


def legacy_train_dropout():
    """The tiny legacy config with ``dropout`` 0.3 on a captured train step
    (its generator registered with the graph): two replays from the same
    parameters and optimizer state draw other masks, so their losses
    differ; each is finite.  -> its record."""
    import yaml

    from celebbasis_tpu_torch.cli import train_legacy

    with open(os.path.join(REPO, "configs", "tiny_legacy.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["params"]["unet_config"]["params"]["dropout"] = 0.3
    with DrawnOutputConvs(train_legacy):
        ldm = train_legacy.build_model(cfg, 4, torch.device("cuda"))
    tr = train_legacy.make_legacy_trainer(
        ldm, cfg, 2, generator=torch.Generator("cuda").manual_seed(5))
    images = torch.from_numpy(train_legacy.fake_dataset(ldm, 2)[0]).cuda()
    t = torch.tensor([10, 40], device="cuda")
    noise = torch.randn(tr.latent_shape(images), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(6))
    tr.step(images, None, t, noise)              # capture
    snap = [x.detach().clone() for x in tr.written_in_place()]
    losses = []
    for _ in range(2):
        with torch.no_grad():
            for x, s_ in zip(tr.written_in_place(), snap, strict=True):
                x.copy_(s_)
        losses.append(float(tr.step(images, None, t, noise)))
    rec = {"losses": losses, "captures": len(tr.step.captured.capture_s),
           "generators": len(tr.step.captured._generators())}
    log("legacy_train", f"tiny step with dropout 0.3 on its graph: two "
                        f"replays from one state, losses {losses} "
                        f"(the generator registered: {rec['generators']})")
    if rec["captures"] != 1 or rec["generators"] != 1 \
            or not all(np.isfinite(losses)) or losses[0] == losses[1]:
        raise RuntimeError(f"legacy_train: dropout on the graph: {rec}")
    return rec


def legacy_train_1p4b(work):
    """``cli/train_legacy.py --fake-data`` on txt2img-1p4B-eval.yaml with
    BERT trainable (module docstring, phase 15).  -> its record."""
    from celebbasis_tpu_torch.cli import train_legacy

    cfg_path = os.path.join(LEGACY_CONFIGS, "txt2img-1p4B-eval.yaml")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    t0 = time.perf_counter()
    with DrawnOutputConvs(train_legacy):
        run = train_legacy.main([
            "--config", cfg_path, "--fake-data", str(LEGACY_1P4B_BATCH),
            "--batch-size", str(LEGACY_1P4B_BATCH), "--max-steps", "2",
            "--log-every", "1", "--logdir", os.path.join(work, "legacy_1p4b")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts()
    want = step_1p4b_launches(LEGACY_1P4B_BATCH)
    tr, ldm = run["trainer"], run["ldm"]
    data, labels, caps, conds = train_legacy.fake_dataset(ldm,
                                                          LEGACY_1P4B_BATCH)
    images = torch.from_numpy(data).cuda()
    cond = train_legacy.cond_batch(ldm, labels, caps, conds)
    ms = []
    for _ in range(2):
        t1 = time.perf_counter()
        tr.step(images, cond)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    n_params = sum(p.numel() for group in tr.optimizer.param_groups
                   for p in group["params"])
    rec = {"batch": LEGACY_1P4B_BATCH, "wall_s": wall,
           "losses": run["losses"], "launches": counts,
           "launches_per_step": tr.step.captured.launches_per_replay(),
           "predicted_per_step": want,
           "capture_s": list(tr.step.captured.capture_s.values()),
           "ms": ms, "trained_params": n_params,
           "cond_trainable": tr.cond_trainable,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    log("legacy_train", f"1p4B cli/train_legacy.py, BERT trainable "
                        f"{tr.cond_trainable}, {n_params / 1e9:.3f} G trained "
                        f"parameters, batch {LEGACY_1P4B_BATCH}: 2 steps in "
                        f"{wall:.1f} s, losses {json.dumps(run['losses'])}; "
                        f"capture s {[round(x, 2) for x in rec['capture_s']]}"
                        f"; ms a step on its graph "
                        f"{[round(x, 2) for x in ms]}; launches "
                        f"{json.dumps(counts)}, a step "
                        f"{json.dumps(rec['launches_per_step'])} (predicted "
                        f"{json.dumps(want)}); peak "
                        f"allocated / reserved GiB {rec['peak_gib']:.2f} / "
                        f"{rec['peak_reserved_gib']:.2f}")
    if not tr.cond_trainable or \
            not all(np.isfinite(v) for v in run["losses"].values()):
        raise RuntimeError("legacy_train: the 1p4B run did not train BERT "
                           "or its loss is not finite")
    # the run: two steps and the capture's warm-up
    if rec["launches_per_step"] != want \
            or counts != {n: 3 * c for n, c in want.items()}:
        raise RuntimeError(f"legacy_train: the 1p4B run launched {counts}, "
                           f"a step {rec['launches_per_step']}; expected "
                           f"{want} a step")
    del run, tr, ldm
    return rec


def legacy_train_ae(work):
    """``cli/train_ae.py --fake-data`` on autoencoder_kl_32x32x4.yaml at
    256^2 (module docstring, phase 15), on its step graph; the step on its
    graph and eagerly in turns before ``disc_start`` and, after the GAN
    step that captures the second signature, after it; then the VQ-f4
    first stage's step the same way.  With cuDNN's deterministic algorithms
    (the discriminator convolves in float32, whose eager steps repeated
    only so).  -> its record."""
    from celebbasis_tpu_torch.cli import train_ae

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        run = train_ae.main([
            "--config", os.path.join(LEGACY_CONFIGS,
                                     "autoencoder_kl_32x32x4.yaml"),
            "--fake-data", str(LEGACY_AE_BATCH), "--max-steps", "2",
            "--log-every", "1", "--logdir", os.path.join(work, "legacy_ae")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr = run["trainer"]
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (LEGACY_AE_BATCH, 256, 256, 3)).astype(np.float32)).cuda()
        gen = torch.Generator("cuda").manual_seed(0)
        ms = []
        for _ in range(2):
            t1 = time.perf_counter()
            log_ = tr.train_batch(x, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        rec = {"batch": LEGACY_AE_BATCH, "wall_s": wall, "ms": ms,
               "logs": run["logs"], "launches": kernel_counts(),
               "capture_s": list(tr.train_batch.captured.capture_s.values()),
               "d_weight": float(log_["train/d_weight"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log("legacy_train", f"cli/train_ae.py KL-f8 256^2, batch "
                            f"{LEGACY_AE_BATCH}: 2 steps in {wall:.1f} s "
                            f"(capture {rec['capture_s']} s); ms a step "
                            f"(generator + discriminator pass, on its graph) "
                            f"{[round(v, 1) for v in ms]}; d_weight "
                            f"{rec['d_weight']:.4e}; kernel launches "
                            f"{rec['launches']}; peak allocated GiB "
                            f"{rec['peak_gib']:.2f}")
        if not all(np.isfinite(v) for r in run["logs"].values()
                   for v in r.values()) or not rec["d_weight"] > 0 \
                or rec["launches"] or len(rec["capture_s"]) != 1:
            raise RuntimeError(f"legacy_train: train_ae {rec}")
        rec["turns_before"] = ae_turns("train_ae KL-f8 before disc_start",
                                       tr, x)
        rec["gan_step"] = legacy_ae_gan_step(tr, x)
        rec["turns_after"] = ae_turns("train_ae KL-f8 after disc_start", tr,
                                      x)
        if len(tr.train_batch.captured.capture_s) != 2:
            raise RuntimeError(f"legacy_train: train_ae captured "
                               f"{len(tr.train_batch.captured.capture_s)} "
                               f"graphs; expected one each side of "
                               f"disc_start")
        del run, tr
        rec["vq"] = legacy_train_vq()
    finally:
        torch.backends.cudnn.deterministic = saved
    return rec


def ae_turns(name, tr, x, steps=2):
    """``steps`` AE steps from the trainer's state on the step's graph and
    eagerly in turns (``graph_turns``): both passes' logs, both modules'
    parameters after Adam bit for bit; the generator's draws from one seed
    each run.  -> the record."""
    snap = [t.detach().clone() for t in tr.written_in_place()]
    step0 = tr.global_step

    def reset():
        with torch.no_grad():
            for t, v in zip(tr.written_in_place(), snap, strict=True):
                t.copy_(v)
        tr.global_step = step0

    def run(fn):
        gen = torch.Generator("cuda").manual_seed(3)
        logs = [fn(x, gen) for _ in range(steps)]
        return [v for lg in logs for v in lg.values()] + [
            p.detach() for m in (tr.model, tr.loss.disc)
            for p in m.parameters()]

    return graph_turns("legacy_train", name, lambda: run(tr.train_batch),
                       lambda: run(tr.train_batch.eager),
                       tr.train_batch.captured, reset, units=steps)


VQ_F4 = {   # CompVis latent-diffusion models/first_stage_models/vq-f4
    "model": {"base_learning_rate": 4.5e-6,
              "target": "ldm.models.autoencoder.VQModel",
              "params": {"embed_dim": 3, "n_embed": 8192, "ddconfig": {
                  "double_z": False, "z_channels": 3, "resolution": 256,
                  "in_channels": 3, "out_ch": 3, "ch": 128,
                  "ch_mult": [1, 2, 4], "num_res_blocks": 2,
                  "attn_resolutions": [], "dropout": 0.0},
                  "lossconfig": {
                      "target": "taming.modules.losses.vqperceptual."
                                "VQLPIPSWithDiscriminator",
                      "params": {"disc_conditional": False,
                                 "disc_in_channels": 3, "disc_start": 0,
                                 "disc_weight": 0.75,
                                 "codebook_weight": 1.0}}}},
    "data": {"params": {"batch_size": 4}}}


def legacy_train_vq():
    """The VQ-f4 first stage (``VQ_F4``, 256^2, batch 4, the
    discriminator on from step 0) through ``build_first_stage_trainer``: a
    step on its graph (the codebook float32, the logs finite, ``d_weight``
    above 0), then ``ae_turns``.  -> its record."""
    from celebbasis_tpu_torch.cli import train_ae

    tr, size = train_ae.build_first_stage_trainer(VQ_F4, device="cuda",
                                                  seed=5)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (4, size, size, 3)).astype(np.float32)).cuda()
    log_ = tr.train_batch(x)
    rec = {"logs": {k: float(v) for k, v in log_.items()},
           "codebook_dtype": str(tr.model.quantize.weight.dtype)}
    log("legacy_train", f"VQ-f4 256^2 batch 4 step on its graph: "
                        f"{json.dumps(rec)}")
    if not tr.is_vq or rec["codebook_dtype"] != "torch.float32" \
            or not all(np.isfinite(v) for v in rec["logs"].values()) \
            or not rec["logs"]["train/d_weight"] > 0 \
            or not rec["logs"]["train/disc_factor"] == 1.0:
        raise RuntimeError(f"legacy_train: the VQ-f4 step {rec}")
    rec["turns"] = ae_turns("train_ae VQ-f4", tr, x)
    return rec


def legacy_ae_gan_step(tr, x):
    """One step of the trained KL-f8 model with the discriminator on
    (``disc_start`` 0: the published 50001 keeps it off in the smoke's
    steps).  The adaptive weight is recomputed here from the same pass
    (the posterior noise given) as ||grad NLL|| / (||grad g|| + 1e-4) on
    the decoder's last conv weight, g = -mean(D(recons)); where that ratio
    passes the 1e4 clamp (random weights), ``loss.logvar`` is raised until
    it is about 100 (the NLL is divided by exp(logvar)).  The step's
    ``d_weight`` must equal the recomputed ratio x ``disc_weight`` within
    1e-2 and lie below the clamp, its discriminator loss and factor be
    positive, and the discriminator's parameters move.  -> its record."""
    import dataclasses
    import math
    model, loss = tr.model, tr.loss
    loss.cfg = dataclasses.replace(loss.cfg, disc_start=0)
    last = model.decoder.conv_out.weight
    with torch.no_grad():
        mean = model.encode(x)[0]
    eps = torch.randn(mean.shape, dtype=mean.dtype, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))

    def ratio():
        mean, logvar = model.encode(x)
        recons = model.decode(mean + torch.exp(0.5 * logvar) * eps)
        nll = loss.nll_of(x, recons)[1]
        g_loss = -loss.disc(recons).mean()
        g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
        g_g = torch.autograd.grad(g_loss, last)[0]
        return float(g_nll.float().norm() / (g_g.float().norm() + 1e-4))

    rec = {"ratio_at_logvar_0": ratio()}
    if rec["ratio_at_logvar_0"] > 1e3:
        with torch.no_grad():
            loss.logvar.fill_(math.log(rec["ratio_at_logvar_0"] / 100))
    rec["logvar"] = float(loss.logvar)
    rec["ratio"] = ratio()
    disc = [p.detach().clone() for p in loss.disc.parameters()]
    log_ = tr.train_batch(x, override_eps=(eps, eps))
    torch.cuda.synchronize()
    clamp = 1e4 * loss.cfg.disc_weight
    rec.update({k.split("/")[1]: float(v) for k, v in log_.items()
                if k.split("/")[1] in ("d_weight", "disc_loss", "disc_factor",
                                       "g_loss", "total_loss")})
    rec["want_d_weight"] = min(rec["ratio"], 1e4) * loss.cfg.disc_weight
    rec["disc_moved"] = max(float((p.detach() - b).abs().max()) for p, b in
                            zip(loss.disc.parameters(), disc, strict=True))
    log("legacy_train", f"train_ae step with disc_start 0: {json.dumps(rec)}")
    if not (np.isfinite(list(rec.values())).all()
            and rec["disc_loss"] > 0 and rec["disc_factor"] > 0
            and rec["disc_moved"] > 0 and rec["d_weight"] < clamp
            and abs(rec["d_weight"] - rec["want_d_weight"])
            <= 1e-2 * rec["want_d_weight"]):
        raise RuntimeError(f"legacy_train: the GAN step {rec}")
    return rec


def legacy_train_classifier():
    """The noisy-latent classifier at a tiny size on the card (an
    EncoderUNetModel, its AttentionBlocks on the per-head entry, the
    attention pool on the packed one): a train step on its graph (#3-#5
    launched), the noise sweep on its eval step's graph; then both on their
    graphs and eagerly in turns (logs, parameters after AdamW bit for bit;
    cuDNN's deterministic algorithms).  -> its record."""
    from celebbasis_tpu_torch.models.unet import UNetConfig
    from celebbasis_tpu_torch.train import classifier as clf
    from celebbasis_tpu_torch.train.step import written_in_place

    cfg = clf.ClassifierConfig(
        num_classes=5, unet=UNetConfig(
            in_channels=4, out_channels=4, model_channels=64,
            channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_head_channels=32,
            use_spatial_transformer=False),
        image_size=16, timesteps=1000)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        c = clf.NoisyLatentClassifier(cfg, device="cuda")
        gen = torch.Generator("cuda").manual_seed(0)
        z = torch.randn(4, 16, 16, 4, device="cuda", generator=gen)
        labels = torch.tensor([0, 1, 2, 4], device="cuda")
        state = c.init_state(lr=1e-4)
        reset_kernel_counts()
        state, log_ = c.train_step(state, z, labels, gen)
        torch.cuda.synchronize()
        counts = kernel_counts()
        sweep = c.validate_noise_sweep(z, labels, gen, log_every_t=250)
        rec = {"loss": float(log_["train/loss"]), "launches": counts,
               "sweep_levels": sorted(sweep),
               "graphs": [len(state["graph"].capture_s),
                          len(c.eval_step.capture_s)]}
        log("legacy_train", f"classifier tiny step: loss {rec['loss']:.4f}, "
                            f"launches {json.dumps(counts)} (warm-up and "
                            f"replay), noise sweep levels "
                            f"{rec['sweep_levels']}, graphs (train, eval) "
                            f"{rec['graphs']}")
        if not np.isfinite(rec["loss"]) or rec["graphs"] != [1, 1] or \
                any(counts.get(n, 0) == 0 for n in TRAIN_KERNELS):
            raise RuntimeError(f"legacy_train: the classifier step {rec}")

        snap = [t.detach().clone() for t in written_in_place(state["opt"])]

        def reset():
            with torch.no_grad():
                for t, v in zip(written_in_place(state["opt"]), snap,
                                strict=True):
                    t.copy_(v)

        def train(fn):
            c.model.train()
            g, out = torch.Generator("cuda").manual_seed(1), []
            for _ in range(2):
                out += list(fn(z, labels, *c.draw_t_noise(z, g)).values())
            return out + [p.detach() for p in c.model.parameters()]

        rec["train_turns"] = graph_turns(
            "legacy_train", "classifier train step", lambda: train(
                state["graph"]), lambda: train(state["graph"].eager),
            state["graph"], reset, units=2)
        noise = torch.randn(z.shape, device="cuda", generator=gen)
        levels = range(0, cfg.timesteps, 250)

        @torch.no_grad()
        def sweep_of(fn):
            c.model.eval()
            return [v for t in levels for v in fn(z, labels, torch.full(
                (4,), t, device="cuda"), noise).values()]

        rec["eval_turns"] = graph_turns(
            "legacy_train", "classifier eval step", lambda: sweep_of(
                c.eval_step), lambda: sweep_of(c.eval_step.eager),
            c.eval_step, units=len(levels))
    finally:
        torch.backends.cudnn.deterministic = saved
    return rec


def legacy_train_summary(rec):
    """The legacy_train phase's ms a step, peaks and walls."""
    med = lambda xs: round(float(np.median(xs)), 2)
    c = rec["celebahq"]
    ge = c["graph_vs_eager"]
    return {
        "phase_s": round(rec["phase_wall_s"], 1),
        "celebahq_batch": c["batch"],
        "celebahq_step_ms_graph": med([m for r in ge["graph"]
                                       for m in r["ms"][1:]]),
        "celebahq_step_ms_eager": med([m for r in ge["eager"]
                                       for m in r["ms"][1:]]),
        "celebahq_capture_s": [round(x, 2) for x in c["capture_s"]],
        "celebahq_peak_gib": [round(c["peak_gib"], 2),
                              round(c["peak_reserved_gib"], 2)],
        "1p4b_step_ms": med(rec["1p4b"]["ms"]),
        "1p4b_peak_gib": [round(rec["1p4b"]["peak_gib"], 2),
                          round(rec["1p4b"]["peak_reserved_gib"], 2)],
        "ae_step_ms": med(rec["train_ae"]["ms"]),
        "ae_peak_gib": round(rec["train_ae"]["peak_gib"], 2),
        **{f"{name}_ms_{way}": turns[f"ms_{way}"]
           for name, turns in (
               ("ae_kl_before", rec["train_ae"]["turns_before"]),
               ("ae_kl_after", rec["train_ae"]["turns_after"]),
               ("ae_vq", rec["train_ae"]["vq"]["turns"]),
               ("classifier_train", rec["classifier"]["train_turns"]),
               ("classifier_eval", rec["classifier"]["eval_turns"]))
           for way in ("graph", "eager")}}


def phase_legacy_train(work):
    """The legacy family's training side (module docstring, phase 15)."""
    import gc
    t0 = time.perf_counter()
    out = {}
    for name, run in (("celebahq", lambda: legacy_train_celebahq(work)),
                      ("tiny_route_parity", legacy_train_tiny_parity),
                      ("dropout", legacy_train_dropout),
                      ("1p4b", lambda: legacy_train_1p4b(work)),
                      ("train_ae", lambda: legacy_train_ae(work)),
                      ("classifier", legacy_train_classifier)):
        gc.collect()                  # the last run's model and graphs
        torch.cuda.empty_cache()
        out[name] = run()
    out["phase_wall_s"] = time.perf_counter() - t0
    log("legacy_train", f"phase {out['phase_wall_s']:.1f} s")
    return out


# -- phase 16 -----------------------------------------------------------------

def phase_warmup():
    """``python -m celebbasis_tpu_torch.cli.warmup`` at its defaults (the
    JAX CLI's: ``configs/aigc_id.yaml``, 512x512, 50 DDIM steps at 8 samples
    and guidance 10, the train step at batch 2) in a process of its own:
    exit 0, every kernel library the paths load built, both graphs captured
    and each capture's seconds printed.  -> its record."""
    cache = tempfile.mkdtemp(prefix="chip_smoke_warmup_")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "celebbasis_tpu_torch.cli.warmup",
             "--cache_dir", cache], cwd=REPO, capture_output=True, text=True,
            timeout=900)
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[warmup]")]
        for ln in lines:
            log("warmup", ln)
        if proc.returncode != 0:
            raise RuntimeError(f"warmup: exit {proc.returncode}\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(cache, "warmup.json")) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    rec["wall_s"] = wall
    log("warmup", f"cli/warmup.py: {wall:.1f} s in all (a process of its "
                  f"own); kernels built in {rec.get('build_s', 0):.1f} s "
                  f"(this process had built them: a finished build is "
                  f"reused); train step graph {rec.get('train_s', 0):.1f} s, "
                  f"txt2img graph {rec.get('txt2img_s', 0):.1f} s")
    # lib<name>_<hash of source and flags>.so
    libs = {lib[3:].rsplit("_", 1)[0] for lib in rec.get("libraries", [])}
    want = set(fa.LIBRARIES + geglu.LIBRARIES)
    if libs != want or not rec["device"].startswith("cuda") \
            or "train_s" not in rec or "txt2img_s" not in rec \
            or sum("captured in" in ln for ln in lines) != 2:
        raise RuntimeError(f"warmup: record {rec}; libraries {libs}, "
                           f"expected {want}")
    return rec


# -- phase 17 -----------------------------------------------------------------

MESH_RANKS = os.path.join(REPO, "torch_scripts", "mesh_ranks.py")
MESH_TIMEOUT_S = 420          # a torchrun launch, all its ranks
MESH_TRAIN_STEPS = 3          # nccl1: uncached steps a run
# gloo2 against one process at the same rate, bf16 (PERF.md 2 and 6): the
# two steps' losses (the second starts from MLPs that the first gradient's
# rounding at a rank's batch size has moved apart: 1.06e-3 read; a rate off
# by the data ranks reads 3.3e-2), the first gradient
MESH_REL_LOSS = (1e-3, 3e-3)
MESH_GRAD_COS, MESH_GRAD_REL = 0.99, 0.1
MESH_SPLIT_REL = 1e-3         # the first gradient against one process's mean
                              # over the batch's halves, each alone (read: 0)
MESH_MLP_COS, MESH_MLP_REL = 0.98, 0.25  # the MLP's change over the run (read
                              # 0.9934 / 0.115; a rate off by the data ranks
                              # reads |diff| / |change| 1.0)
MESH_PLAIN_MEAN = 1.5         # bf16 --mesh 2 pixels against the two-sample
                              # run: mean |diff| within 1.5x the plain
                              # attention route's distance from the kernels'
# the TP W2 step with conv_tp in float32 (TF32 off) against one process in
# float32: summation order alone (a wrong shard or a gradient summed twice
# is off by O(1)); the witness that its bf16 distance is rounding
MESH_FP32_REL_LOSS = (1e-5, 1e-5)
MESH_FP32_GRAD_COS, MESH_FP32_GRAD_REL = 0.999999, 1e-3
MESH_TP_MEAN = 8.0            # --tp 2 pixels, mean |diff| in levels: bf16
                              # rounding moves a few; a wrong shard gives
                              # unrelated images (PERF.md 2)


def torchrun(nproc, args, timeout):
    """``python -m torch.distributed.run`` with ``nproc`` ranks on this
    machine, its own session so that a timeout ends every rank; its
    ``[mesh]`` lines go to the log.  -> the output; raises on a non-zero
    exit."""
    import signal
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={nproc}", "--master_addr=127.0.0.1",
           f"--master_port={port}", MESH_RANKS, *args]
    env = dict(os.environ, OMP_NUM_THREADS="4")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"mesh: {args[0]} ran past {timeout} s\n"
                           f"{out[-6000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    for line in out.splitlines():
        if line.startswith("[mesh]"):
            print(line[:3000], flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"mesh: {args[0]} exited {proc.returncode}\n"
                           f"{out[-8000:]}")
    return out


def _by_run(recs):
    return {r["run"]: r for r in recs}


def _pixels(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return {"max": int(d.max()), "mean": float(d.mean()),
            "p99": float(np.percentile(d, 99))}


def _cos(a, b) -> float:
    a, b = a.double(), b.double()
    return float(a @ b / (a.norm() * b.norm()))


def _rel(a, b) -> float:
    """|a - b| / |b|."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def check_mesh_nccl1(ranks):
    """World size 1 over NCCL, on the graphs: ``--mesh 1`` and ``--mesh 1
    --fsdp`` give the one-process losses, MLP and manager state bit for
    bit; ``--mesh 1 --tp 1`` its pixels."""
    (r,) = ranks
    ref = r["train"]
    for name in ("train_mesh1", "train_mesh1_fsdp"):
        got = r[name]
        if got["losses"] != ref["losses"] or len(ref["losses"]) != \
                MESH_TRAIN_STEPS or not all(
                    torch.equal(got[k], ref[k]) for k in
                    ("mlp", "first_grad", "id_coefficients",
                     "id_embeddings")):
            raise RuntimeError(f"mesh: {name} losses {got['losses']} against "
                               f"{ref['losses']}, or its MLP / gradient / "
                               f"manager state differ")
        want = {n: c * (MESH_TRAIN_STEPS + 1)
                for n, c in TRAIN_LAUNCHES.items() if c}
        if got["launches"] != want or ref["launches"] != want:
            raise RuntimeError(f"mesh: {name} launched {got['launches']}, "
                               f"one process {ref['launches']}; expected "
                               f"{want}")
    if r["train_mesh1_fsdp"]["stored_bytes"] != \
            r["train_mesh1_fsdp"]["fsdp_predicted"]:
        raise RuntimeError("mesh: FSDP at world size 1 stores "
                           f"{r['train_mesh1_fsdp']['stored_bytes']} bytes")
    a, b = r["txt2img"], r["txt2img_mesh1_tp1"]
    if not np.array_equal(a["images"], b["images"]) \
            or a["files"] != b["files"]:
        raise RuntimeError(f"mesh: --mesh 1 --tp 1 pixels "
                           f"{_pixels(a['images'], b['images'])}")
    for x in (a, b):
        if x["launches"] != {"flash_attention_nhd":
                             ATTN_PER_UNET * x["unet_calls"]}:
            raise RuntimeError(f"mesh: txt2img launched {x['launches']} in "
                               f"{x['unet_calls']} UNet calls")
    return {"bits_equal": ["train_mesh1", "train_mesh1_fsdp",
                           "txt2img_mesh1_tp1"],
            "fsdp_bytes": r["train_mesh1_fsdp"]["stored_bytes"]}


def check_mesh_gloo2(ranks):
    """Two ranks over gloo on one card, uncaptured, against rank 0's runs
    without a mesh: data parallel, FSDP, and tensor parallel (the W2 step
    with and without ``conv_tp``; sampling with ``--tp 2``, with
    ``conv_tp`` in bf16 and float32, and on the GEGLU kernel route).  Every
    figure is taken before any check raises."""
    r0, r1 = ranks
    ref = r0["train_b4"]
    split = ref["split_grads"]
    bad = []
    # the witness: one process's eager whole-batch gradient is its step's,
    # and its mean over the batch's halves, each run alone
    out = {"split": {"whole_vs_step": _rel(split["whole"],
                                           ref["first_grad"]),
                     "halves_vs_whole": _rel(split["halves"],
                                             split["whole"])}}
    for name in ("train_mesh2", "train_mesh2_fsdp"):
        got, other = r0[name], r1[name]
        out[name] = rec = {
            "loss_rel": [abs(a - b) / abs(b) for a, b in zip(
                got["losses"], ref["losses"], strict=True)],
            "grad_cos": _cos(got["first_grad"], ref["first_grad"]),
            "grad_rel": _rel(got["first_grad"], ref["first_grad"]),
            "split_rel": _rel(got["first_grad"], split["halves"]),
            "mlp_cos": _cos(got["mlp"] - got["mlp0"],
                            ref["mlp"] - ref["mlp0"]),
            "mlp_rel": _rel(got["mlp"] - got["mlp0"],
                            ref["mlp"] - ref["mlp0"])}
        if any(x > lim for x, lim in zip(rec["loss_rel"], MESH_REL_LOSS)) \
                or rec["grad_cos"] < MESH_GRAD_COS \
                or rec["grad_rel"] > MESH_GRAD_REL \
                or rec["split_rel"] > MESH_SPLIT_REL \
                or rec["mlp_cos"] < MESH_MLP_COS \
                or rec["mlp_rel"] > MESH_MLP_REL \
                or not torch.equal(got["mlp0"], ref["mlp0"]):
            bad.append(f"{name} against one process")
        if not all(torch.equal(got[k], other[k]) for k in
                   ("id_coefficients", "id_embeddings", "mlp")):
            bad.append(f"{name}'s ranks hold different manager states or "
                       f"MLPs")
        if any(x["launches"].get(n, 0) != c * 2 for x in (got, other)
               for n, c in TRAIN_LAUNCHES.items() if c):
            bad.append(f"{name} launched {got['launches']} / "
                       f"{other['launches']}")
    # the W2 step with TP-sharded frozen weights (a (1, 2) mesh, without
    # and with conv_tp) against one process at a rank's batch and rate
    for name in ("train_tp2", "train_tp2_conv", "train_tp2_conv_fp32"):
        got, other = r0[name], r1[name]
        ref2 = r0["train_b2_fp32" if "fp32" in name else "train_b2"]
        loss_lim, grad_cos, grad_rel = (
            (MESH_FP32_REL_LOSS, MESH_FP32_GRAD_COS, MESH_FP32_GRAD_REL)
            if "fp32" in name else (MESH_REL_LOSS, MESH_GRAD_COS,
                                    MESH_GRAD_REL))
        out[name] = rec = {
            "loss_rel": [abs(a - b) / abs(b) for a, b in zip(
                got["losses"], ref2["losses"], strict=True)],
            "grad_cos": _cos(got["first_grad"], ref2["first_grad"]),
            "grad_rel": _rel(got["first_grad"], ref2["first_grad"]),
            "mlp_cos": _cos(got["mlp"] - got["mlp0"],
                            ref2["mlp"] - ref2["mlp0"]),
            "mlp_rel": _rel(got["mlp"] - got["mlp0"],
                            ref2["mlp"] - ref2["mlp0"]),
            "local_heads": got["local_heads"]}
        # the loss and gradient limits (the MLP's change is reported: they
        # train at the reference's rate, and the change's limits were set
        # to catch a rate off by the data ranks)
        if any(x > lim for x, lim in zip(rec["loss_rel"], loss_lim)) \
                or rec["grad_cos"] < grad_cos or rec["grad_rel"] > grad_rel \
                or not torch.equal(got["mlp0"], ref2["mlp0"]) \
                or 4 not in got["local_heads"]:
            bad.append(f"{name} against one process")
        if not all(torch.equal(got[k], other[k]) for k in
                   ("id_coefficients", "id_embeddings", "mlp")):
            bad.append(f"{name}'s ranks hold different manager states or "
                       f"MLPs")
        if any(x["launches"].get(n, 0) != c * 2 for x in (got, other)
               for n, c in TRAIN_LAUNCHES.items() if c):
            bad.append(f"{name} launched {got['launches']} / "
                       f"{other['launches']}")
    out["fsdp_bytes"] = [[x["train_mesh2_fsdp"][k] for k in
                          ("stored_bytes", "fsdp_predicted", "whole_bytes")]
                         for x in (r0, r1)]
    if any(stored != predicted or not stored < whole
           for stored, predicted, whole in out["fsdp_bytes"]):
        bad.append("FSDP bytes stored / predicted / whole")
    one, plain = r0["txt2img"]["images"], r0["txt2img_plain"]["images"]
    out["plain_route"] = _pixels(plain, one)
    out["n1_vs_two"] = _pixels(r0["txt2img_n1"]["images"], one)
    for name in ("txt2img_mesh2", "txt2img_mesh2_fp32", "txt2img_tp2",
                 "txt2img_tp2_conv", "txt2img_tp2_conv_fp32",
                 "txt2img_tp2_geglu"):
        ref = r0["txt2img_fp32" if "fp32" in name else "txt2img"]
        tp = name.startswith("txt2img_tp2")
        for rank, x in enumerate((r0, r1)):
            out[f"{name}_r{rank}"] = px = _pixels(x[name]["images"],
                                                  ref["images"])
            calls = x[name]["unet_calls"]
            want = {"flash_attention_nhd": ATTN_PER_UNET * calls}
            if name == "txt2img_tp2_geglu":   # #6 on this rank's blocks
                want["geglu_ffn"] = GEGLU_PER_UNET * calls
            if x[name]["launches"] != want or not calls:
                bad.append(f"{name} rank {rank} launched "
                           f"{x[name]['launches']} in {calls} UNet calls")
            if tp and 4 not in x[name]["local_heads"]:
                bad.append(f"{name} rank {rank} local heads "
                           f"{x[name]['local_heads']}")
            if "fp32" in name:
                off = px["max"] > 1
            elif tp:
                off = px["mean"] > MESH_TP_MEAN
            else:      # bf16: a rank samples one at a time, as txt2img_n1
                out[f"{name}_vs_n1_r{rank}"] = n1 = _pixels(
                    x[name]["images"], r0["txt2img_n1"]["images"])
                off = n1["max"] > 1 or px["mean"] > \
                    MESH_PLAIN_MEAN * out["plain_route"]["mean"]
            if off:
                bad.append(f"{name} rank {rank} pixels")
        if r0[name]["files"] != ref["files"] or r1[name]["files"]:
            bad.append(f"{name} wrote {r0[name]['files']} / "
                       f"{r1[name]['files']}")
    # one tensor-parallel FF block on #6 against the whole plain block
    for rank, x in enumerate((r0, r1)):
        blk = x["geglu_tp_block"]
        out[f"geglu_tp_block_r{rank}"] = {
            k: blk[k] for k in ("max_abs_err", "scale", "launches")}
        if not blk["max_abs_err"] <= GEGLU_F32_REL_TOL * blk["scale"] \
                or blk["launches"] != {"geglu_ffn": 1}:
            bad.append(f"geglu_tp_block rank {rank}")
    if bad:
        raise RuntimeError(f"mesh: {'; '.join(bad)}: {json.dumps(out)}")
    return out


def phase_mesh():
    """``cli/train.py --mesh/--fsdp`` and ``cli/txt2img.py --mesh/--tp`` at
    full width through ``torchrun`` (module docstring, phase 17).  -> the
    ranks' records, the checks' figures and the phase's wall."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {}
    try:
        write_face_pickle(os.path.join(work, "faces"),
                          os.path.join(REPO, "configs", "aigc_id.yaml"), 512)
        for task, nproc, check in (("nccl1", 1, check_mesh_nccl1),
                                   ("gloo2", 2, check_mesh_gloo2)):
            torch.cuda.empty_cache()
            t = time.perf_counter()
            torchrun(nproc, [task, work, "--steps", str(MESH_TRAIN_STEPS)],
                     MESH_TIMEOUT_S)
            ranks = [_by_run(torch.load(os.path.join(
                work, f"{task}_rank{r}.pt"), weights_only=False))
                for r in range(nproc)]
            out[task] = {"ranks": ranks, "wall_s": time.perf_counter() - t,
                         "checks": check(ranks)}
            log("mesh", f"{task}: {out[task]['wall_s']:.1f} s; checks "
                        f"{json.dumps(out[task]['checks'])}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_wall_s"] = time.perf_counter() - t0
    log("mesh", f"phase {out['phase_wall_s']:.1f} s")
    return out


def mesh_launches(mesh, kernel):
    """A kernel's launches in the mesh phase's runs of a path, by task, run
    and rank (not the FF block held against its plain version)."""
    return {f"mesh_{task}_{name}_r{r}": rec["launches"].get(kernel, 0)
            for task in ("nccl1", "gloo2")
            for r, ranks in enumerate(mesh[task]["ranks"])
            for name, rec in ranks.items() if name != "geglu_tp_block"}


def mesh_summary(mesh):
    """The mesh phase's ms a step by rank, peaks, gloo's collective seconds
    and walls."""
    med = lambda xs: round(float(np.median(xs[1:])), 1) if xs else None
    out = {"phase_s": round(mesh["phase_wall_s"], 1)}
    for task in ("nccl1", "gloo2"):
        for r, ranks in enumerate(mesh[task]["ranks"]):
            for name, rec in ranks.items():
                out[f"{task}_{name}_r{r}"] = {
                    "wall_s": round(rec["wall_s"], 1),
                    "step_ms": med(rec.get("step_ms", [])),
                    "peak_gib": round(rec.get("peak_gib", 0), 2),
                    "collective_s": round(rec["collective_s"], 2)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_env()
    instantiations = phase_build()
    shapes = phase_kernels()
    train_shapes = phase_train_kernels()
    geglu_shapes = phase_geglu_kernels()
    int8_shapes, int8_quotients = phase_int8_kernels()
    phase_parity()
    phase_train_parity()
    launches, request_ms = phase_serve()
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        align, align_files = phase_align(work)
        align_train = phase_align_train(work, align_files, t_start)
        checkpoints, checkpoint = phase_checkpoint(work)
        train_launches, train_ms = phase_train()
        cli_launches, cli = train_cli(work, checkpoints)
        ti = phase_ti(work, checkpoints)
        for path in checkpoints.values():
            os.remove(path)
        for name, r in cli.items():
            train_ms.update({f"{name}_ms": r["median_step_ms"],
                             f"{name}_data_wait_ms": r["median_data_wait_ms"],
                             f"{name}_peak_gib": r["peak_gib"]})
        cli_ckpt = os.path.join(work, f"embeddings_gs-{CLI_STEPS}.pt")
        generate = phase_generate(work, cli_ckpt)
        evaluate = phase_evaluate(work, cli_ckpt, align_files)
        torch.cuda.empty_cache()
        legacy = phase_legacy(work)
        torch.cuda.empty_cache()
        legacy_train = phase_legacy_train(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    warmup = phase_warmup()
    mesh = phase_mesh()

    kernels = []
    for entry, replaces in KERNELS.items():
        main_shape = shapes[entry][0]          # N = M = 4096, D = 40, bf16
        by_path = {"serve": launches[entry], "train": train_launches[entry]}
        if entry == "flash_attention_nhd":
            by_path.update({name: r["launches"].get(entry, 0)
                            for name, r in generate.items()})
            by_path.update({f"train_{name}": c[entry]
                            for name, c in cli_launches.items()})
            by_path.update({
                "ti_train": ti["launches"][entry]
                + ti["graph_vs_eager_launches"].get(entry, 0),
                "ti_txt2img": ti["txt2img"]["launches"][entry],
                "gen_imgs": evaluate["gen_imgs"]["launches"][entry],
                "eval_vit": evaluate["launches"][entry],
                "eval_scorer_turns": sum(
                    r["launches"].get(entry, 0)
                    for r in evaluate["scorer_turns"].values())})
        by_path.update({f"legacy_{name}": legacy[name]["launches"].get(
            entry, 0) for name in ("evaluate_model", "sample_diffusion",
                                   "sample_diffusion_vanilla", "inpaint")})
        by_path["classifier_eval"] = legacy_train["classifier"][
            "eval_turns"]["launches"].get(entry, 0)
        by_path.update(mesh_launches(mesh, entry))
        kernels.append({
            "name": entry, "route": "cuda", "source": FWD_SOURCE,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(s["max_abs_err"] for s in shapes[entry]),
            "max_err_ratio": max(s.get("err_ratio", 0.0)
                                 for s in shapes[entry]),
            "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": {k: main_shape[k] for k in "BHNMD"},
            # the bf16 inference instantiations at each padded head dim
            "per_head_dim": [r for r in instantiations["fwd"]
                             if not r["lse"]],
            # the scorer's ViT-B/32 attention (timed on the packed entry)
            "vit_eval": [{k: s[k] for k in (
                "B", "dtype", "kernel_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err")}
                for s in shapes[entry] if s["N"] == VIT_TOKENS
                and s["D"] == VIT_HEAD_DIM and "kernel_ms" in s],
            # the legacy family's shapes (CelebA-HQ AttentionBlocks, BERT)
            "legacy": [{k: s[k] for k in (
                "B", "H", "N", "D", "interleaved", "kernel_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "max_abs_err",
                "err_ratio")}
                for s in shapes[entry] if (s["B"], s["H"], s["N"], s["D"])
                in LEGACY_ATTN_SHAPES and "kernel_ms" in s],
            "shapes": shapes[entry]})
    main_shape = train_shapes[0]     # B = 2, N = M = 4096, D = 40, bf16, packed
    outputs = {"fwd_lse": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    for name, (source, replaces, _) in TRAIN_KERNELS.items():
        timed = main_shape[name]
        turns = legacy_train["celebahq"]["graph_vs_eager"]
        by_path = {"train": train_launches[name],
                   **{f"train_{run}": c[name]
                      for run, c in cli_launches.items()},
                   "ti_train": ti["launches"][name]
                   + ti["graph_vs_eager_launches"].get(name, 0),
                   "legacy_train_celebahq":
                       legacy_train["celebahq"]["launches"][name],
                   "legacy_train_celebahq_turns": int(sum(
                       r["launches_per_step"][name] * LEGACY_TRAIN_STEPS
                       for way in ("graph", "eager") for r in turns[way])),
                   "legacy_train_1p4b":
                       legacy_train["1p4b"]["launches"].get(name, 0),
                   "classifier":
                       legacy_train["classifier"]["launches"].get(name, 0),
                   "classifier_turns": legacy_train["classifier"][
                       "train_turns"]["launches"].get(name, 0),
                   **mesh_launches(mesh, name)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(s[f"{o}_max_abs_err"] for s in train_shapes
                               for o in outputs[name]),
            "max_err_ratio": max(s.get(f"{o}_err_ratio", 0.0)
                                 for s in train_shapes
                                 for o in outputs[name] if o != "lse"),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "shape": {k: main_shape[k] for k in "BHNMD"},
            # the bf16 instantiations at each padded head dim (fwd_lse: the
            # LSE ones of the forward's list)
            "per_head_dim": instantiations[name] if name != "fwd_lse" else
            [r for r in instantiations["fwd"] if r["lse"]],
            # the legacy train steps' shapes (CelebA-HQ AttentionBlocks on
            # interleaved views, BERT packed) and a CelebA-HQ step's launches
            "legacy_train": [dict({k: s[k] for k in ("layout", *"BHNMD")},
                                  **s[name]) for s in train_shapes
                             if "kernel_ms" in s.get(name, {})
                             and (s["B"], s["H"], s["N"], s["M"], s["D"],
                                  s["layout"]) in LEGACY_TRAIN_SHAPES],
            "launches_per_celebahq_step": {
                way: {n: legacy_train["celebahq"][key].get(n, 0)
                      for n in (name, "dkv_reduce")[:1 + (name == "dkv")]}
                for way, key in (("predicted", "predicted_per_step"),
                                 ("measured", "launches_per_step"))},
            "launches_per_1p4b_step": {
                way: {n: legacy_train["1p4b"][key].get(n, 0)
                      for n in (name, "dkv_reduce")[:1 + (name == "dkv")]}
                for way, key in (("predicted", "predicted_per_step"),
                                 ("measured", "launches_per_step"))},
            "shapes": [dict({k: s[k] for k in ("layout", "dtype", "q_scale",
                                               *"BHNMD")}, **s.get(name, {}))
                       for s in train_shapes]})
    for name, replaces in GEGLU_KERNELS.items():
        recs = geglu_shapes[name]
        main_shape = recs[0]              # 16384 x 320, bf16: 64^2, serving
        kernels.append({
            "name": name, "route": "cuda", "source": GEGLU_SOURCE,
            "replaces": replaces,
            # geglu_block: the serving and training runs on the GEGLU kernel
            # route; geglu_ffn: tensor-parallel sampling on that route (the
            # mesh phase; the kernels phase's launches are apart)
            "launches": (launches["geglu_block"]
                         + train_launches["geglu_block"])
            if name == "geglu_block" else sum(
                mesh_launches(mesh, "geglu_ffn").values()),
            "launches_by_path": {k: v for k, v in mesh_launches(
                mesh, name).items() if v},
            "kernels_phase_launches": len(recs),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "max_err_ratio": max(r.get("err_ratio", 0.0) for r in recs),
            "max_mean_err": max(r.get("mean_err", 0.0) for r in recs),
            "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
            "xla_route_ms": main_shape["xla_route_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "library_call": "the block's two F.linear products alone",
            "shape": {k: main_shape[k] for k in ("rows", "C", "dtype")},
            "shapes": recs})
    main_shape = int8_shapes[1]           # 16384 x 320 -> 2560, bf16: FF in
    kernels.append({
        "name": "int8_matmul", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES,
        "launches": 0,                    # on no path: kernels phase only
        # the checked launches, as the counter saw them (not the timed ones)
        "kernels_phase_launches": sum(r["launches"] for r in int8_shapes)
        + int8_quotients["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in int8_shapes),
        "all_equal": all(r["equal"] for r in int8_shapes),
        "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_int_mm_ms"],
        "library_call": "torch._int_mm on the quantised x, without the "
                        "quantisation and the dequantisation",
        "shape": {k: main_shape[k] for k in ("M", "K", "N", "dtype")},
        "plan": main_shape["plan"],
        "instantiations": instantiations["int8"]["kernels"],
        # each timed shape: kernel, _int_mm, bound and plain ms, the plan
        "timed": [{k: r[k] for k in ("M", "K", "N", "kernel_ms",
                                     "library_int_mm_ms", "bound_ms",
                                     "bound_by", "plain_ms")}
                  | {"variant": r["plan"]["variant"]}
                  for r in int8_shapes if "kernel_ms" in r],
        "shapes": int8_shapes})
    generate_ms = {n: round(r["wall_ms"], 1) for n, r in generate.items()}
    log("done", f"{time.perf_counter() - t_start:.0f} s in all; request ms "
                f"({DDIM_STEPS} DDIM steps) {json.dumps(request_ms)}; train "
                f"step {json.dumps(train_ms)}; TI step "
                f"{ti['median_step_ms']:.1f} ms (Trainer.fit uncached "
                f"{train_ms['uncached_ms']:.1f}); checkpoint "
                f"{json.dumps(checkpoint)}; generate wall ms "
                f"{json.dumps(generate_ms)}; ti txt2img wall ms "
                f"{ti['txt2img']['wall_ms']:.1f}; gen_imgs wall ms "
                f"{evaluate['gen_imgs']['wall_ms']:.1f}; eval_imgs "
                f"{evaluate['scoring_s']:.1f} s (forwards uncaptured "
                f"{evaluate['eager_scoring_s']:.1f} s; with the cropper "
                f"{evaluate['cropped_scoring_s']:.1f} s); scorer forward ms "
                f"graph / eager "
                f"{json.dumps({n: (r['ms_graph'], r['ms_eager']) for n, r in evaluate['scorer_turns'].items()})}; align "
                f"{ALIGN_PHOTOS} photos {json.dumps(align['wall_s'])} s, ms "
                f"per photo {json.dumps(align['stage_ms_per_photo'])}; "
                f"align_train ms a step: PIPNet ResNet-101 "
                f"{align_train['pipnet_r101']['median_ms']:.1f}, GSSL "
                f"ResNet-18 {align_train['gssl_r18']['median_ms']:.1f}; "
                f"phase {align_train['phase_wall_s']:.1f} s; ms on the graph "
                f"vs eagerly "
                f"{json.dumps(graph_summary(request_ms, train_ms, ti))}; "
                f"cli/warmup.py {warmup['wall_s']:.1f} s (train step graph "
                f"{warmup['train_s']:.1f} s, txt2img graph "
                f"{warmup['txt2img_s']:.1f} s); legacy "
                f"{json.dumps(legacy_summary(legacy))}; legacy_train "
                f"{json.dumps(legacy_train_summary(legacy_train))}; mesh "
                f"{json.dumps(mesh_summary(mesh))}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
