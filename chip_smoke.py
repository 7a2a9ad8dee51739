#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths once each at full Stable Diffusion v1 width
on random weights -- serving (``celebbasis_tpu_torch.cli.serve``) and
personalisation training (``celebbasis_tpu_torch.train``) -- and holds every
hand-written kernel against its plain PyTorch version.  Phases:

1. ``env``     the card, its power limit, torch / CUDA / nvcc versions;
2. ``build``   builds the kernel libraries from ``celebbasis_tpu_torch/csrc``,
               one ``nvcc`` per source, all started together, and records
               the bf16 backward's instantiation at each padded head dim
               (tiles, registers, spills, HGMMA in the SASS);
3. ``kernels`` the inference forward (both entry points) at the serving
               path's shapes, and the training forward (with logsumexp), dq
               and dk/dv kernels at the train step's shapes, against their
               plain versions (the error limit scales with the values
               compared), with device times, bounds and a library yardstick
               (``F.scaled_dot_product_attention`` and autograd through it,
               called here and nowhere in the port); the two GEGLU kernels
               (FF sub-block with and without LN and residual) at the
               serving and training shapes in bf16 and fp32, and
               ``int8_matmul`` at the UNet's projection shapes, bit for bit;
4. ``parity``  the tiny pipeline in fp32 through the kernel route and through
               the plain route (attention, then GEGLU): pixels agree within
               one level;
5. ``train_parity`` the tiny train step in fp32: loss and MLP gradients with
               attention, then GEGLU, on the kernel route against the plain
               route;
6. ``serve``   ``TxtToImgService`` on ``configs/aigc_id.yaml`` (bf16, 512x512,
               batch 2) behind the real ``ThreadingHTTPServer``: requests
               alone, co-batched, repeated, in both attention layouts, and
               with the GEGLU kernel route; the kernels' launch counters must
               account for every UNet call;
7. ``train``   ``Trainer.fit`` on ``configs/aigc_id.yaml`` (bf16 compute,
               512x512 images, batch 2, two 512x512 faces per sample,
               synthetic batches): a few uncached steps and two cached ones;
               losses, what moved and what stayed frozen, launch counters,
               the checkpoint, and one step's MLP gradient against the plain
               attention route; then the same gradient and a few uncached
               and cached steps with the GEGLU kernel route.

Exits non-zero if any phase fails or if there is no CUDA device.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line before
it is the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import base64
import ctypes
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
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
# the bf16 backward's padded head dims; at each, its dq and dk/dv kernels are
# wgmma instantiations
BWD_HEAD_DIMS = (48, 80, 160, 256)
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
# fp32: summation order only, over up to 5120 terms
GEGLU_F32_REL_TOL = 2e-5
# bf16: geglu.bf16_mean_error of the outputs against the plain version; on
# an H100 right kernels read at most 0.018 (the widest level), the exact erf
# GELU in place of the tanh form 0.117-0.121 (torch_scripts/mutation_check.sh)
GEGLU_BF16_MEAN_ERR = 0.05
# (M, K, N): the UNet's projections at batch 4 -- q/k/v/out at 64^2, FF in,
# FF out, 32^2 and 16^2 levels -- and a ragged case
INT8_SHAPES = ((16384, 320, 320), (16384, 320, 2560), (16384, 1280, 320),
               (4096, 640, 640), (1024, 1280, 1280), (100, 300, 77))
PEAK_INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core rate


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
    for mod in ("regex", "yaml", "PIL"):
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
    return bwd_instantiations()


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
    ptxas = cuda_build.ptxas_kernels("flash_attention_bwd")
    sass = {op: cuda_build.sass_counts("flash_attention_bwd", op)
            for op in ("HGMMA", "HMMA")}
    records = {"dq": [], "dkv": []}
    for dp in BWD_HEAD_DIMS:
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
            names = [n for n in sass["HGMMA"] if pattern in n]
            if len(names) != 1:
                raise RuntimeError(f"no single kernel {pattern} in the "
                                   f"library: {names}")
            rec = {"head_dim_padded": dp, **tiles[kernel],
                   "hgmma": sass["HGMMA"][names[0]],
                   "hmma": sass["HMMA"][names[0]],
                   "ptxas": ptxas.get(names[0], "not built by this process")}
            rec["instantiation"] = "wgmma" if rec["hgmma"] else "no wgmma"
            log("build", f"bwd {kernel} {json.dumps(rec)}")
            if not rec["hgmma"] or rec["hmma"]:
                raise RuntimeError(f"{pattern}: {rec['hgmma']} HGMMA and "
                                   f"{rec['hmma']} HMMA instructions")
            records[kernel].append(rec)
    return records


# -- phase 3 ------------------------------------------------------------------

def time_ms(fn, iters: int, repeats: int = 5):
    """Device time per call: `iters` calls are captured into one CUDA graph,
    so that its replay runs them back to back with no host between them
    (most of the serving shapes finish faster than the host can issue the
    next launch).  Returns (median, least) of `repeats` replays, by CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    readings = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(readings)), min(readings)


def bound(B, H, N, M, D, dtype):
    """Least time for the work: each input read once, the output written
    once, against the products' operations at the type's peak rate."""
    flops = 4.0 * B * H * N * M * D
    nbytes = (2.0 * B * N * H * D + 2.0 * B * M * H * D) * \
        torch.empty((), dtype=dtype).element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_shape(entry, B, H, N, M, D, dtype, timed, q_scale=1.0):
    """`q_scale` 1 gives logits of unit variance (a nearly flat softmax over
    many keys, outputs of a few hundredths); 4 gives a peaked softmax and
    outputs of unit scale at any M."""
    g = torch.Generator(device="cuda").manual_seed(N * 131 + M * 7 + D)
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
    log("kernels", f"{entry} {json.dumps(rec)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{entry} disagrees with its plain version at "
                           f"{rec}")
    return rec


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
        # ragged tiles on the long-sequence (128-row) path
        shapes.append(check_shape(entry, 1, 2, 1100, 333, 40, torch.bfloat16,
                                  timed=False))
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
    versions on one shape, `layout` "nhd" (packed) or "bhnd" (per-head views
    of packed buffers).  The backward is compared on the kernels' own o and
    lse, run twice (the bits must repeat), and o must equal the inference
    forward's bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(N * 131 + M * 7 + D + 1)
    mk = lambda L, scale=1.0: (torch.randn(B, L, H * D, device="cuda",
                                           generator=g) * scale).to(dtype)
    q, k, v, do = mk(N, q_scale), mk(M), mk(M), mk(N)
    heads = H
    if layout == "bhnd":
        q, k, v, do = (fa._split(x, H) for x in (q, k, v, do))
        heads = None
    to4 = (lambda x: x) if heads is None else (lambda x: fa._split(x, H))
    rec = {"layout": layout, "B": B, "H": H, "N": N, "M": M, "D": D,
           "q_scale": q_scale, "dtype": str(dtype).replace("torch.", "")}

    before = fa.launch_counts()
    o, lse = fa.flash_attention_lse(q, k, v, heads)
    infer = fa.flash_attention_nhd(q, k, v, H) if heads else \
        fa.flash_attention(q, k, v)
    delta = fa.flash_attention_delta(o, do, heads)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, heads, delta=delta)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, heads)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    launched = {n: after[n] - before[n] for n in TRAIN_KERNELS}
    if launched != {"fwd_lse": 1, "dq": 2, "dkv": 2}:
        raise RuntimeError(f"the wrappers did not launch their kernels: "
                           f"{launched}")
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
            sms = torch.cuda.get_device_properties(0).multi_processor_count
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
    return shapes


def geglu_inputs(rows, C, dtype, seed):
    """x, LN scale and bias, W1, b1, W2, b2 of one FF sub-block, the weights
    drawn like the UNet's nn.Linear ones and handed over as the module hands
    them: transposed views of (out, in) buffers in `dtype`, biases fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    inner = 4 * C
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


def check_geglu(entry, rows, C, dtype, timed):
    """One GEGLU kernel (`entry` "geglu_block" or "geglu_ffn") against its
    plain version: fp32 within GEGLU_F32_REL_TOL of the largest output; bf16
    by fa.bf16_error_ratio <= 1 and geglu.bf16_mean_error <=
    GEGLU_BF16_MEAN_ERR."""
    x, (lns, lnb), w1, b1, w2, b2 = geglu_inputs(rows, C, dtype,
                                                 rows * 7 + C)
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
    rec = {"rows": rows, "C": C, "inner": 4 * C,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "ref_max": ref.float().abs().max().item(),
           "splits": geglu._splits(x.device, dtype, rows, C, 4 * C)}
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
        y = torch.randn(rows, 4 * C, device="cuda").to(dtype)
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
    fp32, and a ragged row count; the serving shapes in bf16 are timed."""
    records = {}
    for entry in GEGLU_KERNELS:
        shapes = []
        for dtype in (torch.bfloat16, torch.float32):
            for rows, C in GEGLU_SERVE_SHAPES + GEGLU_TRAIN_SHAPES:
                shapes.append(check_geglu(entry, rows, C, dtype,
                                          timed=dtype == torch.bfloat16))
            shapes.append(check_geglu(entry, 100, 320, dtype, timed=False))
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
    """int8_matmul against its plain version: equal bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(M + 3 * K + 7 * N)
    w = torch.randn(K, N, device="cuda", generator=g) * K ** -0.5
    w_q, w_s = quant.quantize_per_channel(w)
    x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    before = quant.launch_counts()["int8_matmul"]
    out = quant.int8_matmul(x, w_q, w_s)
    torch.cuda.synchronize()
    if quant.launch_counts()["int8_matmul"] != before + 1:
        raise RuntimeError("int8_matmul: the wrapper did not launch its "
                           "kernels")
    ref = quant.int8_matmul_plain(x, w_q, w_s)
    rec = {"M": M, "K": K, "N": N, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "equal": torch.equal(out, ref),
           "ref_max": ref.float().abs().max().item()}
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


def phase_int8_kernels():
    return [check_int8(M, K, N, dtype, timed=dtype == torch.bfloat16
                       and M > 100)
            for dtype in (torch.bfloat16, torch.float32)
            for M, K, N in INT8_SHAPES]


# -- phase 4 ------------------------------------------------------------------

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

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("parity", "cudnn.allow_tf32 = matmul.allow_tf32 = False")
    try:
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

        fa.reset_launch_count()
        img_k = fn(state, basis, tokens, uncond, ids, num_ids, None, x_T=x_T)
        n_kernel = fa.launch_count()
        attn_ops.set_default_impl("xla")
        try:
            fa.reset_launch_count()
            img_p = fn(state, basis, tokens, uncond, ids, num_ids, None,
                       x_T=x_T)
            n_plain = fa.launch_count()
        finally:
            attn_ops.set_default_impl(None)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    geglu.set_default_impl("cuda")
    try:
        geglu.reset_launch_count()
        img_g = fn(state, basis, tokens, uncond, ids, num_ids, None, x_T=x_T)
        torch.cuda.synchronize()
        n_geglu = geglu.launch_counts()
    finally:
        geglu.set_default_impl(None)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
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

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
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
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    geglu.set_default_impl("cuda")
    try:
        loss_g, grad_g, n_g = loss_and_mlp_grad(loss_fn, meta, mstate, basis,
                                                batch, 7)
    finally:
        geglu.set_default_impl(None)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
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


def post(url, obj):
    req = urllib.request.Request(
        url + "/txt2img", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        return json.loads(r.read())


def phase_serve():
    from http.server import ThreadingHTTPServer

    from celebbasis_tpu_torch.cli.serve import (TxtToImgService,
                                                build_argparser, make_handler)
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
    log("serve", f"warm-up request: {time.perf_counter() - t0:.1f} s")

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

        os.environ["CELEBBASIS_FLASH_LAYOUT"] = "bhnd"
        ask("per_head_layout", p_a, 11)
        os.environ.pop("CELEBBASIS_FLASH_LAYOUT")
        calls_total = healthz(url)["batched_calls"] - calls0
        n_per_head = fa.launch_count("flash_attention")
        h = healthz(url)

        # the FF sub-blocks on the GEGLU kernel route
        geglu.set_default_impl("cuda")
        h_geglu = healthz(url)
        calls_g0 = h_geglu["batched_calls"]
        geglu.reset_launch_count()
        ask("geglu_cuda", p_a, 11)
        ask("geglu_cuda_repeat", p_a, 11)
        calls_geglu = healthz(url)["batched_calls"] - calls_g0
        n_geglu = geglu.launch_counts()
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
    want = ATTN_PER_UNET * DDIM_STEPS
    if n_packed != want * calls_packed or n_other != 0:
        raise RuntimeError(
            f"flash_attention_nhd launched {n_packed} times (and "
            f"flash_attention {n_other}) over {calls_packed} device calls; "
            f"expected {want} per call")
    if n_per_head != want * (calls_total - calls_packed) or n_per_head == 0:
        raise RuntimeError(f"flash_attention launched {n_per_head} times in "
                           f"the per-head layout; expected {want}")
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
    if n_geglu != {"geglu_block": GEGLU_PER_UNET * DDIM_STEPS * calls_geglu,
                   "geglu_ffn": 0} or calls_geglu != 2:
        raise RuntimeError(f"GEGLU launches {n_geglu} over {calls_geglu} "
                           f"device calls; expected {GEGLU_PER_UNET} per "
                           f"UNet call")
    if not np.array_equal(results["geglu_cuda_repeat"][0][0], img_g):
        raise RuntimeError("the GEGLU route does not repeat its pixels")
    return ({"flash_attention_nhd": n_packed, "flash_attention": n_per_head,
             "geglu_block": n_geglu["geglu_block"]},
            {name: ms for name, (_, ms) in results.items()})


# -- phase 7 ------------------------------------------------------------------

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
        state = trainer.fit(state)
        torch.cuda.synchronize()
        launches = fa.launch_counts()
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
        if launches != {n: c * TRAIN_STEPS
                        for n, c in TRAIN_LAUNCHES.items()}:
            raise RuntimeError(f"train: launches {launches} over "
                               f"{TRAIN_STEPS} steps; expected per step "
                               f"{TRAIN_LAUNCHES}")
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
        ctrainer.fit(cstate)
        torch.cuda.synchronize()
        c_launches = fa.launch_counts()
        with open(ctrainer.metrics_path) as f:
            crecs = [json.loads(line) for line in f]
        c_ms = [r["step_time_s"] * 1e3 for r in crecs]
        log("train", f"{len(crecs)} cached steps: ms per step "
                     f"{[round(x, 1) for x in c_ms]} (median of all but "
                     f"the first {float(np.median(c_ms[1:])):.1f}); losses "
                     f"{[round(r['loss'], 4) for r in crecs]}")
        # the cache's VAE encodes run no kernel of ours (head dim 512)
        if c_launches != {n: c * (CACHED_STEPS + 1)
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
                gtrainer.fit(gstate)
                torch.cuda.synchronize()
                got = {**fa.launch_counts(), **geglu.launch_counts()}
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
                want = {**{n: c * steps for n, c in TRAIN_LAUNCHES.items()},
                        "geglu_block": GEGLU_PER_UNET * steps,
                        "geglu_ffn": 0}
                if got != want or len(grecs) != steps \
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
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    return ({**launches, "geglu_block": geglu_launches},
            {"uncached_ms": float(np.median(step_ms[1:])),
             "cached_ms": float(np.median(c_ms[1:])),
             "peak_gib": peak / 2 ** 30, **geglu_ms})


# -----------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_env()
    bwd_kernels = phase_build()
    shapes = phase_kernels()
    train_shapes = phase_train_kernels()
    geglu_shapes = phase_geglu_kernels()
    int8_shapes = phase_int8_kernels()
    phase_parity()
    phase_train_parity()
    launches, request_ms = phase_serve()
    train_launches, train_ms = phase_train()

    kernels = []
    for entry, replaces in KERNELS.items():
        main_shape = shapes[entry][0]          # N = M = 4096, D = 40, bf16
        kernels.append({
            "name": entry, "route": "cuda", "source": FWD_SOURCE,
            "replaces": replaces, "launches": launches[entry],
            "max_abs_err": max(s["max_abs_err"] for s in shapes[entry]),
            "max_err_ratio": max(s.get("err_ratio", 0.0)
                                 for s in shapes[entry]),
            "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": {k: main_shape[k] for k in "BHNMD"},
            "shapes": shapes[entry]})
    main_shape = train_shapes[0]     # B = 2, N = M = 4096, D = 40, bf16, packed
    outputs = {"fwd_lse": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    for name, (source, replaces, _) in TRAIN_KERNELS.items():
        timed = main_shape[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": max(s[f"{o}_max_abs_err"] for s in train_shapes
                               for o in outputs[name]),
            "max_err_ratio": max(s.get(f"{o}_err_ratio", 0.0)
                                 for s in train_shapes
                                 for o in outputs[name] if o != "lse"),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "shape": {k: main_shape[k] for k in "BHNMD"},
            # dq, dkv: the bf16 instantiation at each padded head dim
            **({"per_head_dim": bwd_kernels[name]} if name in bwd_kernels
               else {}),
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
            # route; geglu_ffn is on no path of the port (nor of the JAX
            # package): only the kernels phase launches it
            "launches": (launches["geglu_block"]
                         + train_launches["geglu_block"])
            if name == "geglu_block" else 0,
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
        "kernels_phase_launches": len(int8_shapes),
        "max_abs_err": max(r["max_abs_err"] for r in int8_shapes),
        "all_equal": all(r["equal"] for r in int8_shapes),
        "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_int_mm_ms"],
        "library_call": "torch._int_mm on the quantised x, without the "
                        "quantisation and the dequantisation",
        "shape": {k: main_shape[k] for k in ("M", "K", "N", "dtype")},
        "shapes": int8_shapes})
    log("done", f"{time.perf_counter() - t_start:.0f} s in all; request ms "
                f"({DDIM_STEPS} DDIM steps) {json.dumps(request_ms)}; train "
                f"step {json.dumps(train_ms)}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
