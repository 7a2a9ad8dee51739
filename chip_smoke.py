#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``celebbasis_tpu_torch.cli.serve``) once at
full Stable Diffusion v1 width on random weights, and holds the hand-written
flash-attention kernel against its plain PyTorch version.  Phases:

1. ``env``     the card, its power limit, torch / CUDA / nvcc versions;
2. ``build``   builds the kernel library from ``celebbasis_tpu_torch/csrc``;
3. ``kernels`` both entry points of the kernel against their plain versions at
               the serving path's shapes (the error limit scales with
               the outputs compared), with device times, bounds and a library
               yardstick (``F.scaled_dot_product_attention``, called here and
               nowhere in the port);
4. ``parity``  the tiny pipeline in fp32 through the kernel route and through
               the plain route: pixels agree within one level;
5. ``serve``   ``TxtToImgService`` on ``configs/aigc_id.yaml`` (bf16, 512x512,
               batch 2) behind the real ``ThreadingHTTPServer``: requests
               alone, co-batched, repeated, and in both attention layouts; the
               kernel's launch counters must account for every UNet call.

Exits non-zero if any phase fails or if there is no CUDA device.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line before
it is the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import base64
import json
import os
import struct
import subprocess
import sys
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

REPO = os.path.dirname(os.path.abspath(__file__))
DDIM_STEPS = 50
ATTN_PER_UNET = 32           # 16 transformer blocks x (self + cross)
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

KERNELS = {
    "flash_attention_nhd": "celebbasis_tpu/ops/flash_attention.py:402",
    "flash_attention": "celebbasis_tpu/ops/flash_attention.py:158",
}


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

def phase_build() -> None:
    t0 = time.perf_counter()
    path = cuda_build.build("flash_attention_fwd")
    log("build", f"{os.path.relpath(path, REPO)} in "
                 f"{time.perf_counter() - t0:.1f} s")
    fa._kernel()   # load it, so a bad library fails here


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


# -- phase 5 ------------------------------------------------------------------

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
    finally:
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
    return ({"flash_attention_nhd": n_packed, "flash_attention": n_per_head},
            {name: ms for name, (_, ms) in results.items()})


# -----------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    shapes = phase_kernels()
    phase_parity()
    launches, request_ms = phase_serve()

    kernels = []
    for entry, replaces in KERNELS.items():
        main_shape = shapes[entry][0]          # N = M = 4096, D = 40, bf16
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "celebbasis_tpu_torch/csrc/flash_attention_fwd.cu",
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
    log("done", f"{time.perf_counter() - t_start:.0f} s in all; request ms "
                f"{json.dumps(request_ms)}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
