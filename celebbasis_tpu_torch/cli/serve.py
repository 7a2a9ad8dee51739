"""Persistent txt2img serving daemon (counterpart of
``celebbasis_tpu/cli/serve.py``).

Loads the assembly once, optionally warms the prompt->pixels path at startup,
then serves requests over plain HTTP (``http.server`` from the stdlib):

    GET  /healthz            -> {"ok": true, "warm": true, ...}
    POST /txt2img  {"prompt": "...", "seed": 1, "ids": [0,1],
                    "n_samples": 2}
                             -> {"images": [<base64 PNG>...], "ms": ...}
    POST /faces2img {"prompt": "...", "faces": [<base64 image>...],
                     "seed": 1, "n_samples": 1}
                             -> {"images": [...], "ms": ...}
                     live-face personalisation: the identity embeddings come
                     from a MetaIdNet forward on the uploaded aligned crops
                     (``test_mode='image'``), one face per placeholder slot

**Continuous batching**: concurrent /txt2img requests are coalesced into one
device call.  A batcher thread drains the queue into up to ``--batch`` rows
(mixed prompts/seeds/ids per row; requests queue up naturally during the
previous device call).  Every sample row draws from its own generator seeded
from ``(seed, sample_idx)``, so a request's pixels are identical whatever it
is batched with and wherever it lands in the batch.  Requests larger than
``--batch`` are rejected with 400.

The batcher thread runs the /txt2img device calls; HTTP threads only
enqueue those jobs and wait.  A /faces2img request runs in its own HTTP
thread, outside the batcher; the service's lock, which the batcher holds
around its device call too, keeps one device call at a time.  ``--plms``
selects the PLMS sampler for both routes.

Usage:
    python -m celebbasis_tpu_torch.cli.serve --config configs/aigc_id.yaml \
        --embedding_path logs/.../embeddings_gs-800.pt --port 8310
Runs on ``cuda``; ``--device cpu`` asks for the CPU on purpose.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from celebbasis_tpu_torch.diffusion.sampler import sample_seed
from celebbasis_tpu_torch.ops import geglu
from celebbasis_tpu_torch.ops.attention import resolved_impl


class _Job:
    __slots__ = ("prompt", "seed", "ids", "n", "event", "result", "error")

    def __init__(self, prompt, seed, ids, n):
        self.prompt, self.seed, self.ids, self.n = prompt, seed, ids, n
        self.event = threading.Event()
        self.result = None
        self.error = None


class TxtToImgService:
    """Owns the assembly; a single batcher thread owns the device."""

    def __init__(self, args, start_batcher: bool = True, spec=None):
        from celebbasis_tpu_torch.loader import assemble
        from celebbasis_tpu_torch.utils.config import load_run_spec

        if spec is None:
            spec = load_run_spec(args.config)
        self.asm = assemble(
            spec, sd_ckpt=args.ckpt, vocab_path=args.vocab,
            embedding_ckpt=args.embedding_path, image_size=args.H,
            seed=args.seed, device=args.device,
            param_dtype=torch.bfloat16 if args.precision == "bf16" else None)
        self.device = self.asm.device
        self.sampler = "plms" if args.plms else "ddim"
        sampler_args = dict(
            num_steps=args.ddim_steps, guidance_scale=args.scale,
            eta=args.ddim_eta, image_size=args.H, sampler=self.sampler,
            output="uint8")
        self.fn = self.asm.pipeline.make_txt2img_fn(**sampler_args)
        self.faces_fn = self.asm.pipeline.make_txt2img_faces_fn(
            self.asm.meta_net, **sampler_args)
        self.batch = args.batch
        self.k = len(self.asm.pipeline.manager_cfg.placeholder_token_ids)
        self.default_ids = list(args.ids)
        self.image_size = args.H
        self.steps = args.ddim_steps
        self.window = args.batch_window_ms / 1e3
        self._lock = threading.Lock()    # one device call at a time
        self._queue: "queue.Queue[_Job|None]" = queue.Queue()
        self._carry: _Job | None = None  # job that didn't fit the last batch
        self._uncond = None              # cached "" token batch
        self.warm = False
        self.requests = 0
        self.batched_calls = 0
        self.batched_rows = 0
        self._batcher = threading.Thread(target=self._batch_loop,
                                         daemon=True, name="batcher")
        if start_batcher:
            self._batcher.start()

    def warmup(self):
        """Captures the /txt2img and the /faces2img graphs at the daemon's
        one fixed batch (the JAX daemon compiles both at start-up): every
        later request replays them."""
        self.generate("a photo of a person", seed=0)
        size = self.image_size
        self.generate_faces("a photo of a person",
                            [np.zeros((size, size, 3), np.uint8)] * self.k,
                            seed=0)
        self.warm = True

    def stop(self):
        self._queue.put(None)

    # -- continuous batcher -------------------------------------------------
    def _next_job(self, timeout):
        if self._carry is not None:
            job, self._carry = self._carry, None
            return job
        return self._queue.get(timeout=timeout)

    def _batch_loop(self):
        while True:
            job = self._next_job(timeout=None)
            if job is None:
                return
            jobs, rows = [job], job.n
            deadline = time.perf_counter() + self.window
            while rows < self.batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._next_job(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_batch(jobs)
                    return
                if rows + nxt.n > self.batch:
                    self._carry = nxt   # head-of-line for the next batch
                    break
                jobs.append(nxt)
                rows += nxt.n
            self._run_batch(jobs)

    def _run_batch(self, jobs):
        try:
            prompts, ids_rows, nids, seeds = [], [], [], []
            for job in jobs:
                row = (list(job.ids) + [0] * self.k)[:self.k]
                for j in range(job.n):
                    prompts.append(job.prompt)
                    ids_rows.append(row)
                    nids.append(len(job.ids))
                    seeds.append(sample_seed(job.seed, j))
            pad = self.batch - len(prompts)      # one fixed batch shape
            prompts += [""] * pad
            ids_rows += [[0] * self.k] * pad
            nids += [0] * pad
            seeds += [0] * pad
            dev = self.device
            as_dev = lambda a: torch.from_numpy(
                np.asarray(a, np.int64)).to(dev)
            tokens = as_dev(self.asm.tokenizer(prompts))
            if self._uncond is None:
                self._uncond = as_dev(self.asm.tokenizer([""] * self.batch))
            gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
            with self._lock:
                imgs = self.fn(self.asm.manager_state, self.asm.basis, tokens,
                               self._uncond, as_dev(ids_rows), as_dev(nids),
                               gens)
                imgs = imgs.cpu().numpy()        # waits for the device
                self.batched_calls += 1
                self.batched_rows += self.batch - pad
                self.requests += len(jobs)
            at = 0
            for job in jobs:
                job.result = imgs[at:at + job.n]
                at += job.n
                job.event.set()
        except Exception as e:               # noqa: BLE001 -- report to caller
            for job in jobs:
                job.error = e
                job.event.set()

    # -- request API --------------------------------------------------------
    def generate(self, prompt: str, seed: int = 42, ids=None,
                 n_samples: int = 1) -> np.ndarray:
        """-> (n_samples, H, W, 3) uint8 pixels (quantised on the device).
        Sample j of a request draws from a generator seeded from
        ``(seed, j)``: deterministic across batch compositions."""
        if not (1 <= n_samples <= self.batch):
            raise ValueError(
                f"n_samples must be in [1, {self.batch}] (fixed batch "
                f"shape); got {n_samples}")
        job = _Job(prompt, int(seed),
                   list(self.default_ids if ids is None else ids), n_samples)
        self._queue.put(job)
        job.event.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def generate_faces(self, prompt: str, faces_u8, seed: int = 42,
                       n_samples: int = 1) -> np.ndarray:
        """Live-face personalisation: ``faces_u8``, k (H, W, 3) uint8 aligned
        crops of any size, one per placeholder slot (``ids = arange(k)``).
        They are resized to the service's image size and normalised to
        [-1, 1] on the device.  -> (n_samples, H, W, 3) uint8; sample j draws
        from a generator seeded from ``(seed, j)``, as on /txt2img.  The call
        is padded to the fixed batch and to every placeholder slot (blank
        crops past the k given, which ``num_ids = k`` leaves out of the
        prompt), so that every request replays one graph."""
        from torch.nn import functional as F

        if not (1 <= n_samples <= self.batch):
            raise ValueError(f"n_samples must be in [1, {self.batch}]; got "
                             f"{n_samples}")
        k = len(faces_u8)
        if not 1 <= k <= self.k:
            raise ValueError(f"faces: 1 to {self.k} crops (one per "
                             f"placeholder slot); got {k}")
        dev, size, B, n = self.device, self.image_size, self.batch, n_samples
        as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
        tokens = as_dev(self.asm.tokenizer([prompt] * n + [""] * (B - n)))
        if self._uncond is None:
            self._uncond = as_dev(self.asm.tokenizer([""] * B))
        ids = as_dev(np.tile(np.arange(self.k), (B, 1)))
        num_ids = as_dev([k] * n + [0] * (B - n))
        seeds = [sample_seed(seed, j) for j in range(n)] + [0] * (B - n)
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
        with self._lock:
            crops = []
            for face in faces_u8:
                x = torch.from_numpy(np.ascontiguousarray(face)).to(dev)
                x = x.permute(2, 0, 1)[None].float()
                if x.shape[-2:] != (size, size):
                    x = F.interpolate(x, size=(size, size), mode="bilinear",
                                      antialias=True, align_corners=False)
                crops.append(x[0].permute(1, 2, 0) / 127.5 - 1.0)
            crops += [torch.zeros_like(crops[0])] * (self.k - k)
            faces = torch.stack(crops)[None].expand(B, self.k, size, size, 3)
            imgs = self.faces_fn(self.asm.basis, tokens, self._uncond, faces,
                                 ids, num_ids, gens)
            imgs = imgs[:n].cpu().numpy()
            self.requests += 1
        return imgs


def decode_faces(b64_list) -> list:
    """Base64 images (PNG, JPEG, ... as PIL reads them) -> a list of
    (H, W, 3) uint8 arrays."""
    from PIL import Image

    if not isinstance(b64_list, list) or not b64_list:
        raise ValueError("faces must be a non-empty list of base64 images")
    try:
        return [np.array(Image.open(io.BytesIO(base64.b64decode(b)))
                         .convert("RGB"), np.uint8) for b in b64_list]
    except OSError as e:         # PIL's "cannot identify image file"
        raise ValueError(f"faces: {e}") from e


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0, one IDAT), with the
    stdlib alone."""
    arr = np.ascontiguousarray(img, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8; got {arr.shape}")
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * 3)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def _png_b64(img: np.ndarray) -> str:
    return base64.b64encode(encode_png(img)).decode("ascii")


def make_handler(service: TxtToImgService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "ok": True, "warm": service.warm,
                    "batch": service.batch, "steps": service.steps,
                    "image_size": service.image_size,
                    "device": str(service.device),
                    "sampler": service.sampler,
                    "attention": resolved_impl(service.device),
                    "geglu": geglu.resolved_impl(service.device),
                    "requests": service.requests,
                    "batched_calls": service.batched_calls,
                    "batched_rows": service.batched_rows,
                })
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            if self.path not in ("/txt2img", "/faces2img"):
                return self._reply(404, {"error": "unknown path"})
            try:
                req = json.loads(body or b"{}")
                prompt = req["prompt"]
                t0 = time.perf_counter()
                if self.path == "/faces2img":
                    imgs = service.generate_faces(
                        prompt, decode_faces(req["faces"]),
                        seed=int(req.get("seed", 42)),
                        n_samples=int(req.get("n_samples", 1)))
                else:
                    imgs = service.generate(
                        prompt, seed=int(req.get("seed", 42)),
                        ids=req.get("ids"),
                        n_samples=int(req.get("n_samples", 1)))
                ms = (time.perf_counter() - t0) * 1e3
            except (KeyError, ValueError, TypeError) as e:
                return self._reply(400, {"error": str(e)})
            self._reply(200, {"images": [_png_b64(im) for im in imgs],
                              "ms": round(ms, 1)})

        def log_message(self, fmt, *a):
            print(f"[serve] {self.address_string()} {fmt % a}")

    return Handler


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, nargs="+",
                   default=["configs/aigc_id.yaml"])
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--embedding_path", type=str, default=None)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--scale", type=float, default=10.0)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--batch", type=int, default=2,
                   help="fixed batch; requests serve 1..batch samples, and "
                        "concurrent requests coalesce into one device call")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="how long the batcher waits for more requests after "
                        "the first before launching (requests also pile up "
                        "naturally during the previous device call)")
    p.add_argument("--ids", type=int, nargs="+", default=[0, 1])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (fails without a card); 'cpu' runs "
                        "on the CPU on purpose")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8310)
    p.add_argument("--no-warmup", action="store_true")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    service = TxtToImgService(args)
    if not args.no_warmup:
        print("[serve] warming the sampling path (builds the CUDA kernel at "
              "first use)...")
        t0 = time.perf_counter()
        service.warmup()
        print(f"[serve] warm in {time.perf_counter() - t0:.1f}s")
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(service))
    print(f"[serve] listening on http://{args.host}:{httpd.server_address[1]}"
          f" (batch={args.batch}, {args.ddim_steps} {service.sampler} "
          f"steps, "
          f"{service.device}, attention route "
          f"{resolved_impl(service.device)}, GEGLU route "
          f"{geglu.resolved_impl(service.device)})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
        httpd.shutdown()
        service.stop()


if __name__ == "__main__":
    main()
