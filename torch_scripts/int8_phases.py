#!/usr/bin/env python3
"""Cycles by phase of the int8 matmul's product kernel (bf16), from a
temporary copy of ``csrc/int8_matmul.cu`` with ``clock64`` stamps.

    python3 torch_scripts/int8_phases.py [M,K,N,mode ...]

The copy is written next to the source as ``int8_matmul_phases.cu``, built
and loaded as its own library, and deleted again; the repository's source is
never modified.  Thread 0 of each consumer warpgroup of block 0 stamps, for
each N tile: the start, the products issued (the K loop), the last products
waited for, the staging tile free (its last TMA store read) and ws read, the
dequantised values staged, the second barrier, and the TMA store issued;
thread 0 stamps the fused quantisation (x's TMA loads and the quantiser).
The stamps stand where the source's ``// phase: NAME`` marker lines are.
Prints, per shape (default: the three M = 16384 shapes of
``chip_smoke.INT8_TIMED`` in the plan's mode), the quantisation's cycles and
the mean cycles of each phase over the block's N tiles.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the "// phase: NAME" marker lines of csrc/int8_matmul.cu: the tile phases
# in order (each stamp ends the phase it names), then the fused quantisation
TILE_STAMPS = ("tile_start", "products_issued", "products_done",
               "staging_free", "values_staged", "second_barrier",
               "store_issued")
PHASES = TILE_STAMPS[1:]
QUANT_STAMPS = ("quantise_start", "quantise_end")
STAMP_FN = """
__device__ long long g_phase[2 * 32 * 8 + 2];
__device__ __forceinline__ void phase_stamp(int wg, int t, int k) {
  if (blockIdx.x == 0 && (threadIdx.x & 127) == 0 && t < 32)
    g_phase[wg * 256 + t * 8 + k] = clock64();
}
"""


def instrument(src: str) -> str:
    """The source with a stamp in place of each marker line; raises unless
    every marker is found once (the kernel changed: move the markers)."""
    include = '#include "hopper.cuh"\n'
    if src.count(include) != 1:
        raise RuntimeError("the source does not include hopper.cuh once")
    src = src.replace(include, include + STAMP_FN)
    stamps = {f"// phase: {name}": f"phase_stamp(wg, nt - nt0, {k});"
              for k, name in enumerate(TILE_STAMPS)}
    stamps.update({f"// phase: {name}":
                   f"if (blockIdx.x == 0 && tid == 0) g_phase[{512 + k}] = "
                   f"clock64();" for k, name in enumerate(QUANT_STAMPS)})
    lines = src.split("\n")
    for marker, stamp in stamps.items():
        at = [i for i, line in enumerate(lines) if line.strip() == marker]
        if len(at) != 1:
            raise RuntimeError(f"marker {marker!r} found {len(at)} times")
        lines[at[0]] = lines[at[0]].replace(marker, stamp)
    return "\n".join(lines) + (
        '\nextern "C" int int8_phases(long long* h) {\n'
        '  return cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n}\n')


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from celebbasis_tpu_torch.ops import cuda_build, quant
    import chip_smoke

    name = "int8_matmul_phases"
    path = os.path.join(cuda_build.CSRC_DIR, name + ".cu")
    with open(os.path.join(cuda_build.CSRC_DIR, "int8_matmul.cu")) as f:
        src = instrument(f.read())
    with open(path, "w") as f:
        f.write(src)
    try:
        lib = cuda_build.load(name)
    finally:
        os.remove(path)
    _VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = lib.int8_matmul_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = [_VP, _LL, _VP, _LL, _VP, _VP, _VP] + [_INT] * 5 + [_VP]
    read = lib.int8_phases
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.POINTER(_LL)]
    shapes = [tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]] or \
        [(M, K, N, -1) for M, K, N in chip_smoke.INT8_TIMED if M == 16384]
    print(chip_smoke.smi_line(), flush=True)
    for M, K, N, mode in shapes:
        g = torch.Generator(device="cuda").manual_seed(M + 3 * K + 7 * N)
        w_q, w_s = quant.quantize_per_channel(
            torch.randn(K, N, device="cuda", generator=g) * K ** -0.5)
        x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
        how = quant.plan(x.device, torch.bfloat16, M, N, K) if mode < 0 \
            else quant._forced_plan(x.device, torch.bfloat16, M, N, K,
                                    ("fused", "streamed")[mode])
        work = torch.empty(max(how["workspace_bytes"], 1), dtype=torch.uint8,
                           device="cuda")
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        wt, ws = w_q.t(), w_s.float().contiguous()
        for _ in range(3):   # the last run's stamps are read
            rc = fwd(x.data_ptr(), x.stride(0), wt.data_ptr(), wt.stride(0),
                     ws.data_ptr(), out.data_ptr(), work.data_ptr(), 1, M, N,
                     K, mode, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed ({rc})")
            torch.cuda.synchronize()
        if not torch.equal(out, quant.int8_matmul_plain(x, w_q, w_s)):
            raise RuntimeError("the instrumented copy disagrees")
        h = (_LL * 514)()
        if read(h):
            raise RuntimeError("reading the stamps failed")
        a = np.array(list(h), dtype=np.int64)
        rec = {"shape": f"{M}x{K}->{N}", "variant": how["variant"],
               "quantise_cycles": int(a[513] - a[512])
               if how["variant"] == "fused" else None}
        tiles = min(how["n_tiles"] // how["splits"], 32)
        for wg in (0, 1):
            st = a[wg * 256: wg * 256 + tiles * 8].reshape(tiles, 8)[:, :7]
            d = np.diff(st, axis=1)
            rec[f"wg{wg}_mean_cycles"] = dict(zip(
                PHASES, [float(v) for v in d.mean(axis=0)]))
            rec[f"wg{wg}_tile_cycles"] = float(np.diff(st[:, 0]).mean()) \
                if tiles > 1 else None
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
