#!/usr/bin/env python3
"""Where a bf16 GEGLU block call spends its cycles, phase by phase.

    python3 torch_scripts/geglu_phases.py [--root DIR]

Copies the package (and ``chip_smoke.py``) into a temporary directory,
instruments that copy's ``csrc/geglu.cu`` with ``clock64()`` timers around
the consumer warpgroups' barrier waits, wgmma waits and the GELU and y
exchange step, and around the producer's waits for free stages, builds it
and runs ``geglu_block`` at the SD v1 serving and training shapes.  Prints,
per shape, the CUDA-graph time of the instrumented kernel and the mean over
blocks of each timer in SM cycles: for each consumer warpgroup its total,
the waits for a stage's data (``full_wait``), for its wgmma (``wgmma_wait``),
the whole GELU step (``gelu``: after product 1 until the chunk's y is in
place) and, inside it, the arithmetic (``compute``), the wait for the row
tile's last product 2 (``yempty_wait``), the stores and copies
(``store_copy``) and the wait for the peers' pieces (``yfull_wait``); for the
producer its total and its waits for free stages.  The timers cost a few per
cent; the repository itself is never modified.  Needs an NVIDIA GPU and
nvcc.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((16384, 320), (4096, 640), (1024, 1280), (256, 1280), (8192, 320),
          (2048, 640), (512, 1280), (128, 1280))

RUN = r'''
import ctypes, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from celebbasis_tpu_torch.ops import cuda_build, geglu
fn = cuda_build.load("geglu").geglu_prof_read
fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]
buf = np.zeros((4096, 24), np.int64)
names = ["total", "full_wait", "wgmma_wait", "gelu", "yempty_wait",
         "yfull_wait", "compute", "store_copy"]
print(cs.smi_line())
for rows, C in %s:
    x, (lns, lnb), w1, b1, w2, b2 = cs.geglu_inputs(rows, C, torch.bfloat16, 1)
    run = lambda: geglu.geglu_block(x, lns, lnb, w1, b1, w2, b2, impl="cuda")
    ms = cs.time_ms(run, 10)[0]
    run()
    torch.cuda.synchronize()
    assert fn(buf.ctypes.data) == 0
    how = geglu.plan(x.device, torch.bfloat16, rows, C, 4 * C)
    n = how["row_tiles"] * how["cluster"] * how["splits"]
    a = buf[:n].astype(np.float64)
    print(f"{rows}x{C}: {ms:.4f} ms, K={how['cluster']} M={how['partners']} "
          f"splits={how['splits']} blocks={n}")
    for wg in range(2):
        print(f"  consumer warpgroup {wg}: " + ", ".join(
            f"{nm} {a[:, 8 * wg + i].mean():.0f}" for i, nm in enumerate(names)))
    print(f"  producer: total {a[:, 16].mean():.0f}, waits for free stages "
          f"{a[:, 17].mean():.0f}")
'''


# (code of csrc/geglu.cu, the same with timers, occurrences)
TIMERS = (
    ("namespace {\n\nusing namespace hopper;",
     "namespace {\n\nusing namespace hopper;\n"
     "__device__ long long g_prof[4096][24];", 1),
    ("    int it = 0, pending = -1;   // the stage of the batch still in flight",
     "    long long t_full = 0, t_wg = 0, t_gelu = 0, t_ye = 0, t_yf = 0,"
     " t_cmp = 0, t_st = 0;\n"
     "    const long long t_start = clock64();\n"
     "    int it = 0, pending = -1;", 1),
    ("        mbar_wait(&full[s], (it / STAGES) & 1);",
     "        { long long t0 = clock64(); mbar_wait(&full[s], (it / STAGES) & 1);"
     " t_full += clock64() - t0; }", 2),
    ("        wgmma_wait<1>();",
     "        { long long t0 = clock64(); wgmma_wait<1>();"
     " t_wg += clock64() - t0; }", 2),
    ("      wgmma_wait<0>();\n      fence_regs(hg);",
     "      { long long t0 = clock64(); wgmma_wait<0>();"
     " t_wg += clock64() - t0; }\n"
     "      fence_regs(hg);\n      const long long t_g0 = clock64();", 1),
    ("      if (c > 0) mbar_wait(yempty, (c - 1) & 1);",
     "      const long long t_c1 = clock64(); t_cmp += t_c1 - t_g0;\n"
     "      if (c > 0) mbar_wait(yempty, (c - 1) & 1);\n"
     "      const long long t_c2 = clock64(); t_ye += t_c2 - t_c1;", 1),
    ("      mbar_wait(yfull, c & 1);\n",
     "      const long long t_c3 = clock64(); t_st += t_c3 - t_c2;\n"
     "      mbar_wait(yfull, c & 1);\n"
     "      t_yf += clock64() - t_c3; t_gelu += clock64() - t_g0;\n", 1),
    ("    // epilogue: the rows and columns that exist",
     "    if (lane == 0 && w == 0) {\n"
     "      long long* g = g_prof[blockIdx.x + gridDim.x * blockIdx.y];\n"
     "      const long long v[8] = {clock64() - t_start, t_full, t_wg, t_gelu,"
     " t_ye, t_yf, t_cmp, t_st};\n"
     "      for (int i = 0; i < 8; ++i) g[8 * wg + i] = v[i];\n"
     "    }\n"
     "    // epilogue: the rows and columns that exist", 1),
    ("      int it = 0;\n      for (int c = 0; c < chunks; ++c) {",
     "      int it = 0;\n"
     "      long long t_empty = 0;\n"
     "      const long long t_pstart = clock64();\n"
     "      for (int c = 0; c < chunks; ++c) {", 1),
    ("          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);",
     "          if (it >= STAGES) { long long t0 = clock64();"
     " mbar_wait(&empty[s], (it / STAGES - 1) & 1);"
     " t_empty += clock64() - t0; }", 2),
    ("      }\n    }\n  } else {\n    regs_alloc<kConsumerRegs>();",
     "      }\n"
     "      long long* g = g_prof[blockIdx.x + gridDim.x * blockIdx.y];\n"
     "      g[16] = clock64() - t_pstart;\n"
     "      g[17] = t_empty;\n"
     "    }\n  } else {\n    regs_alloc<kConsumerRegs>();", 1),
)
READ = """
extern "C" int geglu_prof_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
"""


def instrument(path: str) -> None:
    """Adds the timers to a copy of geglu.cu; fails if the kernel no longer
    has the code they wrap."""
    with open(path) as f:
        s = f.read()
    for old, new, count in TIMERS:
        if s.count(old) != count:
            raise RuntimeError(f"geglu.cu has {s.count(old)} of {old!r}, "
                               f"expected {count}: update TIMERS")
        s = s.replace(old, new)
    with open(path, "w") as f:
        f.write(s + READ)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    work = tempfile.mkdtemp()
    try:
        shutil.copytree(os.path.join(args.root, "celebbasis_tpu_torch"),
                        os.path.join(work, "celebbasis_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(os.path.join(args.root, "chip_smoke.py"), work)
        instrument(os.path.join(work, "celebbasis_tpu_torch", "csrc",
                                "geglu.cu"))
        return subprocess.run([sys.executable, "-c", RUN % (SHAPES,)],
                              cwd=work).returncode
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
