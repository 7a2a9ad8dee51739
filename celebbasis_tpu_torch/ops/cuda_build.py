"""Build-and-load for the package's hand-written CUDA kernels.

Each kernel source under ``celebbasis_tpu_torch/csrc/`` has a plain C
interface and includes no PyTorch headers, so ``nvcc`` turns it into a shared
library in seconds; ``ctypes`` loads it.  The build happens at first use (never
at import), from the sources in the package alone, into
``celebbasis_tpu_torch/_build/``.  The library name carries a hash of the
source, of the headers beside it and of the flags, so an edited source is
rebuilt and a finished build is reused.  A failed build raises with the
compiler's output; a finished one keeps ``ptxas``'s report (registers, shared
memory and spills per kernel) in ``ptxas_report`` and ``ptxas_kernels``;
``sass_counts`` counts an instruction in each kernel of a built library.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_ptxas: Dict[str, str] = {}
_sms: Dict[object, int] = {}


def build_dir() -> str:
    return os.path.join(PACKAGE_DIR, "_build")


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels of celebbasis_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  Safe against concurrent builds: the
    compiler writes to a private name that is renamed into place."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {name}.cu\n"
            f"$ {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    _ptxas[name] = proc.stderr
    return out


def build_all(names) -> Dict[str, str]:
    """Builds several sources at once, one ``nvcc`` each, all started
    together; returns name -> library path."""
    results: Dict[str, object] = {}

    def one(name):
        try:
            results[name] = build(name)
        except Exception as e:   # noqa: BLE001 -- re-raised below
            results[name] = e

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in results.values():
        if isinstance(r, Exception):
            raise r
    return {n: results[n] for n in names}


def ptxas_report(name: str) -> Dict[str, int]:
    """What ``ptxas -v`` said when this process built ``csrc/<name>.cu``:
    the number of kernels, the most registers a thread of any kernel uses and
    the bytes of spill stores and loads, summed.  Empty if the library was
    built by an earlier process."""
    text = _ptxas.get(name)
    if text is None:
        return {}
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spill_bytes": sum(spills)}


def ptxas_kernels(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of ``csrc/<name>.cu``, what ``ptxas -v``
    said when this process built it: registers a thread, static shared
    bytes, bytes of spill stores plus loads, and ``wgmma_serialized`` (1 if
    ptxas made each wgmma wait for the one before it, its "Potential
    Performance Loss" note).  Empty if the library was built by an earlier
    process."""
    out: Dict[str, Dict[str, int]] = {}
    kernel = None
    text = _ptxas.get(name, "")
    serialized = set(re.findall(
        r"wgmma\.mma_async instructions are serialized.*?function '(\w+)'",
        text))
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            out[kernel] = {"registers": 0, "smem_bytes": 0, "spill_bytes": 0,
                           "wgmma_serialized": int(kernel in serialized)}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[kernel]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[kernel]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def sass_counts(name: str, opcode: str) -> Dict[str, int]:
    """Per kernel (mangled name) of the built library of ``csrc/<name>.cu``:
    how many SASS instructions start with `opcode` (e.g. ``"HGMMA"``), read
    with the toolkit's ``cuobjdump --dump-sass``."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", library_path(name)],
                          capture_output=True, text=True, check=True).stdout
    out: Dict[str, int] = {}
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            kernel = m.group(1)
            out[kernel] = 0
        elif kernel is not None and re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?" + opcode, line):
            out[kernel] += 1
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached): what a wrapper
    sizes its grid splits by."""
    import torch

    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


class Entry:
    """A C entry ``int name(args..., cudaStream_t)`` of ``csrc/<library>.cu``,
    bound at its first call (never at import).  ``error_fn`` names the
    library's ``const char* f(int)`` that explains a non-zero result."""

    def __init__(self, library: str, name: str, argtypes, error_fn: str):
        self.library, self.name = library, name
        self.argtypes, self.error_fn = list(argtypes), error_fn
        self._fns = None

    def bind(self):
        """(entry, error function), the library built and loaded first."""
        if self._fns is None:
            lib = load(self.library)
            fn = getattr(lib, self.name)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            err = getattr(lib, self.error_fn)
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            self._fns = (fn, err)
        return self._fns

    def __call__(self, device, *args) -> None:
        """Launch on `device`'s current stream; raises if the launch is
        refused."""
        import torch

        fn, err = self.bind()
        if device.index == torch.cuda.current_device():
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed ({rc}): "
                               f"{err(rc).decode()}")
