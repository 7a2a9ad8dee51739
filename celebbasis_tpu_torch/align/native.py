"""Build-and-load for the alignment path's host C++ (``native/*.cpp``).

Each source has a plain C interface; ``g++`` turns it into a shared library
at first use (never at import) in ``celebbasis_tpu_torch/_build/``, and
``ctypes`` loads it.  The code is tuned for the host (``-march=native``, as
the JAX package builds its NMS), so the library name carries a hash of the
source, of the flags and of what ``-march=native`` means on this host: an
edited source, or the same checkout on another CPU, is rebuilt, and a
finished build is reused.
A failed build raises with the compiler's output: nothing falls back to
another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Tuple

from celebbasis_tpu_torch.ops.cuda_build import PACKAGE_DIR, build_dir

NATIVE_DIR = os.path.join(PACKAGE_DIR, "native")
# -ffp-contract=off: the resampler reproduces another library's rounding,
# so the compiler may fuse no multiply-add that the source does not ask for
FLAGS: Dict[str, Tuple[str, ...]] = {
    "nms": ("-O3", "-march=native", "-shared", "-fPIC", "-pthread"),
    "cv_resample": ("-O2", "-march=native", "-ffp-contract=off", "-shared",
                    "-fPIC"),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_target: list = []


def _native_target() -> bytes:
    """The target options ``-march=native`` enables here, as g++ lists
    them."""
    if not _target:
        try:
            proc = subprocess.run(["g++", "-march=native", "-Q",
                                   "--help=target"], capture_output=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the alignment path builds "
                               "its host C++ at first use") from e
        _target.append(proc.stdout)
    return _target[0]


def library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(NATIVE_DIR, name + ".cpp"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS[name]).encode())
    h.update(_native_target())
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless it is built; -> the path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-std=c++17", *FLAGS[name], "-o", tmp,
           os.path.join(NATIVE_DIR, name + ".cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the alignment path builds "
                           f"native/{name}.cpp at first use") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {name}.cpp\n"
                           f"$ {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp``, built on the first call."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
