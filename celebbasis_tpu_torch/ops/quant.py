"""Int8 quantized matmul: per-row dynamic activation quantisation fused with
an int8 x int8 -> int32 product and fp32 dequantisation.

Counterpart of ``celebbasis_tpu/ops/quant.py``:

* ``quantize_per_channel`` -- symmetric per-output-channel int8 weights;
* ``int8_matmul`` -- ``x @ dequant(w_q)``: the kernel of
  ``csrc/int8_matmul.cu`` (the Pallas ``_kernel``) on CUDA tensors, which
  it launches or raises; ``int8_matmul_plain`` on CPU tensors.  Counter
  ``int8_matmul`` in ``launch_counts()``.  ``plan`` says how a call runs
  (the C entry ``int8_matmul_plan``): "fused" (one launch that quantises
  the rows itself) or "streamed" (a quantisation pass into a workspace,
  then the product);
* ``quantize_dense_tree`` -- rewrite the 2-D ``kernel`` leaves of a nested
  dict of tensors into ``kernel_q`` / ``kernel_scale`` pairs.

As in the JAX package nothing calls these on a model path: consumers look up
the quantized pair explicitly.  Inference only (no gradient).

The result is exact arithmetic up to the rounding the definition asks for:
``xs = max(max|x_row|, 1e-8) * fp32(1/127)`` over the whole row, ``xq =
clip(round_half_even(x / xs), -127, 127)``, an exact integer product, then
``(acc * xs) * ws`` in fp32 rounded to x's type.  So the kernel and its plain
version agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Tuple

import torch

from celebbasis_tpu_torch.ops import cuda_build

_launches = {"int8_matmul": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {"int8_matmul_fwd": cuda_build.Entry(
    "int8_matmul", "int8_matmul_fwd",
    [_VP, _LL, _VP, _LL, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT],
    "int8_matmul_error_string")}
LIBRARIES = ("int8_matmul",)
# the kernel's two modes (the C entries' mode 0 and 1; -1 is the plan's
# choice), as ``plan`` names them
_MODES = ("fused", "streamed")
PLAN_KEYS = ("mode", "splits", "row_tiles", "n_tiles", "k_chunks", "blocks",
             "stages", "staging_tiles", "group", "threads", "smem_bytes",
             "workspace_bytes")


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_count() -> None:
    _launches["int8_matmul"] = 0


def plan(device, dtype: torch.dtype, M: int, N: int, K: int) -> dict:
    """How the kernel runs a call of this type and shape on `device`, as
    ``int8_matmul_fwd`` itself decides it: the C entry ``int8_matmul_plan``
    (the one place the mode and tiling are chosen), keyed by ``PLAN_KEYS``,
    with ``variant`` the mode's name."""
    return _plan_dict(device, dtype, M, N, K, -1)


def _forced_plan(device, dtype: torch.dtype, M: int, N: int, K: int,
                 variant: str) -> dict:
    """``plan`` with the mode forced ("fused" or "streamed"), for the checks
    and timings that hold each mode; ValueError where it cannot run the
    shape."""
    return _plan_dict(device, dtype, M, N, K, _MODES.index(variant))


def _plan_dict(device, dtype, M, N, K, mode) -> dict:
    out = dict(zip(PLAN_KEYS, _plan(torch.device(device), dtype, M, N, K,
                                    mode)))
    out["variant"] = _MODES[out["mode"]]
    return out


@functools.lru_cache(maxsize=None)
def _plan_entry():
    fn = cuda_build.load("int8_matmul").int8_matmul_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [_INT] * 6 + [ctypes.POINTER(_LL)]
    return fn


@functools.lru_cache(maxsize=256)
def _plan(device, dtype, M, N, K, mode) -> tuple:
    """``int8_matmul_plan``'s numbers, asked once a device and shape."""
    out = (_LL * len(PLAN_KEYS))()
    if _plan_entry()(_DTYPE_CODE[dtype], M, N, K, mode,
                     cuda_build.sm_count(device), out) != 0:
        raise ValueError(f"int8_matmul_plan refused dtype={dtype} M={M} "
                         f"N={N} K={K} mode={mode}")
    return tuple(out)


def quantize_per_channel(w: torch.Tensor, axis: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> (int8 (K, N), scales (N,)), symmetric per output channel
    (``axis=1``; ``axis=0`` gives one scale per row).  With ``axis=1`` the
    int8 matrix is stored as its (N, K) transpose seen through ``.t()``,
    the layout the kernel reads in place."""
    absmax = w.abs().amax(dim=1 - axis, keepdim=True)
    # a true division on every device (on a GPU, PyTorch multiplies by the
    # reciprocal of a Python-number divisor)
    scale = absmax.clamp_min(1e-8) / torch.tensor(127.0, device=w.device)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    if axis == 1:
        q = q.t().contiguous().t()
    return q, scale.reshape(-1).float()


# The JAX kernel's ``max(absmax, 1e-8) / 127.0``, as XLA compiles it: a
# division by a constant becomes a product with the constant's fp32
# reciprocal, which differs from the division in the last bit for some rows.
# (A Python number that fp32 holds exactly: the product is the same on every
# device, and nothing is copied to the device.)
INV_127 = (torch.tensor(1.0) / 127.0).item()


def _quantize_rows(x: torch.Tensor):
    xf = x.float()
    xs = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) * INV_127
    return torch.clamp(torch.round(xf / xs), -127, 127), xs


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  The integer product is
    exact either way: int32 on the CPU, float64 on a GPU (where
    ``torch.matmul`` takes no int8; sums of at most K products of 127 * 127
    stay far below 2**53)."""
    xq, xs = _quantize_rows(x)
    if x.device.type == "cpu":
        acc = torch.matmul(xq.to(torch.int32), w_q.to(torch.int32))
    else:
        acc = torch.matmul(xq.double(), w_q.double())
    return ((acc.float() * xs) * w_scale.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor
                ) -> torch.Tensor:
    """x (M, K) float -> x @ dequant(w_q) (M, N) in x's type; w_q (K, N)
    int8, w_scale (N,).  The TPU tiling arguments of the JAX function have no
    counterpart: the kernel masks ragged edges itself; ``plan`` says how it
    runs the shape."""
    if x.ndim != 2 or w_q.ndim != 2 or w_q.shape[0] != x.shape[1] \
            or w_scale.shape != (w_q.shape[1],) or w_q.dtype != torch.int8:
        raise ValueError(f"bad inputs x{tuple(x.shape)} w_q{tuple(w_q.shape)} "
                         f"{w_q.dtype} w_scale{tuple(w_scale.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, w_scale)
    return _launch(x, w_q, w_scale, -1)


def _int8_matmul_mode(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor, variant: str) -> torch.Tensor:
    """``int8_matmul`` on CUDA tensors with the kernel's mode forced
    ("fused" or "streamed"), for the checks and timings that hold each
    mode."""
    return _launch(x, w_q, w_scale, _MODES.index(variant))


def _launch(x, w_q, w_scale, mode: int) -> torch.Tensor:
    """The kernel on CUDA tensors, in C mode `mode` (-1: the plan's)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x; got "
                        f"{x.dtype}")
    if w_q.device != x.device or w_scale.device != x.device:
        raise ValueError("x, w_q and w_scale must lie on one device")
    M, K = x.shape
    N = w_q.shape[1]
    wt = w_q.t()        # (N, K): K contiguous, the kernel's B operand
    if not (wt.stride(1) == 1 and wt.stride(0) % 16 == 0
            and wt.data_ptr() % 16 == 0):
        # another layout: one copy per call, rows padded to 16 bytes
        wt = torch.zeros((N, -(-K // 16) * 16), dtype=torch.int8,
                         device=x.device)
        wt[:, :K] = w_q.t()
    if x.stride(1) != 1 or x.stride(0) != K or x.data_ptr() % 16:
        # rows K apart from a 16-byte aligned start, the layout the kernel's
        # TMA loads of x take (a copy only for another view)
        x = torch.empty((M, K), dtype=x.dtype, device=x.device).copy_(x)
    how = _plan(x.device, x.dtype, M, N, K, mode)
    work = how[PLAN_KEYS.index("workspace_bytes")]
    # scratch only where the plan quantises into a workspace (streamed)
    workspace = torch.empty((work,), dtype=torch.uint8, device=x.device) \
        if work else None
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = w_scale.float().contiguous()
    ENTRIES["int8_matmul_fwd"](
        x.device, x.data_ptr(), x.stride(0), wt.data_ptr(), wt.stride(0),
        ws.data_ptr(), out.data_ptr(),
        workspace.data_ptr() if workspace is not None else None,
        _DTYPE_CODE[x.dtype], M, N, K, mode)
    _launches["int8_matmul"] += 1
    return out


def quantize_dense_tree(params: dict,
                        path_filter: Callable[[str], bool] = lambda p: True):
    """Rewrite matching ``.../kernel`` leaves (2-D, the JAX layout ``(K,
    N)``) of a nested dict into ``{'kernel_q', 'kernel_scale'}``.

    Returns ``(new_params, n_quantized)``.  Biases and non-matching leaves
    pass through; empty sub-dicts are dropped, as a pytree walk drops them.
    """
    n = 0

    def walk(node, parts):
        nonlocal n
        out = {}
        for key, leaf in node.items():
            path = parts + [str(key)]
            if isinstance(leaf, dict):
                sub = walk(leaf, path)
                if sub:
                    out[key] = sub
            elif key == "kernel" and leaf.ndim == 2 \
                    and path_filter("/".join(path)):
                out["kernel_q"], out["kernel_scale"] = \
                    quantize_per_channel(leaf)
                n += 1
            elif leaf is not None:
                out[key] = leaf
        return out

    return walk(params, []), n
