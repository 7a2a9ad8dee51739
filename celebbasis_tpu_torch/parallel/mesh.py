"""Device mesh and sharding rules: data parallel first, tensor parallel as an
option.

Counterpart of ``celebbasis_tpu/parallel/mesh.py``, in PyTorch's idiom: one
process per GPU (``torchrun`` starts them), a ``DeviceMesh`` with the JAX
package's axes ``("data", "model")``, and explicit collectives where GSPMD
inserted them.

* ``data``: the batch is split over it (``shard_batch``), frozen weights are
  replicated (or, with ``fsdp``, the large ones are sharded and all-gathered
  where they are read), and the trainable MLP's gradients are averaged over
  it (``train.trainer``).
* ``model``: Megatron tensor parallelism for sampling.  Column-parallel
  q/k/v and MLP-in projections hold a block of the output features (whole
  heads), row-parallel output projections a block of the input features; a
  row-parallel layer sums its partial product over the model group and adds
  its replicated bias once (``ops.basic.Dense``,
  ``models.unet.FeedForwardGEGLU``).  Attention then runs on ``heads / M``
  local heads at the same head dim.

The rules are pure functions of the port's parameter names and layouts.
The JAX rules name flax paths and flax layouts: a dense kernel is ``(in,
out)``, a conv kernel HWIO.  The port stores the same weights as torch does,
``(out, in)`` and OIHW, under the names ``utils.bridge.from_jax_params``
gives them (``…/to_q/kernel`` is ``….to_q.weight``).  So every spec below is
the JAX spec moved to the port's axes, written out in the table beside it.
"""
from __future__ import annotations

import os
import re
import socket
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.utils import parametrize

DATA, MODEL = "data", "model"
Spec = Tuple[Optional[str], ...]       # one mesh axis name (or None) a dim
REPLICATED: Spec = ()


# -- the mesh -----------------------------------------------------------------

_OWN_GROUP = False      # whether make_mesh started the default group


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str = "cuda"):
    """A ``DeviceMesh`` of shape ``(n_data, n_model)`` with dims ``("data",
    "model")`` over the processes of the default group; rank ``d * n_model +
    m`` sits at ``(d, m)``, as the JAX package reshapes its device list.

    The default group is the one ``torchrun`` describes in the environment
    (started here if it is not running yet, over ``nccl`` on ``cuda`` and
    ``gloo`` on the CPU; a caller that wants another backend starts the
    group itself).  Without ``torchrun`` only a mesh of one process can be
    made: a group of one rank on a local port.  Raises when ``n_data *
    n_model`` is not the world size: a mesh never runs on fewer ranks than
    it names."""
    global _OWN_GROUP
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device).type
    if not dist.is_initialized():
        backend = "nccl" if device == "cuda" else "gloo"
        want = (n_data or 1) * n_model
        if "WORLD_SIZE" in os.environ:
            if device == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                      % torch.cuda.device_count())
            dist.init_process_group(backend)
        elif want == 1:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                world_size=1, rank=0)
        else:
            raise ValueError(f"a {n_data or '?'} x {n_model} mesh needs "
                             f"{want} processes: launch them with torchrun "
                             f"(no process group is running)")
        _OWN_GROUP = True
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} processes; the group has "
                         f"{world}")
    # the mesh's device type only labels it: the collectives below take
    # the group's own backend (gloo on CUDA tensors runs where asked for)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (n_data, n_model),
                            mesh_dim_names=(DATA, MODEL))


def close_mesh() -> None:
    """Ends the default group if ``make_mesh`` started it."""
    global _OWN_GROUP
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP = False


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_writer(mesh) -> bool:
    """Whether this process writes files: rank 0, or no mesh at all."""
    return mesh is None or dist.get_rank() == 0


def runs_eagerly(mesh) -> bool:
    """Whether a path over ``mesh`` must run uncaptured: gloo's collectives
    cannot be recorded into a CUDA graph (NCCL's can)."""
    return mesh is not None and dist.get_backend() != "nccl"


def batch_sharding(mesh):
    """The placements of a batch: rows split over ``data``, copies over
    ``model`` (JAX ``P("data")``)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0), Replicate()]


def replicated(mesh):
    """The placements of a value every process holds whole (JAX ``P()``)."""
    from torch.distributed.tensor import Replicate
    return [Replicate(), Replicate()]


# -- the rules ----------------------------------------------------------------

# Megatron tensor-parallel rules: (regex on the parameter's name, spec in the
# port's layout).  First match wins; the default is replicated.  A rule holds
# only where the leaf has as many dims as its spec.  Each row is the JAX rule
# (flax path, (in, out) kernels) moved to the port's (out, in) weights:
#
#   JAX path rule                          JAX spec         port spec
#   (to_q|…|v_proj)/kernel  (in, out)      (None, model)    (model, None)
#   (to_q|…|v_proj)/bias                   (model,)         (model,)
#   (to_out|out_proj)/kernel               (model, None)    (None, model)
#   (ff/proj_in|fc1)/kernel                (None, model)    (model, None)
#   (ff/proj_in|fc1)/bias                  (model,)         (model,)
#   (ff/proj_out|fc2)/kernel               (model, None)    (None, model)
#
# The patterns search anywhere in the name, as the JAX ones do: the UNet's
# time_fc1 / time_fc2 are column / row parallel too.
_TP_RULES = [
    (re.compile(r"(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.weight"),
     (MODEL, None)),
    (re.compile(r"(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.bias"), (MODEL,)),
    (re.compile(r"(to_out|out_proj)\.weight"), (None, MODEL)),
    (re.compile(r"(ff\.proj_in|fc1)\.weight"), (MODEL, None)),
    (re.compile(r"(ff\.proj_in|fc1)\.bias"), (MODEL,)),
    (re.compile(r"(ff\.proj_out|fc2)\.weight"), (None, MODEL)),
]

# Conv channel-parallel rules, off by default (the JAX package keeps them for
# experiments only).  JAX HWIO -> port OIHW:
#
#   conv1/kernel        (None, None, None, model) O   (model, None, None, None)
#   conv1/bias          (model,)                      (model,)
#   (conv2|skip)/kernel (None, None, model, None) I   (None, model, None, None)
#
# A zero-initialised output conv (``ZeroConv``, kind "zero_conv") takes none
# of them: in the JAX tree its kernel sits one level down, under
# ``conv2/Conv_0/``, where the patterns do not reach.  ``shard_params``
# refuses these rules: a ResBlock's GroupNorm would normalise groups that
# straddle the channel shards.
_TP_CONV_RULES = [
    (re.compile(r"(conv1)\.weight"), (MODEL, None, None, None)),
    (re.compile(r"(conv1)\.bias"), (MODEL,)),
    (re.compile(r"(conv2|skip)\.weight"), (None, MODEL, None, None)),
]

# A column-parallel output made of independent halves is split half by half:
# GEGLU splits proj_in's 8d outputs into [h, g], so rank r takes its block of
# h and its block of g (a contiguous block would give one rank all of h).
_TP_CHUNKS = [(re.compile(r"ff\.proj_in\."), 2)]


def param_partition_spec(name: str, ndim: int, use_tp: bool,
                         conv_tp: bool = False,
                         kind: Optional[str] = None) -> Spec:
    """The tensor-parallel spec of the port's parameter ``name`` (of ``ndim``
    dims; ``kind`` as ``leaves`` gives it), in the port's layout."""
    if use_tp:
        conv = conv_tp and kind != "zero_conv"
        rules = _TP_RULES + (_TP_CONV_RULES if conv else [])
        for rx, spec in rules:
            if rx.search(name) and ndim == len(spec):
                return spec
    return REPLICATED


# FSDP-style weight sharding: leaves under 2**20 elements stay replicated
_FSDP_MIN_SIZE = 2 ** 20


def jax_axes(kind: Optional[str], ndim: int) -> Tuple[int, ...]:
    """Port axis i holds JAX axis ``jax_axes(kind, ndim)[i]``: a dense
    weight ``(out, in)`` is the kernel ``(in, out)`` transposed, a conv
    weight OIHW the kernel HWIO; every other leaf has one layout."""
    if kind == "dense" and ndim == 2:
        return (1, 0)
    if kind in ("conv", "zero_conv") and ndim == 4:
        return (3, 2, 0, 1)
    return tuple(range(ndim))


def fsdp_partition_spec(shape: Sequence[int], n_data: int,
                        min_size: int = _FSDP_MIN_SIZE,
                        kind: Optional[str] = None) -> Spec:
    """The JAX rule on the JAX layout of a port leaf of ``shape``: shard the
    largest ``n_data``-divisible JAX axis (the first of equals) over
    ``data``; small or indivisible leaves stay replicated."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    if not shape or size < min_size:
        return REPLICATED
    axes = jax_axes(kind, len(shape))
    jshape = [0] * len(shape)
    for i, j in enumerate(axes):
        jshape[j] = shape[i]
    for d in sorted(range(len(jshape)), key=lambda d: -jshape[d]):
        if jshape[d] % n_data == 0:
            spec = [None] * len(shape)
            spec[axes.index(d)] = DATA
            return tuple(spec)
    return REPLICATED


def _kind(owner: nn.Module, attr: str) -> Optional[str]:
    from celebbasis_tpu_torch.ops.basic import ZeroConv
    if attr != "weight":
        return None
    if isinstance(owner, nn.Linear):
        return "dense"
    if isinstance(owner, nn.Conv2d):
        return "zero_conv" if isinstance(owner, ZeroConv) else "conv"
    return None


def leaves(module: nn.Module
           ) -> Iterator[Tuple[str, nn.Module, str, nn.Parameter, str]]:
    """(name, owning module, attribute, parameter, kind) of each parameter
    once; kind is ``"dense"``, ``"conv"``, ``"zero_conv"`` or None (see
    ``jax_axes``)."""
    seen = set()
    for prefix, owner in module.named_modules():
        for attr, p in owner._parameters.items():
            if p is None or id(p) in seen:
                continue
            seen.add(id(p))
            name = f"{prefix}.{attr}" if prefix else attr
            yield name, owner, attr, p, _kind(owner, attr)


def param_shardings(module: nn.Module, n_data: int = 1,
                    use_tp: bool = False, conv_tp: bool = False,
                    fsdp: bool = False,
                    min_size: Optional[int] = None) -> Dict[str, Spec]:
    """Each parameter's spec, without placing anything: its TP rule, else
    (with ``fsdp``, and for parameters that do not train) the FSDP rule."""
    min_size = _FSDP_MIN_SIZE if min_size is None else min_size
    out = {}
    for name, _, _, p, kind in leaves(module):
        spec = param_partition_spec(name, p.ndim, use_tp, conv_tp, kind)
        if fsdp and spec == REPLICATED and not p.requires_grad:
            spec = fsdp_partition_spec(p.shape, n_data, min_size, kind)
        out[name] = spec
    return out


# -- collectives --------------------------------------------------------------

def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The shards (of one or more dims) of every rank of ``group`` joined
    along ``dim``, in rank order.  NCCL gathers; gloo, which lacks the
    gather on CUDA tensors, sums a zero buffer that each rank filled at its
    own slot, on the bytes (so the values come back bit for bit)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        raw = x.view(torch.uint8)
        buf = torch.zeros((n,) + tuple(raw.shape), dtype=torch.uint8,
                          device=x.device)
        buf[dist.get_group_rank(group, dist.get_rank())] = raw
        dist.all_reduce(buf, group=group)
        out = buf.view(x.dtype).reshape((n,) + tuple(x.shape))
    if dim == 0:
        return out.flatten(0, 1)
    return torch.cat(out.unbind(0), dim=dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sums ``x`` over ``group`` in place.  Inference only: the tensor-
    parallel layers that call it take no gradient, as in the JAX package,
    where ``--tp`` is a sampling option."""
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("tensor-parallel layers run without gradients")
    dist.all_reduce(x, group=group)
    return x


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward sums the global gradient over
    the group and keeps this rank's rows, so that the gradients averaged
    over the data ranks are those of the global computation."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_group_rank(ctx.group, dist.get_rank())
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group, grad: bool = False) -> torch.Tensor:
    """Every rank's rows of ``x`` in global row order; with ``grad`` the
    gradient flows back to this rank's rows."""
    if grad and x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, group)
    return all_gather(x.detach(), group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Averages the tensors over ``group`` in place, with one all-reduce
    of them flattened."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


# -- placing the parameters ---------------------------------------------------

def _block(t: torch.Tensor, dim: int, index: int, n: int,
           chunks: int = 1) -> torch.Tensor:
    """Block ``index`` of ``n`` along ``dim`` of each of ``chunks`` equal
    parts, joined; a copy (the full tensor is not kept alive)."""
    size = t.shape[dim]
    if size % (chunks * n):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into "
                         f"{chunks} x {n} blocks")
    parts = t.chunk(chunks, dim=dim)
    return torch.cat([p.chunk(n, dim=dim)[index] for p in parts],
                     dim=dim).clone()


def _chunks(name: str) -> int:
    for rx, chunks in _TP_CHUNKS:
        if rx.search(name):
            return chunks
    return 1


class _Gathered(nn.Module):
    """Parametrization of an FSDP-sharded leaf: each read of the parameter
    all-gathers the shards over the data group.  The gathered copy lives
    while something uses it: a forward's product, and a backward through a
    frozen layer, which reads the copy its forward saved."""

    def __init__(self, dim: int, group):
        super().__init__()
        self.dim, self.group = dim, group

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return all_gather(shard, self.group, self.dim)


def _set_param(owner: nn.Module, attr: str, value: torch.Tensor,
               requires_grad: bool) -> nn.Parameter:
    p = nn.Parameter(value, requires_grad=requires_grad)
    setattr(owner, attr, p)
    return p


def shard_params(module: nn.Module, mesh, use_tp: bool = False,
                 conv_tp: bool = False, fsdp: bool = False,
                 min_size: Optional[int] = None) -> nn.Module:
    """Places ``module``'s parameters on the mesh, in place: TP-sharded over
    ``model`` where a rule claims them (``use_tp``), and with ``fsdp`` the
    frozen leaves no TP rule claimed sharded over ``data`` by the FSDP rule
    (each rank stores 1/n_data of them and gathers them where they are
    read).  Everything else stays replicated.  Modules that own ``heads``
    and a column-parallel query projection then run ``heads / n_model``
    local heads; ``n_model`` must divide their heads.  Returns ``module``."""
    if use_tp and conv_tp:
        raise ValueError("conv_tp is not run by the port: a ResBlock's "
                         "GroupNorm would normalise groups that straddle "
                         "the channel shards")
    n_data, n_model = axis_size(mesh, DATA), axis_size(mesh, MODEL)
    specs = param_shardings(module, n_data, use_tp, False, fsdp, min_size)
    todo = [(name, owner, attr, p, specs[name])
            for name, owner, attr, p, _ in leaves(module)
            if specs[name] != REPLICATED]
    # check everything before anything moves
    column = {owner for name, owner, attr, p, spec in todo
              if MODEL in spec and spec[0] == MODEL}
    heads = [m for m in module.modules() if hasattr(m, "heads") and (
        getattr(m, "to_q", None) in column
        or getattr(m, "q_proj", None) in column)]
    for m in heads:
        if m.heads % n_model:
            raise ValueError(f"--tp {n_model} does not divide "
                             f"{type(m).__name__}'s {m.heads} heads")
    for name, owner, attr, p, spec in todo:
        axis = MODEL if MODEL in spec else DATA
        n = n_model if axis == MODEL else n_data
        if p.shape[spec.index(axis)] % (n * _chunks(name)):
            raise ValueError(f"{name} {tuple(p.shape)} does not split over "
                             f"{n} {axis} shards")
    for m in heads:
        m.heads //= n_model
    with torch.no_grad():
        for name, owner, attr, p, spec in todo:
            if MODEL in spec:
                dim = spec.index(MODEL)
                _set_param(owner, attr, _block(
                    p, dim, axis_index(mesh, MODEL), n_model, _chunks(name)),
                    p.requires_grad)
                if dim == 1:          # row parallel: sum the partials
                    owner.tp_group = mesh.get_group(MODEL)
            else:
                dim = spec.index(DATA)
                _set_param(owner, attr, _block(
                    p, dim, axis_index(mesh, DATA), n_data), False)
                parametrize.register_parametrization(
                    owner, attr, _Gathered(dim, mesh.get_group(DATA)),
                    unsafe=True)
    return module


def stored_bytes(module: nn.Module, frozen_only: bool = True) -> int:
    """Bytes of the storages that hold ``module``'s parameters (the shards,
    where FSDP sharded them), each storage once."""
    seen, total = set(), 0
    for p in module.parameters():
        if frozen_only and p.requires_grad:
            continue
        st = p.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


# -- the batch ----------------------------------------------------------------

def shard_batch(batch: Any, mesh) -> Any:
    """This process's contiguous block of every array's leading (batch)
    axis, as ``P("data")`` splits it; dicts, lists and tuples are walked,
    anything else is kept."""
    n, i = axis_size(mesh, DATA), axis_index(mesh, DATA)
    if n == 1:
        return batch

    def one(a):
        if isinstance(a, dict):
            return {k: one(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(one(v) for v in a)
        if not hasattr(a, "shape") or not len(a.shape):
            return a
        if a.shape[0] % n:
            raise ValueError(f"a batch of {a.shape[0]} rows does not split "
                             f"over {n} data shards")
        b = a.shape[0] // n
        return a[i * b:(i + 1) * b]
    return one(batch)
