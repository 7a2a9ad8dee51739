"""``.pt`` files in the reference's formats.

The port's counterpart of ``celebbasis_tpu/utils/pt_io.py`` (which writes
the torch zip format without torch).  ``save_pt`` takes a tree of dicts,
lists and tuples whose leaves are tensors, numpy arrays or Python scalars;
numpy leaves are stored as CPU tensors, so that the file holds nothing
``torch.load(weights_only=True)`` refuses.  The JAX package's ``load_pt``
reads what this ``save_pt`` writes.

``load_pt`` returns the tree with tensor leaves on the CPU, for files this
port or the JAX package wrote and for checkpoints from elsewhere: the
Lightning ``.ckpt`` of Stable Diffusion pickles callback objects beside its
``state_dict``, which ``weights_only=True`` refuses.  So a zip-format file is
read by a restricted unpickler (``_Unpickler``): it builds tensors from the
archive's storages, rebuilds Python containers, and stands a ``Stub`` in for
every other class the pickle names, without importing or running it.  A
file in the legacy (pre-zip) format goes to ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import codecs
import collections
import pickle
import zipfile
from typing import Any, Dict

import numpy as np
import torch


def _to_torch(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().contiguous()
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def save_pt(obj: Any, path: str) -> None:
    """Write ``obj`` (numpy or tensor leaves) as a torch ``.pt`` file."""
    torch.save(_to_torch(obj), path)


# -- the restricted reader ----------------------------------------------------

_STORAGE_DTYPES = {
    "FloatStorage": torch.float32, "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16, "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64, "IntStorage": torch.int32,
    "ShortStorage": torch.int16, "CharStorage": torch.int8,
    "ByteStorage": torch.uint8, "BoolStorage": torch.bool,
    "UntypedStorage": torch.uint8,
}


class Stub(dict):
    """Stands in for an object of a class the file names and the reader does
    not import (a Lightning callback, a hyper-parameter dict): it keeps what
    the pickle hands it -- constructor arguments, state, items -- and runs
    nothing.  Hashable by identity, as a class used as a dict key must be."""

    __hash__ = object.__hash__

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.args, self.kwargs, self.items_appended = args, kwargs, []

    def __eq__(self, other):
        return self is other

    def __setstate__(self, state):
        self.state = state

    def append(self, item):
        self.items_appended.append(item)

    def extend(self, items):
        self.items_appended.extend(items)


class _StorageType:
    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype


def _rebuild_tensor_v2(storage, storage_offset, size, stride,
                       requires_grad=False, backward_hooks=None,
                       metadata=None):
    return storage.as_strided(tuple(size), tuple(stride), storage_offset)


def _rebuild_parameter(data, requires_grad=False, backward_hooks=None,
                       state=None):
    return data


def _rebuild_from_type_v2(func, new_type, args, state):
    return func(*args)


# (module, name) -> what the unpickler returns for it; every other global
# becomes a Stub subclass
_ALLOWED = {
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch._utils", "_rebuild_parameter_with_state"): _rebuild_parameter,
    ("torch._tensor", "_rebuild_from_type_v2"): _rebuild_from_type_v2,
    ("torch", "Size"): torch.Size,
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("builtins", "dict"): dict, ("builtins", "list"): list,
    ("builtins", "tuple"): tuple, ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("_codecs", "encode"): codecs.encode,
}


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, read_storage):
        super().__init__(file, encoding="latin1")
        self._read_storage = read_storage
        self._stubs: Dict[tuple, type] = {}

    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if module == "torch" and name in _STORAGE_DTYPES:
            return _StorageType(_STORAGE_DTYPES[name])
        if (module, name) not in self._stubs:     # one class per name
            self._stubs[module, name] = type(name, (Stub,),
                                             {"__module__": module})
        return self._stubs[module, name]

    def persistent_load(self, pid):
        kind, storage_type, key, _location, numel = pid
        if kind != "storage" or not isinstance(storage_type, _StorageType):
            raise pickle.UnpicklingError(f"unexpected persistent id {pid!r}")
        return self._read_storage(str(key), storage_type.dtype, numel)


def _load_zip(path: str) -> Any:
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl = next(n for n in names
                   if n == "data.pkl" or n.endswith("/data.pkl"))
        prefix = pkl[: -len("data.pkl")]
        if f"{prefix}byteorder" in names \
                and zf.read(f"{prefix}byteorder").strip() != b"little":
            raise ValueError(f"{path}: big-endian storages are not read")
        cache: Dict[str, torch.Tensor] = {}

        def read_storage(key, dtype, numel):
            if key not in cache:
                raw = bytearray(zf.read(f"{prefix}data/{key}"))
                flat = (torch.frombuffer(raw, dtype=torch.uint8) if raw
                        else torch.empty(0, dtype=torch.uint8))
                cache[key] = flat.view(dtype)
            if cache[key].numel() != numel:
                raise ValueError(f"{path}: storage {key} holds "
                                 f"{cache[key].numel()} elements, the pickle "
                                 f"says {numel}")
            return cache[key]

        with zf.open(pkl) as f:
            return _Unpickler(f, read_storage).load()


def load_pt(path: str) -> Any:
    """Read a ``.pt`` / ``.pth`` / ``.ckpt`` file into a tree with CPU tensor
    leaves; classes other than tensors and containers come back as ``Stub``
    objects, never imported or run."""
    if zipfile.is_zipfile(path):
        return _load_zip(path)
    return torch.load(path, map_location="cpu", weights_only=True)
