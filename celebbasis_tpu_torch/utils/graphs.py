"""Whole paths captured as CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each of its main paths as one compiled program: the
samplers are ``jax.jit`` over ``lax.scan``, the train and eval steps are
``jax.jit`` with the state donated.  Here a function is captured into a CUDA
graph the first time it is called with a given signature and replayed on
every later call with that signature, so a 20-step request or a train step is
one launch from the host instead of thousands.

``Captured(fn)`` is ``fn`` as a captured callable (``entry`` builds an entry
point around one):

* **On CUDA tensors it captures or raises.**  There is no eager retry, no
  switch and no environment variable.  The uncaptured function stays
  reachable as ``.eager``, for comparisons only.
* **On CPU tensors no graph exists**: the same Python runs eagerly.  That is
  what the CPU tests run.
* The **signature** is the structure of the arguments (``torch.utils
  ._pytree``), every tensor's shape, dtype and device, every other leaf's
  value, and the routes that change what a call launches: the attention and
  GEGLU routes, ``CELEBBASIS_FLASH_LAYOUT``, grad and inference mode, the two
  TF32 switches.  Each signature has its own graph and its own private
  memory pool.
* A first call copies its tensors into **static buffers** that the graph
  owns, runs ``fn`` once on a side stream (the **warm-up**: each kernel
  library is built and loaded, each C entry sets its attributes, cuBLAS and
  cuDNN pick their algorithms, all outside the graph), captures ``fn``,
  then replays.  A later call copies its tensors into the buffers and
  replays.  Outputs are returned as copies, so a later call does not
  overwrite what an earlier one returned.
* **What the warm-up changes is put back.**  ``restore`` returns the tensors
  that ``fn`` writes in place (parameters, gradients, optimizer state); they
  are copied before the warm-up and copied back after it, so the first call's
  result comes from the graph, as every later one's does.  Those tensors
  must exist before the first call and must be written only in place
  afterwards: the graph reads and writes them where they lay at capture.
  The same holds for the modules' weights that ``fn`` reads: load or cast
  them before the first call.
* **Launch counts stay true.**  The kernels' wrappers count in Python when
  they launch (``ops.flash_attention``, ``ops.geglu``, ``ops.quant``).  Under
  capture they count launches that are only recorded, so the counts seen
  during capture are taken back and added again at each replay.  The
  warm-up's launches are real and stay counted (``captures()`` says how
  many warm-ups a window held).

Everything random is drawn before the call and passed in: a generator draw
inside a capture would be frozen into the graph.  The one exception is a
draw whose number and shapes only the captured function knows (the UNet's
dropout masks): ``generators`` returns the CUDA generators ``fn`` draws from,
and each is registered with the graph (``register_generator_state``), so
that every replay draws anew from it.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree


_captures = 0


def captures() -> int:
    """Graphs captured in this process so far.  Each capture's warm-up
    launched every kernel of one call for real, so a count of launches over
    a window holds one call's worth per capture besides the replays'."""
    return _captures


def _launch_tables() -> List[dict]:
    from celebbasis_tpu_torch.ops import flash_attention, geglu, quant
    return [flash_attention._launches, flash_attention._reduce_launches,
            geglu._launches, quant._launches]


def _counts() -> List[Dict[str, int]]:
    return [dict(t) for t in _launch_tables()]


def _add_counts(delta: List[Dict[str, int]], sign: int) -> None:
    for table, d in zip(_launch_tables(), delta):
        for name, n in d.items():
            table[name] += sign * n


def _routes(device: torch.device) -> tuple:
    """The process-wide settings that change what ``fn`` launches."""
    from celebbasis_tpu_torch.ops import attention, geglu
    return (attention.resolved_impl(device),
            os.environ.get("CELEBBASIS_FLASH_LAYOUT"),
            geglu.resolved_impl(device), torch.is_grad_enabled(),
            torch.is_inference_mode_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


class _Graph:
    """One captured signature: static buffers, pool, graph, outputs."""

    def __init__(self, fn: Callable, spec, leaves: list, device,
                 restore: Optional[Callable[[], Sequence[torch.Tensor]]],
                 generators: Callable[[], Sequence[torch.Generator]]):
        t0 = time.perf_counter()
        self.static = [
            torch.empty_like(x, memory_format=torch.contiguous_format)
            if isinstance(x, torch.Tensor) else x for x in leaves]
        self.copy_in(leaves)
        args = pytree.tree_unflatten(self.static, spec)
        with torch.no_grad():
            kept = [t.clone() for t in restore()] if restore else []
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn(*args)
        current.wait_stream(side)
        with torch.no_grad():
            for t, k in zip(restore() if restore else [], kept, strict=True):
                t.copy_(k)
        del kept
        before = _counts()
        self.pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators():
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, pool=self.pool):
            out = fn(*args)
        after = _counts()
        self.launches = [{n: a[n] - b.get(n, 0) for n in a}
                         for a, b in zip(after, before)]
        _add_counts(self.launches, -1)       # recorded, not launched
        global _captures
        _captures += 1
        self.out_leaves, self.out_spec = pytree.tree_flatten(out)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def copy_in(self, leaves: list) -> None:
        for s, x in zip(self.static, leaves):
            if isinstance(x, torch.Tensor) and x is not s:
                s.copy_(x)

    def replay(self, leaves: list):
        self.copy_in(leaves)
        self.graph.replay()
        _add_counts(self.launches, +1)
        return pytree.tree_unflatten(
            [o.clone() if isinstance(o, torch.Tensor) else o
             for o in self.out_leaves], self.out_spec)


class Captured:
    """``fn`` captured per signature on CUDA tensors, run as it is on CPU
    tensors (see the module docstring).  ``eager`` is ``fn`` itself;
    ``capture_s`` maps each captured signature to the seconds its first call
    took (warm-up, capture and the first replay)."""

    def __init__(self, fn: Callable, restore=None, generators=lambda: ()):
        self.eager = fn
        self._restore, self._generators = restore, generators
        self._graphs: Dict[tuple, _Graph] = {}

    @property
    def capture_s(self) -> Dict[tuple, float]:
        return {k: g.capture_s for k, g in self._graphs.items()}

    def launches_per_replay(self) -> Dict[str, int]:
        """The kernel launches one replay of each graph adds, summed over the
        captured signatures (empty before the first capture)."""
        out: Dict[str, int] = {}
        for g in self._graphs.values():
            for table in g.launches:
                for name, n in table.items():
                    if n:
                        out[name] = out.get(name, 0) + n
        return out

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
        if all(d.type == "cpu" for d in devices):
            return self.eager(*args)
        if len(devices) != 1:
            raise ValueError(f"a captured call takes its tensors on one CUDA "
                             f"device; got {sorted(map(str, devices))}")
        device = devices.pop()
        key = (repr(spec), tuple(
            (tuple(x.shape), x.dtype, str(x.device))
            if isinstance(x, torch.Tensor) else ("value", x)
            for x in leaves), _routes(device))
        graph = self._graphs.get(key)
        with torch.cuda.device(device):
            if graph is None:
                graph = _Graph(self.eager, spec, leaves, device,
                               self._restore, self._generators)
                self._graphs[key] = graph
            return graph.replay(leaves)


def entry(make: Callable, body: Callable, restore=None,
          generators=lambda: ()) -> Callable:
    """An entry point whose work is a captured ``body``: ``make(run)``
    returns the entry point, which calls ``run`` as the eager code would call
    ``body``.  -> ``make(Captured(body, restore, generators))``, with
    ``eager`` set to ``make(body)`` and ``captured`` to the ``Captured``."""
    captured = Captured(body, restore, generators)
    fn = make(captured)
    fn.eager, fn.captured = make(body), captured
    return fn
