"""Compile-once execution on the card: one captured CUDA graph per signature.

Counterpart of ``sheeprl_tpu/parallel/compile.py``.  The JAX layer lowers
and compiles each program once per abstract signature and then only feeds
it data.  The port's counterpart of "compiled once" is a CUDA graph:

* :class:`GraphFunction` keys a cache by signature — each tensor leaf's
  shape, dtype and device, plus the static arguments by value however they
  are passed — and keeps the same instance-local recompile audit as
  ``AOTFunction`` (the first build is free, the budget is checked before
  the build is paid for, a failed build rolls the audit back and raises,
  the message carries the signature history).  On a CUDA device the first
  call of a signature runs the function eagerly on a side stream (which
  loads the kernels' libraries, sets their attributes and lets cuDNN and
  cuBLAS choose their algorithms) and returns that result; it then captures
  a ``torch.cuda.CUDAGraph`` into static input and output buffers.  Every
  later call copies its tensor inputs into those buffers and replays the
  graph.  A capture that fails raises; nothing falls back to eager
  execution.  On the CPU, or for a route marked ``eager_reason``, the
  function runs eagerly under the same audit.
* :func:`compile_once` builds one with no fabric in scope.
* :class:`CompilePool` runs warm-up work in threads: on the port that is
  the ``nvcc`` builds of ``ops/_build.py``, overlapped with env and ring
  set-up.  It never captures: under the default global capture mode an
  unsafe CUDA call from another thread breaks a capture.
* :func:`warmup_batch_ladder` builds a function at every rung of a serving
  ladder before traffic is admitted.

Contract of a captured function, which the callers keep:

* the state it updates (parameters, optimizer moments, Moments, counters
  on the card) is closed over and updated in place, never rebound, because
  the graph reads and writes the addresses it saw at capture;
* a Python scalar argument is part of the signature by value (a graph
  freezes it); a value that changes from call to call is a tensor;
* the generators it draws from are passed as ``generators`` and registered
  with every graph, so each replay draws what eager execution would;
* a call's outputs stay valid until the next call of the same function:
  the graphs of one function share one memory pool, and a replay rewrites
  its static outputs.

``state_io_shardings`` has no counterpart: on one device there is nothing
to pin, and a captured graph updates its state in place by construction.
"""

from __future__ import annotations

import inspect
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.ops import LAUNCH_COUNTERS
from sheeprl_tpu_torch.utils.profiler import COMPILE_MONITOR, RecompileLimitExceeded  # noqa: F401

_SCALARS = (bool, int, float, complex, str)
_STREAMS: Dict[int, Any] = {}
_STREAMS_LOCK = threading.Lock()


def _capture_stream(device: torch.device):
    """The side stream of ``device`` on which first calls run and graphs are captured."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _STREAMS_LOCK:
        if index not in _STREAMS:
            _STREAMS[index] = torch.cuda.Stream(device=index)
        return _STREAMS[index]


def _flatten(tree: Any, leaves: List[Any]) -> Any:
    """The structure of a pytree of tuples (named ones too), lists and
    dicts; its leaves are appended to ``leaves`` in order."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(tree[k], leaves)) for k in tree))
    leaves.append(tree)
    return "*"


def _unflatten(structure: Any, leaves: Any) -> Any:
    if structure == "*":
        return next(leaves)
    kind, items = structure
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in items}
    values = [_unflatten(s, leaves) for s in items]
    if kind is list:
        return values
    return kind(*values) if hasattr(kind, "_fields") else kind(values)


def _leaf_sig(x: Any, graphs: bool) -> Tuple[Any, ...]:
    """Signature of one dynamic leaf.  Tensors key on shape, dtype and
    device.  Python scalars key on their type when the function runs
    eagerly (as ``jax.jit`` keys them) and on their value when it is
    captured, since a graph freezes them."""
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, np.ndarray):
        return ("np", x.shape, str(x.dtype))
    if isinstance(x, np.generic):
        return ("np", (), str(x.dtype))
    if x is None:
        return ("none",)
    if isinstance(x, _SCALARS):
        return ("py", type(x).__name__, x) if graphs else ("py", type(x).__name__)
    return ("obj", type(x).__name__)


class _Graph:
    """One captured signature: the graph, its static inputs and outputs, and
    the kernel launches it holds per replay."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph: Any, inputs: List[torch.Tensor], outputs: Any, launches: List[Dict[str, int]]):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches


_EAGER = object()  # cache entry of a signature that runs eagerly


class GraphFunction:
    """A function run as one captured CUDA graph per signature, with the
    recompile audit of ``AOTFunction``.

    Call it like the function.  ``device`` is where it runs: a CUDA device
    captures, the CPU runs eagerly.  ``generators`` are registered with every
    graph.  ``eager_reason`` marks a route that runs eagerly on the card too,
    and says why; the audit still holds it to ``max_recompiles``.
    """

    def __init__(
        self,
        fn: Callable,
        *,
        name: Optional[str] = None,
        static_argnums: Tuple[int, ...] = (),
        static_argnames: Tuple[str, ...] = (),
        max_recompiles: Optional[int] = None,
        device: Any = "cpu",
        generators: Sequence[torch.Generator] = (),
        eager_reason: Optional[str] = None,
        monitor: Any = None,
    ):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "<anonymous>")
        self.__name__ = self.name
        self._static_argnums = tuple(static_argnums)
        self._static_argnames = tuple(static_argnames)
        # a static argument is static however it is passed — positionally,
        # by keyword, or omitted with its default — so every spelling of the
        # same value selects the same entry
        try:
            sig = inspect.signature(fn)
            self._param_names = tuple(sig.parameters)
            self._param_defaults = {p: v.default for p, v in sig.parameters.items()
                                    if v.default is not inspect.Parameter.empty}
        except (TypeError, ValueError):
            self._param_names, self._param_defaults = (), {}
        positions = {p: i for i, p in enumerate(self._param_names)}
        self._static_name_pos = frozenset(positions[n] for n in self._static_argnames if n in positions)
        self._static_names = frozenset(self._static_argnames) | frozenset(
            self._param_names[i] for i in self._static_argnums if i < len(self._param_names))
        self.max_recompiles = max_recompiles
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.eager_reason = eager_reason
        self._monitor = monitor if monitor is not None else COMPILE_MONITOR
        self._lock = threading.Lock()
        self._cache: Dict[Any, Any] = {}
        # instance-local audit: THIS wrapper is one compile-once program, so
        # the budget counts only its own builds
        self._compile_count = 0
        self._sig_history: List[str] = []
        self._pool = None  # the graphs of this function share one memory pool
        #: host calls that put work on the card in replays: graph launches and input copies
        self.replays = 0
        self.input_copies = 0

    @property
    def graphs(self) -> bool:
        """Whether calls on this function are captured and replayed."""
        return self.device.type == "cuda" and self.eager_reason is None

    # -- signature / static-arg handling ------------------------------------
    def _split(self, args, kwargs):
        static_idx = set(self._static_argnums) | self._static_name_pos
        dyn_args = tuple(a for i, a in enumerate(args) if i not in static_idx)
        dyn_kwargs = {k: v for k, v in kwargs.items() if k not in self._static_names}
        static: Dict[Any, Any] = {}
        for i in sorted(static_idx):
            if i < len(args):
                static[self._param_names[i] if i < len(self._param_names) else i] = args[i]
        for k, v in kwargs.items():
            if k in self._static_names:
                static[k] = v
        for n in self._static_names:
            if n not in static and n in self._param_defaults:
                static[n] = self._param_defaults[n]
        return dyn_args, dyn_kwargs, tuple(sorted(static.items(), key=lambda kv: str(kv[0])))

    def _signature(self, args, kwargs):
        dyn_args, dyn_kwargs, static_key = self._split(args, kwargs)
        leaves: List[Any] = []
        structure = _flatten((dyn_args, dyn_kwargs), leaves)
        graphs = self.graphs
        sig = (structure, tuple(_leaf_sig(x, graphs) for x in leaves), static_key)
        if graphs:
            # a graph records the autograd mode it was captured under
            sig += (torch.is_grad_enabled(), torch.is_inference_mode_enabled())
        return sig, leaves

    # -- the audit -------------------------------------------------------------
    def _check_budget(self, signature) -> None:
        """Count one build of THIS instance; raise past the budget."""
        with self._lock:
            self._compile_count += 1
            self._sig_history.append(str(signature))
            limit = self.max_recompiles
            if limit is None:
                limit = self._monitor.default_limit()
            if limit is not None and self._compile_count - 1 > int(limit):
                history = "\n  ".join(self._sig_history)
                raise RecompileLimitExceeded(
                    f"'{self.name}' compiled {self._compile_count} times, exceeding max_recompiles={int(limit)} "
                    f"(first compile is free). A new signature reached a compile-once program — signature "
                    f"history:\n  {history}")

    def _rollback_budget(self, signature) -> None:
        """Undo one ``_check_budget`` whose build never completed (the
        matching signature, searched from the end)."""
        sig_str = str(signature)
        with self._lock:
            self._compile_count -= 1
            for i in range(len(self._sig_history) - 1, -1, -1):
                if self._sig_history[i] == sig_str:
                    del self._sig_history[i]
                    break

    # -- building --------------------------------------------------------------
    def _check_graph_leaves(self, leaves: List[Any]) -> None:
        for x in leaves:
            if isinstance(x, torch.Tensor):
                if x.device.type != "cuda":
                    raise TypeError(f"{self.name}: a captured function takes tensors on the card; one input is "
                                    f"on {x.device}")
            elif not (x is None or isinstance(x, _SCALARS)):
                raise TypeError(f"{self.name}: a captured function takes tensors and Python scalars as dynamic "
                                f"arguments, not {type(x).__name__}: pass it as static or close over it")

    def _capture(self, args, kwargs, leaves) -> Tuple[Any, _Graph]:
        """The first call of a signature on the card: run eagerly on the side
        stream (the call's result), then capture the graph."""
        stream = _capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = self._fn(*args, **kwargs)
        current.wait_stream(stream)
        # static inputs: plain tensors (not inference tensors), so a later
        # call outside inference mode may still copy into them
        with torch.inference_mode(False), torch.no_grad():
            statics = [x.detach().clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        dyn_args, dyn_kwargs, static_key = self._split(args, kwargs)
        structure = _flatten((dyn_args, dyn_kwargs), [])
        s_args, s_kwargs = _unflatten(structure, iter(statics))
        full_args = list(s_args)
        static = dict(static_key)
        static_idx = sorted(set(self._static_argnums) | self._static_name_pos)
        for i in static_idx:
            if i < len(args):
                full_args.insert(i, args[i])
        full_kwargs = {**s_kwargs, **{k: v for k, v in kwargs.items() if k in static}}
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [dict(c) for c in LAUNCH_COUNTERS]
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                outputs = self._fn(*full_args, **full_kwargs)
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: capturing a CUDA graph failed ({type(e).__name__}: {e}); a captured function "
                "may not wait on the host or copy from pageable host memory, and nothing runs it eagerly "
                "instead") from e
        finally:
            # the capture recorded launches but ran none: they count per replay
            launches = []
            for counter, seen in zip(LAUNCH_COUNTERS, before):
                launches.append({k: counter[k] - seen.get(k, 0) for k in counter})
                counter.update(seen)
        inputs = [s for s in statics if isinstance(s, torch.Tensor)]
        return out, _Graph(graph, inputs, outputs, launches)

    def _build(self, sig, args, kwargs, leaves):
        # the guard runs BEFORE the (expensive) build: tripping the budget
        # must not first pay for the offending program
        self._check_budget(sig[1:])
        self._monitor.begin(self.name, sig[1:])
        t0 = time.perf_counter()
        try:
            if self.graphs:
                self._check_graph_leaves(leaves)
                out, entry = self._capture(args, kwargs, leaves)
            else:
                out, entry = self._fn(*args, **kwargs), _EAGER
        except BaseException:
            # the build failed: roll the audit back so the counters reflect
            # programs actually built, and a retry is not double-counted
            self._monitor.abort(self.name, sig[1:])
            self._rollback_budget(sig[1:])
            raise
        self._monitor.end(self.name, time.perf_counter() - t0)
        with self._lock:
            self._cache[sig] = entry
        return out

    # -- dispatch --------------------------------------------------------------
    def __call__(self, *args: Any, **kwargs: Any):
        sig, leaves = self._signature(args, kwargs)
        with self._lock:
            entry = self._cache.get(sig)
        if entry is None:
            return self._build(sig, args, kwargs, leaves)
        if entry is _EAGER:
            return self._fn(*args, **kwargs)
        with torch.no_grad():
            tensors = (x for x in leaves if isinstance(x, torch.Tensor))
            for static, x in zip(entry.inputs, tensors):
                if static.data_ptr() != x.data_ptr():
                    static.copy_(x)
                    self.input_copies += 1
        entry.graph.replay()
        self.replays += 1
        for counter, n in zip(LAUNCH_COUNTERS, entry.launches):
            for k, v in n.items():
                counter[k] += v
        return entry.outputs

    def cache_size(self) -> int:
        with self._lock:
            return len(self._cache)


def compile_once(
    fn: Callable,
    *,
    name: Optional[str] = None,
    static_argnums: Tuple[int, ...] = (),
    static_argnames: Tuple[str, ...] = (),
    max_recompiles: Optional[int] = None,
    device: Any = "cpu",
    generators: Sequence[torch.Generator] = (),
    eager_reason: Optional[str] = None,
) -> GraphFunction:
    """Module-level constructor for code with no fabric in scope;
    ``Fabric.compile`` delegates here."""
    return GraphFunction(fn, name=name, static_argnums=static_argnums, static_argnames=static_argnames,
                         max_recompiles=max_recompiles, device=device, generators=generators,
                         eager_reason=eager_reason)


class CompilePool:
    """Warm-up work in a thread pool, overlapped with the host's set-up.

    On the port the work is the kernels' ``nvcc`` builds (``ops/_build.py``),
    which run in subprocesses.  Nothing submitted here may capture a graph.
    Submissions are best-effort: a warm-up failure is swallowed at ``join``
    (the work then happens inline at first use), EXCEPT the recompile guard,
    which stays a hard error.
    """

    def __init__(self, max_workers: Optional[int] = None):
        if max_workers is None:
            max_workers = max(2, min(4, (os.cpu_count() or 2)))
        self._executor = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="sheeprl-compile")
        self._futures: List[Future] = []
        self._hard_errors: List[BaseException] = []
        self._lock = threading.Lock()

    def _track(self, fut: Future) -> Future:
        """Completed futures remove themselves; a recompile-budget trip is
        stashed so a later ``join`` still surfaces it."""
        with self._lock:
            self._futures.append(fut)

        def _drain(f: Future) -> None:
            exc = f.exception()
            with self._lock:
                try:
                    self._futures.remove(f)
                except ValueError:
                    return  # a join() snapshot owns this future and reports it
                if isinstance(exc, RecompileLimitExceeded):
                    self._hard_errors.append(exc)

        fut.add_done_callback(_drain)
        return fut

    def submit_fn(self, fn: Callable, *args: Any, **kwargs: Any) -> Future:
        """Run a warm-up thunk (a kernel build) in the pool."""
        return self._track(self._executor.submit(fn, *args, **kwargs))

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for all outstanding warm-ups.  Re-raises only
        :class:`RecompileLimitExceeded`."""
        with self._lock:
            futures, self._futures = self._futures, []
        for fut in futures:
            try:
                fut.result(timeout=timeout)
            except RecompileLimitExceeded:
                raise
            except Exception:
                pass
        with self._lock:
            errs, self._hard_errors = list(self._hard_errors), []
        if errs:
            raise errs[0]

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)


def warmup_batch_ladder(
    fn: GraphFunction,
    spec_fn: Callable[[int], Tuple[Any, ...]],
    batch_sizes: Tuple[int, ...],
    pool: Optional[CompilePool] = None,
) -> None:
    """Build ``fn`` at every batch size of a serving ladder: ``spec_fn(batch)``
    gives the positional arguments of one rung as the steady dispatch will
    pass them.  Outstanding warm-ups of ``pool`` (the kernels' builds) are
    joined first; each rung is then called, and so captured, on this thread,
    so a server admits traffic with every rung built."""
    if pool is not None:
        pool.join()
    for b in batch_sizes:
        fn(*spec_fn(int(b)))


_POOL: Optional[CompilePool] = None
_POOL_LOCK = threading.Lock()


def get_compile_pool() -> CompilePool:
    """The process-wide warm-up pool (created at first use)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = CompilePool()
        return _POOL
