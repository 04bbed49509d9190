"""The engines' dispatch blocks captured once per shape as CUDA graphs and
replayed: the port's counterpart of the ``jax.jit`` at the JAX engines'
fused functions (``downpore_tpu/ops/map_engine.py``'s ``_fused_map_*`` and
``_fused_overlap*``, ``ops/window_engine.py``'s ``_fused_*``), each
compiled once per shape with its budgets as static arguments.

``run(fn, inputs, tables, **statics)`` is ``fn(**inputs, **tables,
**statics)``.  On the CPU it is exactly that call.  On a card the call is
keyed on ``fn`` (the route), the statics, the name, shape and dtype of
every tensor, and the device:

* the first call of a key allocates static buffers for ``inputs``, runs
  ``fn`` once on a side stream (the warm-up, which also builds and loads
  any kernel library, so no ``nvcc`` or ``dlopen`` happens in a capture),
  captures it into a ``torch.cuda.CUDAGraph`` and returns the warm-up's
  result;
* every later call copies ``inputs`` (already on the device, through
  ``transfer.upload``'s pinned staging) into the static buffers on the
  current stream, replays the graph and returns clones of its outputs.

There is no switch: a capture or a replay that fails raises, and nothing
runs the block eagerly instead.  The engines pad their rows to
``row_bucket``, the JAX package's accelerator ladder, so that the keys
stay few, as the JAX engines' ``_bucket`` keeps their compiled programs
few.

Hazards, and what the cache does about each:

a. Resident tables (membership, chunk seed tables, adapter tables) are
   keyed like every input, by name, shape and dtype.  They live in
   buffers the cache owns, one per (device, name, shape, dtype), shared by
   every graph that reads them.  A table is copied in only when the
   tensor passed differs from the one copied last (another object, or the
   same one modified in place), so an overlap job, which builds a new
   engine every round, copies its tables once a round and captures
   nothing new while their shapes hold.  Tables of one shape that are
   different data at once (the seed shards' membership blocks) go by
   different names, so each has a buffer of its own and none is copied
   in at every call.
b. Budgets are statics, so a budget that moved at every dispatch would be
   a new key each time.  The engines give the key budgets that settle:
   the map budget follows the running maximum of the collected counts,
   the overlap plan's budget only grows, and the trim verdicts' re-runs
   at collect take the running maximum of what a re-run needed; the map
   and overlap re-runs, rare once the budgets have settled, keep the JAX
   escalation.  Any budget gives the same rows, because collect re-runs
   an overflow.
c. Outputs are cloned after each replay, so dispatches in flight never
   share them; static inputs are rewritten only by copies enqueued after
   the previous replay of the device, on its stream (the current stream,
   made to wait on the previous replay's stream when they differ).  A
   dispatch's host copy (``transfer.HostCopy``) starts after the replay,
   outside the capture.
d. Threads: captures run with ``capture_error_mode="thread_local"``, so
   the other threads' CUDA calls (the trimmer's middle-pass worker,
   overlap's prep, the mapper's second shard) neither abort a capture nor
   are refused, and one lock holds each capture, and each copy-in,
   replay and clone-out, together.  ``torch.cuda.graph`` synchronizes
   the device and empties the allocator's cache on entry: a capture is a
   wait, once per key.
e. Memory: every graph of a device is captured into one shared pool
   (``torch.cuda.graph_pool_handle``).  Replays of one device never
   overlap, so their intermediates may share it; what a graph must keep
   (its outputs) it keeps referenced until it is released.
f. Launch counts: a kernel wrapper counts a launch through ``each_run``,
   which counts it at once outside a capture and, inside one, at every
   replay of the graph being captured; so a replay adds the launches it
   contains, and the capture adds none.

``GRAPHS`` is the process's cache (a graph is a property of the process's
device context, as ``jit``'s cache is of the process).  Its ``captures``
counts the captures (the counter ``graph.captures``); a replay (copy-in,
replay, clone-out) is the span ``graph.replay``, a capture (warm-up
included) ``graph.capture``.
"""
from __future__ import annotations

import ctypes
import threading
import time
import weakref

import numpy as np
import torch

from ..utils import metrics
from ..utils.metrics import span


def row_bucket(n: int) -> int:
    """The JAX package's row bucket on the accelerator
    (``downpore_tpu/ops/chain.py:_bucket``, TPU branch): 256, 1024, then
    the 2048 grid."""
    if n <= 256:
        return 256
    if n <= 1024:
        return 1024
    return 2048 if n <= 2048 else ((n + 2047) // 2048) * 2048


def padded_rows(n: int, D: int = 1) -> int:
    """Rows a dispatch of ``n`` rows runs at on a grid of ``D`` data
    shards: ``row_bucket(n)`` rounded up to a multiple of ``D``, as the JAX
    engines round their bucket to the data axis."""
    b = row_bucket(n)
    return -(-b // D) * D


def pad_rows(a, rows: int, fill):
    """Host array ``a`` padded with ``fill`` rows to ``rows`` rows."""
    short = rows - a.shape[0]
    if short <= 0:
        return a
    return np.concatenate([a, np.full((short,) + a.shape[1:], fill,
                                      a.dtype)])


def _shapes(tensors: dict) -> tuple:
    return tuple((n, tuple(t.shape), t.dtype)
                 for n, t in sorted(tensors.items()))


def key_of(fn, inputs: dict, tables: dict, statics: dict) -> tuple:
    """The cache key of a call: the route, its statics, the name, shape
    and dtype of every tensor, and the device."""
    dev = next(iter(inputs.values())).device
    return (fn, tuple(sorted(statics.items())), _shapes(inputs),
            _shapes(tables), str(dev))


_local = threading.local()


def capturing() -> bool:
    """True while this thread captures a graph through ``run``."""
    return getattr(_local, "hooks", None) is not None


def each_run(fn) -> None:
    """Call ``fn()`` now or, while this thread captures a graph, at every
    replay of that graph (right after the replay is enqueued)."""
    hooks = getattr(_local, "hooks", None)
    if hooks is None:
        fn()
    else:
        hooks.append(fn)


class _Entry:
    """One captured key: its graph, static buffers and outputs, the
    hooks its replays call, and what it cost."""

    __slots__ = ("route", "statics", "graph", "inputs", "outputs", "single",
                 "hooks", "replays", "warmup_ms", "capture_ms")

    def __init__(self, route, statics):
        self.route, self.statics = route, statics
        self.replays = 0


class _Table:
    __slots__ = ("buf", "src", "version")


class GraphCache:
    """Captured dispatch blocks by key (see the module docstring).
    ``entries`` maps each key to its ``_Entry``; ``table_copies`` counts
    the copies of resident tables into the cache's buffers and
    ``captures`` the graphs captured."""

    def __init__(self):
        self._lock = threading.RLock()
        self.entries = {}
        self._tables = {}
        self._pools = {}
        self._side = {}
        self._last_stream = {}
        self.table_copies = 0
        self.captures = 0

    # -- buffers --------------------------------------------------------
    def _table(self, dev: str, name: str, t: torch.Tensor) -> torch.Tensor:
        """The cache's buffer for table ``name`` of ``t``'s shape and
        dtype on ``dev``, holding ``t``'s values (copied when the buffer
        last took another tensor, or ``t`` changed since)."""
        key = (dev, name, tuple(t.shape), t.dtype)
        rec = self._tables.get(key)
        if rec is None:
            rec = _Table()
            rec.buf = torch.empty_like(
                t, memory_format=torch.contiguous_format)
            rec.src = None
            self._tables[key] = rec
        src = rec.src() if rec.src is not None else None
        if src is not t or rec.version != t._version:
            rec.buf.copy_(t, non_blocking=True)
            rec.src = weakref.ref(t)
            rec.version = t._version
            self.table_copies += 1
        return rec.buf

    def _order(self, dev: torch.device) -> torch.cuda.Stream:
        """The current stream of ``dev``, made to wait on the stream of
        the device's previous replay when it is another one."""
        cur = torch.cuda.current_stream(dev)
        last = self._last_stream.get(str(dev))
        if last is not None and last != cur:
            cur.wait_stream(last)
        self._last_stream[str(dev)] = cur
        return cur

    # -- entry point ----------------------------------------------------
    def run(self, fn, inputs: dict, tables: dict = None, **statics):
        """``fn(**inputs, **tables, **statics)``: called as it is on the
        CPU, captured at a key's first call and replayed after it on a
        card.  ``inputs`` are the per-dispatch tensors, ``tables`` the
        resident ones, ``statics`` the Python arguments (budgets, shapes'
        parameters, flags)."""
        tables = tables or {}
        dev = next(iter(inputs.values())).device
        if dev.type != "cuda":
            return fn(**inputs, **tables, **statics)
        key = key_of(fn, inputs, tables, statics)
        with self._lock, torch.cuda.device(dev):
            cur = self._order(dev)
            tabs = {n: self._table(str(dev), n, t)
                    for n, t in tables.items()}
            e = self.entries.get(key)
            if e is None:
                with span("graph.capture"):
                    return self._capture(key, fn, inputs, tabs, statics,
                                         dev, cur)
            with span("graph.replay"):
                for n, t in inputs.items():
                    e.inputs[n].copy_(t, non_blocking=True)
                e.graph.replay()
                out = tuple(o.clone() for o in e.outputs)
                for h in e.hooks:
                    h()
                e.replays += 1
            return out[0] if e.single else out

    def _capture(self, key, fn, inputs, tabs, statics, dev, cur):
        e = _Entry(getattr(fn, "__name__", repr(fn)), dict(statics))
        e.inputs = {n: t.clone(memory_format=torch.contiguous_format)
                    for n, t in inputs.items()}
        side = self._side.get(str(dev))
        if side is None:
            side = self._side[str(dev)] = torch.cuda.Stream(dev)
        pool = self._pools.get(str(dev))
        if pool is None:
            pool = self._pools[str(dev)] = torch.cuda.graph_pool_handle()
        # the warm-up: an eager run on the side stream, whose result is
        # this call's output
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            warm = fn(**e.inputs, **tabs, **statics)
        t1 = time.perf_counter()
        e.single = torch.is_tensor(warm)
        warm = (warm,) if e.single else tuple(warm)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        hooks = []
        _local.hooks = hooks
        try:
            with torch.cuda.graph(g, pool=pool,
                                  capture_error_mode="thread_local"):
                out = fn(**e.inputs, **tabs, **statics)
        finally:
            _local.hooks = None
        g.instantiate()
        e.capture_ms = (time.perf_counter() - t1) * 1e3
        e.warmup_ms = (t1 - t0) * 1e3
        e.graph, e.hooks = g, hooks
        e.outputs = (out,) if e.single else tuple(out)
        self.entries[key] = e
        self.captures += 1
        cur.wait_stream(side)
        for t in warm:
            t.record_stream(cur)
        return warm[0] if e.single else warm

    # -- what it holds --------------------------------------------------
    def stats(self) -> dict:
        """Per captured key, a dict of its route, statics, replays, graph
        nodes, and warm-up and capture milliseconds."""
        with self._lock:
            return {k: dict(route=e.route, statics=e.statics,
                            replays=e.replays, nodes=graph_nodes(e.graph),
                            warmup_ms=e.warmup_ms, capture_ms=e.capture_ms)
                    for k, e in self.entries.items()}

    def pool_bytes(self) -> int:
        """Device bytes the allocator holds in this cache's graph pools."""
        ids = {tuple(p) for p in self._pools.values()}
        if not ids:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) in ids)

    def table_bytes(self) -> int:
        """Device bytes of the cache's resident-table buffers."""
        return sum(r.buf.numel() * r.buf.element_size()
                   for r in self._tables.values())


def graph_nodes(g: torch.cuda.CUDAGraph) -> int:
    """Nodes of a graph captured with ``keep_graph=True``
    (``cuGraphGetNodes`` of ``libcuda``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None,
                              ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return n.value


GRAPHS = GraphCache()
metrics.counter("graph.captures", lambda: GRAPHS.captures)


def run(fn, inputs: dict, tables: dict = None, **statics):
    """``GRAPHS.run``: see ``GraphCache.run``."""
    return GRAPHS.run(fn, inputs, tables, **statics)
