"""The port's tracer: spans of what the program does, its named counters,
stage timing, and the ``-profile DIR`` trace of its commands.

``span(name)`` times a block of one thread while tracing is on
(``enable()`` / ``disable()``): name, thread, start and end on
``time.perf_counter_ns``, and the span it ran inside (the innermost open
span of its thread, or the ``parent`` passed where a block is handed to
another thread).  On request it also takes the thread's CPU time
(``cpu=True``) and the named counters at its start and end
(``counts=True``).  While a ``torch.profiler`` capture records on its
thread, a span also opens a profiler range of its name (the profiler's
``_RecordFunctionFast``, a ``cpu_op`` event), so its range lies in the
profiler's trace on the trace's own clock.  With tracing off a span
costs one test of a module-level flag: it reads no clock and opens no
range.  ``spans()`` returns what a recording kept, in memory.
``traced(name)`` makes every call of a function a span.

Counters stay integer attributes of the object that does the work
(``transfer.upload.bytes``, ``HostCopy.bytes``, ``GRAPHS.captures``,
``MapEngine.gate_pairs``);
``counter(name, read)`` names one for ``counters()``.

``StageTimer`` accumulates seconds and item counts per named stage, each
stage a span, and reports them on stderr.  ``start_profiler`` /
``stop_profiler`` capture a ``torch.profiler`` trace with tracing on: a
Chrome trace, ``DIR/trace.json``, with device activity when the command
computes on a CUDA card, and every span of the recording in it (the
profiler records ranges on its own thread only, so the spans of other
threads are added to the file, placed by the offset between the recording
thread's spans and their ranges)."""
from __future__ import annotations

import functools
import itertools
import json
import os
import statistics
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

_on = False
_kept: List["Span"] = []
_ids = itertools.count(1)
_local = threading.local()
_counters: Dict[str, Callable[[], int]] = {}


def enable() -> None:
    """Switch tracing on; a new recording starts (nothing changes while
    it is on)."""
    global _on, _kept
    if not _on:
        _kept = []
        _on = True


def disable() -> None:
    """Switch tracing off; what the recording kept stays for ``spans()``."""
    global _on
    _on = False


def spans() -> Dict[int, List["Span"]]:
    """The recording's closed spans by thread id, each thread's in the
    order they ended."""
    out: Dict[int, List[Span]] = {}
    for s in list(_kept):
        out.setdefault(s.tid, []).append(s)
    return out


def counter(name: str, read: Callable[[], int]) -> None:
    """Name a program counter: ``read()`` returns its value."""
    _counters[name] = read


def counters() -> Dict[str, int]:
    """Every named counter's value."""
    return {n: read() for n, read in _counters.items()}


def _thread():
    """This thread's (open spans, native thread id)."""
    try:
        return _local.stack, _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack, _local.tid


class _Off:
    """The span of a tracer that is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One timed block of one thread: ``name``, ``id``, ``parent`` (the id
    of the span it ran inside, 0 for none), ``tid`` (the native thread
    id), ``start`` and ``end`` (``time.perf_counter_ns``); on request
    ``cpu_ns``, the thread's CPU time in it, and ``counts``, the named
    counters at its start and end.  ``keep`` False times the block
    without recording it (a ``StageTimer`` stage while tracing is off)."""

    __slots__ = ("name", "id", "parent", "tid", "start", "end", "cpu_ns",
                 "counts", "_keep", "_range")

    def __init__(self, name: str, parent=None, cpu: bool = False,
                 counts: bool = False, keep: bool = True):
        self.name = name
        self.parent = parent.id if isinstance(parent, Span) else parent
        self.cpu_ns = 0 if cpu else None
        self.counts = () if counts else None
        self._keep = keep
        self._range = None

    def __enter__(self):
        stack, self.tid = _thread()
        if self.parent is None:
            self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)
        if self._keep and torch._C._autograd._profiler_enabled():
            # not ``record_function``: under the CUDA profiler, with another
            # Python thread running (the map's second shard), one call of
            # it took ~3.5 ms on an H100 host, waiting out that thread's
            # hold of the interpreter lock; this range took ~2 us
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        if self.counts is not None:
            self.counts = (counters(),)
        if self.cpu_ns is not None:
            self.cpu_ns = time.thread_time_ns()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.cpu_ns is not None:
            self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        if self.counts is not None:
            self.counts += (counters(),)
        _thread()[0].pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._keep:
            _kept.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, parent=None, cpu: bool = False, counts: bool = False):
    """A context manager timing its block as span ``name`` while tracing
    is on (see the module docstring); it enters as the ``Span``, or as
    None with tracing off.  ``parent`` (a ``Span`` or an id) places the
    span under a span of another thread."""
    if not _on:
        return _OFF
    return Span(name, parent, cpu, counts)


def traced(name: str):
    """Decorator: each call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            if not _on:
                return fn(*a, **kw)
            with Span(name):
                return fn(*a, **kw)
        return call
    return wrap


class StageTimer:
    """Accumulates (seconds, item count) per named stage; each stage is a
    span (recorded while tracing is on)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: Dict[str, list] = {}

    @contextmanager
    def stage(self, name: str, items: int = 0):
        s = Span(name, keep=_on)
        try:
            with s:
                yield self
        finally:
            acc = self.stages.setdefault(name, [0.0, 0])
            acc[0] += s.seconds
            acc[1] += items

    def add_items(self, name: str, items: int):
        acc = self.stages.setdefault(name, [0.0, 0])
        acc[1] += items

    def report(self, out=None):
        if out is None:
            out = sys.stderr  # resolved at call time (testable)
        if not self.enabled or not self.stages:
            return
        for name, (secs, items) in self.stages.items():
            rate = f"  ({items / secs:.1f}/s)" if items and secs > 0 else ""
            count = f"  {items} items" if items else ""
            print(f"[stage] {name}: {secs:.2f}s{count}{rate}", file=out)


_active: Optional[tuple] = None   # (profiler, trace dir, recording thread)


def start_profiler(trace_dir: str, device: torch.device):
    """Begin a ``torch.profiler`` capture of the host and ``device``, with
    tracing on."""
    global _active
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    enable()
    _active = (prof, trace_dir, threading.get_native_id())


def stop_profiler():
    """End the capture and write ``trace.json`` into its directory, the
    spans of the threads the profiler did not record added."""
    global _active
    if _active is None:
        return
    prof, trace_dir, tid = _active
    _active = None
    disable()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    add_thread_spans(path, tid, spans())
    print(f"[profile] trace written to {trace_dir}", file=sys.stderr)


def add_thread_spans(path: str, tid: int, by_thread: dict) -> None:
    """Write into the Chrome trace ``path`` the spans of every thread but
    ``tid``, the thread the profiler recorded.  Their times move to the
    trace's clock by the median offset between ``tid``'s spans and their
    ranges in the trace (the k-th range of a name is the k-th span of that
    name)."""
    others = [s for t, ss in by_thread.items() if t != tid for s in ss]
    if not others:
        return
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    own: Dict[str, list] = {}
    for s in sorted(by_thread.get(tid, ()), key=lambda s: s.start):
        own.setdefault(s.name, []).append(s.start / 1e3)
    ranges: Dict[str, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("tid") == tid and e["name"] in own:
            ranges.setdefault(e["name"], []).append(e["ts"])
    offsets = [ts - t for n, t0 in own.items()
               for ts, t in zip(sorted(ranges.get(n, ())), t0)]
    if not offsets:
        return
    off = statistics.median(offsets)
    pid = os.getpid()
    for s in others:
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": s.tid, "ts": s.start / 1e3 + off,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"id": s.id, "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(trace, f)


__all__ = ["Span", "StageTimer", "add_thread_spans", "counter", "counters",
           "disable", "enable", "span", "spans", "start_profiler",
           "stop_profiler", "traced"]
