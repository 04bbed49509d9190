"""What a ``--trace 1`` run reads: host spans around calls into the
port's layers, the work of the path kernels' launches, and the device's
activity from ``torch.profiler``.

Every hook is set from outside the program (``patched``) and taken away
afterwards; nothing inside the program changes.  Spans are the host's
``perf_counter`` seconds of each call, from every thread.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import sys
import threading
import time

import torch

from . import bounds


@contextlib.contextmanager
def patched(subs):
    """``(owner, attribute, replacement)`` substitutions for the block;
    afterwards each attribute is restored, or unshadowed where the owner
    inherited it."""
    saved = [(owner, n, owner.__dict__.get(n)) for owner, n, _ in subs]
    for owner, n, fn in subs:
        setattr(owner, n, fn)
    try:
        yield
    finally:
        for owner, n, fn in reversed(saved):
            if fn is None:
                delattr(owner, n)
            else:
                setattr(owner, n, fn)


def resolve(where: str):
    """``"module:Class.attr"`` or ``"module:attr"`` -> (owner, attr)."""
    mod, _, path = where.partition(":")
    owner = importlib.import_module(mod)
    *parts, attr = path.split(".")
    for p in parts:
        owner = getattr(owner, p)
    return owner, attr


class Spans:
    """Host spans by name: (start, end) perf_counter seconds."""

    def __init__(self):
        self.lock = threading.Lock()
        self.by_name: dict = {}

    def wrap(self, fn, name: str):
        spans = self

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                e = time.perf_counter()
                with spans.lock:
                    spans.by_name.setdefault(name, []).append((t, e))
        return wrapper

    def hooks(self, hooks):
        """``patched`` substitutions for ``(where, span name)`` hooks."""
        subs, seen = [], set()
        for where, name in hooks:
            if where in seen:
                continue
            seen.add(where)
            owner, attr = resolve(where)
            subs.append((owner, attr, self.wrap(getattr(owner, attr), name)))
        return patched(subs)

    def seconds(self, name: str, lo: float, hi: float) -> list:
        """Durations of the ``name`` spans that began in ``[lo, hi]``."""
        return [e - s for s, e in self.by_name.get(name, ())
                if lo <= s <= hi]

    def flat(self, lo: float, hi: float) -> list:
        return [(s, e, n) for n, v in self.by_name.items() for s, e in v
                if e >= lo and s <= hi]


# the path kernels' entries: (module, function, kind of bound, chain mode)
KERNELS = (
    ("downpore_tpu_torch.ops.cuda_counts", "retrieval_count", "counts", None),
    ("downpore_tpu_torch.ops.cuda_anchors", "anchors_topk", "anchors", None),
    ("downpore_tpu_torch.ops.cuda_anchors", "anchors_topk_indexed",
     "anchors", None),
    ("downpore_tpu_torch.ops.cuda_chain", "chain_scan", "chain", "forward"),
    ("downpore_tpu_torch.ops.cuda_chain", "chain_scan_fb", "chain", "fb"),
    ("downpore_tpu_torch.ops.cuda_chain", "chain_scan_lean", "chain", "lean"),
)
# each kind's launch counter, and the names of its kernels in a trace
COUNTERS = {
    "counts": ("downpore_tpu_torch.ops.cuda_counts", "retrieval_count"),
    "anchors": ("downpore_tpu_torch.ops.cuda_anchors", "anchors_topk"),
    "chain": ("downpore_tpu_torch.ops.cuda_chain", "chain_scan"),
}
TRACE_NAMES = {
    "counts": ("retrieval_count_kernel",),
    "anchors": ("anchors_topk_kernel",),
    "chain": ("chain_scan_regs", "chain_scan_smem"),
}
CAPTURED = "downpore_tpu_torch.ops.captured"


def launches() -> dict:
    """Each kind's launch counter (a replayed graph counts its launches)."""
    return {kind: getattr(importlib.import_module(mod), fn).launches
            for kind, (mod, fn) in COUNTERS.items()}


def kind_of_kernel(name: str):
    """The kind of a traced device kernel, or None."""
    for kind, names in TRACE_NAMES.items():
        if any(n in name for n in names):
            return kind
    return None


class Work:
    """The work of the path kernels' launches in one unit: the sum of the
    bounds (ms at the card's peaks, ``bounds``) and the launches of each
    kind, recorded at the functions the engines call.

    ``unit_work(unit)`` runs ``unit()`` once with every engine block run
    eagerly (``captured.run`` as it is on the CPU: the same function on
    the same inputs, but no graph, so that each launch passes its entry)
    and returns that unit's work.  A unit repeats byte for byte (the
    digests show it), so the window's launches of a unit do the same
    work as these."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cur = None

    def _wrap(self, fn, kind, mode):
        sig = inspect.signature(fn)
        rec = self

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            if rec.cur is not None:
                ba = sig.bind(*a, **kw)
                ba.apply_defaults()
                args = tuple(ba.arguments.values())
                outs = out if isinstance(out, tuple) else (out,)
                b_ms = launch_bound(fn.__name__, mode, args, outs)
                with rec.lock:
                    s = rec.cur.setdefault(kind, [0.0, 0])
                    s[0] += b_ms
                    s[1] += 1
            return out
        return wrapper

    def hooks(self):
        """``patched`` substitutions of every reference to each kernel
        entry in the program's loaded modules, and of ``captured.run`` by
        its eager form."""
        subs = []
        for mod, name, kind, mode in KERNELS:
            fn = getattr(importlib.import_module(mod), name)
            w = self._wrap(fn, kind, mode)
            for m in list(sys.modules.values()):
                if (getattr(m, "__name__", "").split(".")[0]
                        == "downpore_tpu_torch"
                        and m.__dict__.get(name) is fn):
                    subs.append((m, name, w))

        def eager(fn, inputs, tables=None, **statics):
            return fn(**inputs, **(tables or {}), **statics)
        subs.append((importlib.import_module(CAPTURED), "run", eager))
        return patched(subs)

    def unit_work(self, unit) -> dict:
        self.cur = {}
        try:
            with self.hooks():
                unit()
                torch.cuda.synchronize()
            return self.cur
        finally:
            self.cur = None


def launch_bound(entry: str, mode, args, outs) -> float:
    """The bound in ms of one launch of a kernel entry on ``args`` (the
    entry's arguments in order, defaults filled in)."""
    if entry == "retrieval_count":
        return bounds.counts_bound(args)[0]
    if entry == "anchors_topk":
        return bounds.anchors_bound(args[:4], outs)[0]
    if entry == "anchors_topk_indexed":
        mi, ci, live, qs, qpos, ts, tpos = args
        return bounds.anchors_bound((qs, qpos, ts, tpos, mi, ci, live),
                                    outs)[0]
    return bounds.chain_bound(args[4], mode)[0]


def rooflines(per_unit: dict, window_units: dict, window_launches: dict,
              dev) -> dict:
    """Per kind: (sum of bounds ms, device ms of its kernels, launches)
    over the window.  ``per_unit[u]`` is the work of unit ``u``
    (``Work.unit_work``), ``window_units[u]`` how often the window ran it,
    ``window_launches`` the launches counted in the window and ``dev`` the
    traced window's device activity.  A kind whose launches in the window
    are not the recorded units' launches is left out, with a line on
    standard error."""
    ms = {}
    for s, e, name in dev:
        kind = kind_of_kernel(name)
        if kind is not None:
            ms[kind] = ms.get(kind, 0.0) + (e - s) / 1e3
    out = {}
    for kind in COUNTERS:
        bound_ms = sum(n * per_unit[u].get(kind, [0.0, 0])[0]
                       for u, n in window_units.items())
        want = sum(n * per_unit[u].get(kind, [0.0, 0])[1]
                   for u, n in window_units.items())
        got = window_launches.get(kind, 0)
        if got != want:
            print(f"roofline {kind}: {got} launches in the window, the "
                  f"recorded units make {want}; left out", file=sys.stderr)
            continue
        if got and ms.get(kind, 0.0) > 0:
            out[kind] = (bound_ms, ms[kind], got)
    return out


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_activity(prof, window_name: str):
    """(window start us, window end us, [(start us, end us, name)] of the
    device's kernels, copies and sets) from a profile whose host range
    ``window_name`` spans the measured window."""
    from torch.autograd import DeviceType
    ws = we = None
    dev = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name == window_name and ws is None:
            ws, we = e.time_range.start, e.time_range.end
    if ws is None:
        raise RuntimeError(f"the profile lacks the range {window_name!r}")
    dev = [(max(s, ws), min(e, we), n) for s, e, n in dev
           if e > ws and s < we]
    return ws, we, dev


def breakdown(ws, we, dev, host_spans, t0_host: float, top: int = 10):
    """The device operations that took most time, and the longest idle
    gaps of the window named by the host span that covered each gap's
    middle (the shortest such span; "untraced host work" where none)."""
    ops = {}
    for s, e, n in dev:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], ws
    for s, e, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if we > end:
        gaps.append((end, we))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = t0_host + ((a + b) / 2 - ws) / 1e6
        cover = [(e - s, n) for s, e, n in host_spans if s <= mid <= e]
        name = min(cover)[1] if cover else "untraced host work"
        named.append([name, (b - a) / 1e6])
    return {"device_ops": [[n, v] for n, v in device_ops],
            "idle_gaps": named}
