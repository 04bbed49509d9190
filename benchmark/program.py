"""The program's own spans and counters, for the readers of the metrics
that read them in a ``--trace 1`` run.

The port records them itself (``downpore_tpu_torch.utils.metrics``): spans
with thread, parent and ``perf_counter_ns`` times (the clock of the
harness's window), and, on each ``map.batch`` span, its named counters at
the batch's start and end.  A reader of such a metric calls ``trace()``
when it is loaded: the harness loads readers only for a traced run, after
the cell's set-up and before its warm pass, so the tracer records the warm
pass and the window, and the untraced run never switches it on.  The first
``window(ctx)`` switches it off and keeps the spans that began in the
window as ``ctx.program``.  Where the program has no tracer, ``trace()``
does nothing and every reader here returns None.
"""
from __future__ import annotations


def _tracer():
    try:
        from downpore_tpu_torch.utils import metrics
    except ImportError:
        return None
    return metrics if hasattr(metrics, "enable") else None


def trace() -> None:
    """Switch the program's tracer on, where it has one."""
    m = _tracer()
    if m is not None:
        m.enable()


def window(ctx):
    """The program's spans that began in the window, in order of start
    (``ctx.program``); None where the program kept none."""
    if not hasattr(ctx, "program"):
        ctx.program = None
        m = _tracer()
        if m is not None:
            m.disable()
            lo, hi = (int(t * 1e9) for t in ctx.window)
            ctx.program = sorted(
                (s for ss in m.spans().values() for s in ss
                 if lo <= s.start <= hi), key=lambda s: s.start) or None
    return ctx.program


def ms_per_unit(ctx, name: str):
    """Milliseconds of the window's ``name`` spans a unit, summed over
    threads (0 where the program traced the window and ran none)."""
    spans = window(ctx)
    if spans is None or not ctx.units:
        return None
    return sum(s.end - s.start for s in spans
               if s.name == name) / 1e6 / ctx.units


def shards(ctx):
    """The window's ``map.shard`` spans, each with the ``map.stage`` spans
    under it: ``[(shard, [stage, ...])]``; None where there are none."""
    spans = window(ctx)
    if spans is None or not ctx.units:
        return None
    by_id = {s.id: s for s in spans}
    out = {s.id: (s, []) for s in spans if s.name == "map.shard"}
    for s in spans:
        if s.name != "map.stage":
            continue
        up = by_id.get(s.parent)
        while up is not None and up.name != "map.shard":
            up = by_id.get(up.parent)
        if up is not None:
            out[up.id][1].append(s)
    return list(out.values()) or None


def counter_growth(ctx, names):
    """Growth of the named program counters over the window's units (from
    the first ``map.batch`` span's start to the last one's end), summed;
    None where the program does not count them."""
    spans = window(ctx)
    if spans is None:
        return None
    batches = [s for s in spans if s.name == "map.batch" and s.counts]
    if not batches or any(n not in batches[0].counts[0] for n in names):
        return None
    last = max(batches, key=lambda s: s.end)
    return sum(last.counts[1][n] - batches[0].counts[0][n] for n in names)
