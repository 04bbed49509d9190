"""Helpers of the per-layer metric readers (``benchmark/metrics/``).

A reader returns None where it finds nothing to read, and the harness
then leaves its metric out of the result; it never returns 0 for a share
of a roofline."""
from __future__ import annotations


def span_ms_per_unit(ctx, name: str):
    """Host milliseconds of the ``name`` spans a unit of the window (summed
    over threads)."""
    s = ctx.spans.seconds(name, *ctx.window)
    return sum(s) * 1e3 / ctx.units if s and ctx.units else None


def span_ms_per_call(ctx, name: str):
    """Mean host milliseconds of a ``name`` span in the window."""
    s = ctx.spans.seconds(name, *ctx.window)
    return sum(s) * 1e3 / len(s) if s else None


def counter_per_unit(ctx, name: str):
    """A program counter's growth over the window, a unit."""
    if name not in ctx.counters or not ctx.units:
        return None
    return ctx.counters[name] / ctx.units


def roofline_pct(ctx, kind: str):
    """Σ bound / Σ device time of the window's launches of the ``kind``
    kernel (``counts``, ``anchors``, ``chain``), in percent."""
    s = ctx.kernels.get(kind)
    if not s or s[1] <= 0:
        return None
    return 100.0 * s[0] / s[1]


def idle_pct(ctx):
    """The device's idle share of the traced window, in percent."""
    return None if ctx.idle is None else 100.0 * ctx.idle
