"""The controls and the faults planted in the program, for the checks that
``correct`` must fail.

Each is a context manager that patches the port from outside (the
``trace.patched`` pattern) for the block:

* ``forward_strand_only``: the control.  The configurations state that
  each query window is searched on both strands; this anchor build leaves
  the reverse-complement twin rows (the odd rows, ``MapEngine``'s
  ``[2i] = forward, [2i + 1] = reverse complement`` layout) without query
  seeds, which would halve the anchor work.
* ``half_query_seeds``: a second control.  The configurations state that
  every query seed of a window is anchored (each of its first two hits in
  a candidate chunk); this anchor build keeps every second query seed.
* ``half_left_out``: half of each batch's reads are left out of its output.
* ``answer_altered``: each read's first mapping is moved one base along the
  reference where it is produced.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import sys

from .trace import patched

ANCHORS = "downpore_tpu_torch.ops.cuda_anchors"


def _everywhere(module: str, name: str, make):
    """Substitutions of ``make(fn)`` for every reference to
    ``module.name`` in the program's loaded modules."""
    fn = getattr(importlib.import_module(module), name)
    # the copy keeps the function's attributes (its launch counter)
    w = functools.wraps(fn)(make(fn))
    return [(m, name, w) for m in list(sys.modules.values())
            if getattr(m, "__name__", "").split(".")[0]
            == "downpore_tpu_torch" and m.__dict__.get(name) is fn]


def _query_seeds_cut(rows: slice, cols: slice):
    """Both anchor entries with ``q_seeds[rows, cols]`` emptied."""
    def plain(fn):
        def cut(qs, qpos, ts, tpos, *a, **kw):
            qs = qs.clone()
            qs[rows, cols] = -1
            return fn(qs, qpos, ts, tpos, *a, **kw)
        return cut

    def indexed(fn):
        def cut(mi, ci, live, q_seeds, *a, **kw):
            q_seeds = q_seeds.clone()
            q_seeds[rows, cols] = -1
            return fn(mi, ci, live, q_seeds, *a, **kw)
        return cut

    return patched(_everywhere(ANCHORS, "anchors_topk", plain)
                   + _everywhere(ANCHORS, "anchors_topk_indexed", indexed))


@contextlib.contextmanager
def forward_strand_only():
    with _query_seeds_cut(slice(1, None, 2), slice(None)):
        yield


@contextlib.contextmanager
def half_query_seeds():
    with _query_seeds_cut(slice(None), slice(1, None, 2)):
        yield


@contextlib.contextmanager
def half_left_out():
    from downpore_tpu_torch.mapping import Mapper
    fn = Mapper.map_batch

    def map_batch(self, reads):
        out = fn(self, reads)
        return out[: len(out) // 2] + [[] for _ in out[len(out) // 2:]]
    with patched([(Mapper, "map_batch", map_batch)]):
        yield


@contextlib.contextmanager
def answer_altered():
    from downpore_tpu_torch.mapping import Mapper
    fn = Mapper.map_batch

    def map_batch(self, reads):
        out = fn(self, reads)
        for maps in out:
            if maps:
                maps[0].start += 1
        return out
    with patched([(Mapper, "map_batch", map_batch)]):
        yield


PLANTS = {"forward_strand_only": forward_strand_only,
          "half_query_seeds": half_query_seeds,
          "half_left_out": half_left_out,
          "answer_altered": answer_altered}


def plant(name: str):
    """The control or fault ``name``."""
    return PLANTS[name]()
