"""All-vs-all overlap detection on the torch engine.

``downpore_tpu.overlap.Overlapper`` is host code (query preparation, read
chunking and indexing, the adaptive min-match collation) apart from
``dispatch_find``, which builds the device engine.  This subclass builds
the port's ``MapEngine`` on an explicit ``device``; everything else,
``collect_find`` included, is inherited unchanged.  The JAX engine's
cross-round shape plan and its round-0 pair-budget peek have no
counterpart: the port's engine selects every passing pair.
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np

from downpore_tpu.overlap import overlapper as _ref

from .. import resolve_device
from ..ops.map_engine import MapEngine

# queries per engine dispatch: bounds the [M, C] retrieval counts
SUB = 2048


class Overlapper(_ref.Overlapper):
    def __init__(self, index, chunk_size: int, overlap: int,
                 min_seeds: int, hit_fraction: float, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Overlapper(mesh=...) is not ported yet: ROADMAP.md, "
                "'Multi-GPU'")
        self.device = resolve_device(device)
        super().__init__(index, chunk_size, overlap, min_seeds,
                         hit_fraction)

    def dispatch_find(self, queries: List[_ref.SeedQuery]):
        """Build the round's engine on ``self.device`` and run the fused
        overlap pipeline over the queries in ``SUB``-query batches;
        returns ``(engine, [(first query, result), ...])`` for
        ``collect_find``, or None for an empty round."""
        if not queries or self.index.num_sequences == 0:
            return None
        if self.index._seed_counts is None:
            self.index.index_sequences()
        # target-seed axis sized to the round's real chunks (reads shorter
        # than chunk_size index as one chunk with all their seeds), on the
        # JAX engine's ladder {256, 512, 1024, 2048, 4096}
        max_ts = max((s.num_seeds for s in self.index.sequences),
                     default=1)
        nt = 256
        while nt < max_ts and nt < 4096:
            nt *= 2
        if max_ts > nt:
            print(f"overlap: {max_ts}-seed chunks truncated to {nt} "
                  f"target seeds (chunk anchors past that are dropped; "
                  f"lower -chunk_size to avoid)", file=sys.stderr)
        eng = MapEngine(self.index, self.index.k, nq=128, nt=nt,
                        hit_fraction=self.hit_fraction, device=self.device)
        base_min = np.array(
            [int(self.hit_fraction * q.query.num_seeds + 0.5)
             for q in queries], np.int32)
        subs = []
        for lo in range(0, len(queries), SUB):
            sq = queries[lo : lo + SUB]
            subs.append((lo, eng.dispatch_chains(
                [q.query for q in sq], base_min[lo : lo + SUB])))
        return eng, subs
