"""Read-to-reference mapping on the torch engine.

``downpore_tpu.mapping.Mapper`` is host code apart from two methods: the
device index build and the candidate walk's summary unpacking.  This
subclass swaps in the port's ``MapEngine`` on an explicit ``device`` and
the port's ``unpack_summary``; chunking, the staged per-read flow (ends,
mapNext, chimera split), pairing and PAF output are inherited unchanged.
"""
from __future__ import annotations

import numpy as np

from downpore_tpu import native
from downpore_tpu.mapping import mapper as _ref

from .. import resolve_device
from ..ops.chain import unpack_summary
from ..ops.map_engine import MapEngine

Mapping = _ref.Mapping


class Mapper(_ref.Mapper):
    def __init__(self, reference, circular: bool, k: int,
                 kmer_values: np.ndarray, seed_rate: int = 40,
                 edge_size: int = 1000, chunk_size: int = 10000,
                 mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Mapper(mesh=...) is not ported yet: ROADMAP.md, 'Multi-GPU'")
        self.device = resolve_device(device)
        super().__init__(reference, circular, k, kmer_values, seed_rate,
                         edge_size, chunk_size)

    def _build_device_index(self):
        """Resident engine on ``self.device``, sized as the JAX mapper
        sizes it (``downpore_tpu/mapping/mapper.py:78-103``)."""
        max_ts = max((s.num_seeds for s in self.index.sequences),
                     default=1)
        nt = min(2048, max(320, ((max_ts + 127) // 128) * 128))
        exp_hits = (self.edge_size - self.k + 1) \
            * self.index.num_seeds / (4 ** self.k)
        nq = int(min(192, max(64, -(-2 * exp_hits // 32) * 32)))
        self.engine = MapEngine(self.index, self.k, nq=nq, nt=nt,
                                hit_fraction=0.25, lean=True, binned=True,
                                device=self.device)

    def _walk_candidates(self, queries, num_seeds, coll, results,
                         base: int):
        """Adaptive-threshold candidate walk for one dispatch's rows
        (ref: mapping.go:494-589); the JAX mapper's walk with the port's
        summary unpacking."""
        if coll is None:
            return
        head, packed = coll
        N = head.shape[0]
        if N == 0:
            return
        k = self.k
        K = 4
        s = unpack_summary(packed, K, lean=self.engine.lean)
        mi = head[:, 0]
        ci = head[:, 1]
        eng = self.engine
        ch_off = eng.chunk_off[ci]
        ch_inset = eng.chunk_inset[ci]
        ch_len = eng.chunk_len[ci]
        ref_len = len(self.reference)
        nq = len(queries)
        qi_row = mi >> 1
        is_rc = (mi & 1).astype(bool)
        qlen = np.fromiter((len(q) for q in queries), np.int64, nq)[qi_row]
        qoff = np.fromiter((q.offset for q in queries), np.int64, nq)[qi_row]
        qins = np.fromiter((q.inset for q in queries), np.int64, nq)[qi_row]
        # RC rows swap offset/inset (Sequence.reverse_complement semantics)
        moff = np.where(is_rc, qins, qoff)
        mins_ = np.where(is_rc, qoff, qins)
        sqp, stp = s["top_sqp"], s["top_stp"]
        eqp, etp = s["top_eqp"], s["top_etp"]
        start = ch_off[:, None] + stp
        end = ref_len - ch_inset[:, None] - (ch_len[:, None] - etp - k)
        if self.circular:
            start = np.where(start > ref_len, start - ref_len, start)
        qil = qlen[:, None] - eqp - k
        ok23 = (sqp + qil) <= (qlen[:, None] * 2) // 3
        q_offset = np.where(is_rc[:, None], qil + mins_[:, None],
                            sqp + moff[:, None])
        q_inset = np.where(is_rc[:, None], sqp + moff[:, None],
                           qil + mins_[:, None])
        # rows are sorted by mi (query-major compaction order)
        bounds = np.searchsorted(mi, np.arange(2 * nq + 1))

        acc = native.walk_candidates(
            bounds, num_seeds, nq, np.ascontiguousarray(head[:, 2]),
            s["best"], s["top_valid"], s["top_len"], s["top_cov_t"],
            eqp, etp, sqp, stp, ok23, K)
        if acc is not None:
            self._emit_accepted(queries, acc, start, end, q_offset,
                                q_inset, s["top_cov_t"], results, base)
            return
        self._walk_candidates_py(queries, num_seeds, s, head, bounds,
                                 start, end, q_offset, q_inset, ok23,
                                 eqp, etp, sqp, stp, results, base, K)
