"""All-vs-all overlap detection.

Mirrors the reference overlapper (ref: overlap/overlap.go): queries are
read edges (or centres / whole reads) that contribute seeds to a shared
batch until ``seed_limit`` unique seeds exist; every read is then chopped
into ~chunk-size pieces with overlap/2 step-back and indexed; overlaps are
retrieved with the hit-fraction rule and chained.

Device mapping: the port's ``MapEngine`` on an explicit ``device`` runs
candidate retrieval, the distinct-seed popcount gate and the anchor chain
DP with the seedAligner gap window (ref: seeds/alignment.go:411-424, the
lean forward kernel) over the whole query set, returning full chains via
backpointers.  Its dispatches run at a pair budget; the job's
``shape_plan`` (one dict for every round of a job, as in the JAX
overlapper) keeps the budget the engine's collects have seen a need for,
so later rounds dispatch right-sized.  The JAX overlapper peeks at the
first sub-batch's count in its first round before dispatching the rest;
here that read happens at collect: the first round's later sub-batches
are dispatched once the first is collected.  With a device grid
(``mesh``) the
engine splits the query batches over the grid's data shards and, with a
seed axis, shards the chunk index's hash-bucket rows.
"""
from __future__ import annotations

import functools
import sys
from typing import Iterable, List

import numpy as np

from .. import resolve_device
from ..core.sequence import Sequence
from ..seeds import SeedIndex, SeedSequence
from ..ops.map_engine import MapEngine
from ..seeds.seed_sequence import SeedMatch

# queries per engine dispatch: bounds the [M, C] retrieval counts
SUB = 2048

QUERY_EDGES = 1
QUERY_CENTRE = 2
QUERY_ALL = 4
WEIGHT_EDGES = 8


def _in_order(subs):
    """``(first query, pending result)`` of each sub-batch of a
    ``dispatch_find`` result, in order.  A deferred sub-batch (a call that
    dispatches it) is dispatched, with every deferred one after it, when
    the collect reaches it: by then the first sub-batch's passing count is
    in the job plan, and they run at its budget."""
    for i, (lo, futs) in enumerate(subs):
        if callable(futs):
            subs[i:] = [(l, f() if callable(f) else f) for l, f in subs[i:]]
            futs = subs[i][1]
        yield lo, futs


class SeedQuery:
    """(ref: overlap/overlap.go:10-16)"""
    __slots__ = ("id", "sequence_id", "query", "at_start", "rc")

    def __init__(self, id: int, sequence_id: int, query: SeedSequence,
                 at_start: bool, rc: bool):
        self.id = id
        self.sequence_id = sequence_id
        self.query = query
        self.at_start = at_start
        self.rc = rc


class Overlapper:
    def __init__(self, index: SeedIndex, chunk_size: int, overlap: int,
                 min_seeds: int, hit_fraction: float, mesh=None,
                 device=None, shape_plan: dict = None):
        # optional DeviceGrid: query batches split over its data shards
        self.mesh = mesh
        self.device = mesh.home if mesh is not None \
            else resolve_device(device)
        self.index = index
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.min_seeds = min_seeds
        self.hit_fraction = hit_fraction
        # the job's plan: the pair budget its rounds have needed
        self.shape_plan = shape_plan if shape_plan is not None else {}

    # -- query preparation ---------------------------------------------
    def _query_subsequences(self, seqs: Iterable[Sequence], query_type: int,
                            seed_limit: int, num_seeds: int,
                            kmer_values: np.ndarray) -> List[Sequence]:
        """Pass 1: pick subsequences and grow the seed set
        (ref: overlap/overlap.go:55-155)."""
        weight_sides = bool(query_type & WEIGHT_EDGES)

        def emit(sub, out):
            if weight_sides and len(sub) > 400:
                out.append(sub.subsequence(0, 200))
                out.append(sub.subsequence(len(sub) - 200, len(sub)))
            else:
                out.append(sub)

        cached: List[Sequence] = []
        for s in seqs:
            if self.index.num_seeds >= seed_limit:
                break
            subs: List[Sequence] = []
            if query_type & QUERY_EDGES:
                if len(s) < self.overlap * 2:
                    emit(s, subs)
                    cached.append(s)
                else:
                    s1 = s.subsequence(0, self.overlap)
                    s2 = s.subsequence(len(s) - self.overlap, len(s))
                    emit(s1, subs)
                    emit(s2, subs)
                    cached.append(s1)
                    cached.append(s2)
            elif query_type & QUERY_CENTRE:
                start = max(0, (len(s) - self.overlap) // 2)
                end = min(start + self.overlap, len(s) - 1)
                centre = s.subsequence(start, end)
                emit(centre, subs)
                cached.append(centre)
            else:  # QUERY_ALL
                if len(s) < self.overlap * 2:
                    emit(s, subs)
                    cached.append(s)
                else:
                    slices = len(s) // self.overlap
                    for i in range(slices):
                        start = (i * len(s)) // slices
                        end = ((i + 1) * len(s)) // slices
                        sub = s.subsequence(start, end)
                        emit(sub, subs)
                        cached.append(sub)
            ns = num_seeds // 2 if weight_sides else num_seeds
            for sub in subs:
                self.index.add_seeds(sub, ns, kmer_values)
        return cached

    def prepare_queries_pass1(self, num_seeds: int, seed_limit: int,
                              kmer_values: np.ndarray,
                              seqs: Iterable[Sequence],
                              query_type: int) -> List[Sequence]:
        """Pass 1 of query prep: pick query subsequences and grow the
        round's seed set until ``seed_limit``.  After this the seed
        table is frozen, so pass 2 (query re-extraction) and
        ``add_sequences`` (read chunk indexing) only READ it — callers
        run those two concurrently (the native extraction releases the
        GIL; measured prep was the overlap round's critical path)."""
        return self._query_subsequences(seqs, query_type, seed_limit,
                                        num_seeds, kmer_values)

    def prepare_queries_pass2(self, cached: List[Sequence]
                              ) -> List[SeedQuery]:
        """Pass 2: re-extract every cached query subsequence with the
        full seed set, plus its RC twin (ref: overlap/overlap.go:182-213)."""
        queries: List[SeedQuery] = []
        k = self.index.k
        for qid, ss in enumerate(
                self.index.new_seed_sequences_batch(cached)):
            queries.append(SeedQuery(qid, ss.id, ss, True, False))
            queries.append(SeedQuery(qid, ss.id,
                                     ss.reverse_complement(k, self.index),
                                     True, True))
        return queries

    def prepare_queries(self, num_seeds: int, seed_limit: int,
                        kmer_values: np.ndarray,
                        seqs: Iterable[Sequence],
                        query_type: int) -> List[SeedQuery]:
        """Two-pass query prep: grow seeds, then re-extract every query
        with the full seed set plus its RC twin
        (ref: overlap/overlap.go:157-214)."""
        return self.prepare_queries_pass2(self.prepare_queries_pass1(
            seqs=seqs, query_type=query_type, seed_limit=seed_limit,
            num_seeds=num_seeds, kmer_values=kmer_values))

    def prepare_round(self, num_seeds: int, seed_limit: int,
                      kmer_values: np.ndarray, query_seqs,
                      query_type: int, all_seqs) -> List[SeedQuery]:
        """Full round prep with the query re-extraction and the read
        chunk indexing overlapped on a worker thread (both only read the
        pass-1-frozen seed table; the heavy extraction is native and
        GIL-releasing).  Equivalent to prepare_queries + add_sequences."""
        cached = self.prepare_queries_pass1(num_seeds, seed_limit,
                                            kmer_values, query_seqs,
                                            query_type)
        if not cached:
            return []
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as tp:
            fq = tp.submit(self.prepare_queries_pass2, cached)
            self.add_sequences(all_seqs)
            return fq.result()

    # -- indexing -------------------------------------------------------
    def add_sequences(self, seqs: Iterable[Sequence]):
        """Chop every read into ~chunk_size / 100-seed chunks with
        overlap/2 step-back and index them
        (ref: overlap/overlap.go:217-318)."""
        for ss in self.index.new_seed_sequences_batch(seqs):
            self._chunk_and_add(ss)
        self.index.index_sequences()

    def _chunk_and_add(self, s: SeedSequence):
        """Port of chunkWorker (ref: overlap/overlap.go:253-318)."""
        k = self.index.k
        num_chunks = s.length // self.chunk_size + 1
        n = s.num_seeds
        if num_chunks == 1 or n < self.min_seeds * 3:
            if n >= self.min_seeds:
                self.index.add_sequence(s)
            return
        pos = s.seed_positions(k)
        prev = 0                     # first seed of current chunk
        total_offset = int(pos[0])   # bases before seed `prev`
        while True:
            if prev >= n - 150:  # add right up to the end
                if prev == 0:
                    self.index.add_sequence(s)
                else:
                    new_first_gap = int(s.gaps[prev]) if prev > 0 else 0
                    length = int(pos[n - 1]) + k - int(pos[prev]) \
                        + int(s.gaps[-1]) + new_first_gap
                    self.index.add_sequence(s.sub_sequence(
                        prev, n - 1, length, total_offset - new_first_gap, 0))
                return
            # count seeds until chunk_size bases or 100 seeds
            count = 0
            length = 0
            while (length < self.chunk_size and count < 100
                   and prev + count < n):
                nxt = prev + count
                step = (int(pos[nxt + 1]) - int(pos[nxt])) if nxt + 1 < n \
                    else int(s.gaps[-1]) + k
                length += step
                count += 1
            if count >= self.min_seeds:
                new_first_gap = int(s.gaps[prev])
                length += new_first_gap
                self.index.add_sequence(s.sub_sequence(
                    prev, prev + count - 1, length,
                    total_offset - new_first_gap,
                    s.length - total_offset - length + new_first_gap))
                total_offset += length - new_first_gap
                prev += count
                if prev >= n:
                    return
                # step back 5 seeds or overlap/2
                stepped = 0
                back = 0
                while back < 5 and stepped < self.overlap // 2 and prev > 0:
                    prev -= 1
                    d = (int(pos[prev + 1]) - int(pos[prev])) if prev + 1 < n \
                        else int(s.gaps[-1]) + k
                    stepped += d
                    total_offset -= d
                    back += 1
            else:
                prev += count
                stepped = 0
                while stepped < self.overlap // 2 and prev > 0:
                    prev -= 1
                    d = (int(pos[prev + 1]) - int(pos[prev])) if prev + 1 < n \
                        else int(s.gaps[-1]) + k
                    stepped += d
                    total_offset -= d

    # -- overlap search -------------------------------------------------
    def find_overlaps(self, queries: List[SeedQuery]) -> List[SeedMatch]:
        """Batched matchWorker (ref: overlap/overlap.go:346-387): ONE
        fused dispatch per query batch — retrieval gathers over the
        resident membership matrix, the distinct-seed popcount gate, the
        seedAligner chain DP and the best-chain backpointer walk all run
        on device (``ops.map_engine._fused_overlap``); the host applies
        only the sequential adaptive min-match rule to the compact
        result rows."""
        futs = self.dispatch_find(queries)
        return self.collect_find(queries, futs)

    def dispatch_find(self, queries: List[SeedQuery]):
        """Async half of ``find_overlaps``: build the round's engine on
        ``self.device`` and run the fused overlap pipeline over the
        queries in ``SUB``-query batches against the one resident engine,
        reading nothing back (in a job's first round only the first batch
        is enqueued: the rest wait for its count, see ``_in_order``);
        returns ``(engine, [(first query, result), ...])`` for
        ``collect_find``, or None for an empty round.  The caller may do
        host work (the next round's query prep) before collecting."""
        if not queries or self.index.num_sequences == 0:
            return None
        if self.index._seed_counts is None:
            self.index.index_sequences()
        # target-seed axis sized to the round's real chunks (reads shorter
        # than chunk_size index as one chunk with all their seeds), on the
        # ladder {256, 512, 1024, 2048, 4096}
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
                        mesh=self.mesh, hit_fraction=self.hit_fraction,
                        device=self.device)
        base_min = np.array(
            [int(self.hit_fraction * q.query.num_seeds + 0.5)
             for q in queries], np.int32)
        subs = []
        for lo in range(0, len(queries), SUB):
            run = functools.partial(
                eng.dispatch_chains, [q.query for q in queries[lo:lo + SUB]],
                base_min[lo:lo + SUB], shape_plan=self.shape_plan)
            # the job's first round: the sub-batches after the first wait
            # for its passing count (the JAX overlapper's round-0 budget
            # peek), read at its collect, not here
            deferred = subs and "budget" not in self.shape_plan
            subs.append((lo, run if deferred else run()))
        return eng, subs

    def collect_find_arrays(self, queries: List[SeedQuery], futs):
        """Array-direct collect for the native final-check fast path:
        returns ``(qids, rcq, ia, ib, ma_flat, mb_flat, m_off)`` flat
        numpy arrays over the round's KEPT matches in query order — no
        SeedMatch objects, no per-row Python.  The
        adaptive min-match ratchet (ref matchWorker,
        overlap/overlap.go:346-387) vectorizes exactly: a dropped row
        never raises the threshold, so keep_i <=> blen_i >=
        max(1, m0_q, (2 * cummax_prev(blen))//3) per query row-run.

        ``ia`` indexes the query entries (= position in ``queries``);
        ``ib`` is the raw index-chunk id (callers building a combined
        sequence table offset it).  Returns None on the empty round.
        """
        if futs is None:
            return None
        eng, subs = futs
        heads, cqs, cts = [], [], []
        for lo, chain_futs in _in_order(subs):
            M, head, cq, ct = eng.collect_chains_raw(chain_futs)
            live = (head[:, 0] >= 0) & (head[:, 0] < M) & (head[:, 2] > 0)
            head = head[live].astype(np.int64)
            head[:, 0] += lo                      # global query-entry row
            heads.append(head)
            cqs.append(cq[live])
            cts.append(ct[live])
        head = np.concatenate(heads) if heads else np.zeros((0, 4), np.int64)
        if head.shape[0] == 0:
            return None
        qe = head[:, 0]                           # query-entry index
        blen = head[:, 2]
        # per-entry adaptive ratchet, segment-cummax via the ascending-
        # offset trick (rows are query-major within and across subs)
        m0 = np.array([int(self.hit_fraction * q.query.num_seeds + 0.5)
                       for q in queries], np.int64)
        BIGB = 1 << 20
        lifted = blen + qe * BIGB
        prev = np.empty_like(lifted)
        prev[0] = -1
        np.maximum.accumulate(lifted[:-1], out=prev[1:])
        prev -= qe * BIGB                         # cummax of blen among
        boundary = np.empty(len(qe), bool)        # PRIOR same-entry rows
        boundary[0] = True
        np.not_equal(qe[1:], qe[:-1], out=boundary[1:])
        prev[boundary] = 0
        thresh = np.maximum(np.maximum(1, m0[qe]), (2 * prev) // 3)
        keep = blen >= thresh
        head = head[keep]
        if head.shape[0] == 0:
            return None
        # flatten reversed chains without per-row Python: row r
        # contributes cq[r, blen-1 .. 0]
        cq = np.concatenate(cqs)[keep]
        ct = np.concatenate(cts)[keep]
        bl = head[:, 2]
        m_off = np.zeros(len(bl) + 1, np.int64)
        np.cumsum(bl, out=m_off[1:])
        total = int(m_off[-1])
        rows = np.repeat(np.arange(len(bl)), bl)
        within = np.arange(total) - np.repeat(m_off[:-1], bl)
        pos = np.repeat(bl, bl) - 1 - within
        ma_flat = cq[rows, pos].astype(np.int32)
        mb_flat = ct[rows, pos].astype(np.int32)
        qe = head[:, 0]
        entry_qid = np.array([q.id for q in queries], np.int64)
        entry_rc = np.array([q.rc for q in queries], np.uint8)
        qids = entry_qid[qe]
        rcq = entry_rc[qe]
        ia = qe.astype(np.int32)                  # query-entry table slot
        ib = head[:, 1].astype(np.int32)          # raw chunk id
        return qids, rcq, ia, ib, ma_flat, mb_flat, m_off

    def seq_objects(self, queries: List[SeedQuery]):
        """Sequence table order matching collect_find_arrays' ia/ib:
        query entries first (ia = entry index), then index chunks
        (ib offset by len(queries))."""
        return [q.query for q in queries] + list(self.index.sequences)

    def collect_find(self, queries: List[SeedQuery],
                     futs) -> List[SeedMatch]:
        """Blocking half of ``find_overlaps`` (ref matchWorker collation,
        overlap/overlap.go:346-387).  Collects the round's sub-batches in
        order; the adaptive min-match rule is per query, so the split is
        invisible to results."""
        if futs is None:
            return []
        eng, subs = futs
        results: List[SeedMatch] = []
        for lo, chain_futs in _in_order(subs):
            per_meta = eng.collect_chains(chain_futs)
            for qi, meta in enumerate(per_meta):
                q = queries[lo + qi]
                min_m = int(self.hit_fraction * q.query.num_seeds + 0.5)
                for ci, dcount, best_len, ma, mb in meta:
                    if best_len < max(1, min_m):
                        continue
                    m = SeedMatch(
                        ma if isinstance(ma, list) else ma.tolist(),
                        mb if isinstance(mb, list) else mb.tolist(),
                        q.query, self.index.sequences[ci],
                        query_id=q.id, rc_query=q.rc)
                    results.append(m)
                    if best_len * 2 > min_m * 3:
                        min_m = (best_len * 2) // 3
        return results
