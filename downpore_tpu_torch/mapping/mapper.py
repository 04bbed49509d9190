"""Read-to-reference mapping: seed-chain alignment against an indexed
reference genome, on the torch engine.

Mirrors the reference mapper (ref: mapping/mapping.go): the reference
genome gets one best-ranked seed per ``seed_rate`` bases, is chunked in 10
interleaved passes so neighbouring chunks overlap by ``edge_size``
(mapping.go:79-101, wrap chunk for circular genomes), and reads are mapped
by querying 1k-base windows — first both ends, pairing consistent hits
(``is_consistent`` distance-ratio rule, mapping.go:131-160), stepping
inward, and binary-searching for chimeric split points
(mapping.go:207-288).

The device half is the port's ``MapEngine`` on an explicit ``device``
(retrieval gate, chain DP kernel, summaries); each mapping stage batches
the device work across every active read, so host control flow never
issues per-read device calls.  With a device grid (``mesh``,
``parallel.make_mesh``) the engine splits every batch over the grid's data
shards and, with a seed axis, shards the index's hash-bucket rows.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from .. import native, resolve_device
from ..core.sequence import Sequence
from ..ops.chain import summary_columns, unpack_summary
from ..ops.map_engine import MapEngine, WindowRows
from ..seeds import SeedIndex
from ..utils.metrics import counter, span, traced


class _EndsCounts:
    """Long reads of the native ends route: paired or closed there
    (``map.ends.native_reads``), or handed on open to the next phase
    (``map.ends.open_reads``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.native_reads = 0
        self.open_reads = 0

    def count(self, closed: int, still_open: int) -> None:
        with self.lock:
            self.native_reads += closed
            self.open_reads += still_open


_ENDS = _EndsCounts()
counter("map.ends.native_reads", lambda: _ENDS.native_reads)
counter("map.ends.open_reads", lambda: _ENDS.open_reads)


class _StageCounts:
    """Work of the short path and the later stages, summed over the shard
    threads: reads through ``map.short`` (``map.short.reads``), windows of
    mapNext's two rounds (``map.next.windows``), and the split search's
    pack/dispatch/collect rounds and their windows (``map.split.rounds``,
    ``map.split.windows``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.short_reads = 0
        self.next_windows = 0
        self.split_rounds = 0
        self.split_windows = 0

    def add(self, name: str, n: int) -> None:
        with self.lock:
            setattr(self, name, getattr(self, name) + n)


_STAGES = _StageCounts()
counter("map.short.reads", lambda: _STAGES.short_reads)
counter("map.next.windows", lambda: _STAGES.next_windows)
counter("map.split.rounds", lambda: _STAGES.split_rounds)
counter("map.split.windows", lambda: _STAGES.split_windows)


class Mapping:
    """One mapped region (ref: mapping/mapping.go:11-20)."""
    __slots__ = ("query", "start", "end", "query_offset", "query_inset",
                 "rc", "ids")

    def __init__(self, query, start, end, query_offset, query_inset, rc, ids):
        self.query = query
        self.start = start
        self.end = end
        self.query_offset = query_offset
        self.query_inset = query_inset
        self.rc = rc
        self.ids = ids

    def __repr__(self):
        return (f"Mapping({self.start}-{self.end} q[{self.query_offset},"
                f"-{self.query_inset}] rc={self.rc} ids={self.ids})")


class Mapper:
    """Read-to-reference mapper on a resident ``MapEngine``.  The class's
    ``walk_native_rows`` sums, over every mapper, the collected rows the
    native walk read in place (the counter ``map.walk.native_rows``)."""

    walk_native_rows = 0
    _walk_lock = threading.Lock()

    def __init__(self, reference: Sequence, circular: bool, k: int,
                 kmer_values: np.ndarray, seed_rate: int = 40,
                 edge_size: int = 1000, chunk_size: int = 10000,
                 mesh=None, device=None):
        # optional DeviceGrid with a "data" axis: query batches split over
        # its data shards (the reference index replicates or, with a
        # "seed" axis, shards its hash-bucket rows)
        self.mesh = mesh
        self.device = mesh.home if mesh is not None \
            else resolve_device(device)
        self.reference = reference
        self.circular = circular
        self.k = k
        self.edge_size = edge_size
        self.index = SeedIndex(k)
        self.index.add_single_seeds(reference, seed_rate, kmer_values)
        # 10 interleaved chunking passes (ref: mapping/mapping.go:79-101)
        n = len(reference)
        for j in range(10):
            step = chunk_size * 10 - edge_size
            i = j * chunk_size
            while i < n - chunk_size // 2:
                end = min(i + chunk_size, n)
                self.index.add_sequence(
                    self.index.new_seed_sequence(reference.subsequence(i, end)))
                i += step
        if circular:
            wrap = reference.subsequence(n - edge_size, n).append(
                reference.subsequence(0, edge_size))
            self.index.add_sequence(self.index.new_seed_sequence(wrap))
        self.index.index_sequences()
        self._build_device_index()

    def _build_device_index(self):
        """Resident engine on ``self.device``: hashed membership and the
        chunk seed tables live on the card; each query batch is one
        dispatch (``ops.map_engine``).  ``nt`` is sized to the real max
        chunk seed count (128 grid, floor 320 = the typical 10 kb / seed
        rate 40 load), so dense chunks keep their tail anchors.  ``nq``
        scales with seed-table density: a 1 kb window's expected table
        hits = window_kmers * distinct_seeds / 4^k.  ``binned=True`` arms
        the two-level genome-bin gate, which the engine engages once the
        chunk count makes the flat gather the bottleneck (>= 1024
        chunks)."""
        max_ts = max((s.num_seeds for s in self.index.sequences),
                     default=1)
        nt = min(2048, max(320, ((max_ts + 127) // 128) * 128))
        exp_hits = (self.edge_size - self.k + 1) \
            * self.index.num_seeds / (4 ** self.k)
        nq = int(min(192, max(64, -(-2 * exp_hits // 32) * 32)))
        self.engine = MapEngine(self.index, self.k, nq=nq, nt=nt,
                                mesh=self.mesh, hit_fraction=0.25,
                                lean=True, binned=True, device=self.device)

    # ------------------------------------------------------------------
    def as_string(self, m: Mapping) -> str:
        """PAF line (ref: mapping/mapping.go:112-122)."""
        rc = "-" if m.rc else "+"
        mapped_len = m.end - m.start
        if self.circular and mapped_len < 0:
            mapped_len = len(self.reference) - m.start + m.end
        q = m.query
        return (f"{q.get_name()}\t{len(q)}\t{m.query_offset}\t"
                f"{len(q) - m.query_inset}\t{rc}\t"
                f"{self.reference.get_name()}\t{len(self.reference)}\t"
                f"{m.start}\t{m.end}\t{m.ids}\t{mapped_len}\t255")

    # -- batched performMapping ----------------------------------------
    @traced("map.stage")
    def perform_mapping_batch(self, rows: WindowRows) -> tuple:
        """The reference's performMapping (mapping.go:489-611) over a batch
        of query windows: retrieval matmul, popcount gate, chain DP,
        adaptive thresholds.  Returns every window's accepted mappings as
        arrays ``(window, start, end, q_offset, q_inset, rc, ids)``,
        window-major in the walk's order, not yet deduplicated
        (``_mappings`` makes them objects).

        Feature extraction (seeds, run buckets) runs batch-vectorized in
        ``MapEngine.pack_query_windows`` — one pass over all windows + RC
        twins instead of per-query ``new_seed_sequence`` loops (which were
        the single largest map cost in round-1 profiles)."""
        parts = [self._walk_candidates(sub, num_seeds, coll, lo)
                 for lo, sub, num_seeds, coll in self._chunks(rows)]
        parts = [p for p in parts if p is not None]
        if not parts:
            return tuple(np.zeros(0, t) for t in
                         (np.int64,) * 5 + (bool, np.int64))
        return tuple(np.concatenate(c) for c in zip(*parts))

    def _chunks(self, queries: WindowRows):
        """Pack, dispatch and collect ``queries`` in chunks: ``(lo, sub,
        num_seeds, collected)`` for each."""
        if not len(queries):
            return []
        # chunked dispatch-ahead pipeline: pack chunk i+1 on host while
        # the device crunches chunk i (pack and compute are each ~half
        # the stage, so the overlap nearly halves wall-clock)
        CHUNK = 4096
        inflight = []
        for lo in range(0, len(queries), CHUNK):
            sub = queries[lo : lo + CHUNK]
            packed = self.engine.pack_query_windows(sub)
            num_seeds = packed[6]
            base_min = np.maximum(5, num_seeds // 5).astype(np.int32)
            futs = self.engine.dispatch_packed(packed, base_min)
            inflight.append((lo, sub, num_seeds, futs))
        colls = self.engine.collect_arrays_many([f for *_, f in inflight])
        return [(lo, sub, num_seeds, coll)
                for (lo, sub, num_seeds, _), coll in zip(inflight, colls)]

    @traced("map.walk")
    def _walk_candidates(self, rows: WindowRows, num_seeds, coll,
                         base: int):
        """Adaptive-threshold candidate walk for one packed chunk
        (ref: mapping.go:494-589): the accepted mappings as arrays
        ``(window, start, end, q_offset, q_inset, rc, ids)``, window
        ``base + qi``, in the walk's order; None for a chunk with no
        collected rows.  The native walk runs when the host library
        loaded; its pure-Python twin otherwise.

        The native walk reads the collected head and summary matrices in
        place, one pass in row order, and applies the 2/3-coverage rule to
        the chains it is about to accept alone: a repeat-rich genome's
        batch holds millions of rows, and no array of that size is built
        on the host around the walk (``map.walk.native_rows`` counts the
        rows it read).  The walk is sequential because thresholds ratchet
        up as chains are accepted, affecting later candidates of the same
        query.  The mappings' geometry (reference start/end, query
        offset/inset) is computed for the accepted chains alone."""
        if coll is None or coll[0].shape[0] == 0:
            return None
        head, packed = coll
        k = self.k
        K = 4
        nq = len(rows)
        qlen, qoff, qins = rows.lens, rows.offset, rows.inset
        col = summary_columns(K, lean=self.engine.lean)
        # rows are sorted by mi (query-major compaction order)
        bounds = np.searchsorted(head[:, 0], np.arange(2 * nq + 1))
        acc = native.walk_candidates(bounds, num_seeds, nq, head, packed,
                                     col, qlen, k, K)
        if acc is None:
            acc = self._walk_candidates_py(
                *self._walk_columns(bounds, num_seeds, head, packed, qlen,
                                    k, K, self.engine.lean))
        else:
            with Mapper._walk_lock:
                Mapper.walk_native_rows += head.shape[0]
        qi, b, j, is_rc = acc
        eng = self.engine
        ci = head[b, 1]

        def top(name):
            return packed[b, col[name] + j]

        # RC rows swap offset/inset (Sequence.reverse_complement)
        moff = np.where(is_rc, qins[qi], qoff[qi])
        mins_ = np.where(is_rc, qoff[qi], qins[qi])
        ref_len = len(self.reference)
        start = eng.chunk_off[ci] + top("top_stp")
        end = ref_len - eng.chunk_inset[ci] \
            - (eng.chunk_len[ci] - top("top_etp") - k)
        if self.circular:
            start = np.where(start > ref_len, start - ref_len, start)
        qil = qlen[qi] - top("top_eqp") - k
        sq = top("top_sqp")
        return (qi.astype(np.int64) + base, start, end,
                np.where(is_rc, qil + mins_, sq + moff),
                np.where(is_rc, sq + moff, qil + mins_), is_rc,
                top("top_cov_t"))

    @staticmethod
    def _walk_columns(bounds, num_seeds, head, packed, qlen, k: int, K: int,
                      lean: bool) -> tuple:
        """``_walk_candidates_py``'s arguments: the summary's columns
        unpacked and the 2/3-coverage rule of every (row, chain)."""
        s = unpack_summary(packed, K, lean=lean)
        sqp, eqp = s["top_sqp"], s["top_eqp"]
        ql = qlen[head[:, 0] >> 1].astype(np.int32)[:, None]
        ok23 = (sqp + (ql - eqp - k)) <= (ql * 2) // 3
        return (bounds, num_seeds, len(qlen), head[:, 2], s["best"],
                s["top_valid"], s["top_len"], s["top_cov_t"], eqp,
                s["top_etp"], sqp, s["top_stp"], ok23, K)

    @staticmethod
    def _walk_candidates_py(bounds, num_seeds, nq: int, dc, best, tv, tl,
                            ct, eq, et, sq, st, ok23, K: int):
        """Pure-Python twin of ``native.walk_candidates``, on its arguments
        and with its accepted ``(qi, b, j, rc)`` arrays: the route without
        the native library, and the parity oracle."""
        dc_l = dc.tolist()
        best_l = best.tolist()
        tv_l = tv.tolist()
        tl_l = tl.tolist()
        ct_l = ct.tolist()
        eq_l = eq.tolist()
        et_l = et.tolist()
        sq_l = sq.tolist()
        st_l = st.tolist()
        ok_l = ok23.tolist()
        acc = []
        for qi in range(nq):
            lo_f, hi_f = bounds[2 * qi], bounds[2 * qi + 1]
            lo_r, hi_r = bounds[2 * qi + 1], bounds[2 * qi + 2]
            if lo_f == hi_f and lo_r == hi_r:
                continue
            min_matches = max(5, int(num_seeds[2 * qi]) // 5)
            min_rc = max(5, int(num_seeds[2 * qi + 1]) // 5)
            for lo, hi, rc in ((lo_f, hi_f, False), (lo_r, hi_r, True)):
                for b in range(lo, hi):
                    cur_min = min_rc if rc else min_matches
                    # popcount gate on distinct shared seeds
                    if dc_l[b] < cur_min or best_l[b] < cur_min:
                        continue
                    # one chain per distinct start, best stat wins
                    # (ref: mapping.go:528-551)
                    tvb, tlb = tv_l[b], tl_l[b]
                    ctb, eqb, etb = ct_l[b], eq_l[b], et_l[b]
                    sqb, stb = sq_l[b], st_l[b]
                    starts = {}
                    for j in range(K):
                        if not tvb[j] or tlb[j] < cur_min:
                            continue
                        key = (sqb[j], stb[j])
                        stat = (tlb[j], ctb[j], eqb[j], etb[j])
                        prev = starts.get(key)
                        if prev is None or stat > prev[0]:
                            starts[key] = (stat, j)
                    okb = ok_l[b]
                    for stat, j in starts.values():
                        if not okb[j]:
                            continue
                        acc.append((qi, b, j, rc))
                        limit = (stat[0] * 4) // 5
                        if not rc and limit > min_matches:
                            min_matches = limit
                        if limit > min_rc:
                            min_rc = limit
        a = np.array(acc, np.int32).reshape(-1, 4)
        return a[:, 0], a[:, 1], a[:, 2], a[:, 3].astype(bool)

    def _map_windows(self, reads, starts, ends) -> List[List[Mapping]]:
        """Windows ``[starts[w], ends[w])`` of ``reads[w]`` mapped: each
        window's deduplicated mappings, their query the read."""
        rows = WindowRows.cut(reads, starts, ends)
        return _mappings(reads, self.perform_mapping_batch(rows), len(rows))

    def _map_cuts(self, reads, cuts) -> dict:
        """Windows ``(i, tag, start, end)`` of ``reads`` mapped: ``{i:
        {tag: mappings}}``, each window's mappings deduplicated and its
        dominated ones dropped."""
        idx, tags, starts, ends = zip(*cuts) if cuts else ((),) * 4
        maps = self._map_windows([reads[i] for i in idx], starts, ends)
        out = {}
        for i, tag, ms in zip(idx, tags, maps):
            out.setdefault(i, {})[tag] = _remove_dominated(ms, ms,
                                                           len(reads[i]))
        return out

    # -- pairing / consistency ------------------------------------------
    def is_consistent(self, left: Mapping, right: Mapping) -> bool:
        """Distance-ratio rule (ref: mapping/mapping.go:131-160)."""
        if left.rc != right.rc:
            return False
        expected = right.query_offset - len(left.query) + left.query_inset
        if not left.rc:
            distance = right.start - left.end
        else:
            distance = left.start - right.end
        if self.circular and distance < -50:
            distance += len(self.reference)
        if distance < 50 and expected < 50 and distance > -50:
            return True
        if distance < 500:
            return expected < (distance * 3) // 2 and expected > (distance * 2) // 3
        if distance > 5000:
            return expected < (distance * 10) // 9 and expected > (distance * 9) // 10
        ratio = (distance - 500) / 4500.0
        ratio = 3.0 / 2.0 + ratio * (10.0 / 9.0 - 3.0 / 2.0)
        return (distance < int(expected * ratio)
                and distance > int(expected / ratio))

    def match_pairs(self, open_a: List[Mapping], open_b: List[Mapping]):
        """Merge consistent end pairs (ref: mapping/mapping.go:174-203)."""
        matched: List[Mapping] = []
        open_a = list(open_a)
        open_b = list(open_b)
        i = len(open_a) - 1
        while i >= 0:
            ra = open_a[i]
            for j in range(len(open_b) - 1, -1, -1):
                rb = open_b[j]
                if self.is_consistent(ra, rb):
                    q_offset = ra.query_offset
                    q_inset = rb.query_inset
                    first, second = (rb, ra) if ra.rc else (ra, rb)
                    matched.append(Mapping(
                        ra.query, first.start, second.end, q_offset,
                        q_inset, ra.rc, ra.ids + rb.ids))
                    open_a[i] = open_a[-1]
                    open_a.pop()
                    open_b[j] = open_b[-1]
                    open_b.pop()
                    break
            i -= 1
        return open_a, open_b, matched

    # -- top-level per-read mapping -------------------------------------
    _SHARD_MIN = 2048   # shard-threading threshold (module-testable)

    def map_batch(self, reads: List[Sequence]) -> List[List[Mapping]]:
        """Map a batch of reads.  Large batches split into two shards
        mapped on concurrent threads: the per-read stage chain
        (ends -> mapNext -> split) is sequential with a link round trip
        per stage, so one shard's host/fetch work hides under the other
        shard's device compute.  Reads are independent, so results are
        identical to the unsharded run.  A grid engine already splits each
        batch over its devices (and, across processes, collects in
        lockstep), so it maps on one thread."""
        with span("map.batch", counts=True) as batch:
            if len(reads) >= self._SHARD_MIN and self.mesh is None:
                from concurrent.futures import ThreadPoolExecutor
                mid = (len(reads) + 1) // 2
                with ThreadPoolExecutor(max_workers=1) as tp:
                    fut = tp.submit(self._map_batch_one, reads[mid:], batch)
                    out_a = self._map_batch_one(reads[:mid])
                    with span("map.join", cpu=True):
                        out_b = fut.result()
                    return out_a + out_b
            return self._map_batch_one(reads)

    def _map_batch_one(self, reads: List[Sequence],
                       parent=None) -> List[List[Mapping]]:
        """Map a batch of reads, batching every device stage across reads
        (ref flow: mapping/mapping.go:430-487).  ``parent`` is the batch's
        span where this runs on a shard thread of its own."""
        with span("map.shard", parent=parent, cpu=True):
            return self._map_phases(reads)

    def _map_phases(self, reads: List[Sequence]) -> List[List[Mapping]]:
        results: List[Optional[List[Mapping]]] = [None] * len(reads)
        es = self.edge_size

        short_idx = [i for i, r in enumerate(reads) if len(r) <= 2 * es]
        long_idx = [i for i, r in enumerate(reads) if len(r) > 2 * es]
        # short reads: one window each, the whole read (its end clipped)
        with span("map.short"):
            _STAGES.add("short_reads", len(short_idx))
            shorts = [reads[i] for i in short_idx]
            for i, ms in zip(short_idx, self._map_windows(shorts, 0, 2 * es)):
                results[i] = _remove_dominated(ms, ms, len(reads[i]))

        # long reads stage 1: both ends
        with span("map.ends"):
            states = self._map_ends(reads, long_idx, results)

        # stage 2: mapNext (two rounds of stepping inward), batched
        with span("map.next"):
            self._map_next_stage(reads, states, results)

        # stage 3: chimera split search for remaining reads
        with span("map.split"):
            self._split_stage(reads, states, results)
        return [r if r is not None else [] for r in results]

    def _map_ends(self, reads, long_idx, results) -> dict:
        """The ends phase: each long read's two end windows mapped, each
        end's dominated mappings dropped, the ends paired.  A read with
        pairs, or under 3 * ``edge_size``, gets its results; the rest are
        returned open, ``{i: (open_a, open_b)}``.  Pairing takes one native
        call on the walk's arrays (``_pair_ends_native``) where the library
        loaded, and runs on objects (``_pair_ends_py``) where not."""
        if not long_idx:
            return {}
        es = self.edge_size
        ends = [reads[i] for i in long_idx for _ in (0, 1)]
        lens = np.fromiter(map(len, ends), np.int64, len(ends))
        starts = np.where(np.arange(len(ends)) % 2, lens - es, 0)
        accepted = self.perform_mapping_batch(
            WindowRows.cut(ends, starts, starts + es))
        if native.load() is not None:
            return self._pair_ends_native(reads, long_idx, accepted, results)
        return self._pair_ends_py(reads, long_idx,
                                  _mappings(ends, accepted, len(ends)),
                                  results)

    def _pair_ends_py(self, reads, long_idx, end_maps, results) -> dict:
        """``_map_ends`` after the walk, on objects: ``end_maps[2 * t]``
        and ``[2 * t + 1]`` are long read t's deduplicated end mappings.
        The twin ``_pair_ends_native`` is held to."""
        es = self.edge_size
        states = {}
        for idx, i in enumerate(long_idx):
            r = reads[i]
            open_a = _remove_dominated(end_maps[2 * idx],
                                       end_maps[2 * idx], len(r))
            open_b = _remove_dominated(end_maps[2 * idx + 1],
                                       end_maps[2 * idx + 1], len(r))
            open_a, open_b, matched = self.match_pairs(open_a, open_b)
            if matched:
                results[i] = matched
            elif len(r) < 3 * es:
                results[i] = open_a + open_b
            else:
                states[i] = (open_a, open_b)
        return states

    def _pair_ends_native(self, reads, long_idx, accepted,
                          results) -> dict:
        """``_pair_ends_py`` on the walk's accepted rows (``accepted``, as
        ``perform_mapping_batch`` returns them), in one native call
        (``native.pair_ends``, the interpreter lock released) for the
        dedup, dominance and pairing of every read.  Mapping objects are
        built only for a read's results and open lists."""
        n = len(long_idx)
        longs = [reads[i] for i in long_idx]
        win, start, end, q_off, q_ins, rc, ids = accepted
        with span("map.pair"):
            status, n_a, n_b, *out = native.pair_ends(
                np.searchsorted(win, np.arange(2 * n + 1)),
                np.fromiter(map(len, longs), np.int64, n), self.edge_size,
                start, end, q_off, q_ins, rc, ids, self.circular,
                len(self.reference))
            cnt = n_a + n_b
            qs = [longs[t] for t in np.repeat(np.arange(n), cnt).tolist()]
            ms = list(map(Mapping, qs, *(a.tolist() for a in out)))
            stops = np.cumsum(cnt).tolist()
            states = {}
            for i, st, lo, na, hi in zip(long_idx, status.tolist(),
                                         [0] + stops[:-1], n_a.tolist(),
                                         stops):
                if st == 2:
                    states[i] = (ms[lo:lo + na], ms[lo + na:hi])
                else:
                    results[i] = ms[lo:hi]
        _ENDS.count(n - len(states), len(states))
        return states

    def _map_next_stage(self, reads, states, results):
        """Batched mapNext (ref: mapping/mapping.go:305-383)."""
        es = self.edge_size
        if not states:
            return
        # round 1 windows
        cuts = []
        for i in states:
            n = len(reads[i])
            if n < es * 4:
                cuts.append((i, "mid", es, n - es))
            else:
                cuts += [(i, "a1", es, es * 2), (i, "b1", n - es * 2, n - es)]
        _STAGES.add("next_windows", len(cuts))
        new_by_read = self._map_cuts(reads, cuts)
        need_round2 = []
        for i, tags in new_by_read.items():
            open_a, open_b = states[i]
            if "mid" in tags:
                new_a = tags["mid"]
                open_a2, new_a, extended = self.match_pairs(open_a, new_a)
                if extended:
                    open_a = new_a + extended
                else:
                    open_a = open_a2 + new_a
                new_a, new_b, matched = self.match_pairs(open_a, open_b)
                if matched:
                    results[i] = matched
                    del states[i]
                else:
                    # unmatched leftovers go on to the split stage
                    # (ref: mapping/mapping.go:322-326, 448-467)
                    states[i] = (new_a, new_b)
                continue
            new_a = tags.get("a1", [])
            new_b = tags.get("b1", [])
            open_a, new_a2, extended = self.match_pairs(open_a, new_a)
            open_a = open_a + new_a2
            if extended:
                open_a = open_a + extended
            open_b, new_b2, extended = self.match_pairs(new_b, open_b)
            open_b = open_b + new_b2
            if extended:
                open_b = open_b + extended
            new_a, new_b, matched = self.match_pairs(open_a, open_b)
            if matched:
                results[i] = matched
                del states[i]
            else:
                states[i] = (new_a, new_b)
                need_round2.append(i)
        # round 2: one more step inward
        if not need_round2:
            return
        cuts = []
        for i in need_round2:
            n = len(reads[i])
            if n > es * 5:
                cuts.append((i, "a2", es * 2, es * 3))
            if n > es * 6:
                cuts.append((i, "b2", n - es * 3, n - es * 2))
        _STAGES.add("next_windows", len(cuts))
        new_by_read = self._map_cuts(reads, cuts)
        for i in need_round2:
            open_a, open_b = states[i]
            r = reads[i]
            tags = new_by_read.get(i, {})
            if len(r) > es * 5:
                next_a = tags.get("a2", [])
                next_a, open_a2, extended = self.match_pairs(open_a, next_a)
                open_a = next_a
                if extended:
                    open_a = open_a + extended
                open_a = open_a + open_a2
            if len(r) > es * 6:
                next_b = tags.get("b2", [])
                next_b, open_b2, extended = self.match_pairs(next_b, open_b)
                open_b = next_b
                if extended:
                    open_b = open_b + extended
                open_b = open_b + open_b2
            if len(r) > es * 5:
                open_a, open_b, matched = self.match_pairs(open_a, open_b)
                if matched:
                    results[i] = matched
                    del states[i]
                    continue
            states[i] = (open_a, open_b)

    def _split_stage(self, reads, states, results):
        """Batched chimeric split-point binary search
        (ref: mapping/mapping.go:207-288, 452-483)."""
        es = self.edge_size
        # per read: stack of (open_a, open_b, left, right) searches
        searches = {}
        for i, (open_a, open_b) in states.items():
            r = reads[i]
            left = es * 2
            right = len(r) - es * 2
            for a in open_a:
                if a.query_inset > left:
                    left = a.query_inset
            left = len(r) - right
            for b in open_b:
                if b.query_offset < right:
                    right = b.query_offset
            searches[i] = [(open_a, open_b, left, right)]
        while True:
            metas = []
            for i, stack in searches.items():
                if not stack:
                    continue
                open_a, open_b, left, right = stack[-1]
                if right - left < es:
                    stack.pop()
                    continue
                metas.append((i, (right + left - es) // 2))
            if not metas:
                active = any(s for s in searches.values())
                if not active:
                    break
                continue
            _STAGES.add("split_rounds", 1)
            _STAGES.add("split_windows", len(metas))
            starts = np.array([start for _, start in metas], np.int64)
            maps = self._map_windows([reads[i] for i, _ in metas], starts,
                                     starts + es)
            for (i, start), mid in zip(metas, maps):
                stack = searches[i]
                open_a, open_b, left, right = stack.pop()
                r = reads[i]
                new_left, new_right = left, right
                after_a = after_b = 0
                for mm in mid:
                    for ma in open_a:
                        if self.is_consistent(ma, mm):
                            ma.query_inset = mm.query_inset
                            ma.ids += mm.ids
                            if ma.rc:
                                ma.start = mm.start
                            else:
                                ma.end = mm.end
                            mid_matched = len(r) - mm.query_inset - mm.query_offset
                            after_a = max(after_a, mid_matched)
                            new_left = max(new_left, len(r) - mm.query_inset)
                            break
                    if after_a < (es * 2) // 3:
                        for mb in open_b:
                            if self.is_consistent(mm, mb):
                                mb.query_offset = mm.query_offset
                                mb.ids += mm.ids
                                if mb.rc:
                                    mb.end = mm.end
                                else:
                                    mb.start = mm.start
                                mid_matched = len(r) - mm.query_inset - mm.query_offset
                                after_b = max(after_b, mid_matched)
                                new_right = min(new_right, mm.query_offset)
                                break
                if after_a > 0 and after_b > 0:
                    if new_left - left > es * 2:
                        stack.append((open_a, [], new_left - es * 2,
                                      new_left - es))
                    if right - new_right > es * 2:
                        stack.append(([], open_b, new_right + es,
                                      new_right + es * 2))
                elif after_a == 0 and after_b == 0:
                    end = start + es
                    if open_a:
                        stack.append((open_a, [], left, start))
                    if open_b:
                        stack.append(([], open_b, end, right))
                else:
                    stack.append((open_a, open_b, new_left, new_right))
        # finalize: drop unpaired ends that reach the far edge
        for i, (open_a, open_b) in states.items():
            r = reads[i]
            size = len(r) - es
            open_a = [a for a in open_a if a.query_inset < size]
            open_b = [b for b in open_b if b.query_offset < size]
            results[i] = open_a + open_b

    def map(self, read: Sequence) -> List[Mapping]:
        return self.map_batch([read])[0]


counter("map.walk.native_rows", lambda: Mapper.walk_native_rows)


def _mappings(queries, accepted, n: int) -> List[List[Mapping]]:
    """Each of ``n`` windows' deduplicated mappings from the walk's accepted
    rows (``Mapper.perform_mapping_batch``'s arrays); window w's mappings
    take ``queries[w]``, the read it was cut from, as their query."""
    win, *cols = accepted
    qs = [queries[w] for w in win.tolist()]
    ms = list(map(Mapping, qs, *(c.tolist() for c in cols)))
    stops = np.searchsorted(win, np.arange(n + 1)).tolist()
    return [_dedup_by_position(ms[lo:hi])
            for lo, hi in zip(stops, stops[1:])]


def _dedup_by_position(results: List[Mapping]) -> List[Mapping]:
    """Sort by start, drop same-strand overlaps keeping the longer
    (ref: mapping/mapping.go:590-608)."""
    if len(results) <= 1:
        return results
    results = sorted(results, key=lambda m: m.start)
    out = []
    for m in results:
        if out and out[-1].rc == m.rc and m.start < out[-1].end:
            if (out[-1].end - out[-1].start) < (m.end - m.start):
                out[-1] = m
        else:
            out.append(m)
    return out


def _remove_dominated(open_list: List[Mapping], extended: List[Mapping],
                      query_len: int) -> List[Mapping]:
    """Drop mappings 90%-contained in a 25%-better mapping
    (ref: mapping/mapping.go:387-428)."""
    if not open_list or not extended:
        return open_list
    open_list = sorted(open_list, key=lambda m: m.query_offset)
    ext = sorted(extended, key=lambda m: m.query_offset)
    keep = []
    j = 0
    for nxt in open_list:
        while j < len(ext) and query_len - ext[j].query_inset < nxt.query_offset:
            j += 1
        if j == len(ext):
            keep.append(nxt)
            continue
        dominated = False
        kk = j
        while (not dominated and kk < len(ext)
               and ext[kk].query_offset < query_len - nxt.query_inset):
            e = ext[kk]
            if e is not nxt and e.ids * 4 > nxt.ids * 5:
                start = max(nxt.query_offset, e.query_offset)
                end = query_len - max(nxt.query_inset, e.query_inset)
                dominated = ((end - start) * 10 >
                             (query_len - nxt.query_offset - nxt.query_inset) * 9)
            kk += 1
        if not dominated:
            keep.append(nxt)
    return keep
