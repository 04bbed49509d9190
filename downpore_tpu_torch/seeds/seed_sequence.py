"""Gapped-seed sequences and in-order seed matches.

A ``SeedSequence`` is the universal intermediate representation: an ordered
list of seed ids with the base gap before each seed (gaps may be negative
when seeds overlap) plus a trailing gap, exactly the reference's
interleaved ``segments`` array split into two numpy vectors
(ref: seeds/sequence.go:10-20).  ``offset``/``inset`` track bases before /
after this subsequence in the parent read.

The greedy chain walk ``dynamic_match`` reproduces the reference's
tie-breaking behaviour (ref: seeds/sequence.go:401-576) and serves as the
oracle for the batched device chain DP in ``downpore_tpu.ops.chain``; the
device DP finds chains at least as long under the same gap-window rule.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.sequence import kmer_reverse_complement


class SeedSequence:
    __slots__ = ("gaps", "seeds", "id", "name", "length", "offset", "inset",
                 "rc", "parent", "_rc_cache", "_pos_cache")

    def __init__(self, gaps: np.ndarray, seeds: np.ndarray, id: int = -1,
                 name: Optional[str] = None, length: int = 0,
                 offset: int = 0, inset: int = 0, rc: bool = False,
                 parent: Optional["SeedSequence"] = None):
        self.gaps = np.asarray(gaps, dtype=np.int32)
        self.seeds = np.asarray(seeds, dtype=np.int32)
        assert self.gaps.shape[0] == self.seeds.shape[0] + 1
        self.id = id
        self.name = name
        self.length = length
        self.offset = offset
        self.inset = inset
        self.rc = rc
        self.parent = parent
        self._rc_cache = None
        self._pos_cache = None

    # -- construction helpers ----------------------------------------
    @classmethod
    def from_segments(cls, segments, k: int, **kw) -> "SeedSequence":
        """Build from the reference's interleaved representation; computes
        length like the LoadSequence test hook (ref: seeds/sequence.go:35)."""
        segments = np.asarray(segments, dtype=np.int32)
        gaps = segments[0::2]
        seeds = segments[1::2]
        length = int(gaps.sum()) + k * seeds.shape[0]
        return cls(gaps, seeds, length=length, **kw)

    def segments(self) -> np.ndarray:
        """Interleaved (gap, seed, ..., gap) view for parity checks."""
        out = np.empty(self.gaps.shape[0] + self.seeds.shape[0], dtype=np.int32)
        out[0::2] = self.gaps
        out[1::2] = self.seeds
        return out

    @property
    def num_seeds(self) -> int:
        return self.seeds.shape[0]

    def get_name(self) -> str:
        p = self
        while p.parent is not None:
            p = p.parent
        return p.name if p.name is not None else str(p.id)

    # -- coordinate algebra ------------------------------------------
    def seed_positions(self, k: int) -> np.ndarray:
        """Base offset of the start of each seed within this sequence
        (vectorized GetSeedOffset, ref: seeds/sequence.go:1239).  Cached
        per k (callers treat the result as read-only; the consensus
        final check calls this ~3x per match)."""
        c = self._pos_cache
        if c is not None and c[0] == k:
            return c[1]
        if self.num_seeds == 0:
            pos = np.empty(0, dtype=np.int64)
        else:
            steps = self.gaps[:-1].astype(np.int64)
            steps[1:] += k
            pos = np.cumsum(steps)
        self._pos_cache = (k, pos)
        return pos

    def seed_offset(self, index: int, k: int) -> int:
        """Bases before the start of seed ``index``."""
        return int(self.gaps[0]) + int((self.gaps[1 : index + 1] + k).sum())

    def seed_offset_from_end(self, index: int, k: int) -> int:
        """Bases after the end of seed ``index``
        (ref: seeds/sequence.go:1269)."""
        return int(self.gaps[-1]) + int((self.gaps[index + 1 : -1] + k).sum())

    def seed_offset_between(self, a: int, b: int, k: int) -> int:
        """Bases from the end of seed a to the start of seed b
        (ref: seeds/sequence.go:1300)."""
        return int(self.gaps[a + 1 : b + 1].sum()) + k * (b - a - 1)

    # -- transforms ---------------------------------------------------
    def sub_sequence(self, start: int, end: int, length: int,
                     offset: int, inset: int) -> "SeedSequence":
        """Keep seeds [start, end] inclusive (ref: seeds/sequence.go:46)."""
        return SeedSequence(self.gaps[start : end + 2],
                           self.seeds[start : end + 1],
                           id=self.id, length=length, offset=offset,
                           inset=inset, rc=self.rc, parent=self)

    def trimmed(self, start_offset: int, start_seed: int, end_offset: int,
                end_seed: int, k: int) -> Tuple["SeedSequence", int]:
        """Keep seeds between start_seed/end_seed plus any within the given
        base offsets of them (ref: seeds/sequence.go:54-82)."""
        while start_seed > 0 and start_offset >= int(self.gaps[start_seed]) + k:
            start_offset -= int(self.gaps[start_seed]) + k
            start_seed -= 1
        n = self.num_seeds
        while end_seed < n - 1 and end_offset >= int(self.gaps[end_seed + 1]) + k:
            end_offset -= int(self.gaps[end_seed + 1]) + k
            end_seed += 1
        offset = self.seed_offset(start_seed, k) - start_offset
        inset = self.seed_offset_from_end(end_seed, k) - end_offset
        if self.rc:
            t = self.sub_sequence(start_seed, end_seed,
                                  self.length - offset - inset,
                                  self.offset + inset, self.inset + offset)
        else:
            t = self.sub_sequence(start_seed, end_seed,
                                  self.length - offset - inset,
                                  self.offset + offset, self.inset + inset)
        gaps = t.gaps.copy()
        gaps[0] = start_offset
        gaps[-1] = end_offset
        t.gaps = gaps
        t._pos_cache = None
        return t, start_seed

    def reduced(self, whitelist: np.ndarray, k: int, min_seeds: int,
                make_index: bool):
        """Keep only whitelisted seeds, merging gaps; consecutive duplicate
        seeds are dropped (ref: seeds/sequence.go:85-123).

        ``whitelist`` is a bool array indexed by seed id.  Returns
        ``(SeedSequence, index)`` or ``(None, None)`` if fewer than
        ``min_seeds`` remain; ``index`` maps new seed positions to original
        ones when requested.
        """
        n = self.num_seeds
        if n == 0:
            return None, None
        seeds = self.seeds
        keep = whitelist[seeds]
        # drop consecutive duplicates among kept seeds: a kept seed equal
        # to the previous *kept* seed is dropped (a non-whitelisted seed
        # does NOT reset the run in the reference).  Vectorized: among
        # the kept positions, drop those equal to their kept predecessor
        # — runs collapse to their first element exactly as the scalar
        # walk does.
        ki = np.flatnonzero(keep)
        if ki.shape[0]:
            ks = seeds[ki]
            first = np.empty(ki.shape[0], dtype=bool)
            first[0] = True
            np.not_equal(ks[1:], ks[:-1], out=first[1:])
            idx = ki[first]
        else:
            idx = ki
        if idx.shape[0] < min_seeds:
            return None, None
        pos = self.seed_positions(k)
        new_seeds = seeds[idx]
        new_gaps = np.empty(idx.shape[0] + 1, dtype=np.int32)
        new_gaps[0] = self.gaps[0] + (pos[idx[0]] - pos[0])
        new_gaps[1:-1] = (pos[idx[1:]] - pos[idx[:-1]]) - k
        new_gaps[-1] = self.gaps[-1] + (pos[-1] - pos[idx[-1]])
        out = SeedSequence(new_gaps, new_seeds, id=self.id,
                           length=self.length, offset=self.offset,
                           inset=self.inset, rc=self.rc, parent=self)
        return out, (idx.astype(np.int32) if make_index else None)

    def reverse_complement(self, k: int, index) -> "SeedSequence":
        """Seed-space reverse complement via the index's kmer<->seed maps
        (ref: seeds/sequence.go:134-159)."""
        if self._rc_cache is not None:
            return self._rc_cache
        from ..core.sequence import kmer_reverse_complement_vec
        kmers = index.seed_kmers_of(self.seeds)
        rc_seeds = index.kmer_map[
            kmer_reverse_complement_vec(kmers, k)][::-1].copy()
        ns = SeedSequence(self.gaps[::-1].copy(), rc_seeds, id=self.id,
                          length=self.length, offset=self.offset,
                          inset=self.inset, rc=not self.rc, parent=self.parent)
        ns._rc_cache = self
        self._rc_cache = ns
        return ns

    def shift(self, bases: int):
        """Add bases before the first seed (ref: seeds/sequence.go:166)."""
        self.gaps = self.gaps.copy()
        self.gaps[0] += bases
        self._pos_cache = None
        if self.rc:
            self.inset -= bases
        else:
            self.offset -= bases

    def extend(self, bases: int):
        self.gaps = self.gaps.copy()
        self.gaps[-1] += bases
        self._pos_cache = None
        if self.rc:
            self.inset -= bases
        else:
            self.offset -= bases

    # -- matching (scalar oracle; device path in ops.chain) -----------
    def match(self, query: "SeedSequence", query_whitelist, seq_whitelist,
              min_match: int, k: int) -> Optional[List["SeedMatch"]]:
        """Chain the query against this sequence after mutual reduction
        (ref: seeds/sequence.go:361-394).  Whitelists are bool arrays or
        None."""
        s, s_index = (self, None)
        q, q_index = (query, None)
        if query_whitelist is not None:
            s, s_index = self.reduced(query_whitelist, k, min_match, True)
        if seq_whitelist is not None:
            q, q_index = query.reduced(seq_whitelist, k, min_match, True)
        if s is None or q is None:
            return None
        ms = dynamic_match(q, s, min_match, k)
        for m in ms:
            if q_index is not None:
                m.match_a = [int(q_index[p]) for p in m.match_a]
            if s_index is not None:
                m.match_b = [int(s_index[p]) for p in m.match_b]
            m.seq_a = query
            m.seq_b = self
        return ms if ms else None

    def __repr__(self):
        parts = []
        for g, s in zip(self.gaps[:-1], self.seeds):
            parts.append(f"<{g}> {s}")
        parts.append(f"<{self.gaps[-1]}>")
        return f"{self.id}:" + " ".join(parts)


class SeedMatch:
    """A chain of exactly-matching seeds between two SeedSequences
    (ref: seeds/sequence.go:24-32)."""

    __slots__ = ("match_a", "match_b", "mismatch_count", "seq_a", "seq_b",
                 "query_id", "rc_query")

    def __init__(self, match_a, match_b, seq_a, seq_b,
                 query_id: int = -1, rc_query: bool = False):
        self.match_a = list(match_a)
        self.match_b = list(match_b)
        self.mismatch_count = 0
        self.seq_a = seq_a
        self.seq_b = seq_b
        self.query_id = query_id
        self.rc_query = rc_query

    def __len__(self):
        return len(self.match_a)

    def bases_covered(self, k: int) -> Tuple[int, int]:
        """Bases of A and B covered by matched seeds, overlaps subtracted
        (ref: seeds/sequence.go:830-858)."""
        count_a = len(self.match_a) * k
        count_b = count_a
        pos_a = self.seq_a.seed_positions(k)
        pos_b = self.seq_b.seed_positions(k)
        d1 = np.diff(pos_a[self.match_a]) - k
        d2 = np.diff(pos_b[self.match_b]) - k
        count_a += int(d1[d1 < 0].sum())
        count_b += int(d2[d2 < 0].sum())
        return count_a, count_b

    def get_a_indices(self, k: int) -> Tuple[int, int]:
        """Start/end bases of the matched region in A's original read
        (ref: seeds/sequence.go:1311)."""
        pos = self.seq_a.seed_positions(k)
        start = int(pos[self.match_a[0]]) + self.seq_a.offset
        end = int(pos[self.match_a[-1]]) + self.seq_a.offset
        return start, end

    def get_b_indices(self, k: int) -> Tuple[int, int]:
        pos = self.seq_b.seed_positions(k)
        start = int(pos[self.match_b[0]]) + self.seq_b.offset
        end = int(pos[self.match_b[-1]]) + self.seq_b.offset
        return start, end

    def validate(self) -> bool:
        for a, b in zip(self.match_a, self.match_b):
            if self.seq_a.seeds[a] != self.seq_b.seeds[b]:
                return False
        return True

    def reverse_complement(self, k: int, index):
        """Replace both sequences with their RCs and flip the match
        (ref: seeds/sequence.go:800-816)."""
        self.seq_a = self.seq_a.reverse_complement(k, index)
        self.seq_b = self.seq_b.reverse_complement(k, index)
        la = self.seq_a.num_seeds - 1
        lb = self.seq_b.num_seeds - 1
        self.match_a = [la - i for i in reversed(self.match_a)]
        self.match_b = [lb - i for i in reversed(self.match_b)]

    def get_base_index(self, a_index: int, k: int):
        """Locate position ``a_index`` (a seed index in A) within B: returns
        (b_seed_index, bases_after, distance) (ref: seeds/sequence.go:1190).

        Closed-form over the cached ``seed_positions`` arrays (bisect
        instead of the reference's per-gap walks); bit-identical to
        ``get_base_index_scalar`` by fuzz test — the scalar walk is the
        oracle.  ~3x of the overlap final check's host time was these
        walks."""
        import bisect
        sa = self.seq_a
        sb = self.seq_b
        ma = self.match_a
        mb = self.match_b
        pos_a = sa.seed_positions(k)
        pos_b = sb.seed_positions(k)
        before = bisect.bisect_right(ma, a_index)
        if before == 0:
            b0 = mb[0]
            offset = int(pos_a[ma[0]] - pos_a[a_index])
            # backward walk: stops at the largest j <= b0 with
            # pos_b[j] <= pos_b[b0] - offset, or at 0
            target = int(pos_b[b0]) - offset
            j = bisect.bisect_right(pos_b, target, 0, b0 + 1) - 1
            if j < 0:
                j = 0
            rem = offset - (int(pos_b[b0]) - int(pos_b[j]))
            distance = int(pos_b[b0]) - int(pos_b[j])
            if j == 0:
                return 0, -rem, distance + rem
            return j, -rem, distance
        before -= 1
        b_index = mb[before]
        if a_index == ma[before]:
            return b_index, 0, 0
        offset = int(pos_a[a_index] - pos_a[ma[before]])
        n = sb.num_seeds
        # walk forward while offset covers the next gap: advances through
        # every seed j with pos_b[j] <= pos_b[b0] + offset + k
        limit = int(pos_b[b_index]) + offset + k
        j = bisect.bisect_right(pos_b, limit, b_index + 1, n) - 1
        j = max(j, b_index)
        consumed = int(pos_b[j]) - int(pos_b[b_index])
        rem = offset - consumed
        distance = consumed
        if j == n - 1 and rem >= int(sb.gaps[n]):
            # the reference walks the trailing gap too (segments 2n)
            g = int(sb.gaps[n]) + k
            rem -= g
            distance += g
            return n - 1, rem, distance + rem
        return j, rem, distance + rem

    def get_base_index_scalar(self, a_index: int, k: int):
        """Scalar-walk oracle for ``get_base_index`` (the reference's
        loop, ref: seeds/sequence.go:1190)."""
        sa = self.seq_a
        sb = self.seq_b
        before = 0
        while before < len(self.match_a) and self.match_a[before] <= a_index:
            before += 1
        if before == 0:
            offset = 0
            for i in range(self.match_a[0], a_index, -1):
                offset += int(sa.gaps[i]) + k
            b_index = self.match_b[0]
            distance = 0
            i = b_index
            while i > 0 and offset > 0:
                offset -= int(sb.gaps[i]) + k
                distance += int(sb.gaps[i]) + k
                b_index -= 1
                i -= 1
            if b_index == 0:
                return 0, -offset, distance + offset
            return b_index, -offset, distance
        before -= 1
        b_index = self.match_b[before]
        if a_index == self.match_a[before]:
            return b_index, 0, 0
        offset = 0
        for i in range(self.match_a[before] + 1, a_index + 1):
            offset += int(sa.gaps[i]) + k
        distance = 0
        i = b_index + 1
        # the reference walks the trailing gap too (segments index 2n)
        while i < sb.num_seeds + 1 and offset >= int(sb.gaps[i]):
            offset -= int(sb.gaps[i]) + k
            distance += int(sb.gaps[i]) + k
            b_index += 1
            i += 1
        if b_index >= sb.num_seeds:
            return b_index - 1, offset, distance + offset
        return b_index, offset, distance + offset


def _trunc_div(a: int, b: int) -> int:
    """Go-style integer division (truncate toward zero)."""
    q = abs(a) // b
    return -q if a < 0 else q


def _gap_window(gap_a: int, k: int) -> Tuple[int, int]:
    """Allowed B gap range for an A gap (ref: seeds/sequence.go:489-496)."""
    if gap_a < 0:
        return -k, 0
    return _trunc_div(gap_a * 2, 3) - k, _trunc_div(gap_a * 3, 2) + k


def dynamic_match(query: SeedSequence, seq: SeedSequence, min_match: int,
                  k: int, collect_all: bool = True) -> List[SeedMatch]:
    """Greedy in-order chaining, faithful to the reference's
    ``dynamicMatch``/``extendChain`` walk including first-match tie-breaking
    (ref: seeds/sequence.go:401-576).  Returns all chains within 2/3 of the
    best, each of at least ``min_match`` seeds.
    """
    if min_match == 0:
        min_match = 1
    nq = query.num_seeds
    chains_a: List[Optional[List[int]]] = [None] * nq
    chains_b: List[Optional[List[int]]] = [None] * nq
    all_good: List[SeedMatch] = []
    qseeds = query.seeds
    qgaps = query.gaps
    sseeds = seq.seeds
    qi = -1
    while True:
        qi += 1
        # loop bounds use the *current* (adaptive) min_match, as the
        # reference re-evaluates them each iteration
        if qi > nq - min_match:
            break
        if (qi > 0 and qi + 1 < nq and qgaps[qi] < 0 and qgaps[qi + 1] < 0
                and qseeds[qi] == qseeds[qi - 1] and qseeds[qi] == qseeds[qi + 1]):
            continue  # internal to closely spaced repeats
        if chains_a[qi] is not None:
            continue
        prev_seed = -1
        si = -1
        while True:
            si += 1
            if si > seq.num_seeds - min_match:
                break
            next_seed = int(sseeds[si])
            if (next_seed == qseeds[qi] and next_seed != prev_seed
                    and (chains_a[qi] is None or chains_b[qi][-1] != si)):
                chains_a[qi] = [qi]
                chains_b[qi] = [si]
                ca, cb = _extend_chain(query, seq, chains_a, chains_b, qi, si, k)
                if len(ca) >= min_match:
                    next_len = (len(ca) * 2) // 3
                    if next_len > min_match:
                        min_match = next_len
                        all_good = [m for m in all_good
                                    if len(m.match_a) >= next_len]
                    all_good.append(SeedMatch(ca, cb, query, seq))
                    remaining = sum(1 for c in chains_a if c is None)
                    if remaining < len(ca):
                        return all_good
            prev_seed = next_seed
    return all_good


def _extend_chain(a: SeedSequence, b: SeedSequence, chains_a, chains_b,
                  ai: int, bi: int, k: int):
    """Forward chain extension (ref: seeds/sequence.go:476-576)."""
    cur_a = chains_a[ai]
    cur_b = chains_b[ai]
    offset_a = int(a.gaps[ai + 1])
    offset_b = int(b.gaps[bi + 1])
    ai += 1
    bi += 1
    na = a.num_seeds
    nb = b.num_seeds
    while ai < na and bi < nb:
        min_b, max_b = _gap_window(offset_a, k)
        while max_b < offset_b:
            offset_a += int(a.gaps[ai + 1]) + k
            ai += 1
            if ai >= na:
                return cur_a, cur_b
            # the reference recomputes the window with the plain ratio
            # formula here, without the negative-gap special case
            min_b = _trunc_div(offset_a * 2, 3) - k
            max_b = _trunc_div(offset_a * 3, 2) + k
        while offset_b < min_b:
            offset_b += int(b.gaps[bi + 1]) + k
            bi += 1
            if bi >= nb:
                return cur_a, cur_b
        old_bi = bi
        old_b_offset = offset_b
        matched = False
        seed_a = int(a.seeds[ai])
        while offset_b <= max_b:
            if seed_a == int(b.seeds[bi]):
                if chains_a[ai] is not None:
                    if (chains_b[ai][-1] == bi
                            and len(chains_a[ai]) > len(cur_a)):
                        return cur_a, cur_b
                cur_a = cur_a + [ai]
                chains_a[ai] = cur_a
                cur_b = cur_b + [bi]
                chains_b[ai] = cur_b
                offset_a = int(a.gaps[ai + 1])
                offset_b = int(b.gaps[bi + 1])
                ai += 1
                bi += 1
                matched = True
                break
            offset_b += int(b.gaps[bi + 1]) + k
            bi += 1
            if bi >= nb:
                break
        if not matched:
            offset_a += int(a.gaps[ai + 1]) + k
            ai += 1
            offset_b = old_b_offset
            bi = old_bi
    return cur_a, cur_b
