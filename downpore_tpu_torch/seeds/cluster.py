"""Greedy incremental seed-space consensus clustering.

Behaviour-level port of the reference's cluster consensus — the anchored
greedy matchers ``match_from``/``match_to`` (ref: seeds/sequence.go:202-359),
the seed-timeline ``merge`` (ref: seeds/sequence.go:1046-1183), the
support-pruned ``Cluster`` (ref: seeds/sequence.go:578-797) and the
``consensus`` entry point (ref: seeds/sequence.go:942-1044).

Like the overlap graph, this subsystem is dead code in the reference (no
command calls it), so this port preserves the algorithms rather than
bit-level quirks: sequences are greedily aligned to a growing consensus
from quality order, merged on a shared base timeline with weighted gaps,
and seeds supported by fewer than two members are periodically pruned.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .seed_sequence import SeedSequence, SeedMatch

MIN_MATCH_LENGTH = 5


def _segments(s: SeedSequence) -> List[int]:
    """Interleaved [gap0, seed0, gap1, ..., gapN] view."""
    out = []
    for i in range(s.num_seeds):
        out.append(int(s.gaps[i]))
        out.append(int(s.seeds[i]))
    out.append(int(s.gaps[s.num_seeds]))
    return out


def match_from(a: SeedSequence, b: SeedSequence, start_a: int, start_b: int,
               offset: int, k: int) -> SeedMatch:
    """Greedy forward walk from (start_a, start_b): match identical seeds
    whose accumulated offsets agree within the 0.66-1.5x gap-ratio window
    (ref: seeds/sequence.go:202-270).

    Divergence: the reference accumulates ``segments[i-1]`` — the gap
    *before* the current A seed — so its window lags one gap behind (its
    backward twin MatchTo uses the correct side).  This port accumulates
    the gap after, making the two directions symmetric."""
    m = SeedMatch([], [], a, b)
    if start_b >= b.num_seeds or start_a >= a.num_seeds:
        return m
    gap_limit = max(5, (2 * a.num_seeds + 1) // 10)
    bi = start_b           # first b seed that might match
    max_bi = bi + gap_limit
    offset_b = -offset
    offset_a = 0
    for i in range(start_a, a.num_seeds):
        min_off = int(0.66 * offset_a)
        if min_off < 0:
            min_off = int(1.5 * offset_a)
        max_off = max(int(1.5 * offset_a), k)
        while offset_b < min_off and bi < b.num_seeds - 1:
            offset_b += int(b.gaps[bi + 1]) + k
            bi += 1
        next_b_off = offset_b
        j = bi
        while j < b.num_seeds and j <= max_bi:
            if int(b.seeds[j]) == int(a.seeds[i]):
                m.match_a.append(i)
                m.match_b.append(j)
                offset_a = 0
                offset_b = int(b.gaps[j + 1]) + k
                bi = j + 1
                max_bi = j + gap_limit
                break
            if next_b_off < min_off:
                bi += 1
                offset_b += int(b.gaps[j + 1]) + k
            next_b_off += int(b.gaps[j + 1]) + k
            if next_b_off > max_off:
                break
            j += 1
        offset_a += int(a.gaps[i + 1]) + k
    return m


def match_to(a: SeedSequence, b: SeedSequence, start_a: int, start_b: int,
             offset: int, k: int) -> SeedMatch:
    """Greedy backward walk, excluding the starting pair itself
    (ref: seeds/sequence.go:272-359)."""
    m = SeedMatch([], [], a, b)
    if start_b <= 0 or start_a <= 0:
        return m
    start_b = min(start_b, b.num_seeds - 1)
    start_a = min(start_a, a.num_seeds - 1)
    bi = start_b - 1
    offset_b = offset + int(b.gaps[start_b])
    offset_a = 0
    for i in range(start_a - 1, -1, -1):
        offset_a += int(a.gaps[i + 1]) + k
        min_off = int(0.66 * offset_a)
        if min_off < 0:
            min_off = int(1.5 * offset_a)
        max_off = max(int(1.5 * offset_a), k)
        while offset_b < min_off and bi > 0:
            offset_b += int(b.gaps[bi]) + k
            bi -= 1
        next_b_off = offset_b
        j = bi
        while j >= 0:
            if int(b.seeds[j]) == int(a.seeds[i]):
                m.match_a.append(i)
                m.match_b.append(j)
                if j > 0:
                    offset_a = 0
                    offset_b = int(b.gaps[j]) + k
                bi = j - 1
                break
            if next_b_off < min_off:
                bi -= 1
                offset_b += int(b.gaps[j]) + k
            next_b_off += int(b.gaps[j]) + k
            if next_b_off > max_off:
                break
            j -= 1
    m.match_a.reverse()
    m.match_b.reverse()
    return m


def merge(m: SeedMatch, k: int, b_weight: float
          ) -> Tuple[SeedSequence, List[int]]:
    """Combine the two sequences of an alignment on a shared base
    timeline, keeping ALL seeds (ref: seeds/sequence.go:1046-1183).

    Matched seed pairs anchor the timeline; the span between consecutive
    matched pairs becomes the ``b_weight``-blended mean of the two
    sequences' spans, and unmatched seeds inside a span keep their
    relative position (scaled into the blended span).  Edges keep their
    native distances.  For consecutive matched seeds this reduces to the
    reference's weighted-mean gap exactly.  Returns the merged sequence
    and the old-A-index -> new-index map."""
    a, b = m.seq_a, m.seq_b
    events: List[Tuple[float, int, int, int]] = []  # (pos, src, ai, seed)
    # matched-pair anchor positions on the blended timeline
    anchor_pos = [0.0]
    for n in range(len(m.match_a) - 1):
        # spans measured start-of-seed to start-of-seed
        span_a = k + a.seed_offset_between(m.match_a[n], m.match_a[n + 1], k)
        span_b = k + b.seed_offset_between(m.match_b[n], m.match_b[n + 1], k)
        blended = (1.0 - b_weight) * span_a + b_weight * span_b
        if span_a < 2 * k and span_b < 2 * k:
            blended = float(span_a)
        anchor_pos.append(anchor_pos[-1] + blended)

    def emit_span(seq, src, lo, hi, p0, p1, native_span):
        """Seeds strictly between matched indices lo..hi, scaled from
        their native offsets into [p0, p1]."""
        scale = (p1 - p0) / native_span if native_span else 1.0
        off = 0
        for i in range(lo + 1, hi):
            off += int(seq.gaps[i]) + k
            events.append((p0 + off * scale, src, i, int(seq.seeds[i])))

    # between matched pairs (src 0 = A, 1 = B; matched seeds src -1)
    for n in range(len(m.match_a)):
        events.append((anchor_pos[n], -1, m.match_a[n],
                       int(a.seeds[m.match_a[n]])))
        if n + 1 < len(m.match_a):
            ia, ia2 = m.match_a[n], m.match_a[n + 1]
            jb, jb2 = m.match_b[n], m.match_b[n + 1]
            emit_span(a, 0, ia, ia2, anchor_pos[n], anchor_pos[n + 1],
                      k + a.seed_offset_between(ia, ia2, k))
            emit_span(b, 1, jb, jb2, anchor_pos[n], anchor_pos[n + 1],
                      k + b.seed_offset_between(jb, jb2, k))
    # left edge: native distances, negative positions
    off = 0
    for i in range(m.match_a[0] - 1, -1, -1):
        off += int(a.gaps[i + 1]) + k
        events.append((-float(off), 0, i, int(a.seeds[i])))
    off = 0
    for j in range(m.match_b[0] - 1, -1, -1):
        off += int(b.gaps[j + 1]) + k
        events.append((-float(off), 1, j, int(b.seeds[j])))
    # right tail
    off = 0
    for i in range(m.match_a[-1] + 1, a.num_seeds):
        off += int(a.gaps[i]) + k
        events.append((anchor_pos[-1] + off, 0, i, int(a.seeds[i])))
    off = 0
    for j in range(m.match_b[-1] + 1, b.num_seeds):
        off += int(b.gaps[j]) + k
        events.append((anchor_pos[-1] + off, 1, j, int(b.seeds[j])))

    events.sort(key=lambda e: (e[0], e[1]))
    new_a = [0] * a.num_seeds
    gaps, seeds = [0], []
    prev = None
    for pos, src, idx, seed in events:
        if prev is not None:
            gaps.append(int(round(pos - prev)) - k)
        seeds.append(seed)
        if src <= 0:  # A seed or matched pair (recorded under A's index)
            new_a[idx] = len(seeds) - 1
        prev = pos
    gaps.append(0)
    merged = SeedSequence(np.array(gaps, np.int32),
                          np.array(seeds, np.int32), id=-1, length=0)
    merged.length = merged.seed_offset(merged.num_seeds - 1, k) + k
    return merged, new_a


class Cluster:
    """A consensus target plus its aligned member sequences with
    per-seed support counts (ref: seeds/sequence.go:578-695)."""

    def __init__(self, first: SeedSequence, anchor: int,
                 anchor_offset: int):
        self.target = first
        self.target_anchor = anchor
        self.target_anchor_offset = anchor_offset
        self.components: List[SeedSequence] = [first]
        n = first.num_seeds
        self.alignments: List[SeedMatch] = [
            SeedMatch(list(range(n)), list(range(n)), first, first)]
        self.support: Optional[List[int]] = None

    def intersects(self, other: "Cluster") -> bool:
        return any(s is t for s in self.components
                   for t in other.components)

    def is_distinct(self, others: List["Cluster"]) -> bool:
        return all(o is self or not self.intersects(o) for o in others)

    def add_sequence(self, m: SeedMatch, k: int) -> List[int]:
        self.alignments.append(m)
        target, new_idx = merge(m, k, 1.0 / (len(self.components) + 1.0))
        self.target = target
        self.target_anchor = new_idx[self.target_anchor]
        self.components.append(m.seq_b)
        n = target.num_seeds
        support = [1] * n
        if self.support is None:
            for i in m.match_a:
                support[new_idx[i]] = 2
        else:
            for i, s in enumerate(self.support):
                support[new_idx[i]] = s
            for i in m.match_a:
                support[new_idx[i]] += 1
        self.support = support
        for a in self.alignments:
            a.match_a = [new_idx[x] for x in a.match_a]
            a.seq_a = target
        return new_idx

    def rationalise(self, k: int, keep_edges: bool):
        """Drop seeds supported by only one member (the anchor and,
        optionally, the unmatched edges survive)
        (ref: seeds/sequence.go:714-797)."""
        sup = self.support
        n = len(sup)
        seg = _segments(self.target)
        first_n1 = next((i for i, s in enumerate(sup) if s > 1), n)
        last_n1 = next((i for i in range(n - 1, -1, -1) if sup[i] > 1), -1)
        keep = []
        for i in range(n):
            edge = keep_edges and (i < first_n1 or i > last_n1)
            # with keep_edges off, the leading run from the anchor to the
            # first supported seed survives (ref: sequence.go:726-734)
            lead = (not keep_edges and self.target_anchor < first_n1
                    and self.target_anchor <= i < first_n1)
            if sup[i] > 1 or i == self.target_anchor or edge or lead:
                keep.append(i)
        new_idx = {old: new for new, old in enumerate(keep)}
        gaps, seeds, support = [], [], []
        offset = 0
        for i in range(n):
            offset += seg[2 * i]
            if i in new_idx:
                gaps.append(offset)
                seeds.append(seg[2 * i + 1])
                support.append(sup[i])
                offset = 0
            else:
                offset += k
        gaps.append(0)
        if not keep_edges and keep:
            gaps[0] = 0
        t = SeedSequence(np.array(gaps, np.int32),
                         np.array(seeds, np.int32), id=-1, length=0)
        if t.num_seeds:
            t.length = t.seed_offset(t.num_seeds - 1, k) + k
        self.target = t
        self.support = support
        self.target_anchor = new_idx.get(self.target_anchor, 0)
        for a in self.alignments:
            ma, mb = [], []
            for x, y in zip(a.match_a, a.match_b):
                if x in new_idx:
                    ma.append(new_idx[x])
                    mb.append(y)
            a.match_a, a.match_b = ma, mb
            a.seq_a = t


def consensus(seqs: List[SeedSequence], badness: List[int],
              anchors: List[int], anchor_offsets: List[int],
              k: int) -> List[SeedMatch]:
    """Greedy incremental consensus over anchored sequences
    (ref: seeds/sequence.go:942-1044): best-quality first, align each to
    the growing consensus (forward from the anchor, then back), merge,
    prune 1-support seeds every 5 members, retry early failures, and
    finally re-align every member demanding 5x mean seed support."""
    order = sorted(range(len(seqs)), key=lambda i: badness[i])
    seqs = [seqs[i] for i in order]
    anchors = [anchors[i] for i in order]
    anchor_offsets = [anchor_offsets[i] for i in order]

    c = Cluster(seqs[0], anchors[0], anchor_offsets[0])
    retry = []

    def try_add(i) -> bool:
        mf = match_from(c.target, seqs[i], c.target_anchor, anchors[i],
                        anchor_offsets[i] - c.target_anchor_offset, k)
        if mf.match_a:
            mb = match_to(c.target, seqs[i], mf.match_a[0], mf.match_b[0],
                          0, k)
        else:
            mb = match_to(c.target, seqs[i], c.target_anchor, anchors[i],
                          anchor_offsets[i] - c.target_anchor_offset, k)
        if len(mb.match_a) + len(mf.match_a) > MIN_MATCH_LENGTH:
            m = SeedMatch(mb.match_a + mf.match_a, mb.match_b + mf.match_b,
                          c.target, seqs[i])
            c.add_sequence(m, k)
            if len(c.components) % 5 == 0:
                c.rationalise(k, False)
            return True
        return False

    for i in range(1, len(seqs)):
        if not try_add(i):
            retry.append(i)
    for i in retry:
        try_add(i)

    result: List[SeedMatch] = []
    if len(c.components) == 1:
        return result
    if len(c.components) % 5 != 0:
        c.rationalise(k, True)
    total = sum(c.support)
    required = (total * 5) // max(1, len(c.support))
    for j, s in enumerate(c.components):
        al = c.alignments[j]
        if not al.match_a:
            continue
        anchor_a = al.match_a[len(al.match_a) // 2]
        anchor_b = al.match_b[len(al.match_b) // 2]
        mf = match_from(c.target, s, anchor_a, anchor_b, 0, k)
        if not mf.match_a:
            continue
        mb = match_to(c.target, s, mf.match_a[0], mf.match_b[0], 0, k)
        if len(mb.match_a) + len(mf.match_a) > MIN_MATCH_LENGTH:
            m = SeedMatch(mb.match_a + mf.match_a, mb.match_b + mf.match_b,
                          c.target, s)
            support = sum(c.support[x] for x in m.match_a)
            if support >= required:
                result.append(m)
    if result:
        t = result[0].seq_a
        t.length = t.seed_offset(t.num_seeds, k)
    return result
