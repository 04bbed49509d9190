"""Overlap consensus in seed space: SeedContig assembly
(ref: overlap/combine.go)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..seeds import SeedIndex, SeedSequence
from ..seeds.seed_sequence import SeedMatch
from ..seeds import msa


class SeedContig:
    """(ref: overlap/combine.go:8-17)"""
    __slots__ = ("combined", "parts", "reverse_complement", "offsets",
                 "lengths", "approximate", "seq_lengths", "matches")

    def __init__(self, combined, parts, reverse_complement, offsets,
                 lengths, approximate, seq_lengths, matches):
        self.combined = combined
        self.parts = parts
        self.reverse_complement = reverse_complement
        self.offsets = offsets
        self.lengths = lengths
        self.approximate = approximate
        self.seq_lengths = seq_lengths
        self.matches = matches

    def remove(self, part: int):
        """Drop one part (ref: overlap/combine.go:136-161)."""
        idx = self.parts.index(part)
        for field in ("parts", "reverse_complement", "offsets", "lengths",
                      "approximate", "seq_lengths", "matches"):
            lst = getattr(self, field)
            lst[idx] = lst[-1]
            lst.pop()


def trim_to_best_seed(upto: int, ms: List[SeedMatch], min_match: int,
                      k: int):
    """Pick the best-supported front/back anchor seeds of the consensus and
    re-trim all parts to them (ref: overlap/combine.go:21-111)."""
    parts: List[Optional[SeedSequence]] = [None] * len(ms)
    cant_trim = [False] * len(ms)
    best_count = best_score = 0
    best_index = upto
    back_count = back_score = 0
    length = ms[0].seq_a.num_seeds
    back_index = length - upto - 1
    # support histograms, vectorized: the scalar walk counts, per anchor
    # i, the matches whose (strictly ascending) match_a contains i —
    # i.e. a presence histogram.  The back walk iterates j down to 1
    # EXCLUSIVE of 0, so each match's first entry never contributes to
    # back support (faithful to the reference, overlap/combine.go:21-60).
    if upto > 0:
        front_hist = np.zeros(upto, np.int64)
        back_hist = np.zeros(upto, np.int64)
        for match in ms:
            ma = np.asarray(match.match_a)
            f = ma[ma < upto]
            front_hist[f] += 1
            b = (length - 1) - ma[1:]
            b = b[(b >= 0) & (b < upto)]
            back_hist[b] += 1
    for i in range(upto):
        count = int(front_hist[i])
        b_count = int(back_hist[i])
        if count - i >= best_score or (best_count < min_match
                                       and count >= min_match):
            best_count = count
            best_score = count - i
            best_index = i
        if b_count - i >= back_score or (back_count < min_match
                                         and b_count >= min_match):
            back_count = b_count
            back_score = b_count - i
            back_index = length - 1 - i
    consensus, _ = ms[0].seq_a.trimmed(0, best_index, 0, back_index, k)
    for j, match in enumerate(ms):
        index, bases, front_distance = match.get_base_index(best_index, k)
        b_index, back_bases, back_distance = match.get_base_index(back_index, k)
        cant_trim[j] = (front_distance > 50 or front_distance < -50
                        or back_distance > 50 or back_distance < -50)
        if bases > -k and index < match.seq_b.num_seeds - 1:
            bases = int(match.seq_b.gaps[index + 1]) + k - bases
            index += 1
        elif bases < 0:
            bases = -bases + k
        parts[j], _ = match.seq_b.trimmed(bases, index, back_bases, b_index, k)
        match.seq_b = parts[j]
        match.seq_a = consensus
        front = 0
        while front < len(match.match_b) and match.match_b[front] < index:
            front += 1
        back = len(match.match_b) - 1
        while back >= 0 and match.match_b[back] > b_index:
            back -= 1
        # ALSO trim in consensus space: a pair can sit inside the part's
        # kept range but outside [best_index, back_index] on the
        # consensus, which would leave out-of-range match_a entries (the
        # reference keeps them and prints its "Bad back:" diagnostic,
        # ref: overlap/combine.go:94-103, then indexes out of range in
        # GetBasesCovered — here they are dropped instead)
        while front <= back and match.match_a[front] < best_index:
            front += 1
        while back >= front and match.match_a[back] > back_index:
            back -= 1
        match.match_a = match.match_a[front:back + 1]
        match.match_b = match.match_b[front:back + 1]
        for n in range(len(match.match_b)):
            match.match_a[n] -= best_index
            match.match_b[n] -= index
    return consensus, parts, cant_trim


def new_seed_contig(ms: List[SeedMatch], k: int) -> SeedContig:
    """(ref: overlap/combine.go:113-133)"""
    min_match = min(5, len(ms))
    consensus, parts, trim_failed = trim_to_best_seed(
        ms[0].seq_a.num_seeds // 4, ms, min_match, k)
    contig = SeedContig(consensus, [0] * len(ms), [False] * len(ms),
                        [0] * len(ms), [0] * len(ms), trim_failed,
                        [0] * len(ms), list(ms))
    for i, part in enumerate(parts):
        contig.parts[i] = part.id
        contig.reverse_complement[i] = part.rc
        parent = part
        while parent.parent is not None:
            parent = parent.parent
        contig.seq_lengths[i] = parent.length
        contig.offsets[i] = part.offset
        contig.lengths[i] = parent.length - part.offset - part.inset
    return contig


def build_consensus(index: SeedIndex,
                    overlaps: List[SeedMatch]) -> Optional[SeedContig]:
    """Normalize RC overlaps, trim each to the query overlap, run the
    seed-space MSA and wrap into a SeedContig
    (ref: overlap/combine.go:163-193)."""
    k = index.k
    for lap in overlaps:
        if lap.rc_query:
            lap.reverse_complement(k, index)
    seqs: List[SeedSequence] = []
    a0 = overlaps[0].seq_a
    for lap in overlaps:
        ca, cb = lap.bases_covered(k)
        if ca < 25 or cb < 25:
            continue
        s, _ = lap.seq_b.trimmed(
            a0.seed_offset(lap.match_a[0], k), lap.match_b[0],
            a0.seed_offset_from_end(lap.match_a[-1], k), lap.match_b[-1], k)
        seqs.append(s)
    if len(seqs) > 1:
        _, overlap = msa.consensus(seqs, k)
        if len(overlap) > 1:
            return new_seed_contig(overlap, k)
    return None
