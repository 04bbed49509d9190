"""Pileup layout and overlap cleanup (ref: overlap/pileup.go)."""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np


class Pileup:
    """Sequences ordered by estimated start position along a query
    (ref: overlap/pileup.go:15-22)."""

    def __init__(self, members, starts, ends):
        self.members = members
        self.starts = starts
        self.ends = ends
        self.reference_members: List[List[int]] = []
        self.reference_positions: List[List[int]] = []

    def __len__(self):
        return len(self.members)

    def members_at(self, offset: int) -> List[int]:
        ms = []
        for i, start in enumerate(self.starts):
            if start >= offset:
                break
            if self.ends[i] > offset:
                ms.append(self.members[i])
        return ms

    def members_spanning(self, frm: int, to: int) -> List[int]:
        ms = []
        for i, start in enumerate(self.starts):
            if start >= frm:
                break
            if self.ends[i] > to:
                ms.append(self.members[i])
        return ms


def new_pileup(contigs) -> Pileup:
    """Arrange contig parts into a global layout with estimated per-contig
    offsets (ref: overlap/pileup.go:62-183)."""
    members = sorted({p for c in contigs if c is not None for p in c.parts})
    back_map = {m: i for i, m in enumerate(members)}
    n = len(members)
    first_contig = [0] * n
    last_contig = [0] * n
    starts = [0] * n
    ends = [0] * n
    seq_ends = [0] * n
    contig_offsets = [0] * len(contigs)
    for i, contig in enumerate(contigs):
        if contig is None:
            if i > 0:
                contig_offsets[i] = contig_offsets[i - 1] + 1000
            continue
        pos_estimate = 0
        count = 0
        for j, p in enumerate(contig.parts):
            rc = contig.reverse_complement[j]
            index = back_map[p]
            if first_contig[index] == 0:
                first_contig[index] = i
                if rc:
                    starts[index] = -(contig.seq_lengths[j]
                                      - (contig.offsets[j] + contig.lengths[j]))
                else:
                    starts[index] = -contig.offsets[j]
                if i == 0 and -starts[index] > contig_offsets[0]:
                    contig_offsets[0] = -starts[index]
            if i > 0 and last_contig[index] != 0:
                prev = last_contig[index]
                base = contig_offsets[prev] + contigs[prev].combined.length
                if rc:
                    pos_estimate += base + seq_ends[index] \
                        - (contig.offsets[j] + contig.lengths[j])
                else:
                    pos_estimate += base + contig.offsets[j] - seq_ends[index]
                count += 1
            last_contig[index] = i
            if rc:
                ends[index] = contig.combined.length + contig.offsets[j]
                seq_ends[index] = contig.offsets[j]
            else:
                ends[index] = contig.combined.length + \
                    (contig.seq_lengths[j] - contig.lengths[j]
                     - contig.offsets[j])
                seq_ends[index] = contig.offsets[j] + contig.lengths[j]
        if count > 0:
            contig_offsets[i] = pos_estimate // count
        elif i > 0:
            contig_offsets[i] = contig_offsets[i - 1] + 1000
    for index in range(n):
        starts[index] += contig_offsets[first_contig[index]]
        ends[index] += contig_offsets[last_contig[index]]
    order = np.argsort(np.asarray(starts), kind="stable")
    pile = Pileup([members[i] for i in order],
                  [starts[i] for i in order],
                  [ends[i] for i in order])
    print(f"Pileup of {len(pile.members)} member sequences.",
          file=sys.stderr)
    return pile


def _diagonal_of(match, k: int) -> int:
    """Position of a match on the query/target diagonal
    (ref: overlap/pileup.go:206-211)."""
    a_off = match.seq_a.offset + match.seq_a.seed_offset(match.match_a[0], k)
    b_off = match.seq_b.offset + match.seq_b.seed_offset(match.match_b[0], k)
    if match.rc_query:
        return a_off + b_off
    return a_off - b_off


def _check_contained_sequence(rid, future, seq_sets, overlap_size, k):
    """Keep only the diagonally consistent window of hits for one sequence
    (ref: overlap/pileup.go:186-269)."""
    right_most = len(future) - 1
    while right_most >= 1 and rid not in seq_sets[right_most]:
        right_most -= 1
    if right_most == 0:
        return 0, 0
    diagonal = []
    indices = []
    for i in range(right_most + 1):
        if rid in seq_sets[i]:
            match = next(m for m in future[i] if m.seq_b.id == rid)
            indices.append(i)
            diagonal.append(_diagonal_of(match, k))
    order = np.argsort(np.asarray(diagonal), kind="stable")
    indices = [indices[i] for i in order]
    diagonal = [diagonal[i] for i in order]
    window = overlap_size // 2
    best_length = 1
    best_start, best_end = -1, 0
    start, end = -1, 0
    while start < len(indices) - best_length:
        start += 1
        first = diagonal[start]
        while end < len(indices) and first + window > diagonal[end]:
            end += 1
        if end - start >= best_length:
            best_length = end - start
            best_start, best_end = start, end
    if best_length == len(indices):
        return 0, right_most
    if best_length == 1:
        best_length = 0
        keep = []
    else:
        keep = indices[best_start:best_end]
    drop = [i for i in indices if i not in keep]
    for index in drop:
        if rid in seq_sets[index]:
            future[index][:] = [m for m in future[index]
                                if m.seq_b.id != rid]
            seq_sets[index].discard(rid)
    if best_length == 0:
        return -1, -1
    return min(keep), max(keep)


def _has_overhang(rid, overlaps, left_index, right_index, overlap_size, k):
    """(ref: overlap/pileup.go:272-305)"""
    left_match = next(m for m in overlaps[left_index] if m.seq_b.id == rid)
    if left_index == right_index:
        right_match = left_match
    else:
        right_match = next(m for m in overlaps[right_index]
                           if m.seq_b.id == rid)
    if left_match.rc_query:
        left_overhang = right_match.seq_b.seed_offset(
            right_match.match_b[0], k)
        right_overhang = left_match.seq_b.seed_offset_from_end(
            left_match.match_b[-1], k)
    else:
        left_overhang = left_match.seq_b.seed_offset(
            left_match.match_b[0], k)
        right_overhang = right_match.seq_b.seed_offset_from_end(
            right_match.match_b[-1], k)
    return ((right_index < len(overlaps) - 2
             and right_overhang > overlap_size * 2)
            or (left_index > 1 and left_overhang > overlap_size * 2))


def cleanup_overlaps(overlaps, overlap_size: int, k: int):
    """Remove matches inconsistent with the diagonal or overhanging
    (ref: overlap/pileup.go:309-364).  Mutates ``overlaps`` in place."""
    seq_sets = [set(m.seq_b.id for m in ov) for ov in overlaps]
    checked = set()
    for i in range(len(seq_sets)):
        for rid in sorted(seq_sets[i]):
            if rid in checked:
                continue
            left, right = _check_contained_sequence(
                rid, overlaps[i:], seq_sets[i:], overlap_size, k)
            if left == -1:
                continue
            checked.add(rid)
            left += i
            right += i
            if _has_overhang(rid, overlaps, left, right, overlap_size, k):
                for m_i in range(left, right + 1):
                    if rid in seq_sets[m_i]:
                        overlaps[m_i][:] = [m for m in overlaps[m_i]
                                            if m.seq_b.id != rid]
                        seq_sets[m_i].discard(rid)
