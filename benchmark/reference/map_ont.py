"""The nanopore-shaped map cell's plain reference: the rules a PAF line of
a read with insertions, deletions and chimeric joins must keep, judged by
the truth path the generator kept (``benchmark/ont.py``: each read's
segments, and the genome position each read base copies).

A mapper's line starts and ends at exact k-mer anchors: its query start
and the reference base its strand puts there begin one k-mer shared by
read and reference, and so do its query end and the other reference end
(forward strand: ``read[qs:qs+k] == genome[ts:ts+k]`` and ``read[qe-k:qe]
== genome[te-k:te]``; reverse strand: the reverse complements of the read's
k-mers against ``genome[te-k:te]`` and ``genome[ts:ts+k]``).  An anchor on
the truth path puts each end on the base the path gives it; one that
straddles an indel inside a run of one base or of a short unit matches a
few bases away, and the line's ends may then move by less than k.  So a
line keeps, besides ``reference/map.py``'s field rules (names, lengths,
ranges, aligned length, mapping quality 255, a seed count of at least 1):

* both ends are exact k-mer copies, as above;
* it lies inside one segment's read interval (give or take ``tol``
  bases, ``tolerance``: k - 1), on that segment's strand;
* each of its two reference ends lies within ``tol`` bases of the base the
  segment's truth path gives its query end (the path runs on past the
  segment's ends at one base a base, and an inserted base takes its
  nearest copied neighbour's position).

A random or junk read copies no genome: any line it has is wrong.  A
non-chimeric read copied from the genome is unplaced with no line; reads
of low identity may rightly have none.

A line must also reach as far as the later stages take it: a segment (a
non-chimeric read, or a chimera's piece of three windows or more) is
covered where one of its lines ends within two windows of each of the
segment's ends (``reach``).  The ends phase and mapNext pair a read's
ends; the split search extends each open end to within a window of a
chimera's join.  A segment with no line is not covered.

The seed count of a clean non-chimeric read follows ``reference/
map_mixed.py``'s rule on the truth path: a window's anchored seeds are its
first ``width`` seed k-mers, each kept where the genome holds the read's
k-mer less than k bases from the place the path gives its first base (at
the place itself where the k-mer is copied with no error; a few bases
off where it straddles an indel in a run, as above) and that place is
one of the first two of its k-mer in the chunk; the chain covers the
union of their k-mers on the reference.  A read of at most two
windows' length is one window, the whole read (the mapper's short path);
a longer one has its two end windows, which must pair.  Indels move a
read's anchors off one diagonal, and where the chain rule splits them
the count departs from this rule: the limit is sized from sound runs.

Plain Python and numpy; it imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import map as plain
from . import map_mixed

_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def _revcomp(s: np.ndarray) -> np.ndarray:
    return _COMP[s[::-1]]


def _fields(line: str, name: str, length: int, ref_name: str,
            ref_len: int):
    """``(qs, qe, rc, ts, te)`` of a PAF line that keeps
    ``reference/map.py``'s field rules, else None."""
    f = line.split("\t")
    if len(f) != 12 or f[0] != name or f[5] != ref_name or \
            f[4] not in ("+", "-"):
        return None
    try:
        qlen, qs, qe, tlen, ts, te, ids, alen, mapq = (
            int(f[i]) for i in (1, 2, 3, 6, 7, 8, 9, 10, 11))
    except ValueError:
        return None
    if (qlen != length or tlen != ref_len or mapq != 255 or ids < 1
            or not 0 <= qs < qe <= length or not 0 <= ts < te <= ref_len
            or alen != te - ts):
        return None
    return qs, qe, f[4] == "-", ts, te


def anchored(read: np.ndarray, genome: np.ndarray, qs: int, qe: int,
             rc: bool, ts: int, te: int, k: int) -> bool:
    """Whether both ends of the line are exact k-mer copies (see above)."""
    if qe - qs < k or te - ts < k:
        return False
    first, last = read[qs:qs + k], read[qe - k:qe]
    if rc:
        first, last = _revcomp(last), _revcomp(first)
    return bool((first == genome[ts:ts + k]).all()
                and (last == genome[te - k:te]).all())


def path_at(gpos: np.ndarray, seg, j: int) -> int:
    """The genome position the truth path of segment ``seg`` gives read
    base ``j``: its copied base's, or the nearest copied base's moved on
    one base a base along the segment's strand."""
    lo, hi = seg.read_lo, seg.read_hi
    copied = np.flatnonzero(gpos[lo:hi] >= 0) + lo
    at = copied[min(int(np.searchsorted(copied, j)), len(copied) - 1)]
    return int(gpos[at]) + (j - int(at)) * (-1 if seg.rc else 1)


def tolerance(k: int) -> int:
    """``tol``: how far a line's ends may lie from the truth path.  An
    exact k-mer copy that straddles an indel matches only where the indel
    sits in a run the k-mer spans (one base, or a short unit repeated), so
    it moves along that run by less than k bases; a copy k or more bases
    off the path is another place's."""
    return k - 1


def on_segment(qs: int, qe: int, rc: bool, ts: int, te: int,
               gpos: np.ndarray, seg, tol: int) -> bool:
    """Whether the line lies inside segment ``seg``'s read interval (give
    or take ``tol``), on its strand, with both reference ends within
    ``tol`` of the segment's truth path."""
    if seg.rc != rc or qs < seg.read_lo - tol or qe > seg.read_hi + tol:
        return False
    a, b = path_at(gpos, seg, qs), path_at(gpos, seg, qe - 1)
    want_ts, want_te = (b, a + 1) if rc else (a, b + 1)
    return abs(ts - want_ts) <= tol and abs(te - want_te) <= tol


def placed(qs: int, qe: int, rc: bool, ts: int, te: int, gpos: np.ndarray,
           segments, tol: int) -> bool:
    """Whether the line lies on one of ``segments`` (``on_segment``)."""
    return any(on_segment(qs, qe, rc, ts, te, gpos, seg, tol)
               for seg in segments)


def line_segment(line: str, name: str, read: np.ndarray, gpos: np.ndarray,
                 segments, genome: np.ndarray, ref_name: str, k: int):
    """``(segment index, qs, qe)`` of the segment ``line`` of read ``name``
    keeps every rule above on, or None where it breaks one."""
    got = _fields(line, name, len(read), ref_name, len(genome))
    if got is None or not anchored(read, genome, *got, k):
        return None
    tol = tolerance(k)
    for j, seg in enumerate(segments):
        if on_segment(*got, gpos, seg, tol):
            return j, got[0], got[1]
    return None


def line_ok(line: str, name: str, read: np.ndarray, gpos: np.ndarray,
            segments, genome: np.ndarray, ref_name: str, k: int) -> bool:
    """True where ``line`` of read ``name`` keeps every rule above."""
    return line_segment(line, name, read, gpos, segments, genome, ref_name,
                        k) is not None


def reach(edge: int) -> int:
    """``reach``: how far a line that covers a segment may stop short of
    each of its ends: two windows (``edge``, the map command's query size,
    is one).  The ends phase maps each read's outermost window at each end
    and mapNext's first round the next one in, so a line whose end windows
    failed but whose next ones paired still starts and ends within two
    windows of the read's ends; the split search runs on until the stretch
    it has left around a chimera's join is under one window wide, so each
    piece's line ends within two windows of the join.  A line that a
    skipped step leaves short stops further off: without mapNext's rounds
    the search's first window lies two windows in from each end; without
    the search a long piece's line stops at mapNext's last step, three
    windows in from the read's end."""
    return 2 * edge


def long_piece(seg, edge: int) -> bool:
    """Whether a chimera's segment is counted for its cover: at least three
    windows long.  A shorter piece lies within the end steps' reach of the
    read's end; where no step extends its end window's mapping the
    algorithm drops that mapping (ROADMAP Queue 3), so such a piece may
    rightly have no line."""
    return seg.read_hi - seg.read_lo >= 3 * edge


def covers(got, j: int, seg, far: int) -> bool:
    """Whether one of the judged lines ``got`` (``line_segment``'s answers)
    lies on segment ``j`` and reaches within ``far`` of both its ends."""
    return any(g is not None and g[0] == j and g[1] <= seg.read_lo + far
               and g[2] >= seg.read_hi - far for g in got)


class Judged(NamedTuple):
    """What ``judge`` counts over a set of reads."""
    wrong: int        # reads with a line that breaks a rule
    unplaced: int     # non-chimeric genome reads with no line
    whole: int        # non-chimeric genome reads
    uncovered: int    # non-chimeric genome reads no one line covers
    pieces: int       # the chimeras' segments of three windows or more
    pieces_uncovered: int   # those no one line covers


def judge(lines_per_read, names, reads, gpos, segments, genome_read,
          genome: np.ndarray, ref_name: str, k: int, edge: int) -> Judged:
    """``Judged`` over every read: ``segments[i]`` is empty for a random
    or junk read, holds one segment for a non-chimeric genome read
    (``genome_read[i]``) and two for a chimera.  A segment is covered
    where one line lies on it and reaches within ``reach(edge)`` of both
    its ends; a segment with no line is not covered.  A chimera's segments
    count where ``long_piece``."""
    far = reach(edge)
    wrong = unplaced = whole = uncovered = pieces = pieces_uncovered = 0
    for lines, n, r, gp, segs, one in zip(lines_per_read, names, reads,
                                          gpos, segments, genome_read):
        got = [line_segment(ln, n, r, gp, segs, genome, ref_name, k)
               for ln in lines]
        wrong += None in got
        if one:
            whole += 1
            unplaced += not lines
            uncovered += not covers(got, 0, segs[0], far)
        elif len(segs) == 2:
            for j, seg in enumerate(segs):
                if long_piece(seg, edge):
                    pieces += 1
                    pieces_uncovered += not covers(got, j, seg, far)
    return Judged(wrong, unplaced, whole, uncovered, pieces,
                  pieces_uncovered)


# -- the seed count of a clean non-chimeric read -------------------------

# shifts from the path's place, nearest first: 0, -1, 1, ..., k - 1
SHIFTS = {k: np.array(sorted(range(1 - k, k), key=lambda d: (abs(d), d)))
          for k in range(1, 33)}


def codes_at(genome: np.ndarray, starts: np.ndarray, k: int) -> np.ndarray:
    """The code of the genome's k-mer at each of ``starts``
    (``map.kmer_codes``' coding)."""
    out = np.zeros(len(starts), np.int64)
    for j in range(k):
        out = (out << 2) | plain.CODE[genome[starts + j]]
    return out


def window(seeds: plain.Seeds, w: np.ndarray, gp: np.ndarray, width: int):
    """(seeds in window ``w``, anchors of its chain, bases the chain covers
    on the reference, first and last anchor in ``w``) for ``w`` (ASCII, on
    the genome's strand) whose base ``x`` copies genome base ``gp[x]`` (-1
    for none); None where no one chunk holds the bases it copies."""
    k, n = seeds.k, len(seeds.genome)
    copied = np.flatnonzero(gp >= 0)
    if not len(copied) or len(w) < k:
        return None
    span = seeds.chunk_of(int(gp[copied[0]]), int(gp[copied[-1]]) + 1)
    if span is None:
        return None
    q = plain.kmer_codes(w, k)
    at = np.flatnonzero(seeds.table[q])
    p = at[:width]
    # the path's place of each seed's first base, and the nearest place,
    # less than k bases from it, where the genome holds the seed's k-mer
    near = copied[np.minimum(np.searchsorted(copied, p), len(copied) - 1)]
    t0 = gp[near].astype(np.int64) + (p - near)
    place = np.clip(t0[:, None] + SHIFTS[k], 0, n - k)
    hit = codes_at(seeds.genome, place.ravel(), k).reshape(place.shape) \
        == q[p][:, None]
    found = hit.any(axis=1)
    p, g0 = p[found], place[found, np.argmax(hit[found], axis=1)]
    before = (np.searchsorted(seeds.keys, q[p] * n + g0)
              - np.searchsorted(seeds.keys, q[p] * n + span[0]))
    keep = before < 2
    p, g0 = p[keep], np.sort(g0[keep])
    if not len(p):
        return len(at), 0, 0, None
    cover = int(np.minimum(np.diff(g0), k).sum()) + k
    return len(at), len(p), cover, (int(p[0]), int(p[-1]))


def expected_ids(seeds: plain.Seeds, read: np.ndarray, gp: np.ndarray,
                 rc: bool, width: int):
    """The seed count of the line that maps a clean non-chimeric read (see
    above), or None where the read is not clean."""
    L, e, k = len(read), seeds.edge, seeds.k
    cuts = [(0, L)] if L <= 2 * e else [(0, e), (L - e, L)]
    total = 0
    for lo, hi in cuts:
        w, g = read[lo:hi], gp[lo:hi]
        if rc:
            w, g = _revcomp(w), g[::-1]
        got = window(seeds, w, g, width)
        if got is None:
            return None
        n_seeds, n_chain, cover, ends = got
        ql = hi - lo
        # the walk's thresholds, on every seed of the window
        if ends is None or n_chain < max(5, n_seeds // 5) \
                or ends[0] + (ql - ends[1] - k) > (ql * 2) // 3:
            return None
        total += cover
    return total


def ids_differing(seeds: plain.Seeds, reads, gpos, rcs, lines_per_read):
    """(clean reads, clean reads whose one line's seed count is not the
    expected one) over non-chimeric genome ``reads`` (ASCII arrays), the
    genome positions their bases copy, their strands and their PAF lines,
    at the mapper's query width."""
    width = map_mixed.query_width(seeds)
    clean = differ = 0
    for read, gp, rc, lines in zip(reads, gpos, rcs, lines_per_read):
        want = expected_ids(seeds, read, gp, bool(rc), width)
        if want is None:
            continue
        clean += 1
        got = [int(ln.split("\t")[9]) for ln in lines
               if len(ln.split("\t")) == 12]
        differ += got != [want]
    return clean, differ
