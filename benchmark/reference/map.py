"""The map cells' plain reference: every read's origin, as the generator
drew it, and the rules a PAF line of that read must keep.

A read is drawn from ``genome[o : o + L]`` with substitutions only, and
reverse-complemented where ``rc``.  Every anchor of a chain that a mapper
builds from the read's own copy is an exact k-mer match at the same offset,
so a line that places the read where it came from keeps, exactly:

* forward strand: ``tstart - qstart == o`` and ``tend - qend == o``;
* reverse strand: ``tend + qstart == o + L`` and ``tstart + qend == o + L``;

and, like every PAF line, its query name and length, the reference's name
and length, ``0 <= qstart < qend <= L``, ``0 <= tstart < tend <= tlen``,
the aligned length ``tend - tstart``, at least one matching seed, and the
mapping quality 255.  The genome's content is random, so a read has no
second place: a read is placed where it has a line and every line keeps
every rule.

Plain Python and numpy; it imports nothing of the program.
"""
from __future__ import annotations

import numpy as np


def judge_line(line: str, name: str, length: int, origin: int, rc: bool,
               ref_name: str, ref_len: int) -> bool:
    """True where PAF ``line`` of read ``name`` keeps every rule above."""
    f = line.split("\t")
    if len(f) != 12 or f[0] != name or f[5] != ref_name:
        return False
    try:
        qlen, qs, qe, tlen, ts, te, ids, alen, mapq = (
            int(f[i]) for i in (1, 2, 3, 6, 7, 8, 9, 10, 11))
    except ValueError:
        return False
    if (qlen != length or tlen != ref_len or mapq != 255 or ids < 1
            or not 0 <= qs < qe <= length or not 0 <= ts < te <= ref_len
            or alen != te - ts or f[4] != ("-" if rc else "+")):
        return False
    if rc:
        return te + qs == origin + length and ts + qe == origin + length
    return ts - qs == origin and te - qe == origin


def judge(lines_per_read, names, lengths, origins, rcs, ref_name: str,
          ref_len: int) -> int:
    """Reads ``i`` (PAF lines ``lines_per_read[i]``) not placed: with no
    line that keeps every rule, or with a line that breaks one."""
    misplaced = 0
    for lines, n, L, o, rc in zip(lines_per_read, names, lengths, origins,
                                  rcs):
        ok = [judge_line(ln, n, int(L), int(o), bool(rc), ref_name, ref_len)
              for ln in lines]
        misplaced += not ok or not all(ok)
    return misplaced


# -- the seed coverage a clean read's line reports ----------------------
#
# The configurations' seeds (the map command's, after the reference
# toolkit's ``getKmerValues`` and ``AddSingleSeeds``): a k-mer's value is
# ``1 - |count / total - 5e-6|`` where it occurs 3 times or more in the
# genome, else 0; the 1% of k-mers with the most occurrences on both
# strands (ties: the higher code) and the k-mer of code 0 are worth 0.
# Walking the genome in steps of ``seed_rate`` bases, each step whose
# k-mers hold no seed yet makes its best k-mer (the first of the highest
# value) a seed.  A chunk's or a window's seeds are all its k-mers that
# are seeds.  A window's chain on the read's own strand is its exact
# copies of seeds at their own place, each kept where it is one of the
# first two places of its k-mer in the chunk; the chain covers the union
# of their k-mers.  A read whose two end windows each lie inside one chunk
# and whose chains pass the walk's thresholds is mapped by pairing the two,
# and its line's seed count (column 10) is the sum of the two coverages.

CODE = np.full(256, 255, np.uint8)
CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """The code (2 bits a base, A C G T = 0 1 2 3, first base highest)
    of each k-mer of ASCII ``seq``."""
    c = CODE[seq].astype(np.int64)
    n = len(seq) - k + 1
    out = np.zeros(max(n, 0), np.int64)
    for j in range(k):
        out = (out << 2) | c[j:j + n]
    return out


def reverse_codes(k: int) -> np.ndarray:
    """The code of each k-mer's reverse complement, by code."""
    v = np.arange(4 ** k, dtype=np.int32 if k <= 15 else np.int64)
    r = np.zeros_like(v)
    for j in range(k):
        r <<= 2
        r |= 3 - ((v >> (2 * j)) & 3)
    return r


def seed_table(genome: np.ndarray, k: int, seed_rate: int) -> np.ndarray:
    """Whether each k-mer code is a seed of ``genome`` (ASCII)."""
    kmers = kmer_codes(genome, k)
    counts = np.bincount(kmers, minlength=4 ** k)
    values = 1.0 - np.abs(counts / float(counts.sum()) - 0.000005)
    values *= counts >= 3
    both = counts + counts[reverse_codes(k)]
    # the top 1%: every count above the boundary count, and the last of
    # the k-mers at it (a stable ascending order's top slice)
    top = len(both) // 100
    cum = np.cumsum(np.bincount(both))
    edge = int(np.searchsorted(cum, len(both) - top, side="right"))
    above = both > edge
    at = np.flatnonzero(both == edge)
    values[above] = 0.0
    values[at[len(at) - (top - int(above.sum())):]] = 0.0
    values[0] = 0.0
    table = np.zeros(4 ** k, bool)
    span = seed_rate - k + 1
    vals = values[kmers]
    for i in range(0, len(genome) - seed_rate, seed_rate):
        ks = kmers[i:i + span]
        if not table[ks].any():
            table[ks[int(np.argmax(vals[i:i + span]))]] = True
    return table


def chunk_spans(n: int, chunk: int, edge: int) -> np.ndarray:
    """``[start, end)`` of the genome's chunks: ten interleaved passes of
    ``chunk``-base chunks every ``10 * chunk - edge`` bases."""
    spans = []
    for j in range(10):
        i = j * chunk
        while i < n - chunk // 2:
            spans.append((i, min(i + chunk, n)))
            i += chunk * 10 - edge
    return np.array(sorted(spans), np.int64)


class Seeds:
    """The genome's seeds and chunks at a configuration's map settings."""

    def __init__(self, genome: np.ndarray, k: int, seed_rate: int,
                 chunk: int, edge: int, circular: bool):
        self.genome = genome
        self.k = k
        self.edge = edge
        self.table = seed_table(genome, k, seed_rate)
        self.spans = chunk_spans(len(genome), chunk, edge)
        self.circular = circular
        kmers = kmer_codes(genome, k)
        pos = np.flatnonzero(self.table[kmers])
        # the genome's seed places, by (k-mer, place)
        self.keys = np.sort(kmers[pos] * len(genome) + pos)

    def chunk_of(self, lo: int, hi: int):
        """The one chunk that holds ``[lo, hi)``, or None (none, or more
        than one: a circular genome's wrap chunk holds its two ends)."""
        inside = (self.spans[:, 0] <= lo) & (self.spans[:, 1] >= hi)
        if self.circular and (lo < self.edge or hi > len(self.genome)
                              - self.edge):
            return None
        if int(inside.sum()) != 1:
            return None
        return self.spans[np.argmax(inside)]

    def window(self, w: np.ndarray, g0: int):
        """(seeds in window ``w``, anchors of its chain, bases its chain
        covers, first and last anchor) for ``w`` (ASCII, the read's bases
        on the genome's strand) copied from ``genome[g0:]``; None where no
        one chunk holds it."""
        k, n = self.k, len(self.genome)
        span = self.chunk_of(g0, g0 + len(w))
        if span is None:
            return None
        q = kmer_codes(w, k)
        t = kmer_codes(self.genome[g0:g0 + len(w)], k)
        seeds = int(self.table[q].sum())
        p = np.flatnonzero(self.table[q] & (q == t))
        # each query seed keeps the first two places of its k-mer in the
        # chunk: the place on the diagonal must be one of them
        before = (np.searchsorted(self.keys, q[p] * n + g0 + p)
                  - np.searchsorted(self.keys, q[p] * n + span[0]))
        p = p[before < 2]
        if not len(p):
            return seeds, 0, 0, None
        cover = int(np.minimum(np.diff(p), k).sum()) + k
        return seeds, len(p), cover, (int(p[0]), int(p[-1]))


def expected_ids(seeds: Seeds, read: np.ndarray, origin: int, rc: bool):
    """The seed count of the line that maps a clean read (see above), or
    None where the read is not clean."""
    L, e, k = len(read), seeds.edge, seeds.k
    on_genome = read[::-1].copy() if rc else read
    if rc:
        on_genome = _complement(on_genome)
    total = 0
    for lo in (0, L - e):
        w = seeds.window(on_genome[lo:lo + e], origin + lo)
        if w is None:
            return None
        n_seeds, n_chain, cover, ends = w
        # the walk's thresholds: seed hits, chain length, and a chain
        # that spans a third of its window
        if ends is None or n_chain < max(5, n_seeds // 5) \
                or ends[0] + (e - ends[1] - k) > (e * 2) // 3:
            return None
        total += cover
    return total


_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def _complement(s: np.ndarray) -> np.ndarray:
    return _COMP[s]


def ids_differing(seeds: Seeds, reads, lines_per_read, origins, rcs):
    """(clean reads, clean reads whose one line's seed count is not the
    expected one) over ``reads`` (ASCII arrays) and their PAF lines."""
    clean = differ = 0
    for read, lines, o, rc in zip(reads, lines_per_read, origins, rcs):
        want = expected_ids(seeds, read, int(o), bool(rc))
        if want is None:
            continue
        clean += 1
        got = [int(ln.split("\t")[9]) for ln in lines
               if len(ln.split("\t")) == 12]
        differ += got != [want]
    return clean, differ
