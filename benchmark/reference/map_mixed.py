"""The mixed map cells' plain reference: the map cells' rules
(``reference/map.py``), with two kinds of read they do not have.

* A read drawn from the unrelated genome has no place in the reference:
  it is placed correctly only with no PAF line, and any line counts it as
  misplaced.
* A read drawn from the reference keeps the map cells' rule: every line
  places it exactly at its origin, and it has at least one.

The seed count of a clean on-target read is checked by the map cells'
rule with the mapper's query width: the mapper anchors the first
``width`` seeds of a window, in the window's order on the genome's
strand, ``width`` being twice the seeds a window of random sequence
expects, on a grid of 32 from 64 to 192 (the JAX package's ``Mapper``:
``(edge - k + 1) * seeds / 4**k``, the "tail seeds" it documents
truncating).  On random content no window comes near it, so the map
cells' rule, which anchors every seed of a window, held there.  A window
inside repeat copies can hold more: the seed choice prefers k-mers that
occur often (not the top 1%), and a family's copies share them.  On such
a window the chain ends at its last anchored seed, and the line reports
the coverage of the anchored seeds alone; the walk's threshold still
counts every seed of the window.  The JAX package's lines are the
port's there, byte for byte (``tests/test_torch_map_mixed.py``).

The rule departs once more inside repeats, and that is left to the limit:
the candidate walk raises a window's chain threshold to four fifths of
each chain it accepts, in chunk order, so a window that chains longer at
a copy walked earlier than at its own place drops its own; the read's
ends then pair from an inner window (``mapNext``), and the line's seed
count is that pairing's.  Neither moves a line off the read's origin.

Plain Python and numpy; it imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from . import map as plain


def judge(lines_per_read, names, lengths, origins, rcs, off, ref_name: str,
          ref_len: int):
    """(reads not placed, off-target reads with a line): an off-target read
    (``off[i]``) with any line, an on-target one as ``map.judge`` has
    it."""
    misplaced = stray = 0
    for lines, n, L, o, rc, x in zip(lines_per_read, names, lengths,
                                     origins, rcs, off):
        if x:
            stray += bool(lines)
            continue
        misplaced += plain.judge([lines], [n], [L], [o], [rc], ref_name,
                                 ref_len)
    return misplaced + stray, stray


def query_width(seeds: plain.Seeds) -> int:
    """The mapper's query width: the seeds of a window it anchors."""
    e, k = seeds.edge, seeds.k
    expected = (e - k + 1) * int(seeds.table.sum()) / (4 ** k)
    return int(min(192, max(64, -(-2 * expected // 32) * 32)))


def window(seeds: plain.Seeds, w: np.ndarray, g0: int, width: int):
    """``map.Seeds.window`` with the chain built from the first ``width``
    seeds of ``w``: (seeds in ``w``, anchors of the chain, bases it
    covers, first and last anchor), or None where no one chunk holds
    ``w``."""
    k, n = seeds.k, len(seeds.genome)
    span = seeds.chunk_of(g0, g0 + len(w))
    if span is None:
        return None
    q = plain.kmer_codes(w, k)
    t = plain.kmer_codes(seeds.genome[g0:g0 + len(w)], k)
    at = np.flatnonzero(seeds.table[q])
    p = at[:width]
    p = p[q[p] == t[p]]
    before = (np.searchsorted(seeds.keys, q[p] * n + g0 + p)
              - np.searchsorted(seeds.keys, q[p] * n + span[0]))
    p = p[before < 2]
    if not len(p):
        return len(at), 0, 0, None
    cover = int(np.minimum(np.diff(p), k).sum()) + k
    return len(at), len(p), cover, (int(p[0]), int(p[-1]))


def expected_ids(seeds: plain.Seeds, read: np.ndarray, origin: int,
                 rc: bool, width: int):
    """``map.expected_ids`` with each end window's chain built from its
    first ``width`` seeds (``window``): the seed count of the line that
    maps a clean read, or None where the read is not clean."""
    L, e, k = len(read), seeds.edge, seeds.k
    on_genome = plain._complement(read[::-1]) if rc else read
    total = 0
    for lo in (0, L - e):
        w = window(seeds, on_genome[lo:lo + e], origin + lo, width)
        if w is None:
            return None
        n_seeds, n_chain, cover, ends = w
        # the walk's thresholds, on every seed of the window
        if ends is None or n_chain < max(5, n_seeds // 5) \
                or ends[0] + (e - ends[1] - k) > (e * 2) // 3:
            return None
        total += cover
    return total


def ids_differing(seeds: plain.Seeds, reads, lines_per_read, origins, rcs):
    """(clean reads, clean reads whose one line's seed count is not the
    expected one) over on-target ``reads`` (ASCII arrays) and their PAF
    lines, at the mapper's query width."""
    width = query_width(seeds)
    clean = differ = 0
    for read, lines, o, rc in zip(reads, lines_per_read, origins, rcs):
        want = expected_ids(seeds, read, int(o), bool(rc), width)
        if want is None:
            continue
        clean += 1
        got = [int(ln.split("\t")[9]) for ln in lines
               if len(ln.split("\t")) == 12]
        differ += got != [want]
    return clean, differ
