"""K-mer statistics and seed-value scoring.

The reference counts k-mers with parallel dense counters merged at the end
(ref: util/sequtil/kmers.go:34-69); here counting is a numpy bincount per
read batch (a device bincount over a device grid lives in
``downpore_tpu_torch.parallel``).  Seed value scoring is the
shared logic of the map and overlap commands
(ref: commands/map.go:45-71, commands/overlap.go:39-94).
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from ..core.sequence import Sequence, kmer_value, rolling_kmers


def kmer_occurrences(seqs: Iterable[Sequence], k: int,
                     mesh=None) -> np.ndarray:
    """Dense k-mer counts over all sequences (uint64[4**k]).

    With a device grid of more than one entry (``parallel.make_mesh``) the
    histogram runs on the grid's devices through
    ``parallel.sharded_kmer_histogram`` (a bincount per entry, summed in
    int64; ref: util/sequtil/kmers.go:34-51).  Without one, or on a 1 x 1
    grid, one host bincount per block of reads."""
    if mesh is not None and getattr(mesh, "size", 1) > 1:
        return _kmer_occurrences_device(seqs, k, mesh)
    return _kmer_occurrences_host(seqs, k)


def _kmer_occurrences_device(seqs: Iterable[Sequence], k: int,
                             mesh) -> np.ndarray:
    """Grid histogram: k-mers batch into fixed ``[E, CH]`` blocks (E the
    grid's entries, padded with -1), each block one sharded bincount."""
    from ..parallel.mesh import sharded_kmer_histogram
    hist = sharded_kmer_histogram(mesh, k)
    E = mesh.size
    CH = 1 << 20                       # 4 MB per entry block
    buf = np.full(E * CH, -1, np.int32)
    fill = 0
    total = None                       # running total on the grid's home

    def flush():
        nonlocal fill, total
        if fill == 0:
            return
        buf[fill:] = -1
        part = hist(buf.reshape(E, CH))
        total = part if total is None else total + part
        fill = 0

    for seq in seqs:
        ks = seq.kmers(k).astype(np.int32)
        lo = 0
        while lo < ks.size:
            take = min(ks.size - lo, buf.size - fill)
            buf[fill : fill + take] = ks[lo : lo + take]
            fill += take
            lo += take
            if fill == buf.size:
                flush()
    flush()
    if total is None:
        return np.zeros(4 ** k, dtype=np.uint64)
    return total.cpu().numpy().astype(np.uint64)


def _kmer_occurrences_host(seqs: Iterable[Sequence], k: int) -> np.ndarray:
    size = 4 ** k
    counts = np.zeros(size, dtype=np.int64)
    # block accumulation: one bincount per ~8M k-mers instead of one
    # full-size bincount+add per read — a GB-scale read set at k=10 paid
    # a fresh 4^k pass per read (tens of thousands of 8 MB traversals)
    pend: list = []
    pend_n = 0

    def flush():
        nonlocal pend, pend_n
        if pend:
            counts_part = np.bincount(
                pend[0] if len(pend) == 1 else np.concatenate(pend),
                minlength=size)
            np.add(counts, counts_part, out=counts)
            pend, pend_n = [], 0

    for seq in seqs:
        ks = seq.kmers(k)
        if ks.size:
            pend.append(ks)
            pend_n += ks.size
            if pend_n >= (1 << 23):
                flush()
    flush()
    return counts.astype(np.uint64)


def top_occurrences(counts: np.ndarray, k: int, top_n: int,
                    bottom_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bottom_ids, top_ids) after merging forward/RC counts, mirroring
    TopOccurrences (ref: util/sequtil/kmers.go:87-112).  The bottom list
    starts at the first non-zero merged count."""
    # int64 internally: uint64 partition/compare paths are pathologically
    # slow in this numpy build (counts fit int64 by construction)
    merged = counts.astype(np.int64)
    np.add(merged, rc_permute(merged, k), out=merged)
    n = len(merged)
    # value histogram + cumulative ranks: boundary values come from one
    # bincount pass instead of np.partition, and only STRICTLY-interior
    # elements are sorted — ties at the two boundary values (the k=13
    # pathology: low counts tie across tens of millions of k-mers, and
    # the old boundary-band stable argsort took ~45 s) are taken in
    # index order directly, which IS the stable order among equal values.
    hist = np.bincount(merged)
    cum = np.cumsum(hist)              # cum[v] = #elements <= v

    def ranked_slice(lo_rank: int, m: int) -> np.ndarray:
        if m <= 0:
            return np.empty(0, np.int64)
        hi_rank = min(lo_rank + m - 1, n - 1)
        v_lo = int(np.searchsorted(cum, lo_rank, side="right"))
        v_hi = int(np.searchsorted(cum, hi_rank, side="right"))
        below = int(cum[v_lo - 1]) if v_lo else 0
        if v_lo == v_hi:
            ties = np.flatnonzero(merged == v_lo)
            return ties[lo_rank - below : lo_rank - below + m]
        lo_ties = np.flatnonzero(merged == v_lo)[lo_rank - below:]
        inner = np.flatnonzero((merged > v_lo) & (merged < v_hi))
        inner = inner[np.argsort(merged[inner], kind="stable")]
        need_hi = m - len(lo_ties) - len(inner)
        hi_ties = np.flatnonzero(merged == v_hi)[:need_hi]
        return np.concatenate([lo_ties, inner, hi_ties])

    start = int(hist[0])               # first non-zero rank
    if start > n - bottom_n:
        start = n - bottom_n
    return ranked_slice(start, bottom_n), ranked_slice(n - top_n, top_n)


def rc_permute(arr: np.ndarray, k: int) -> np.ndarray:
    """``arr[_rc_table(k)]`` without the table or the gather: the RC
    permutation is a base-4 digit reversal plus per-digit complement,
    i.e. the ``(4,)*k`` view with axes transposed (digit reversal) and
    every axis reversed (complement).  One strided copy instead of a
    4^k gather plus the table build (~15 s cold at k=13)."""
    v = arr.reshape((4,) * k).transpose(tuple(reversed(range(k))))
    v = v[(slice(None, None, -1),) * k]
    return np.ascontiguousarray(v).reshape(-1)


_RC_TABLES = {}


def _rc_table(k: int) -> np.ndarray:
    """kmer -> reverse-complement kmer lookup, computed with O(log k)
    vectorized bit passes (no gathers; fast even at 4^11 entries)."""
    if k in _RC_TABLES:
        return _RC_TABLES[k]
    # uint32 while k <= 13 (2k <= 26 bits): halves the first-build page
    # pressure, which dominates on such hosts (see the mallopt note)
    dt = np.uint32 if 2 * k <= 32 else np.int64
    v = np.arange(4 ** k, dtype=dt) ^ dt(4 ** k - 1)  # complement
    # reverse the k 2-bit groups within 2k bits: classic swap cascade on
    # a power-of-two width, then shift out the unused high groups
    width = 1
    while width < k:
        width *= 2
    bits = 2 * width
    masks = {
        2: 0x3333333333333333,
        4: 0x0F0F0F0F0F0F0F0F,
        8: 0x00FF00FF00FF00FF,
        16: 0x0000FFFF0000FFFF,
        32: 0x00000000FFFFFFFF,
    }
    step = 2
    while step < bits:
        m = dt(masks[step] & ((1 << bits) - 1) & (2 ** 64 - 1)
               if dt is np.int64 else
               masks[step] & ((1 << min(bits, 32)) - 1))
        v = ((v >> dt(step)) & m) | ((v & m) << dt(step))
        step *= 2
    v >>= dt(bits - 2 * k)
    if dt is not np.int64:
        v = v.astype(np.int32)
    _RC_TABLES[k] = v
    return v


def default_kmer_values(counts: np.ndarray,
                        target_freq: float = 0.000005) -> np.ndarray:
    """Frequency-targeted seed values: prefer k-mers near ~1:200000
    frequency, zero rare (<3) k-mers (ref: commands/map.go:52-63)."""
    # out=-chained: every fresh multi-hundred-MB temporary re-faults its
    # pages at pathological cost on such hosts (see the package-level
    # mallopt note); one allocation + in-place ops instead of six
    c = counts.astype(np.int64)
    values = c.astype(np.float64)
    tot = float(values.sum())
    np.divide(values, max(tot, 1.0), out=values)
    # the branchy form collapses to 1 - |freq - target|; plain arithmetic
    # sidesteps np.where / boolean fancy indexing
    np.subtract(values, target_freq, out=values)
    np.abs(values, out=values)
    np.subtract(1.0, values, out=values)
    values *= c >= 3
    return values


def score_seed_values(counts: np.ndarray, k: int,
                      seed_values_file: str = "") -> np.ndarray:
    """The full getKmerValues flow: default or file-loaded values, zero the
    merged-count top 1%% and k-mer 0 (ref: commands/overlap.go:39-94,
    commands/map.go:66-71)."""
    if seed_values_file:
        file_k, values = load_kmer_values(seed_values_file)
        if file_k != k:
            raise ValueError(f"Seed values k of {file_k} does not match "
                             f"target k of {k}")
        values = values.copy()
        values[counts < 3] = 0.0
    else:
        values = default_kmer_values(counts)
    _, top = top_occurrences(counts, k, len(counts) // 100,
                             len(counts) // 50)
    values[top] = 0.0
    values[0] = 0.0
    return values


def load_kmer_values(filename: str) -> Tuple[int, np.ndarray]:
    """Seed-value files: 'KMER value' lines; shift-periodic k-mers zeroed
    (ref: util/sequtil/kmerlist.go:14-47)."""
    k = 0
    values = None
    with open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            tokens = line.split(" ")
            if k == 0:
                k = len(tokens[0])
                values = np.zeros(4 ** k, dtype=np.float64)
            v = kmer_value(tokens[0])
            values[v] = float(tokens[1])
            if (tokens[0][1:] == tokens[0][:-1]
                    or tokens[0][2:] == tokens[0][:-2]):
                values[v] = 0.0
    return k, values


def load_confusion_matrix(filename: str) -> Tuple[np.ndarray, int]:
    """K-mer confusion matrices: 'KMER cost KMER cost KMER ...' lines
    (ref: util/sequtil/confusion.go:12-59)."""
    matrix = None
    k = 0
    with open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            tokens = line.split(" ")
            if len(tokens) < 3:
                continue
            if k == 0:
                k = len(tokens[0])
                n = 4 ** k
                matrix = np.full((n, n), 15, dtype=np.uint8)
                np.fill_diagonal(matrix, 0)
            from_kmer = kmer_value(tokens[0])
            for i in range(1, len(tokens) - 1, 2):
                cost = int(tokens[i])
                kmer = kmer_value(tokens[i + 1])
                if cost == 0 or cost > 15:
                    cost = 15
                matrix[from_kmer][kmer] = cost
    return matrix, k


def long_kmer_occurrences(seqs, k: int):
    """Sparse k-mer counts for large k where a dense 4^k table would not
    fit (ref: util/sequtil/kmers.go:9-32).  Returns {kmer_value: count}."""
    from collections import Counter
    counts = Counter()
    for seq in seqs:
        ks = seq.kmers(k)
        if ks.size:
            vals, ns = np.unique(ks, return_counts=True)
            counts.update(dict(zip(vals.tolist(), ns.tolist())))
    return counts
