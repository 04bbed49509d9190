"""K-mer distance measures for the DTW consensus engine.

Every reference measure — position-weighted XOR (simpleMeasure), 1-2 base
edit detection (editDistance), confusion matrices (matrixDistance) and the
nanopore current model — is a function of a k-mer pair, so on the device
they all become one dense ``[4^k, 4^k]`` distance table built once and gathered per
band position (ref: sequence/alignment/measures.go, model/model.go).  The
table construction below vectorizes the reference's bit tricks over whole
axes; the Measure classes keep the reference's host API (Distances with
tail filling) for the beam engine.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _collapse(diff: np.ndarray) -> np.ndarray:
    """OR each 2-bit base diff down to its low bit."""
    return diff | (diff >> 1)


def build_simple_table(k: int) -> np.ndarray:
    """Position-weighted XOR mismatch costs
    (ref: sequence/alignment/measures.go:45-104).  Index by
    ``table[diff]`` where diff = a ^ b."""
    size = 4 ** k
    diff = np.arange(size, dtype=np.int64)
    bit = lambda sh: ((diff >> sh) | (diff >> (sh + 1))) & 1

    cost = np.zeros(size, dtype=np.uint16)
    if k == 5:
        cost += (bit(4) << 3).astype(np.uint16)
        cost += (bit(6) << 1).astype(np.uint16)
        cost += (bit(2) << 1).astype(np.uint16)
        cost += bit(0).astype(np.uint16)
        cost += bit(8).astype(np.uint16)
    elif k == 4:
        cost += (bit(4) << 2).astype(np.uint16)
        cost += (bit(2) << 2).astype(np.uint16)
        cost += (bit(6) << 1).astype(np.uint16)
        cost += (bit(0) << 1).astype(np.uint16)
    elif k == 3:
        cost += (bit(2) << 3).astype(np.uint16)
        cost += (bit(4) << 1).astype(np.uint16)
        cost += (bit(0) << 1).astype(np.uint16)
    elif k == 6:
        cost += (bit(4) << 2).astype(np.uint16)
        cost += (bit(6) << 2).astype(np.uint16)
        cost += (bit(2) << 1).astype(np.uint16)
        cost += (bit(8) << 1).astype(np.uint16)
        cost += bit(0).astype(np.uint16)
        cost += bit(10).astype(np.uint16)
    elif k == 1:
        cost += bit(0).astype(np.uint16) * 8
    else:
        raise ValueError(f"simple measure supports k in 1,3,4,5,6; got {k}")
    return cost


def _count_low_matches(diff: np.ndarray, upto: int) -> np.ndarray:
    """Number of consecutive matching 2-bit groups from the low end
    (vectorized run of the reference's dRHS loops)."""
    n = np.zeros(diff.shape, dtype=np.int64)
    still = np.ones(diff.shape, dtype=bool)
    for j in range(upto):
        ok = ((diff >> (2 * j)) & 1) == 0
        still = still & ok
        n += still
    return n


def _count_high_matches(diff: np.ndarray, start_group: int) -> np.ndarray:
    """Consecutive matching 2-bit groups counting down from
    ``start_group`` (the reference's dLHS/lLHS/rLHS loops)."""
    n = np.zeros(diff.shape, dtype=np.int64)
    still = np.ones(diff.shape, dtype=bool)
    for j in range(start_group, -1, -1):
        ok = ((diff >> (2 * j)) & 1) == 0
        still = still & ok
        n += still
    return n


def build_edit_table(k: int, mismatch: int, insert: int,
                     delete: int) -> np.ndarray:
    """Edit-distance-ish costs detecting 1-2 base indels
    (ref: sequence/alignment/measures.go:129-249), vectorized over the full
    [4^k, 4^k] pair table."""
    size = 4 ** k
    a = np.arange(size, dtype=np.int64)[:, None]
    b = np.arange(size, dtype=np.int64)[None, :]
    diff = _collapse(a ^ b)
    d_rhs = _count_low_matches(diff, k)
    d_lhs = _count_high_matches(diff, k - 1)

    out = np.empty((size, size), dtype=np.uint16)
    right = _collapse(((b >> 2) ^ a) % (4 ** k))
    left = _collapse((((b << 2) ^ a) >> 2) % (4 ** k))
    r_rhs = _count_low_matches(right, k - 1)
    l_lhs = _count_high_matches(left, k - 2)
    r_lhs = _count_high_matches(right, k - 2)
    l_rhs = _count_low_matches(left, k - 1)
    mism = np.zeros(diff.shape, dtype=np.int64)
    for j in range(k):
        mism += (diff >> (2 * j)) & 1

    # cascade, mirroring the early returns of the reference
    min_cost = (k - (d_lhs + d_rhs)) * mismatch
    c = np.minimum(min_cost, (k - (d_lhs + r_rhs)) * delete)
    c = np.minimum(c, (k - (l_lhs + d_rhs)) * delete)
    c = np.minimum(c, (k - (r_lhs + d_rhs)) * insert)
    c = np.minimum(c, (k - (d_lhs + l_rhs)) * insert)
    c = np.minimum(c, mism * mismatch)

    # early-return overrides, in reference order
    out[:] = c.astype(np.uint16)
    one_err = (d_rhs >= k - 1) | (d_lhs + d_rhs >= k - 1)
    del_hit = ((d_lhs + r_rhs >= k - 1) | (l_lhs + d_rhs >= k - 1)) \
        & (delete < min_cost)
    ins_hit = ((d_lhs + l_rhs >= k - 1) | (r_lhs + d_rhs >= k - 1)) \
        & (insert < np.minimum(min_cost,
                               np.minimum((k - (d_lhs + r_rhs)) * delete,
                                          (k - (l_lhs + d_rhs)) * delete)))
    out[ins_hit] = insert
    out[del_hit] = delete
    out[one_err] = mismatch
    out[a == b] = 0
    return out


class _BaseMeasure:
    """Host-side Measure API (ref: sequence/alignment/alignment.go:37-42)."""

    def __init__(self, k: int, tail_cost: int):
        self.k = k
        self.tail_cost = tail_cost
        self.seqs: List[np.ndarray] = []
        self.rcs: List[bool] = []

    def set_sequences(self, seqs, rcs):
        self.seqs = [np.asarray(s, dtype=np.int64) for s in seqs]
        self.rcs = list(rcs) if rcs is not None else [False] * len(self.seqs)

    def sequence_len(self, index: int) -> int:
        return len(self.seqs[index])

    def _lookup(self, a: int, kmers: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def distances(self, a: int, seq: int, start: int, n: int) -> np.ndarray:
        """Distances of consensus k-mer ``a`` to sequence positions
        [start, start+n); positions past the end fill with tail_cost."""
        kmers = self.seqs[seq]
        ds = np.full(n, self.tail_cost, dtype=np.uint16)
        avail = max(0, min(n, len(kmers) - start))
        if avail > 0:
            ds[:avail] = self._lookup(a, kmers[start : start + avail])
        return ds

    def pair_table(self) -> np.ndarray:
        """Dense [4^k, 4^k] table for the device engine."""
        raise NotImplementedError


class SimpleMeasure(_BaseMeasure):
    def __init__(self, k: int):
        super().__init__(k, 14)
        self.table = build_simple_table(k)

    def _lookup(self, a, kmers):
        return self.table[np.bitwise_xor(kmers, a)]

    def pair_table(self):
        size = 4 ** self.k
        a = np.arange(size)[:, None]
        b = np.arange(size)[None, :]
        return self.table[a ^ b]


class EditDistanceMeasure(_BaseMeasure):
    def __init__(self, k: int, mismatch: int = 4, insert: int = 3,
                 delete: int = 3):
        super().__init__(k, k * mismatch)
        self.table = build_edit_table(k, mismatch, insert, delete)

    def _lookup(self, a, kmers):
        return self.table[a, kmers]

    def pair_table(self):
        return self.table


class MatrixMeasure(_BaseMeasure):
    def __init__(self, k: int, matrix: np.ndarray):
        super().__init__(k, 15)
        self.table = np.asarray(matrix, dtype=np.uint16)

    def _lookup(self, a, kmers):
        return self.table[a, kmers]

    def pair_table(self):
        return self.table


def make_measure(kind: str, k: int, **kw) -> _BaseMeasure:
    if kind == "simple":
        return SimpleMeasure(k)
    if kind == "edit":
        return EditDistanceMeasure(k, **kw)
    if kind == "matrix":
        return MatrixMeasure(k, kw["matrix"])
    raise ValueError(kind)
