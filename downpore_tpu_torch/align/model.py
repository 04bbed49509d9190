"""Nanopore current-level model measure (ref: model/model.go).

Loads a k-mer -> current-level file, rescales the 20th-80th percentile span
to ~100 units, derives reverse-complement levels, and measures k-mer
distance as the clamped level difference (exact match = 0).  Fits the same
Measure API as ``align.measures`` and exposes a dense pair table for the
device engine.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.sequence import kmer_value
from ..utils.kmers import _rc_table


class Model:
    def __init__(self, filename: str, is_2d: bool = False):
        self.is_2d = is_2d
        levels = None
        k = 0
        with open(filename) as f:
            for line in f:
                if not line or line[0] not in "ACGT":
                    continue
                tokens = line.rstrip("\n").split("\t")
                if k == 0:
                    k = len(tokens[0])
                    levels = np.zeros(4 ** k, dtype=np.float64)
                levels[kmer_value(tokens[0])] = float(tokens[1])
        self.k = k
        # rescale: 20th-80th percentile span -> 255 units, offset to min
        # (ref: model/model.go:71-87)
        temp = np.sort(levels)
        min_level = temp[len(temp) // 5]
        max_level = temp[len(temp) - len(temp) // 5]
        f = 255.0 / (max_level - min_level)
        scaled = np.minimum((levels - temp[0]) * f, 10000.0)
        self.levels = scaled.astype(np.uint16)
        rc = _rc_table(k)
        self.rc_levels = np.zeros_like(self.levels)
        self.rc_levels[rc] = self.levels
        self.seqs: List[np.ndarray] = []
        self.rcs: List[bool] = []
        self._level_seqs: List[np.ndarray] = []
        self._rc_level_seqs: List[np.ndarray] = []

    def clone(self) -> "Model":
        m = object.__new__(Model)
        m.is_2d = self.is_2d
        m.k = self.k
        m.levels = self.levels
        m.rc_levels = self.rc_levels
        m.seqs = []
        m.rcs = []
        m._level_seqs = []
        m._rc_level_seqs = []
        return m

    # -- Measure API ---------------------------------------------------
    def set_sequences(self, seqs, rcs):
        self.seqs = [np.asarray(s, dtype=np.int64) for s in seqs]
        self.rcs = list(rcs) if rcs is not None else [False] * len(self.seqs)
        self._level_seqs = [self.levels[s] for s in self.seqs]
        self._rc_level_seqs = [self.rc_levels[s] for s in self.seqs]

    def sequence_len(self, index: int) -> int:
        return len(self.seqs[index])

    def distances(self, a: int, seq: int, start: int, n: int) -> np.ndarray:
        """(ref: model/model.go:123-212)"""
        kmers = self.seqs[seq]
        ds = np.full(n, 1000, dtype=np.uint16)
        avail = max(0, min(n, len(kmers) - start))
        if avail == 0:
            return ds
        sl = slice(start, start + avail)
        if self.is_2d:
            level = int(self.levels[a])
            rc_level = int(self.rc_levels[a])
            b = self._level_seqs[seq][sl].astype(np.int64)
            rcb = self._rc_level_seqs[seq][sl].astype(np.int64)
            d = np.abs(b - level) + 1
            d += np.abs(rcb - rc_level) + 1
            d //= 2
            d = np.minimum(d, 50)
            d[kmers[sl] == a] = 0
            ds[:avail] = d
            return ds
        if self.rcs[seq]:
            level = int(self.rc_levels[a])
            b = self._rc_level_seqs[seq][sl].astype(np.int64)
        else:
            level = int(self.levels[a])
            b = self._level_seqs[seq][sl].astype(np.int64)
        d = np.abs(b - level) + 1
        d[b == level] = 1
        d[(b == level) & (kmers[sl] == a)] = 0
        d = np.minimum(d, 50)
        ds[:avail] = d
        return ds

    def distance(self, a: int, b: int) -> int:
        if a == b:
            return 0
        d = abs(int(self.levels[a]) - int(self.levels[b]))
        return 50 if d >= 49 else 1 + d

    def distance_rc(self, a: int, b: int) -> int:
        if a == b:
            return 0
        d = abs(int(self.rc_levels[a]) - int(self.rc_levels[b]))
        return 50 if d >= 49 else 1 + d

    def distance_2d(self, a: int, b: int) -> int:
        return self.distance(a, b) + self.distance_rc(a, b)

    def pair_table(self, rc: bool = False) -> np.ndarray:
        lv = (self.rc_levels if rc else self.levels).astype(np.int64)
        d = np.abs(lv[:, None] - lv[None, :])
        out = np.minimum(1 + d, 50).astype(np.uint16)
        np.fill_diagonal(out, 0)
        return out
