"""Realistic nanopore read simulation for validation and benchmarking
(copy of ``downpore_tpu/sim/__init__.py``: the same functions and the
same numpy ``Generator`` calls in the same order, so the same outputs
from the same seed).

The reference validates on real ONT datasets (E. coli 500 MB reads,
human chr20; the reference's README.md:192-243,317-326).  None of that
data ships with the repository, so this module generates the *hard
parts* of real long-read data synthetically:

* genomes with planted tandem repeats and low-complexity tracts
  (homopolymer runs, dinucleotide microsatellites) — the cases where
  seed-based retrieval and chaining actually get confused;
* an ONT-like error model: substitutions plus insertion/deletion errors,
  with deletions sharply boosted inside homopolymer runs (the dominant
  ONT basecaller failure mode) — NOT the uniform substitution noise of
  easy-mode fixtures.

Every generator returns plain strings/arrays plus ground truth, so tests
can score recall/precision against planted positions.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_TO_CODE = bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))
_TO_BASE = bytes.maketrans(bytes([0, 1, 2, 3]), b"ACGT")


def random_genome(rng: np.random.Generator, n: int) -> str:
    return _BASES[rng.integers(0, 4, n)].tobytes().decode()


def plant_tandem_repeat(rng: np.random.Generator, genome: str,
                        unit_len: int, n_copies: int,
                        at: Optional[int] = None,
                        divergence: float = 0.02) -> Tuple[str, int, int]:
    """Overwrite a stretch of ``genome`` with ``n_copies`` of a random
    ``unit_len``-base unit, each copy independently mutated by
    ``divergence`` substitutions.  Returns (genome, start, end)."""
    unit = _BASES[rng.integers(0, 4, unit_len)]
    total = unit_len * n_copies
    if at is None:
        at = int(rng.integers(0, len(genome) - total))
    copies = []
    for _ in range(n_copies):
        c = unit.copy()
        m = rng.random(unit_len) < divergence
        c[m] = _BASES[rng.integers(0, 4, int(m.sum()))]
        copies.append(c)
    block = np.concatenate(copies).tobytes().decode()
    return genome[:at] + block + genome[at + total:], at, at + total


def plant_low_complexity(rng: np.random.Generator, genome: str,
                         length: int, period: int = 1,
                         at: Optional[int] = None) -> Tuple[str, int, int]:
    """Overwrite a stretch with a period-1 homopolymer or period-2/3
    microsatellite tract.  Returns (genome, start, end)."""
    if at is None:
        at = int(rng.integers(0, len(genome) - length))
    motif = _BASES[rng.integers(0, 4, period)]
    reps = -(-length // period)
    block = np.tile(motif, reps)[:length].tobytes().decode()
    return genome[:at] + block + genome[at + length:], at, at + length


def structured_genome(rng: np.random.Generator, n: int,
                      n_repeats: int = 2, n_tracts: int = 3) -> str:
    """A genome with tandem repeats and low-complexity tracts planted —
    the default adversarial backdrop for map/overlap validation."""
    g = random_genome(rng, n)
    for _ in range(n_repeats):
        g, _, _ = plant_tandem_repeat(rng, g, unit_len=int(rng.integers(80, 250)),
                                      n_copies=int(rng.integers(3, 6)))
    for i in range(n_tracts):
        g, _, _ = plant_low_complexity(
            rng, g, length=int(rng.integers(40, 120)),
            period=int(rng.integers(1, 4)))
    return g


def _homopolymer_runs(codes: np.ndarray) -> np.ndarray:
    """run_len[i] = length of the maximal equal-base run containing i."""
    n = len(codes)
    if n == 0:
        return np.zeros(0, np.int32)
    change = np.empty(n, bool)
    change[0] = True
    change[1:] = codes[1:] != codes[:-1]
    run_id = np.cumsum(change) - 1
    lens = np.bincount(run_id)
    return lens[run_id].astype(np.int32)


def ont_read(rng: np.random.Generator, template: str,
             sub_rate: float = 0.04, ins_rate: float = 0.025,
             del_rate: float = 0.025, hp_del_boost: float = 3.0,
             hp_min_run: int = 3) -> str:
    """Apply an ONT-like error model to ``template``.

    Deletion probability is multiplied by ``hp_del_boost`` at positions
    inside homopolymer runs of length >= ``hp_min_run`` (matching the
    dominant ONT error mode the reference's DTW consensus is built to fix,
    ref sequence/alignment/alignment.go homopolymer states).  Insertions
    duplicate the current base half the time (stutter) and insert a random
    base otherwise.  Fully vectorized.
    """
    codes = np.frombuffer(template.encode().translate(_TO_CODE),
                          np.uint8).copy()
    n = len(codes)
    runs = _homopolymer_runs(codes)
    p_del = np.where(runs >= hp_min_run, del_rate * hp_del_boost, del_rate)
    u = rng.random(n)
    deleted = u < p_del
    subbed = (~deleted) & (u < p_del + sub_rate)
    # substitutions: shift by 1..3 mod 4 so the base always changes
    codes[subbed] = (codes[subbed] + rng.integers(1, 4, int(subbed.sum()))) % 4
    inserted = rng.random(n) < ins_rate
    stutter = rng.random(n) < 0.5
    ins_base = np.where(stutter, codes, rng.integers(0, 4, n)).astype(np.uint8)
    # build output: each kept position contributes itself, plus an inserted
    # base after it where flagged
    out_len = (~deleted).astype(np.int32) + inserted.astype(np.int32)
    total = int(out_len.sum())
    out = np.empty(total, np.uint8)
    pos = np.cumsum(out_len) - out_len
    keep = ~deleted
    out[pos[keep]] = codes[keep]
    ins_pos = pos + keep.astype(np.int32)
    out[ins_pos[inserted]] = ins_base[inserted]
    return out.tobytes().translate(_TO_BASE).decode()


def revcomp(s: str) -> str:
    return s.encode().translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1].decode()


def sample_reads(rng: np.random.Generator, genome: str, n_reads: int,
                 min_len: int = 2000, max_len: int = 9000,
                 rc_fraction: float = 0.5, circular: bool = False,
                 **error_kw) -> Tuple[List[str], List[Tuple[int, int, bool]]]:
    """Sample ONT reads from ``genome``.  Returns (reads, truth) where
    truth[i] = (start, end, is_rc) of read i's template on the genome."""
    reads, truth = [], []
    G = len(genome)
    for _ in range(n_reads):
        L = int(rng.integers(min_len, max_len + 1))
        if circular:
            p = int(rng.integers(0, G))
            tmpl = (genome + genome)[p : p + L]
        else:
            L = min(L, G)
            p = int(rng.integers(0, G - L + 1))
            tmpl = genome[p : p + L]
        r = ont_read(rng, tmpl, **error_kw)
        rc = bool(rng.random() < rc_fraction)
        if rc:
            r = revcomp(r)
        reads.append(r)
        truth.append((p, p + L, rc))
    return reads, truth


def score_mappings(truth, mapped_ranges, genome_len: int,
                   tol: int = 400) -> Tuple[float, float]:
    """(recall, precision) of mapped ranges vs planted truth.

    ``mapped_ranges[i]`` is a list of (start, end) genome ranges reported
    for read i; a report is correct if it overlaps the true range by more
    than half of the shorter of the two (ends may be trimmed by
    ``tol``-scale seed effects)."""
    hits = reported = correct = 0
    for (ts, te, _), ranges in zip(truth, mapped_ranges):
        found = False
        for (ms, me) in ranges:
            reported += 1
            lo, hi = max(ts, ms), min(te, me)
            span = min(te - ts, max(1, me - ms))
            if hi - lo > span // 2:
                correct += 1
                found = True
        if found:
            hits += 1
    recall = hits / max(1, len(truth))
    precision = correct / max(1, reported)
    return recall, precision
