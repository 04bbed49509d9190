"""Inputs of every cell, made from ``--seed`` alone.

Frozen copies of the port's old bench generators (``rand_seq``, ``mutate``,
``make_reads``), vectorised: a genome of random content, and reads drawn
from it with substitutions, every second one reverse-complemented.  Read
lengths are a fixed set, spread evenly over the traffic's range and put in
an order drawn from the seed, so that every seed gives the same amount of
work.  Each read's origin is kept: it is what the plain reference judges a
mapping by.  Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of the seed (genome, reads,
    ...), so that adding a use never shifts another."""
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng([int(seed) & (2**64 - 1), tag])


def genome(seed: int, n: int) -> np.ndarray:
    """``n`` random bases (uint8 ASCII)."""
    return BASES[rng_for(seed, "genome").integers(0, 4, n, dtype=np.uint8)]


def mutate(rng: np.random.Generator, arr: np.ndarray, rate: float) -> None:
    """Substitute a random base (possibly the same one) at each position
    with probability ``rate``, in place."""
    m = rng.random(arr.shape) < rate
    arr[m] = BASES[rng.integers(0, 4, int(m.sum()), dtype=np.uint8)]


def lengths(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths evenly spread over ``[lo, hi)``, in a random order."""
    base = lo + ((np.arange(n) + 0.5) * (hi - lo) / n).astype(np.int64)
    return rng.permutation(base)


def reverse_complement(s: np.ndarray) -> np.ndarray:
    return _COMP[s[::-1]]


class Reads:
    """Reads drawn from a genome, with their origins: read ``i`` is
    ``g[start[i] : start[i] + length[i]]`` after substitutions, reverse-
    complemented where ``rc[i]``."""

    def __init__(self, seqs, start, length, rc):
        self.seqs = seqs
        self.start = start
        self.length = length
        self.rc = rc


def sample_reads(rng: np.random.Generator, g: np.ndarray, n: int, lo: int,
                 hi: int, err: float) -> Reads:
    """``n`` reads of ``g``, lengths from ``lengths``, substitutions at
    ``err``, every second read reverse-complemented."""
    lens = lengths(rng, n, lo, hi)
    starts = (rng.random(n) * (len(g) - lens)).astype(np.int64)
    total = int(lens.sum())
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    idx = np.repeat(starts - offs[:-1], lens) + np.arange(total)
    flat = g[idx]
    mutate(rng, flat, err)
    rc = np.arange(n) % 2 == 1
    seqs = []
    for i in range(n):
        r = flat[offs[i]:offs[i + 1]]
        seqs.append(reverse_complement(r) if rc[i] else r)
    return Reads(seqs, starts, lens, rc)
