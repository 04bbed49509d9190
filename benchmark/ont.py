"""Inputs of the nanopore-shaped map cell, made from ``--seed`` alone:
reads with a sequencer's length spread and per-read identity, carrying
substitutions, insertions and deletions, with chimeras, random reads and
junk reads among them, each kept with the truth path the plain reference
judges it by.

The profile is a configuration's ``reads`` block, after Badread's
documented defaults (Wick 2019, doi:10.21105/joss.01316):

* a read spans a number of genome bases drawn from a gamma distribution
  of mean ``length_mean`` and standard deviation ``length_sd``; a draw
  under ``min_length`` is drawn again, and so is a read that its errors
  leave under ``min_length`` (the map command skips such reads);
* its identity is drawn from a beta distribution on ``[0,
  identity_max]`` of mean ``identity_mean`` and standard deviation
  ``identity_sd``; its error rate ``1 - identity`` is split evenly: each
  genome base is deleted, substituted by another base, or preceded by an
  inserted random base, each with a third of the rate, drawn base by base;
* fixed shares of a batch, in slots drawn from the seed, are chimeras
  (``chimera_share``: two pieces, each with its own place and strand, the
  span split at a uniform point with each piece spanning at least
  ``chimera_min_piece`` bases), random reads (``random_share``: random
  bases) and junk reads (``junk_share``: one random unit of ``junk_unit``
  bases, its length uniform over that range, repeated);
* each piece lies on the reverse strand with probability ``rc_share``.

A read keeps its segments (read interval, genome interval, strand) and
the genome position of each of its bases on the forward strand, -1 where
a base copies none (an inserted base; every base of a random or junk
read).  Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np

from . import generate

GENOME, CHIMERA, RANDOM, JUNK = 0, 1, 2, 3
_CODE = np.zeros(256, np.uint8)
_CODE[generate.BASES] = np.arange(4, dtype=np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[generate.BASES] = np.frombuffer(b"TGCA", np.uint8)


class Segment:
    """Read bases ``[read_lo, read_hi)`` copy genome bases ``[g_lo,
    g_hi)``, reverse-complemented where ``rc``."""

    __slots__ = ("read_lo", "read_hi", "g_lo", "g_hi", "rc")

    def __init__(self, read_lo, read_hi, g_lo, g_hi, rc):
        self.read_lo = read_lo
        self.read_hi = read_hi
        self.g_lo = g_lo
        self.g_hi = g_hi
        self.rc = rc


class OntReads:
    """Read ``i`` is ``seqs[i]`` (ASCII), of kind ``kind[i]`` (``GENOME``,
    ``CHIMERA``, ``RANDOM`` or ``JUNK``), with segments ``segments[i]``
    (none for a random or junk read) and ``gpos[i]``, the genome position
    each of its bases copies (-1 for none)."""

    def __init__(self, seqs, gpos, kind, segments):
        self.seqs = seqs
        self.gpos = gpos
        self.kind = kind
        self.segments = segments
        self.length = np.fromiter(map(len, seqs), np.int64, len(seqs))


def spans(rng: np.random.Generator, n: int, mean: float, sd: float,
          floor: int) -> np.ndarray:
    """``n`` draws of a gamma distribution of ``mean`` and ``sd``, rounded,
    each under ``floor`` drawn again."""
    shape, scale = (mean / sd) ** 2, sd * sd / mean
    out = np.empty(n, np.int64)
    todo = np.arange(n)
    while len(todo):
        x = np.rint(rng.gamma(shape, scale, len(todo))).astype(np.int64)
        ok = x >= floor
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out


def identities(rng: np.random.Generator, n: int, mean: float, top: float,
               sd: float) -> np.ndarray:
    """``n`` draws of a beta distribution scaled to ``[0, top]`` with
    ``mean`` and standard deviation ``sd``."""
    p, v = mean / top, (sd / top) ** 2
    c = p * (1.0 - p) / v - 1.0
    return top * rng.beta(p * c, (1.0 - p) * c, n)


def copy_pieces(rng: np.random.Generator, g: np.ndarray, g0: np.ndarray,
                span: np.ndarray, rc: np.ndarray, err: np.ndarray):
    """Piece ``j`` copies ``g[g0[j] : g0[j] + span[j]]`` at error rate
    ``err[j]`` (split evenly, see the module), reverse-complemented where
    ``rc[j]``.  Returns the pieces' bases in one flat array, the genome
    position of each (-1 for an inserted base) and each piece's start in
    the flat arrays (one more entry: the end)."""
    m = len(span)
    offs = np.zeros(m + 1, np.int64)
    np.cumsum(span, out=offs[1:])
    pos = (np.repeat(g0 - offs[:-1], span)
           + np.arange(offs[-1])).astype(np.int32)
    bases = g[pos]
    # one draw a base: under a third of the rate deleted, under two thirds
    # substituted, under the rate preceded by an insertion
    third = np.repeat((err / 3.0).astype(np.float32), span)
    u = rng.random(len(pos), dtype=np.float32)
    at = np.flatnonzero(u < 3 * third)
    what = np.minimum((u[at] / third[at]).astype(np.int64), 2)
    del u, third
    dele, sub, ins = (at[what == w] for w in range(3))
    shift = rng.integers(1, 4, len(sub), dtype=np.uint8)
    bases[sub] = generate.BASES[(_CODE[bases[sub]] + shift) % 4]
    bases, pos = np.delete(bases, dele), np.delete(pos, dele)
    into = ins - np.searchsorted(dele, ins)
    bases = np.insert(bases, into, generate.BASES[rng.integers(
        0, 4, len(ins), dtype=np.uint8)])
    pos = np.insert(pos, into, -1)
    piece_len = (span - np.bincount(np.searchsorted(offs, dele, "right") - 1,
                                    minlength=m)
                 + np.bincount(np.searchsorted(offs, ins, "right") - 1,
                               minlength=m))
    poff = np.zeros(m + 1, np.int64)
    np.cumsum(piece_len, out=poff[1:])
    for j in np.flatnonzero(rc).tolist():
        a, b = poff[j], poff[j + 1]
        bases[a:b] = _COMP[bases[a:b][::-1]]
        pos[a:b] = pos[a:b][::-1].copy()
    return bases, pos, poff


def _draw(rng: np.random.Generator, g: np.ndarray, kind: np.ndarray,
          prof: dict) -> tuple:
    """Reads of kinds ``kind``: ``(seqs, gpos, segments)``."""
    n = len(kind)
    mean, sd = float(prof["length_mean"]), float(prof["length_sd"])
    floor, mp = int(prof["min_length"]), int(prof["chimera_min_piece"])
    chim = kind == CHIMERA
    total = spans(rng, n, mean, sd, floor)
    total[chim] = spans(rng, int(chim.sum()), mean, sd, max(floor, 2 * mp))
    err = 1.0 - identities(rng, n, float(prof["identity_mean"]),
                           float(prof["identity_max"]),
                           float(prof["identity_sd"]))
    on = np.flatnonzero(kind <= CHIMERA)
    # each genome read one piece, a chimera two, cut at a uniform point
    cut = mp + (rng.random(n) * (total - 2 * mp + 1)).astype(np.int64)
    reads_of = np.repeat(on, np.where(chim[on], 2, 1))
    first = np.r_[True, reads_of[1:] != reads_of[:-1]]
    span = np.where(chim[reads_of], np.where(first, cut[reads_of],
                                             total[reads_of] - cut[reads_of]),
                    total[reads_of])
    g0 = (rng.random(len(span)) * (len(g) - span + 1)).astype(np.int64)
    rc = rng.random(len(span)) < float(prof["rc_share"])
    bases, gpos, poff = copy_pieces(rng, g, g0, span, rc, err[reads_of])
    seqs, pos, segs = [None] * n, [None] * n, [[] for _ in range(n)]
    # a read's pieces lie one after the other in the flat arrays
    for p, i in enumerate(reads_of.tolist()):
        lo = int(poff[p] - poff[np.searchsorted(reads_of, i)])
        segs[i].append(Segment(lo, lo + int(poff[p + 1] - poff[p]),
                               int(g0[p]), int(g0[p] + span[p]),
                               bool(rc[p])))
    stops = poff[np.searchsorted(reads_of, np.r_[on, n])]
    for i, a, b in zip(on.tolist(), stops[:-1].tolist(), stops[1:].tolist()):
        seqs[i], pos[i] = bases[a:b], gpos[a:b]
    lo_u, hi_u = prof["junk_unit"]
    for i in np.flatnonzero(kind >= RANDOM).tolist():
        L = int(total[i])
        if kind[i] == RANDOM:
            seqs[i] = generate.BASES[rng.integers(0, 4, L, dtype=np.uint8)]
        else:
            unit = generate.BASES[rng.integers(
                0, 4, int(rng.integers(lo_u, hi_u + 1)), dtype=np.uint8)]
            seqs[i] = np.resize(unit, L)
        pos[i] = np.full(L, -1, np.int32)
    return seqs, pos, segs


def sample(rng: np.random.Generator, g: np.ndarray, n: int,
           prof: dict) -> OntReads:
    """``n`` reads of genome ``g`` (ASCII) with profile ``prof`` (see the
    module); the kinds' counts are fixed, their slots drawn from ``rng``."""
    kind = np.full(n, GENOME, np.int8)
    slots = rng.permutation(n)
    at = 0
    for k, key in ((CHIMERA, "chimera_share"), (RANDOM, "random_share"),
                   (JUNK, "junk_share")):
        c = int(round(float(prof[key]) * n))
        kind[slots[at:at + c]] = k
        at += c
    seqs, gpos, segs = _draw(rng, g, kind, prof)
    floor = int(prof["min_length"])
    short = [i for i, s in enumerate(seqs) if len(s) < floor]
    while short:
        again = _draw(rng, g, kind[short], prof)
        for j, i in enumerate(short):
            seqs[i], gpos[i], segs[i] = (a[j] for a in again)
        short = [i for i in short if len(seqs[i]) < floor]
    return OntReads(seqs, gpos, kind, segs)
