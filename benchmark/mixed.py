"""Inputs of the mixed map cells, made from ``--seed`` alone: repeat
families planted in a random genome, and batches of reads of which a fixed
share is drawn from a second, unrelated genome.

A configuration's ``repeats`` block names each family with its consensus
length (``consensus``), its share of the genome's bases (``share``), the
range each copy's substitution rate is drawn from (``substitution``) and
its copies' lengths: whole copies, or (``mean_copy``) the consensus's 3'
end, whole with probability ``whole_share`` and otherwise ``min_copy``
bases plus an exponential length, its scale set so that the mean copy is
``mean_copy`` bases.  Each consensus is random bases from the seed.  Each
copy is on a random strand and written over the genome at a place drawn
from the seed; copies do not overlap.  Every copy's interval is kept.
Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np

from . import generate

_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


class Copies:
    """The planted copies, in genome order: copy ``i`` covers
    ``[start[i], start[i] + length[i])``, of family ``family[i]`` (an
    index into ``names``), reverse-complemented where ``rc[i]``."""

    def __init__(self, names, start, length, family, rc):
        self.names = names
        self.start = start
        self.length = length
        self.family = family
        self.rc = rc

    def bases_of(self, name: str) -> int:
        """Bases the copies of family ``name`` cover."""
        f = self.names.index(name)
        return int(self.length[self.family == f].sum())


def copy_lengths(rng: np.random.Generator, spec: dict, target: int):
    """Copy lengths of one family summing to ``target`` bases (whole
    copies: the largest multiple of the consensus at most ``target``)."""
    C = int(spec["consensus"])
    if "mean_copy" not in spec:
        return np.full(target // C, C, np.int64)
    w, m0 = float(spec["whole_share"]), int(spec["min_copy"])
    scale = (float(spec["mean_copy"]) - w * C) / (1.0 - w) - m0
    n = int(1.25 * target / float(spec["mean_copy"])) + 16
    lens = np.minimum(m0 + rng.exponential(scale, n).astype(np.int64), C)
    lens[rng.random(n) < w] = C
    stop = int(np.searchsorted(np.cumsum(lens), target))
    lens = lens[:stop + 1].copy()
    lens[-1] -= int(lens.sum()) - target
    return lens[lens > 0]


def plant(seed: int, g: np.ndarray, repeats: dict) -> Copies:
    """Write the families of ``repeats`` over genome ``g`` (ASCII, in
    place), from the seed stream ``repeats``; returns the copies."""
    rng = generate.rng_for(seed, "repeats")
    names = sorted(repeats)
    cons, lens, fam, lo_rate, hi_rate = [], [], [], [], []
    for f, name in enumerate(names):
        spec = repeats[name]
        cons.append(generate.BASES[rng.integers(
            0, 4, int(spec["consensus"]), dtype=np.uint8)])
        ln = copy_lengths(rng, spec, int(round(spec["share"] * len(g))))
        lens.append(ln)
        fam.append(np.full(len(ln), f, np.int64))
        lo, hi = spec["substitution"]
        lo_rate.append(np.full(len(ln), lo))
        hi_rate.append(np.full(len(ln), hi))
    order = rng.permutation(sum(len(ln) for ln in lens))
    length = np.concatenate(lens)[order]
    family = np.concatenate(fam)[order]
    lo_r = np.concatenate(lo_rate)[order]
    hi_r = np.concatenate(hi_rate)[order]
    m, total = len(length), int(length.sum())
    if total > len(g):
        raise ValueError("the families cover more than the genome")
    # sorted cut points in the free bases, each copy after its cut
    offs = np.zeros(m + 1, np.int64)
    np.cumsum(length, out=offs[1:])
    start = np.sort(rng.integers(0, len(g) - total + 1, m)) + offs[:-1]
    rc = rng.random(m) < 0.5
    rate = lo_r + (hi_r - lo_r) * rng.random(m)
    # each copy's bases: the consensus's 3' end, read backwards on the
    # reverse strand, then substitutions at the copy's rate
    all_cons = np.concatenate(cons)
    cons_off = np.concatenate([[0], np.cumsum([len(c) for c in cons])])
    cons_len = cons_off[1:] - cons_off[:-1]
    j = np.arange(total) - np.repeat(offs[:-1], length)
    rep_len = np.repeat(length, length)
    rep_rc = np.repeat(rc, length)
    src = np.where(rep_rc, rep_len - 1 - j, j)
    first = cons_off[family] + cons_len[family] - length
    flat = all_cons[np.repeat(first, length) + src]
    flat[rep_rc] = _COMP[flat[rep_rc]]
    sub = rng.random(total) < np.repeat(rate, length)
    flat[sub] = generate.BASES[rng.integers(0, 4, int(sub.sum()),
                                            dtype=np.uint8)]
    g[np.repeat(start - offs[:-1], length) + np.arange(total)] = flat
    return Copies(names, start, length, family, rc)


def genome(seed: int, config: dict) -> np.ndarray:
    """The configuration's genome: random bases from the seed, with its
    ``repeats`` planted where it has them."""
    g = generate.genome(seed, config["genome_bases"])
    if config.get("repeats"):
        plant(seed, g, config["repeats"])
    return g


class MixedReads(generate.Reads):
    """``generate.Reads`` where read ``i`` is drawn from the unrelated
    genome where ``off[i]``; its ``start`` is then a place in that
    genome."""

    def __init__(self, seqs, start, length, rc, off):
        super().__init__(seqs, start, length, rc)
        self.off = off


def offtarget_genome(seed: int, n: int) -> np.ndarray:
    """The unrelated genome: ``n`` random bases from the seed stream
    ``offtarget``."""
    return generate.BASES[generate.rng_for(seed, "offtarget").integers(
        0, 4, n, dtype=np.uint8)]


def sample_mixed(rng: np.random.Generator, g: np.ndarray, other, n: int,
                 lo: int, hi: int, err: float, share: float) -> MixedReads:
    """``generate.sample_reads`` of ``n`` reads, ``round(share * n)`` of
    them (in slots drawn from ``rng``) from ``other`` instead of ``g``."""
    n_off = int(round(share * n))
    off = np.zeros(n, bool)
    off[rng.permutation(n)[:n_off]] = True
    lens = generate.lengths(rng, n, lo, hi)
    size = np.full(n, len(g))
    if n_off:
        size[off] = len(other)
    starts = (rng.random(n) * (size - lens)).astype(np.int64)
    total = int(lens.sum())
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    idx = np.repeat(starts - offs[:-1], lens) + np.arange(total)
    flat = g[np.minimum(idx, len(g) - 1)]
    if n_off:
        flat_off = other[np.minimum(idx, len(other) - 1)]
        rep_off = np.repeat(off, lens)
        flat[rep_off] = flat_off[rep_off]
    generate.mutate(rng, flat, err)
    rc = np.arange(n) % 2 == 1
    seqs = []
    for i in range(n):
        r = flat[offs[i]:offs[i + 1]]
        seqs.append(generate.reverse_complement(r) if rc[i] else r)
    return MixedReads(seqs, starts, lens, rc, off)
