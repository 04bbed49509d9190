"""Mixed map traffic: the map driver's closed-loop batches, on a genome
that may carry planted repeat families (the configuration's ``repeats``,
from the seed stream ``repeats``), with ``offtarget_share`` of each batch's
reads drawn from an unrelated random genome of the same length (the seed
stream ``offtarget``).  The count of those reads is fixed, their slots in
the batch drawn from the seed.

The window, the output and its digests are the map driver's.  After the
window the plain reference of this kind judges every read: an off-target
read by having no line, an on-target one by its origin; and a sample of the
on-target reads by their seed count.
"""
from __future__ import annotations

import sys

from .. import generate, mixed
from ..reference import map as plain
from ..reference import map_mixed as reference
from . import map as base

LABELS = base.LABELS


class Workload(base.Workload):

    def setup(self):
        from downpore_tpu_torch.core.sequence import Sequence
        from downpore_tpu_torch.mapping import Mapper
        from downpore_tpu_torch.utils import (kmer_occurrences,
                                              score_seed_values)
        cfg, tr, seed = self.ctx.config, self.ctx.traffic, self.ctx.seed
        m = cfg["map"]
        g = self.genome = mixed.genome(seed, cfg)
        ref = Sequence.from_string(g.tobytes().decode(), id=0,
                                   name=cfg["reference_name"])
        values = score_seed_values(kmer_occurrences([ref], m["k"]), m["k"])
        self.mapper = Mapper(ref, m["circular"], m["k"], values,
                             m["seed_rate"], m["query_size"],
                             m["chunk_size"], device=self.ctx.device)
        share = float(tr["offtarget_share"])
        other = mixed.offtarget_genome(seed, len(g)) if share > 0 else None
        lo, hi = tr["read_length"]
        self.truth, self.batches, self.bases = [], [], []
        for b in range(tr["batches"]):
            rng = generate.rng_for(seed, f"reads{b}")
            reads = mixed.sample_mixed(rng, g, other, tr["batch_reads"], lo,
                                       hi, tr["substitution_rate"], share)
            names = [f"b{b}r{i}" for i in range(len(reads.seqs))]
            self.truth.append((names, reads.length, reads.start, reads.rc,
                               reads.seqs, reads.off))
            self.batches.append([
                Sequence.from_string(a.tobytes().decode(), id=i, name=n)
                for i, (n, a) in enumerate(zip(names, reads.seqs))])
            self.bases.append(int(reads.length.sum()))
        self.lines = [None] * len(self.batches)
        self.digests = [set() for _ in self.batches]

    def check(self) -> list:
        """The map driver's three numbers, by this kind's reference: the
        share of the reads not placed (an off-target read is placed only
        with no line), in percent; the share of the clean reads, among
        ``ids_sample`` on-target reads drawn from the seed, whose line's
        seed count is not the reference's, in percent; and the passes of
        a batch that gave other bytes than its first."""
        cfg, tr = self.ctx.config, self.ctx.traffic
        reads = misplaced = off_lined = 0
        for lines, (names, lens, starts, rcs, _, off) in zip(self.lines,
                                                             self.truth):
            bad, stray = reference.judge(lines, names, lens, starts, rcs,
                                         off, cfg["reference_name"],
                                         cfg["genome_bases"])
            misplaced += bad
            off_lined += stray
            reads += len(names)
        m = cfg["map"]
        seeds = plain.Seeds(self.genome, m["k"], m["seed_rate"],
                            m["chunk_size"], m["query_size"], m["circular"])
        per = len(self.truth[0][0])
        on = [i for i in range(reads)
              if not self.truth[i // per][5][i % per]]
        pick = generate.rng_for(self.ctx.seed, "ids").choice(
            on, min(tr["ids_sample"], len(on)), replace=False)
        sample = [(self.truth[i // per], self.lines[i // per], i % per)
                  for i in sorted(pick.tolist())]
        clean, differ = reference.ids_differing(
            seeds, [t[4][j] for t, _, j in sample],
            [ln[j] for _, ln, j in sample],
            [t[2][j] for t, _, j in sample], [t[3][j] for t, _, j in sample])
        print(f"check: {misplaced} of {reads} reads not placed ({off_lined} "
              f"off-target reads with a line); of {len(pick)} on-target "
              f"reads sampled, {clean} clean ones compared, {differ} seed "
              f"counts differ", file=sys.stderr)
        passes = sum(len(d) - 1 for d in self.digests)
        return [("map_reads_misplaced_pct", 100.0 * misplaced / reads),
                ("map_ids_differing_pct", 100.0 * differ / max(clean, 1)),
                ("map_passes_differing", passes)]
