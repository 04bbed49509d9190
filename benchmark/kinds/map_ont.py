"""Nanopore-shaped map traffic: the map workload's closed-loop batches, on
the configuration's genome (``mixed.genome``: repeat families planted
where it has them), of reads drawn with the configuration's read profile
(``benchmark/ont.py``, the seed stream ``reads<b>`` for batch ``b``).

The window, the output and its digests are the map workload's.  After the
window the plain reference of this kind judges every read by the truth
path the generator kept, and a sample of the non-chimeric genome reads by
their seed count.
"""
from __future__ import annotations

import sys

import numpy as np

from .. import generate, mixed, ont
from ..reference import map as plain
from ..reference import map_ont as reference
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
        self.truth, self.batches, self.bases = [], [], []
        for b in range(tr["batches"]):
            reads = ont.sample(generate.rng_for(seed, f"reads{b}"), g,
                               tr["batch_reads"], cfg["reads"])
            names = [f"b{b}r{i}" for i in range(len(reads.seqs))]
            self.truth.append((names, reads))
            self.batches.append([
                Sequence.from_string(a.tobytes().decode(), id=i, name=n)
                for i, (n, a) in enumerate(zip(names, reads.seqs))])
            self.bases.append(int(reads.length.sum()))
        self.lines = [None] * len(self.batches)
        self.digests = [set() for _ in self.batches]

    def check(self) -> list:
        """The reference's numbers on the newest pass of every batch: the
        share of the reads with a line that breaks a rule, in percent; the
        share of the non-chimeric genome reads with no line, and with no
        one line that covers the read to within a window of both its ends,
        in percent; the share of the chimeras' segments that no one line
        so covers, in percent; the share of the clean reads, among
        ``ids_sample`` non-chimeric genome reads drawn from the seed, whose
        line's seed count is not the reference's, in percent; and the
        passes of a batch that gave other bytes than its first."""
        cfg, tr = self.ctx.config, self.ctx.traffic
        m = cfg["map"]
        reads = wrong = unplaced = whole = uncovered = 0
        pieces = pieces_uncovered = 0
        pool = []
        for lines, (names, r) in zip(self.lines, self.truth):
            one = r.kind == ont.GENOME
            got = reference.judge(
                lines, names, r.seqs, r.gpos, r.segments, one, self.genome,
                cfg["reference_name"], m["k"], m["query_size"])
            wrong += got.wrong
            unplaced += got.unplaced
            whole += got.whole
            uncovered += got.uncovered
            pieces += got.pieces
            pieces_uncovered += got.pieces_uncovered
            reads += len(names)
            pool += [(r, lines, i) for i in np.flatnonzero(one).tolist()]
        seeds = plain.Seeds(self.genome, m["k"], m["seed_rate"],
                            m["chunk_size"], m["query_size"], m["circular"])
        pick = generate.rng_for(self.ctx.seed, "ids").choice(
            len(pool), min(tr["ids_sample"], len(pool)), replace=False)
        sample = [pool[j] for j in sorted(pick.tolist())]
        clean, differ = reference.ids_differing(
            seeds, [r.seqs[i] for r, _, i in sample],
            [r.gpos[i] for r, _, i in sample],
            [r.segments[i][0].rc for r, _, i in sample],
            [ln[i] for _, ln, i in sample])
        print(f"check: {wrong} of {reads} reads with a wrong line, "
              f"{unplaced} of {whole} non-chimeric genome reads with none "
              f"and {uncovered} not covered, {pieces_uncovered} of "
              f"{pieces} chimera segments not covered; of {len(pick)} "
              f"sampled, {clean} clean ones compared, {differ} seed counts "
              f"differ", file=sys.stderr)
        passes = sum(len(d) - 1 for d in self.digests)
        return [("map_lines_wrong_pct", 100.0 * wrong / reads),
                ("map_reads_unplaced_pct", 100.0 * unplaced / max(whole, 1)),
                ("map_reads_uncovered_pct",
                 100.0 * uncovered / max(whole, 1)),
                ("map_pieces_uncovered_pct",
                 100.0 * pieces_uncovered / max(pieces, 1)),
                ("map_ids_differing_pct", 100.0 * differ / max(clean, 1)),
                ("map_passes_differing", passes)]
