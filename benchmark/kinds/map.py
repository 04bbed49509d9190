"""Map traffic: closed-loop batches of reads through ``Mapper.map_batch``,
every mapping formatted by ``Mapper.as_string`` as the map command does.

One unit is one batch of ``batch_reads`` reads (the map command's batch);
``batches`` distinct batches are made from the seed and cycled.  The
output goes to an in-memory sink that keeps each batch's newest PAF lines
per read and the digest of every pass.  After the window every read's
newest lines are judged by the plain reference against the read's origin,
and a sample of them against the seed coverage the reference works out.
"""
from __future__ import annotations

import gc
import hashlib
import sys

from .. import generate
from ..reference import map as reference


# host spans that name the idle gaps of a traced run (no metric reads them)
LABELS = [
    ("downpore_tpu_torch.mapping.mapper:Mapper.perform_mapping_batch",
     "map.stage"),
    ("downpore_tpu_torch.mapping.mapper:Mapper._map_next_stage",
     "map.next_stage"),
    ("downpore_tpu_torch.mapping.mapper:Mapper._split_stage",
     "map.split_stage"),
    ("downpore_tpu_torch.ops.map_engine:MapEngine.collect_arrays_many",
     "map.collect"),
    ("benchmark.kinds.map:Workload.format", "map.as_string"),
]


class Workload:
    metric = "map_bases_per_s"

    def __init__(self, ctx):
        self.ctx = ctx
        self.next = 0

    def setup(self):
        from downpore_tpu_torch.core.sequence import Sequence
        from downpore_tpu_torch.mapping import Mapper
        from downpore_tpu_torch.utils import (kmer_occurrences,
                                              score_seed_values)
        cfg, tr, seed = self.ctx.config, self.ctx.traffic, self.ctx.seed
        m = cfg["map"]
        g = self.genome = generate.genome(seed, cfg["genome_bases"])
        ref = Sequence.from_string(g.tobytes().decode(), id=0,
                                   name=cfg["reference_name"])
        values = score_seed_values(kmer_occurrences([ref], m["k"]), m["k"])
        self.mapper = Mapper(ref, m["circular"], m["k"], values,
                             m["seed_rate"], m["query_size"],
                             m["chunk_size"], device=self.ctx.device)
        lo, hi = tr["read_length"]
        self.truth, self.batches, self.bases = [], [], []
        for b in range(tr["batches"]):
            rng = generate.rng_for(seed, f"reads{b}")
            reads = generate.sample_reads(rng, g, tr["batch_reads"], lo, hi,
                                          tr["substitution_rate"])
            names = [f"b{b}r{i}" for i in range(len(reads.seqs))]
            self.truth.append((names, reads.length, reads.start, reads.rc,
                               reads.seqs))
            self.batches.append([
                Sequence.from_string(a.tobytes().decode(), id=i, name=n)
                for i, (n, a) in enumerate(zip(names, reads.seqs))])
            self.bases.append(int(reads.length.sum()))
        self.lines = [None] * len(self.batches)
        self.digests = [set() for _ in self.batches]

    def warm(self):
        for _ in range(self.ctx.traffic["warm_passes"]):
            for _ in self.batches:
                self.unit()

    def unit_key(self) -> int:
        """The batch the next unit maps."""
        return self.next % len(self.batches)

    def seek(self, key: int) -> None:
        """Make batch ``key`` the next unit's."""
        self.next = key

    def unit(self) -> int:
        b = self.unit_key()
        self.next += 1
        per_read = self.format(self.mapper.map_batch(self.batches[b]))
        text = "\n".join(ln for r in per_read for ln in r)
        if text:
            text += "\n"
        self.lines[b] = per_read
        self.digests[b].add(hashlib.sha256(text.encode()).hexdigest())
        return self.bases[b]

    def format(self, results) -> list:
        """PAF lines per read, as the map command formats them."""
        as_string = self.mapper.as_string
        return [[as_string(m) for m in maps] for maps in results]

    def counters(self) -> dict:
        eng = self.mapper.engine
        return {"reruns": sum(eng.reruns.values())}

    def release(self):
        self.mapper = None
        self.batches = None
        gc.collect()

    def check(self) -> list:
        """Every read of every batch judged against its origin by the
        plain reference, on the newest pass of its batch: the share of the
        reads not placed, in percent; the share of the clean reads among
        ``ids_sample`` drawn from the seed whose line's seed count is not
        the reference's, in percent; and the passes of a batch that gave
        other bytes than its first."""
        cfg, tr = self.ctx.config, self.ctx.traffic
        reads = misplaced = 0
        for lines, (names, lens, starts, rcs, _) in zip(self.lines,
                                                        self.truth):
            misplaced += reference.judge(lines, names, lens, starts, rcs,
                                         cfg["reference_name"],
                                         cfg["genome_bases"])
            reads += len(names)
        m = cfg["map"]
        seeds = reference.Seeds(self.genome, m["k"], m["seed_rate"],
                                m["chunk_size"], m["query_size"],
                                m["circular"])
        per = len(self.truth[0][0])
        pick = generate.rng_for(self.ctx.seed, "ids").choice(
            reads, min(tr["ids_sample"], reads), replace=False)
        sample = [(self.truth[i // per], self.lines[i // per], i % per)
                  for i in sorted(pick.tolist())]
        clean, differ = reference.ids_differing(
            seeds, [t[4][j] for t, _, j in sample],
            [ln[j] for _, ln, j in sample],
            [t[2][j] for t, _, j in sample], [t[3][j] for t, _, j in sample])
        print(f"check: {misplaced} of {reads} reads not placed, {differ} "
              f"of {clean} clean reads' seed counts differ", file=sys.stderr)
        passes = sum(len(d) - 1 for d in self.digests)
        return [("map_reads_misplaced_pct", 100.0 * misplaced / reads),
                ("map_ids_differing_pct", 100.0 * differ / max(clean, 1)),
                ("map_passes_differing", passes)]
