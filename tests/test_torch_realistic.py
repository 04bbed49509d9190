"""The realistic fixtures of test_realistic.py through both packages, on
the CPU, at shapes no larger than theirs: ONT-like reads (~10% error, homopolymer-biased
deletions) from genomes with planted tandem repeats and low-complexity
tracts (``downpore_tpu.sim``).  The port's outputs must equal the JAX
package's (tolerance 0), unsharded and, for map and overlap, on a
(data 2, seed 2) grid of CPU entries; the planted-truth scores of the
JAX tests must hold for the port's output too."""
import numpy as np
import torch

from downpore_tpu.core import Sequence as JaxSequence
from downpore_tpu.sim import (ont_read, sample_reads, score_mappings,
                              structured_genome, random_genome)
from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")


def grid22():
    return make_mesh(2, 2, [CPU] * 4)


def map_both(genome: str, reads, k: int = 11):
    """Map ``reads`` (strings) with the JAX mapper, the port's mapper and
    the port's mapper on a 2 x 2 grid; returns the three lists of
    per-read (start, end, query_offset, query_inset, rc, ids)."""
    from downpore_tpu.mapping import Mapper as JaxMapper
    from downpore_tpu_torch.mapping import Mapper
    values = score_seed_values(kmer_occurrences(
        [JaxSequence.from_string(genome, id=0, name="g")], k), k)
    out = []
    for cls, seq, kw in ((JaxMapper, JaxSequence, {}),
                         (Mapper, Sequence, {"device": CPU}),
                         (Mapper, Sequence, {"mesh": grid22()})):
        mapper = cls(seq.from_string(genome, id=0, name="g"), False, k,
                     values, 40, 1000, 10000, **kw)
        res = mapper.map_batch([seq.from_string(r, id=i, name=f"r{i}")
                                for i, r in enumerate(reads)])
        out.append([[(m.start, m.end, m.query_offset, m.query_inset, m.rc,
                      m.ids) for m in ms] for ms in res])
    return out


def test_map_recall_precision_on_ont_reads():
    """test_realistic.py:50 at 60 kb and 24 reads."""
    rng = np.random.default_rng(11)
    G = 60_000
    genome = structured_genome(rng, G, n_repeats=2, n_tracts=3)
    reads, truth = sample_reads(rng, genome, 24, 3000, 7000)
    ref, got, sharded = map_both(genome, reads)
    assert got == ref == sharded
    recall, precision = score_mappings(
        truth, [[(m[0], m[1]) for m in ms] for ms in got], G)
    assert recall >= 0.90 and precision >= 0.95, (recall, precision)


def test_overlap_precision_recall_on_ont_reads():
    """test_realistic.py:75 at its own size (60 kb, 64 reads): the same
    overlaps from both packages and from the 2 x 2 grid."""
    from downpore_tpu.overlap import Overlapper as JaxOverlapper
    from downpore_tpu.seeds import SeedIndex as JaxSeedIndex
    from downpore_tpu_torch.overlap import QUERY_EDGES, Overlapper
    from downpore_tpu_torch.seeds import SeedIndex

    rng = np.random.default_rng(13)
    G = 60_000
    genome = structured_genome(rng, G, n_repeats=2, n_tracts=3)
    reads, truth = sample_reads(rng, genome, 64, 2500, 5000,
                                sub_rate=0.025, ins_rate=0.015,
                                del_rate=0.015)
    k = 10
    values = score_seed_values(kmer_occurrences(
        [JaxSequence.from_string(r, id=i) for i, r in enumerate(reads)], k),
        k)
    outs = []
    for cls, index, seq, kw in (
            (JaxOverlapper, JaxSeedIndex, JaxSequence, {}),
            (Overlapper, SeedIndex, Sequence, {"device": CPU}),
            (Overlapper, SeedIndex, Sequence, {"mesh": grid22()})):
        seqs = [seq.from_string(r, id=i, name=f"o{i}")
                for i, r in enumerate(reads)]
        ov = cls(index(k), 10000, 1000, 15, 0.25, **kw)
        queries = ov.prepare_queries(15, 10000, values, iter(seqs),
                                     QUERY_EDGES)
        ov.add_sequences(iter(seqs))
        q2s = {q.id: q.sequence_id for q in queries}
        outs.append([(q2s[m.query_id], m.seq_b.id, m.rc_query,
                      tuple(m.match_a), tuple(m.match_b))
                     for m in ov.find_overlaps(queries)])
    ref, got, sharded = outs
    assert got == ref == sharded

    def iv(a, b):
        return min(a[1], b[1]) - max(a[0], b[0])

    pairs = {(a, b) for a, b, *_ in got if a != b}
    tp = sum(1 for (a, b) in pairs if iv(truth[a][:2], truth[b][:2]) >= 300)
    assert tp / max(1, len(pairs)) >= 0.95
    want = {(i, j) for i in range(len(truth)) for j in range(len(truth))
            if i != j and iv(truth[i][:2], truth[j][:2]) >= 1500}
    found = sum(1 for (i, j) in want if (i, j) in pairs or (j, i) in pairs)
    assert found / max(1, len(want)) >= 0.90


def test_consensus_fixes_homopolymer_errors():
    """test_realistic.py:117 at a 500-base template: the port's beam scan
    gives the JAX package's consensus k-mers, which beat every member."""
    from downpore_tpu.align import SimpleMeasure
    from downpore_tpu.consensus.consensus import _kmers_to_codes
    from downpore_tpu.ops.dtw import consensus_kmers as jax_consensus
    from downpore_tpu_torch.ops.dtw import consensus_kmers

    rng = np.random.default_rng(17)
    t = list(structured_genome(rng, 500, n_repeats=0, n_tracts=0))
    for at in (100, 250, 400):
        t[at:at + 6] = ["G" if at != 250 else "A"] * 6
    tmpl = "".join(t)
    members = [ont_read(rng, tmpl) for _ in range(8)]
    k = 5
    streams = [JaxSequence.from_string(m, id=i).short_kmers(k, False)
               for i, m in enumerate(members)]
    table = SimpleMeasure(k).pair_table()
    ref = jax_consensus(streams, table, k, simple_k=k)
    got = consensus_kmers(streams, table, k, simple_k=k, device=CPU)
    np.testing.assert_array_equal(got, ref)
    cons = "".join("ACGT"[c] for c in _kmers_to_codes(got, k))

    def kmer_acc(s, truth, kk=12):
        tk = {truth[i:i + kk] for i in range(len(truth) - kk + 1)}
        sk = [s[i:i + kk] for i in range(len(s) - kk + 1)]
        return sum(1 for x in sk if x in tk) / max(1, len(sk))

    assert kmer_acc(cons, tmpl) > max(kmer_acc(m, tmpl) for m in members)


def test_map_chunk_boundary_class():
    """test_realistic.py:153 on a 100 kb genome: reads whose head spans an
    unoverlapped chunk boundary map to the true locus in both packages
    and on the grid, with the same fields."""
    rng = np.random.default_rng(33)
    G = 100_000
    genome = random_genome(rng, G)
    reads, truths = [], []
    for boundary in (30_000, 50_000, 70_000, 90_000):
        start = boundary - 480
        reads.append(ont_read(rng, genome[start:start + 6000]))
        truths.append((start, start + 6000))
    ref, got, sharded = map_both(genome, reads)
    assert got == ref == sharded
    for (s, e), ms in zip(truths, got):
        assert ms, "boundary read did not map at all"
        best = max(ms, key=lambda m: m[1] - m[0])
        assert abs(best[1] - e) < 1200 and best[0] < s + 1200
        assert best[0] - s < 1100
