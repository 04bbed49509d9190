"""The port's copies of ``overlap/graph.py`` and ``seeds/cluster.py``,
which no command reaches (both are dead code in the reference), held
against the JAX package's on the cases of ``tests/test_pileup_graph.py``
(``OverlapGraph`` arcs, GFA, bridgeable contigs) and
``tests/test_seeds.py`` (``match_from``, ``match_to``, ``merge``,
``consensus``): the same inputs go through both packages and every
field of the results must be equal (tolerance 0: all are integers,
flags and strings).
"""
import importlib

import numpy as np
import pytest

PACKAGES = ("downpore_tpu", "downpore_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def seed_sequence(pkg, gaps, seeds, **kw):
    return mod(pkg, "seeds.seed_sequence").SeedSequence(
        np.array(gaps, np.int32), np.array(seeds, np.int32), **kw)


def seq_fields(s):
    return (s.gaps.tolist(), s.seeds.tolist(), s.id, s.length, s.offset)


def match_fields(m):
    return (m.match_a, m.match_b, m.mismatch_count, seq_fields(m.seq_a),
            seq_fields(m.seq_b), m.query_id, m.rc_query)


# -- overlap graph (tests/test_pileup_graph.py:71,91) -------------------------
def make_contig(pkg, parts, offsets, lengths, seq_lengths, combined_len=500):
    combined = mod(pkg, "seeds.seed_sequence").SeedSequence.from_segments(
        [0, 1, combined_len - 20, 2, 0], k=10)
    combined.length = combined_len
    return mod(pkg, "overlap.combine").SeedContig(
        combined, list(parts), [False] * len(parts), list(offsets),
        list(lengths), [False] * len(parts), list(seq_lengths), None)


def graph_fields(g):
    nodes = [(n.id, n.colour,
              [(a.to.id, a.length, a.from_rc, a.to_rc) for a in n.out_arcs],
              [(a.from_node.id, a.length) for a in n.in_arcs],
              [(s.sequence.id, s.offset, s.length, s.rc, s.approximate)
               for s in n.sequences]) for n in g.nodes]
    seqs = [None if s is None else
            (s.id, s.colour, s.length, s.is_rc, s.is_not_rc, s.covered,
             s.covered_front, s.covered_back,
             [(a.node.id, a.offset) for a in s.nodes])
            for s in g.sequences]
    return nodes, seqs, g.gfa()


def contig_fields(c):
    combined = None if c.combined is None else seq_fields(c.combined)
    return (combined, c.parts, c.reverse_complement, c.offsets, c.lengths,
            c.approximate, c.seq_lengths)


def graph_arcs(pkg):
    g = mod(pkg, "overlap.graph").OverlapGraph(10)
    cons = mod(pkg, "core").Sequence.from_string("ACGT" * 100)
    g.add_node(make_contig(pkg, [1, 3], [0, 100], [400, 400],
                           [3000, 3000]), cons)
    g.add_node(make_contig(pkg, [3, 4], [900, 0], [400, 400],
                           [3000, 3000]), cons)
    g.generate_arcs()
    return graph_fields(g)


def graph_bridges(pkg):
    g = mod(pkg, "overlap.graph").OverlapGraph(10)
    cons = mod(pkg, "core").Sequence.from_string("ACGT" * 100)
    shared = [1, 2, 5]
    g.add_node(make_contig(pkg, shared, [0, 10, 20], [400, 400, 400],
                           [5000, 5000, 5000]), cons)
    g.add_node(make_contig(pkg, shared, [2000, 2010, 2020],
                           [400, 400, 400], [5000, 5000, 5000]), cons)
    bridges = g.get_bridgable_contigs(min_coverage=2)
    return [contig_fields(b) for b in bridges], graph_fields(g)


@pytest.mark.parametrize("case", [graph_arcs, graph_bridges],
                         ids=["arcs_and_gfa", "bridgeable_contigs"])
def test_overlap_graph_matches_jax(case):
    ref, got = (case(pkg) for pkg in PACKAGES)
    assert got == ref
    nodes = got[0] if case is graph_arcs else got[1][0]
    assert len(nodes) == 2
    if case is graph_arcs:
        assert nodes[0][2] == [(1, 400, False, False)]
        assert got[2].count("\nL\t") == 1
    else:
        assert len(got[0]) == 1 and sorted(got[0][0][1]) == [1, 2, 5]


# -- seed clusters (tests/test_seeds.py:180,195,208,225) ----------------------
def match_from_to(pkg):
    cluster = mod(pkg, "seeds.cluster")
    gaps, seeds = [3, 10, 7, 12, 9, 4], [5, 9, 2, 14, 7]
    a = seed_sequence(pkg, gaps, seeds, id=0, length=100)
    b = seed_sequence(pkg, gaps, seeds, id=1, length=100)
    return (match_fields(cluster.match_from(a, b, 0, 0, 0, 6)),
            match_fields(cluster.match_to(a, b, 4, 4, 0, 6)))


def match_from_inserted(pkg):
    cluster = mod(pkg, "seeds.cluster")
    a = seed_sequence(pkg, [0, 20, 20, 20, 0], [5, 9, 2, 14], id=0,
                      length=110)
    b = seed_sequence(pkg, [0, 20, 8, 6, 20, 0], [5, 9, 77, 2, 14], id=1,
                      length=116)
    return match_fields(cluster.match_from(a, b, 0, 0, 0, 6))


def merged(pkg):
    cluster = mod(pkg, "seeds.cluster")
    a = seed_sequence(pkg, [0, 10, 30, 0], [5, 9, 14], id=0, length=80)
    b = seed_sequence(pkg, [0, 20, 12, 8, 0], [5, 9, 42, 14], id=1,
                      length=90)
    m = cluster.match_from(a, b, 0, 0, 0, 6)
    out, new_idx = cluster.merge(m, 6, 0.5)
    return match_fields(m), seq_fields(out), list(new_idx)


def noisy_copies(pkg, k=8, n=40):
    """test_seeds.py's eight noisy copies of one seed sequence, drawn
    from the same generator in the same order."""
    rng = np.random.default_rng(17)
    truth_seeds = rng.choice(5000, n, replace=False).astype(np.int32)
    truth_gaps = rng.integers(5, 40, n + 1).astype(np.int32)
    SeedSequence = mod(pkg, "seeds.seed_sequence").SeedSequence
    seqs = []
    for sid in range(8):
        keep = rng.random(n) > 0.12          # dropped seeds
        seeds = []
        for i in range(n):                   # the test's first pass draws
            int(rng.integers(-2, 3))
            if keep[i]:
                if seeds:
                    int(rng.integers(-2, 3))
                seeds.append(int(truth_seeds[i]))
        gaps = [0]
        acc = int(truth_gaps[0])
        for i in range(n):
            if keep[i]:
                gaps.append(acc + int(rng.integers(0, 3)))
                acc = 0
            else:
                acc += int(truth_gaps[i + 1]) + k
                continue
            acc = int(truth_gaps[i + 1])
        gaps = [gaps[1]] + gaps[2:] + [0]
        s = SeedSequence(np.array(gaps, np.int32),
                         np.array(seeds, np.int32), id=sid, length=0)
        s.length = s.seed_offset(s.num_seeds - 1, k) + k
        seqs.append(s)
    return seqs


def cluster_consensus(pkg):
    seqs = noisy_copies(pkg)
    result = mod(pkg, "seeds.cluster").consensus(
        seqs, list(range(8)), [0] * 8, [0] * 8, 8)
    return [match_fields(m) for m in result]


@pytest.mark.parametrize("case", [match_from_to, match_from_inserted,
                                  merged, cluster_consensus],
                         ids=["match_from_to", "match_from_inserted",
                              "merge", "consensus"])
def test_seed_cluster_matches_jax(case):
    ref, got = (case(pkg) for pkg in PACKAGES)
    assert got == ref
    if case is cluster_consensus:
        assert len(got) >= 5
    elif case is match_from_to:
        assert got[0][0] == [0, 1, 2, 3, 4]
