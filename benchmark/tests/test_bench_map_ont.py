"""The nanopore-shaped map cell on the CPU at test sizes: its generator
(every copied base is the genome's at its truth position, on its segment's
strand; a chimera's segments tile the read; lengths at least the minimum;
the same seed gives the same reads), its plain reference (the truth line
passes; a line moved past ``tol``, on the wrong strand, across a segment
border, or on a random read fails; a segment is covered only by a line
that reaches within ``reach`` of both its ends), the port judged by the
reference (``correct`` true) and ``correct`` false under the control and
under each fault, those planted in the later stages included."""
import contextlib
import json

import numpy as np
import pytest

from benchmark import faults, generate, mixed, ont, run
from benchmark.reference import map_ont as reference
from benchmark.trace import patched

MAN = run.manifest()
CELL = "ont_repeats_64m_k13.map_ont"
SEED = 2**31 + 43
ES = 1000    # the configuration's query size: one window
COMP = np.zeros(256, np.uint8)
COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def small(genome_bases=1_000_000, batch_reads=64, length_mean=5000,
          length_sd=4000, chimera_share=0.03):
    """The cell at test size: a genome carrying the repeats, reads of a
    shorter spread (mean 5 kb) with enough chimeras, random and junk reads
    that a small batch draws two of each."""
    _, _, cfg, trf = run.cell_parts(MAN, CELL)
    cfg, trf = json.loads(json.dumps(cfg)), json.loads(json.dumps(trf))
    cfg["genome_bases"] = genome_bases
    cfg["reads"].update(length_mean=length_mean, length_sd=length_sd,
                        chimera_share=chimera_share, random_share=0.03,
                        junk_share=0.03)
    trf.update(batch_reads=batch_reads, batches=2)
    return cfg, trf


def long_reads():
    """The cell at test size with the profile's own lengths (mean 15 kb)
    and one read in seven a chimera: most chimeras then have two pieces of
    three windows or more, which only the split search covers."""
    _, _, full, _ = run.cell_parts(MAN, CELL)
    return small(length_mean=full["reads"]["length_mean"],
                 length_sd=full["reads"]["length_sd"], chimera_share=0.15)


@contextlib.contextmanager
def split_search_skipped():
    """A fault in the split search: its loop never runs, and each open
    read's ends are finished as they came from mapNext (the stage's own
    last step: an end that reaches the read's far edge dropped)."""
    from downpore_tpu_torch.mapping import Mapper

    def split_stage(self, reads, states, results):
        es = self.edge_size
        for i, (open_a, open_b) in states.items():
            size = len(reads[i]) - es
            results[i] = ([a for a in open_a if a.query_inset < size]
                          + [b for b in open_b if b.query_offset < size])
    with patched([(Mapper, "_split_stage", split_stage)]):
        yield


@contextlib.contextmanager
def map_next_skipped():
    """A fault in mapNext: neither of its rounds runs, so no open read's
    ends are extended or paired there and each goes on to the split
    search as the ends phase left it."""
    from downpore_tpu_torch.mapping import Mapper

    def map_next_stage(self, reads, states, results):
        return None
    with patched([(Mapper, "_map_next_stage", map_next_stage)]):
        yield


# the later stages' faults and the number each must break
LATER = {"split_search_skipped": (split_search_skipped,
                                  "map_pieces_uncovered_pct"),
         "map_next_skipped": (map_next_skipped, "map_reads_uncovered_pct")}


@pytest.fixture(scope="module")
def drawn():
    """A 300 kb planted genome and 300 reads of the cell's own profile."""
    cfg, _ = small(300_000)
    g = mixed.genome(SEED, cfg)
    _, _, full, _ = run.cell_parts(MAN, CELL)
    reads = ont.sample(generate.rng_for(SEED, "reads0"), g, 300,
                       full["reads"])
    return g, reads, full["reads"]


def test_generator_keeps_the_truth_path(drawn):
    g, reads, prof = drawn
    assert (reads.length >= prof["min_length"]).all()
    kinds = np.bincount(reads.kind, minlength=4)
    assert kinds[ont.CHIMERA] == kinds[ont.RANDOM] == kinds[ont.JUNK] == 3
    errors = copied = 0
    for s, gp, segs, kind in zip(reads.seqs, reads.gpos, reads.segments,
                                 reads.kind):
        assert len(gp) == len(s)
        if kind in (ont.RANDOM, ont.JUNK):
            assert not segs and (gp == -1).all()
            continue
        assert len(segs) == (2 if kind == ont.CHIMERA else 1)
        # the segments tile the read
        assert segs[0].read_lo == 0 and segs[-1].read_hi == len(s)
        assert all(a.read_hi == b.read_lo for a, b in zip(segs, segs[1:]))
        for seg in segs:
            part = slice(seg.read_lo, seg.read_hi)
            pos, bases = gp[part], s[part]
            on = pos >= 0
            assert seg.g_lo <= pos[on].min() and pos[on].max() < seg.g_hi
            step = np.diff(pos[on])
            assert ((step < 0) if seg.rc else (step > 0)).all()
            want = COMP[g[pos[on]]] if seg.rc else g[pos[on]]
            # a copied base is the genome's, but where it was substituted
            errors += int((bases[on] != want).sum()) + int((~on).sum())
            copied += int(on.sum())
            if kind == ont.CHIMERA:
                assert seg.g_hi - seg.g_lo >= prof["chimera_min_piece"]
    # about a third of 5% of bases substituted, a third inserted
    assert 0.02 < errors / copied < 0.05


def test_same_seed_same_reads(drawn):
    g, reads, prof = drawn
    again = ont.sample(generate.rng_for(SEED, "reads0"), g, 300, prof)
    assert all((a == b).all() for a, b in zip(reads.seqs, again.seqs))
    assert all((a == b).all() for a, b in zip(reads.gpos, again.gpos))
    other = ont.sample(generate.rng_for(SEED + 1, "reads0"), g, 300, prof)
    assert (reads.length != other.length).any()


def test_the_length_spread_is_the_profiles():
    """At the profile's gamma, ~6% of reads are 0.5-2 kb and the mean is
    ~15 kb; errors keep every read at the minimum or above."""
    _, _, full, _ = run.cell_parts(MAN, CELL)
    g = generate.genome(SEED, 2_000_000)
    reads = ont.sample(generate.rng_for(SEED, "reads1"), g, 2048,
                       full["reads"])
    L = reads.length
    assert L.min() >= 500 and 13_500 < L.mean() < 17_000
    assert 0.04 < (L <= 2000).mean() < 0.09


def _truth_line(read, gp, seg, genome, name, k):
    """The line a mapper gives a read segment from its first to its last
    k-mer copied with no error."""
    step = -1 if seg.rc else 1
    copy = COMP[genome[gp]] if seg.rc else genome[gp]
    ok = [x for x in range(seg.read_lo, seg.read_hi - k + 1)
          if gp[x] >= 0 and (np.diff(gp[x:x + k]) == step).all()
          and (read[x:x + k] == copy[x:x + k]).all()]
    qs, qe = ok[0], ok[-1] + k
    ends = sorted((int(gp[qs]), int(gp[qe - 1])))
    ts, te = ends[0], ends[1] + 1
    return (f"{name}\t{len(read)}\t{qs}\t{qe}\t{'-' if seg.rc else '+'}\tg"
            f"\t{len(genome)}\t{ts}\t{te}\t{k}\t{te - ts}\t255")


def _fields(line):
    f = line.split("\t")
    return int(f[2]), int(f[3]), f[4] == "-", int(f[7]), int(f[8])


def test_reference_judges_each_rule(drawn):
    g, reads, _ = drawn
    k = 13
    tol = reference.tolerance(k)
    assert tol <= k
    chim = [i for i in range(len(reads.seqs)) if reads.kind[i] == ont.CHIMERA]
    whole = [i for i in range(len(reads.seqs))
             if reads.kind[i] == ont.GENOME][:20]
    for i in whole + chim:
        s, gp, segs = reads.seqs[i], reads.gpos[i], reads.segments[i]
        for seg in segs:
            line = _truth_line(s, gp, seg, g, "r", k)
            assert reference.line_ok(line, "r", s, gp, segs, g, "g", k)
            qs, qe, rc, ts, te = _fields(line)
            for d in (-tol, tol):
                assert reference.placed(qs, qe, rc, ts + d, te + d, gp,
                                        segs, tol)
            for d in (-tol - 1, tol + 1):
                assert not reference.placed(qs, qe, rc, ts + d, te + d, gp,
                                            segs, tol)
                assert not reference.placed(qs, qe, rc, ts, te + d, gp,
                                            segs, tol)
            # a line one base along is no exact copy at its ends
            moved = line.replace(f"\t{ts}\t{te}\t", f"\t{ts + 1}\t{te + 1}\t")
            assert not reference.line_ok(moved, "r", s, gp, segs, g, "g", k)
            flipped = line.replace("\t+\t" if not rc else "\t-\t",
                                   "\t-\t" if not rc else "\t+\t")
            assert not reference.line_ok(flipped, "r", s, gp, segs, g, "g",
                                         k)
        if len(segs) == 2:
            # across the border: the first segment's start to the second's
            # end, on the first's path
            a, b = segs
            qs, _, rc, ts, te = _fields(_truth_line(s, gp, a, g, "r", k))
            qe = b.read_hi
            assert not reference.placed(qs, qe, rc, ts, te + qe - a.read_hi,
                                        gp, segs, tol)
    # a random read with a line, a genome read with its truth line, and a
    # genome read with none
    x = whole[0]
    rand = next(i for i in range(len(reads.seqs))
                if reads.kind[i] == ont.RANDOM)
    line = _truth_line(reads.seqs[x], reads.gpos[x], reads.segments[x][0], g,
                       "x", k)
    pick = [x, rand, x]
    got = reference.judge(
        [[line], [line.replace("x\t", "y\t", 1)], []], ["x", "y", "x"],
        [reads.seqs[i] for i in pick], [reads.gpos[i] for i in pick],
        [reads.segments[i] for i in pick], [True, False, True], g, "g", k,
        ES)
    assert got[:3] == (1, 1, 2)
    # the read with its truth line is covered, the one with none is not
    assert got.uncovered == 1


def test_reference_judges_cover(drawn):
    g, reads, _ = drawn
    k = 13
    far = reference.reach(ES)
    assert far == 2 * ES
    seg = ont.Segment(100, 9100, 0, 9000, False)
    for qs, qe, ok in ((100 + far, 9100 - far, True),
                       (100 + far + 1, 9100, False),
                       (100, 9100 - far - 1, False)):
        assert reference.covers([None, (0, qs, qe)], 0, seg, far) == ok
        # a line on another segment covers nothing here
        assert not reference.covers([(1, qs, qe)], 0, seg, far)
    counted = 0
    for i in np.flatnonzero(reads.kind == ont.CHIMERA).tolist():
        s, gp, segs = reads.seqs[i], reads.gpos[i], reads.segments[i]
        lines = [_truth_line(s, gp, seg, g, "c", k) for seg in segs]
        longs = [reference.long_piece(seg, ES) for seg in segs]
        both = reference.judge([lines], ["c"], [s], [gp], [segs], [False],
                               g, "g", k, ES)
        assert both.wrong == 0 and both.whole == 0
        assert (both.pieces, both.pieces_uncovered) == (sum(longs), 0)
        # the first piece's line left out: that piece, if counted, is not
        # covered
        one = reference.judge([lines[1:]], ["c"], [s], [gp], [segs],
                              [False], g, "g", k, ES)
        assert one.pieces_uncovered == int(longs[0])
        counted += sum(longs)
    assert counted > 0


def _run(cfg, trf, trace=False):
    return run.run_cell(CELL, SEED, 0.05, trace, "cpu", config=cfg,
                        traffic=trf, man=MAN)


def test_port_matches_reference():
    res = _run(*small(), trace=True)
    assert res["correct"], res["checks"]
    line = run.result_line(res, "cpu", 1)
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"map_lines_wrong_pct",
                                   "map_reads_unplaced_pct",
                                   "map_reads_uncovered_pct",
                                   "map_pieces_uncovered_pct",
                                   "map_ids_differing_pct",
                                   "map_passes_differing"}
    got = {n: v["value"] for n, v in res["metrics"].items()}
    assert got["split_rounds.map"] > 0 and got["later_windows.map"] > 0
    _, layer = run.metrics_of(MAN, CELL)
    host = {m["name"] for m in layer if m["source"] != "device_trace"}
    assert host <= set(got)


def test_port_covers_long_reads():
    """On the reads the later stages' faults are planted under, the sound
    port reads each number those faults must break under its limit."""
    res = _run(*long_reads())
    for _, number in LATER.values():
        check = res["checks"][number]
        assert check["value"] <= check["limit"], res["checks"]


@pytest.mark.parametrize("plant", sorted(faults.PLANTS) + sorted(LATER))
def test_control_and_faults_are_not_correct(plant):
    if plant in LATER:
        fault, number = LATER[plant]
        with fault():
            res = _run(*long_reads())
        check = res["checks"][number]
        assert check["value"] > check["limit"], (plant, res["checks"])
    else:
        with faults.plant(plant):
            res = _run(*small())
    assert not res["correct"], (plant, res["checks"])
