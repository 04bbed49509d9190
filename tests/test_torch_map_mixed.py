"""The mixed map cells (``benchmark/kinds/map_mixed.py``) on the CPU at
small sizes: the planted repeat families, the port judged by the cells'
plain reference on both traffics, off-target reads, the program counter
``map.gate.pairs`` and ``map.collect.host_sorted``, the six readers of a
traced run, the card-ordered collect of binned blocks against the host
ordering it replaced, and
``Mapper.map_batch`` on a planted genome against the JAX package, which
decides whether a reading the reference does not expect is the
algorithm's or the port's.
"""
import json
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from benchmark import generate, mixed, run
from benchmark.kinds import map_mixed as driver
from benchmark.reference import map as plain
from benchmark.reference import map_mixed as reference
from downpore_tpu.core import Sequence as JaxSequence
from downpore_tpu.mapping import Mapper as JaxMapper
from downpore_tpu_torch.core.sequence import Sequence
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.ops import map_engine
from downpore_tpu_torch.ops.map_engine import MapEngine, WindowRows
from downpore_tpu_torch.utils import (kmer_occurrences, metrics,
                                      score_seed_values)

torch.set_num_threads(2)

MAN = run.manifest()
REPEATS = "repeats_64m_k13.map_repeats"
OFFTARGET = "random_4m6_k11.map_offtarget"
# the cells at test size: (configuration changes, traffic changes)
SMALL = {REPEATS: ({"genome_bases": 300_000},
                   {"batch_reads": 24, "batches": 2}),
         OFFTARGET: ({"genome_bases": 300_000},
                     {"batch_reads": 32, "batches": 2})}
SEED = 2**31 + 19
NEW = ("gate_pairs.map", "rerun_ms.map", "open_reads.map", "next_ms.map",
       "split_ms.map", "host_sorted.map")


def small(name):
    _, _, cfg, trf = run.cell_parts(MAN, name)
    cfg, trf = json.loads(json.dumps(cfg)), json.loads(json.dumps(trf))
    cfg.update(SMALL[name][0])
    trf.update(SMALL[name][1])
    return cfg, trf


def repeats_config(n):
    cfg = small(REPEATS)[0]
    cfg["genome_bases"] = n
    return cfg


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 123456789012])
def test_planted_families_keep_their_shares(seed):
    cfg = repeats_config(300_000)
    g = generate.genome(seed, cfg["genome_bases"])
    copies = mixed.plant(seed, g, cfg["repeats"])
    for name, spec in cfg["repeats"].items():
        share = copies.bases_of(name) / len(g)
        assert abs(share - spec["share"]) <= 0.01 * spec["share"], name
        mine = copies.family == copies.names.index(name)
        if "mean_copy" not in spec:
            assert (copies.length[mine] == spec["consensus"]).all()
    ends = copies.start + copies.length
    assert (copies.start[1:] >= ends[:-1]).all()
    assert copies.start[0] >= 0 and ends[-1] <= len(g)
    # the same seed plants the same genome; the copies changed it
    g2 = mixed.genome(seed, cfg)
    assert (g2 == g).all()
    assert (g != generate.genome(seed, cfg["genome_bases"])).any()


def test_l1_copies_are_three_prime_ends():
    """An L1-like copy with no substitution drawn is its consensus's 3'
    end, on its strand."""
    spec = {"consensus": 6100, "share": 0.5, "substitution": [0.0, 0.0],
            "mean_copy": 900, "whole_share": 0.04, "min_copy": 100}
    g = generate.genome(3, 200_000)
    copies = mixed.plant(3, g, {"l1_like": spec})
    longest = int(np.argmax(copies.length))
    ends = []
    for i in range(len(copies.start)):
        s = g[copies.start[i]:copies.start[i] + copies.length[i]]
        ends.append(generate.reverse_complement(s) if copies.rc[i] else s)
    assert len(ends[longest]) == 6100
    cons = ends[longest]
    for e in ends:
        assert (e == cons[len(cons) - len(e):]).all()


def test_offtarget_reads_are_a_fixed_share():
    g = generate.genome(4, 50_000)
    other = mixed.offtarget_genome(4, len(g))
    rng = generate.rng_for(4, "reads0")
    reads = mixed.sample_mixed(rng, g, other, 100, 600, 1000, 0.0, 0.9)
    assert int(reads.off.sum()) == 90
    for s, o, L, rc, x in zip(reads.seqs, reads.start, reads.length,
                              reads.rc, reads.off):
        src = (other if x else g)[o:o + L]
        assert (s == (generate.reverse_complement(src) if rc else src)).all()


@pytest.fixture(scope="module")
def offtarget_units():
    """The off-target cell's driver after one unit a batch, with the
    passing counts each block's collect ended on, and the counter's
    growth over the units."""
    cfg, trf = small(OFFTARGET)
    ctx = run.Context({"chips": 1}, cfg, trf, SEED, 0.0, False, "cpu")
    w = driver.Workload(ctx)
    w.setup()
    counts = []
    collect = MapEngine._collect_block

    def recorded(self, p):
        out = collect(self, p)
        counts.append(out[2])
        return out
    before = metrics.counters()["map.gate.pairs"]
    MapEngine._collect_block = recorded
    try:
        for _ in w.batches:
            w.unit()
    finally:
        MapEngine._collect_block = collect
    grown = metrics.counters()["map.gate.pairs"] - before
    return w, counts, grown


def test_offtarget_reads_get_no_line(offtarget_units):
    w = offtarget_units[0]
    n_off = n_on = 0
    for lines, truth in zip(w.lines, w.truth):
        off = truth[5]
        n_off += int(off.sum())
        for ln, x in zip(lines, off):
            if x:
                assert ln == []
            else:
                n_on += bool(ln)
    assert n_off == 2 * round(0.9 * 32) and n_on >= 4
    checks = dict(w.check())
    lim = run.limits(OFFTARGET)
    assert all(v <= lim[n] for n, v in checks.items()), checks


def test_gate_pairs_counter_sums_the_collected_counts(offtarget_units):
    _, counts, grown = offtarget_units
    assert counts and grown == sum(counts) > 0


@pytest.mark.parametrize("name", [REPEATS, OFFTARGET])
def test_traced_run_is_correct_and_reads_the_new_metrics(name):
    cfg, trf = small(name)
    res = run.run_cell(name, SEED, 0.05, True, "cpu", config=cfg,
                       traffic=trf, man=MAN)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(NEW) <= set(got)
    assert got["gate_pairs.map"]["value"] > 0
    assert got["rerun_ms.map"]["value"] >= 0
    # at test size every block is one piece: nothing to order on the host
    assert got["host_sorted.map"]["value"] == 0
    if name == OFFTARGET:
        # most long reads have no end pair: the later stages run
        assert got["open_reads.map"]["value"] >= 0.5 * 32
        assert got["next_ms.map"]["value"] > 0
        assert got["split_ms.map"]["value"] > 0


def _wide_reads(g, seeds, width, rng, n):
    """``n`` reads of 3-4 kb copied whole from the genome whose first
    window (on the genome's strand) holds more than ``width`` seeds,
    alternately on each strand; starts past the first chunk's edge.  (At
    8% substitutions a window keeps about a third of its seeds, and no
    window of a 300 kb genome holds three times the width.)"""
    flag = seeds.table[plain.kmer_codes(g, seeds.k)].astype(np.int32)
    e = seeds.edge
    dense = np.convolve(flag, np.ones(e - seeds.k + 1, np.int32), "valid")
    starts = np.flatnonzero(dense > width)
    starts = starts[(starts > 2 * e) & (starts < len(g) - 5 * e)]
    out = []
    for i, o in enumerate(rng.choice(starts, n, replace=False)):
        L = int(rng.integers(3000, 4000))
        s = g[o:o + L].copy()
        out.append((s, int(o), bool(i % 2)))
    return out


@pytest.fixture(scope="module")
def planted():
    """A 300 kb genome planted with the repeat cell's families at its
    k, its reference seeds, the port's mapper on it and its seed
    values."""
    cfg = repeats_config(300_000)
    k = cfg["map"]["k"]
    g = mixed.genome(SEED, cfg)
    seeds = plain.Seeds(g, k, 40, 10000, 1000, False)
    ref = Sequence.from_string(g.tobytes().decode(), id=0, name="g")
    values = score_seed_values(kmer_occurrences([ref], k), k)
    mapper = Mapper(ref, False, k, values, 40, 1000, 10000, device="cpu")
    return g, seeds, mapper, values


def test_map_batch_matches_jax_on_a_planted_genome(planted):
    """The port's lines on a planted genome are the JAX package's, byte
    for byte, on both strands: reads drawn anywhere, and reads whose
    window holds more seeds than the mapper's query width, whose seed
    count the map cells' rule does not expect and the mixed cells'
    reference does (the algorithm anchors the first ``width`` seeds of a
    window)."""
    g, seeds, tm, values = planted
    k = seeds.k
    width = tm.engine.nq
    rng = generate.rng_for(SEED, "parity")
    drawn = generate.sample_reads(rng, g, 10, 2500, 5000, 0.08)
    reads = [(s, int(o), bool(rc)) for s, o, rc in
             zip(drawn.seqs, drawn.start, drawn.rc)]
    wide = _wide_reads(g, seeds, width, rng, 6)
    reads += [(generate.reverse_complement(s) if rc else s, o, rc)
              for s, o, rc in wide]
    # both mappers on the same seed values, as test_torch_map.py's
    jref = JaxSequence.from_string(g.tobytes().decode(), id=0, name="g")
    jm = JaxMapper(jref, False, k, values, 40, 1000, 10000)
    assert jm.engine.nq == width == reference.query_width(seeds)
    tq = [Sequence.from_string(s.tobytes().decode(), id=i, name=f"r{i}")
          for i, (s, _, _) in enumerate(reads)]
    jq = [JaxSequence.from_string(s.tobytes().decode(), id=i,
                                  name=f"r{i}")
          for i, (s, _, _) in enumerate(reads)]
    got = [[tm.as_string(m) for m in ms] for ms in tm.map_batch(tq)]
    want = [[jm.as_string(m) for m in ms] for ms in jm.map_batch(jq)]
    assert got == want
    assert sum(bool(x) for x in got) >= 14
    assert any(rc for _, _, rc in wide) and not all(rc for _, _, rc in wide)
    # every read is placed; where clean, its seed count is the mixed
    # cells' reference's (the first ``width`` seeds of a window anchored),
    # on the wide reads too, where the map cells' rule does not hold on
    # some: the algorithm's truncation, as the lines are the JAX package's
    compared = plain_differ = 0
    for i, ((s, o, rc), lines) in enumerate(zip(reads, got)):
        assert plain.judge([lines], [f"r{i}"], [len(s)], [o], [rc], "g",
                           len(g)) == 0
        want_ids = reference.expected_ids(seeds, s, o, rc, width)
        if want_ids is None:
            continue
        compared += 1
        assert [int(ln.split("\t")[9]) for ln in lines] == [want_ids]
        plain_differ += i >= 10 and \
            plain.expected_ids(seeds, s, o, rc) != want_ids
    assert compared >= 8 and plain_differ >= 1


def _toy_binned(mapper, values, monkeypatch):
    """The planted genome's mapper on the binned gate at toy scale."""
    monkeypatch.setattr(map_engine, "_BINNED_MIN_C", 16)
    monkeypatch.setattr(map_engine, "_BINNED_CB", 2)
    return Mapper(mapper.reference, False, mapper.k, values, 40, 1000,
                  10000, device="cpu")


def _capped_windows(g, eng):
    """48 1 kb windows of the planted genome, packed, and their minimum
    chain lengths."""
    rng = generate.rng_for(SEED, "capped")
    drawn = generate.sample_reads(rng, g, 48, 1000, 1001, 0.08)
    windows = [Sequence.from_string(s.tobytes().decode(), id=i, name=f"w{i}")
               for i, s in enumerate(drawn.seqs)]
    packed = eng.pack_query_windows(
        WindowRows.cut(windows, 0, [len(w) for w in windows]))
    return packed, np.maximum(5, packed[6] // 5).astype(np.int32)


@pytest.mark.parametrize("gate", ["flat", "binned"])
def test_capped_collect_gives_the_uncapped_rows(planted, monkeypatch, gate):
    """A block whose passing count outgrows the pair cap re-runs in pieces
    of the cap, and its collected rows are those of one run that holds
    every pair; on the binned gate too, whose count grows when a re-run
    widens the bins it selects."""
    g, _, mapper, values = planted
    if gate == "binned":
        mapper = _toy_binned(mapper, values, monkeypatch)
    eng = mapper.engine
    assert eng._binned == (gate == "binned")
    packed, base_min = _capped_windows(g, eng)

    def collected():
        eng.reruns.clear()
        futs = eng.dispatch_packed(packed, base_min, pair_budget=16)
        return eng.collect_arrays_many([futs])[0], dict(eng.reruns)
    (head, rows), _ = collected()
    monkeypatch.setattr(eng, "pair_cap", 64)
    (cut_head, cut_rows), reruns = collected()
    assert len(head) > 3 * 64
    assert cut_head.shape == head.shape and cut_rows.shape == rows.shape
    assert (cut_head == head).all() and (cut_rows == rows).all()
    assert reruns.get("pair_budget", 0) >= 2
    if gate == "binned":
        assert any("BB" in c for c in reruns)


def _host_ordered_rows(eng, blocks):
    """The rows of a dispatch whose runs left the card in the gate's order
    with engine chunk ids, ordered as the collect did before the card
    ordered them: each block's runs joined whole, dead slots masked,
    summaries widened, binned chunk ids translated to the index's and the
    rows lexsorted."""
    parts = []
    for p in blocks:
        runs, _ = eng._runs(p)
        head = np.concatenate([h for h, _, _ in runs])
        packed = np.concatenate([q for _, q, _ in runs])
        live = head[:, 0] >= 0
        head, packed = head[live], packed[live].astype(np.int32)
        head[:, 0] += p.lo
        if eng._perm is not None:
            head[:, 1] = eng._perm[head[:, 1]]
            order = np.lexsort((head[:, 1], head[:, 0]))
            head, packed = head[order], packed[order]
        parts.append((head, packed))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(2))


@pytest.mark.parametrize("pieces", ["one", "capped"])
@pytest.mark.parametrize("route", ["bd", "bc", "d", "c"])
def test_card_ordered_collect_gives_the_host_ordered_rows(
        planted, monkeypatch, route, pieces):
    """A dispatch's collected rows, with the card putting binned runs in
    the walk's order and the collect taking each run's live rows by
    count, are those the host ordering gives from the same dispatch, row
    for row: on both binned routes and, for the count's slice, both flat
    ones; in one piece and in pieces of 64 pairs, whose boundaries split
    query rows on the binned gate (ordered on the host, and counted)."""
    g, _, mapper, values = planted
    if route.startswith("b"):
        mapper = _toy_binned(mapper, values, monkeypatch)
    eng = mapper.engine
    assert eng._binned == route.startswith("b")
    packed, base_min = _capped_windows(g, eng)
    if route.endswith("c"):
        packed = packed[:6]          # no num_seeds: buckets shipped
    if pieces == "capped":
        monkeypatch.setattr(eng, "pair_cap", 64)
    eng.routes.clear()
    before = MapEngine.host_sorted
    head, rows = eng.collect_arrays_many(
        [eng.dispatch_packed(packed, base_min, pair_budget=16)])[0]
    host_sorted = MapEngine.host_sorted - before
    assert dict(eng.routes) == {"_fused_map_" + route: 1}
    # the card as it was: the gate's order, engine chunk ids
    monkeypatch.setattr(map_engine, "_walk_order",
                        lambda mi, ci, dc, live, perm, C:
                        (mi, ci, dc, live, ci))
    _, blocks, _ = eng.dispatch_packed(packed, base_min, pair_budget=16)
    want_head, want_rows = _host_ordered_rows(eng, blocks)
    assert len(head) > 3 * 64
    assert head.dtype == want_head.dtype and rows.dtype == want_rows.dtype
    np.testing.assert_array_equal(head, want_head)
    np.testing.assert_array_equal(rows, want_rows)
    if route.startswith("b") and pieces == "capped":
        assert 0 < host_sorted < len(head)
    else:
        assert host_sorted == 0


def test_host_sorted_counter_sums_every_thread(planted, monkeypatch):
    """``map.collect.host_sorted`` grows by the rows every collect orders
    on the host: on both shard threads of ``Mapper.map_batch``, and with
    more collecting threads than cores at a short switch interval (the
    runs precomputed, so the threads contend on the count): no update is
    lost."""
    g, _, mapper, values = planted
    mapper = _toy_binned(mapper, values, monkeypatch)
    eng = mapper.engine
    monkeypatch.setattr(eng, "pair_cap", 64)
    monkeypatch.setattr(eng, "_map_budget", lambda route, rows: 16)
    monkeypatch.setattr(Mapper, "_SHARD_MIN", 8)
    ordered = []
    straddled = map_engine._straddled

    def recorded(*args):
        n = straddled(*args)
        ordered.append((threading.get_ident(), n))
        return n
    monkeypatch.setattr(map_engine, "_straddled", recorded)
    rng = generate.rng_for(SEED, "shards")
    drawn = generate.sample_reads(rng, g, 16, 3000, 4000, 0.08)
    reads = [Sequence.from_string(s.tobytes().decode(), id=i, name=f"r{i}")
             for i, s in enumerate(drawn.seqs)]
    before = metrics.counters()["map.collect.host_sorted"]
    mapper.map_batch(reads)
    grown = metrics.counters()["map.collect.host_sorted"] - before
    assert len({t for t, n in ordered if n}) == 2
    assert grown == sum(n for _, n in ordered)

    packed, base_min = _capped_windows(g, eng)
    _, (p,), _ = eng.dispatch_packed(packed, base_min, pair_budget=16)
    runs = eng._runs(p)
    monkeypatch.setattr(eng, "_runs", lambda p: runs)
    ordered.clear()
    before = metrics.counters()["map.collect.host_sorted"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=32) as tp:
            futs = [tp.submit(eng._collect_block, p) for _ in range(256)]
            sizes = {len(f.result(timeout=60)[0]) for f in futs}
    finally:
        sys.setswitchinterval(interval)
    grown = metrics.counters()["map.collect.host_sorted"] - before
    (n,) = {n for _, n in ordered}
    assert len(sizes) == 1 and len(ordered) == 256 and n > 0
    assert grown == 256 * n
