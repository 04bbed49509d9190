"""The map's native routes against their Python twins on the CPU: the
ends phase's pairing (``Mapper._pair_ends_native``, one call of
``native.pair_ends``, against ``Mapper._pair_ends_py``) on seeded random
end-window mappings at the edges of every rule it follows, the candidate
walk (``native.walk_candidates`` against ``Mapper._walk_candidates_py``)
on collected chunks of both gates, ``Mapper.map_batch`` with the native
library and with it absent, and the counters of the native route.
Results, open lists and arrays must be equal field by field and in order
(tolerance 0)."""
import sys
import threading

import numpy as np
import pytest
import torch

from downpore_tpu_torch import native
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.mapping.mapper import _EndsCounts, _mappings
from downpore_tpu_torch.ops import map_engine
from downpore_tpu_torch.ops.map_engine import WindowRows
from downpore_tpu_torch.utils import kmer_occurrences, metrics, \
    score_seed_values

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="no native toolchain")

torch.set_num_threads(2)

K = 11
ES = 1000
GENOME = 60000


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(5)
    return Sequence(rng.integers(0, 4, GENOME).astype(np.uint8), id=0,
                    name="chr")


@pytest.fixture(scope="module")
def mappers(genome):
    values = score_seed_values(kmer_occurrences([genome], K), K)
    return {c: Mapper(genome, c, K, values, 40, ES, 10000, device="cpu")
            for c in (False, True)}


def fields(maps):
    return [(m.start, m.end, m.query_offset, m.query_inset, m.rc, m.ids,
             id(m.query)) for m in maps]


# distances at the rule's edges: +-50, 500, 5000, negatives (floor
# division) and the interpolated band between 500 and 5000
DISTANCES = [-5000, -2000, -51, -50, -49, -1, 0, 1, 49, 50, 51, 100, 499,
             500, 501, 1000, 2375, 2750, 4550, 4999, 5000, 5001, 6000]


def _ratio(d):
    r = (d - 500) / 4500.0
    return 3.0 / 2.0 + r * (10.0 / 9.0 - 3.0 / 2.0)


def _expected_near(d, rng):
    """An ``expected`` at an edge of the rule for distance ``d``: the
    floor-divided bounds, the 50 cut, and where ``expected * ratio`` or
    ``expected / ratio`` lands on ``d`` (an integer product)."""
    c = [d * 3 // 2, d * 2 // 3, d * 10 // 9, d * 9 // 10, 49, 50, -d]
    if 500 <= d <= 5000:
        q = _ratio(d)
        c += [round(d / q), round(d * q), int(d / q), int(d * q)]
    return int(rng.choice(c)) + int(rng.integers(-2, 3))


def _window_rows(rng, qlen, lefts, right, circular):
    """Up to 4 mappings of one end window as (start, end, q_offset,
    q_inset, rc, ids) rows; the right end's are mostly placed against a
    left one at an edge distance and ``expected``."""
    pool = rng.integers(0, GENOME, 3)
    grid = [0, 10, 99, 100, 101, 200]
    rows = []
    for _ in range(int(rng.integers(0, 5))):
        length = int(rng.choice([800, 900, 1000, 1200]))
        ids = int(rng.choice([4, 5, 6, 8, 10, 12, 15]))
        rc = bool(rng.integers(0, 2))
        start = int(rng.choice(pool)) + int(rng.choice([0, 0, 5, 500]))
        if not right:
            qo = int(rng.choice(grid))
            qi = qlen - ES + int(rng.choice(grid))
        else:
            qo = qlen - ES + int(rng.choice(grid))
            qi = int(rng.choice(grid))
            if lefts and rng.random() < 0.7:
                left = lefts[int(rng.integers(0, len(lefts)))]
                rc = left[4]
                # the raw distance, and what the rule reads after a wrap
                raw = d = int(rng.choice(DISTANCES))
                if circular and d < -50:
                    d += GENOME
                elif circular and rng.random() < 0.3:
                    raw = d - GENOME
                qo = _expected_near(d, rng) + qlen - left[3]
                if rc:
                    start = left[0] - raw - length
                else:
                    start = left[1] + raw
        rows.append((start, start + length, qo, qi, rc, ids))
    return rows


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_pair_ends_matches_python(mappers, seed, circular):
    m = mappers[circular]
    rng = np.random.default_rng(1000 + seed)
    # reads of 2-3 x edge_size (closed when unpaired), longer ones (left
    # open) and a short one (no ends phase)
    reads = [Sequence(np.zeros(int(rng.choice(
        [1500, 2001, 2500, 2999, 3000, 3001, 4000, 6000, 9000])), np.uint8),
        id=i, name=f"r{i}") for i in range(300)]
    long_idx = [i for i, r in enumerate(reads) if len(r) > 2 * ES]
    windows = []
    for i in long_idx:
        qlen = len(reads[i])
        a = _window_rows(rng, qlen, [], False, circular)
        windows += [a, _window_rows(rng, qlen, a, True, circular)]
    flat = [(w, *row) for w, rows in enumerate(windows) for row in rows]
    cols = list(zip(*flat))
    accepted = tuple(np.array(c, np.int64) for c in cols[:5]) + (
        np.array(cols[5], bool), np.array(cols[6], np.int64))
    ends = [reads[i] for i in long_idx for _ in (0, 1)]
    res_py = [None] * len(reads)
    states_py = m._pair_ends_py(reads, long_idx,
                                _mappings(ends, accepted, len(ends)), res_py)
    res_nat = [None] * len(reads)
    states_nat = m._pair_ends_native(reads, long_idx, accepted, res_nat)
    assert [i for i, r in enumerate(res_nat) if r is not None] == \
        [i for i, r in enumerate(res_py) if r is not None]
    for got, ref in zip(res_nat, res_py):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert fields(got) == fields(ref)
    assert list(states_nat) == list(states_py)
    for i, (a, b) in states_py.items():
        assert fields(states_nat[i][0]) == fields(a)
        assert fields(states_nat[i][1]) == fields(b)
    # every branch had work: pairs, closed reads, open reads
    assert states_py and any(r for r in res_py if r is not None)
    closed = [i for i in long_idx if res_py[i] is not None
              and len(reads[i]) < 3 * ES]
    assert closed


def batch_reads(genome, n=24):
    """Reads of 1.5-9 kb at 8% substitutions, every second one
    reverse-complemented, a chimera, an unrelated read, two cut out of a
    longer read (their own offset and inset), and two whose codes are
    int64 or a strided view: short reads, both ends, mapNext and the split
    search all get windows (``traced_map``)."""
    rng = np.random.default_rng(77)
    g = genome.codes
    reads = []
    for i in range(n):
        ln = int(rng.integers(1500, 9000))
        start = int(rng.integers(0, GENOME - ln))
        codes = g[start:start + ln].copy()
        hit = rng.random(ln) < 0.08
        codes[hit] = (codes[hit] + rng.integers(1, 4, hit.sum())) % 4
        read = Sequence(codes, id=i, name=f"r{i}")
        if i % 2:
            read = read.reverse_complement()
            read.offset = read.inset = 0
        reads.append(read)
    reads.append(Sequence(np.concatenate([g[2000:6000], g[40000:44000]]),
                          id=n, name="chimera"))
    reads.append(Sequence(rng.integers(0, 4, 4000).astype(np.uint8),
                          id=n + 1, name="junk"))
    whole = Sequence(g[50000:58000].copy(), id=n + 2, name="cut")
    reads += [whole.subsequence(300, 7900), whole.subsequence(0, 2600)]
    # codes that are no contiguous byte buffer: wider integers, a view
    reads.append(Sequence(g[9000:15000].astype(np.int64), id=n + 3,
                          name="wide"))
    reads.append(Sequence(g[20000:26000][::-1], id=n + 4, name="view"))
    return reads


def traced_map(m, reads):
    """``m.map_batch(reads)`` traced, and the phases whose stage packed
    windows (the phase span above each ``map.pack`` span's stage)."""
    metrics.enable()
    try:
        got = m.map_batch(reads)
    finally:
        metrics.disable()
    every = {s.id: s for ss in metrics.spans().values() for s in ss}
    return got, {every[every[s.parent].parent].name
                 for s in every.values() if s.name == "map.pack"}


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("shards", [1, 2])
def test_map_batch_same_without_native(monkeypatch, mappers, genome,
                                       circular, shards):
    m = mappers[circular]
    reads = batch_reads(genome)
    if shards == 2:
        monkeypatch.setattr(Mapper, "_SHARD_MIN", 4)
    got, phases = traced_map(m, reads)
    with monkeypatch.context() as mp:
        mp.setattr(native, "load", lambda: None)
        ref, ref_phases = traced_map(m, reads)
    assert phases == ref_phases == {"map.short", "map.ends", "map.next",
                                    "map.split"}
    assert [[m.as_string(x) for x in ms] for ms in got] == \
        [[m.as_string(x) for x in ms] for ms in ref]
    assert [fields(ms) for ms in got] == [fields(ms) for ms in ref]
    assert sum(1 for ms in got if ms) >= 24


@pytest.fixture(scope="module")
def repeat_genome(genome):
    """``genome`` with bases 10,000-13,000 copied at 30,000 (3%
    substitutions) and, reverse-complemented, at 45,000 (6%): windows
    there chain in three chunks, on both strands, so the walk's
    thresholds ratchet."""
    rng = np.random.default_rng(9)
    g = genome.codes.copy()
    for at, rate, rc in ((30000, 0.03, False), (45000, 0.06, True)):
        seg = g[10000:13000].copy()
        hit = rng.random(len(seg)) < rate
        seg[hit] = (seg[hit] + rng.integers(1, 4, hit.sum())) % 4
        g[at:at + len(seg)] = (3 - seg[::-1]) if rc else seg
    return Sequence(g, id=0, name="chr")


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("gate", ["flat", "binned"])
def test_walk_same_without_native(monkeypatch, repeat_genome, gate,
                                  circular):
    """``Mapper._walk_candidates`` returns the same arrays, dtypes
    included, from the native walk and from ``_walk_candidates_py`` on the
    same collected chunks: 1 kb windows at the start, middle and end of
    every read of ``batch_reads``, of a read across the genome's origin
    and of the repeat's copies."""
    genome = repeat_genome
    values = score_seed_values(kmer_occurrences([genome], K), K)
    chunk = 10000
    if gate == "binned":
        monkeypatch.setattr(map_engine, "_BINNED_MIN_C", 16)
        monkeypatch.setattr(map_engine, "_BINNED_CB", 2)
        chunk = 2000        # past the toy threshold
    m = Mapper(genome, circular, K, values, 40, ES, chunk, device="cpu")
    assert m.engine._binned == (gate == "binned")
    g = genome.codes
    reads = batch_reads(genome) + [
        Sequence(np.concatenate([g[-3000:], g[:3000]]), id=99, name="o"),
        genome.subsequence(9500, 13500)]
    wreads = [r for r in reads for _ in range(3)]
    lens = np.array([len(r) for r in wreads])
    starts = np.maximum(0, np.tile([0, 1, 2], len(reads))
                        * (lens - ES) // 2)
    chunks = m._chunks(WindowRows.cut(wreads, starts, starts + ES))
    walks = []
    for load in (native.load, lambda: None):
        monkeypatch.setattr(native, "load", load)
        walks.append([m._walk_candidates(sub, n, coll, lo)
                      for lo, sub, n, coll in chunks])
    got, ref = walks
    assert len(got) == len(ref) == 1 and len(got[0]) == 7
    for a, b in zip(got[0], ref[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    win, rc = got[0][0], got[0][5]
    assert rc.any() and not rc.all()
    # a repeat window accepts chains at more than one copy
    assert max((win == w).sum() for w in range(len(wreads) - 3,
                                               len(wreads))) > 1


def test_ends_counters_sum_to_long_reads(monkeypatch, mappers, genome):
    m = mappers[False]
    reads = batch_reads(genome)
    longs = sum(1 for r in reads if len(r) > 2 * ES)
    names = ("map.ends.native_reads", "map.ends.open_reads")
    c0 = metrics.counters()
    m.map_batch(reads)
    c1 = metrics.counters()
    closed, still_open = (c1[n] - c0[n] for n in names)
    assert closed + still_open == longs
    assert closed > 0
    # the Python route counts nothing
    monkeypatch.setattr(native, "load", lambda: None)
    m.map_batch(reads)
    assert {n: metrics.counters()[n] for n in names} == \
        {n: c1[n] for n in names}


def test_ends_counts_lose_no_update_across_threads():
    counts = _EndsCounts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                counts.count(2, 1)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert (counts.native_reads, counts.open_reads) == (64000, 32000)


def test_pair_ends_refuses_ragged_columns():
    one = np.zeros(1, np.int64)
    with pytest.raises(ValueError):
        native.pair_ends(np.array([0, 1, 1]), one, ES, one, one, one,
                         np.zeros(2, np.int64), np.zeros(1, bool), one,
                         False, GENOME)
