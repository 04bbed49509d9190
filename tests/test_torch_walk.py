"""The mapper's native candidate walk (``native.walk_candidates``), which
reads the collected head and packed summary matrices in place, against
its Python twin (``Mapper._walk_candidates_py`` on the unpacked columns,
``Mapper._walk_columns``) on hand-built rows at the edges of every rule
the walk follows, in both summary layouts; and the walk's counter
``map.walk.native_rows`` on a mapped batch.  Accepted rows must be equal
and in order (tolerance 0)."""
import numpy as np
import pytest

from downpore_tpu_torch import native
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.mapping import mapper as mapper_mod
from downpore_tpu_torch.ops.chain import summary_columns
from downpore_tpu_torch.utils import kmer_occurrences, metrics, \
    score_seed_values

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="no native toolchain")

K = 4       # chains a row
KMER = 11


def chain(sq=0, st=0, eq=900, et=900, ct=300, tl=60, tv=1):
    return dict(top_valid=tv, top_sqp=sq, top_stp=st, top_eqp=eq,
                top_etp=et, top_cov_t=ct, top_len=tl)


def row(mi, chains, dc=200, best=200):
    return mi, dc, best, chains


def build(rows, lean, seed=0):
    """``head`` [N, 3] and ``packed`` [N, W] from ``(mi, dc, best,
    chains)`` rows; columns the walk does not read hold noise, and a row's
    unlisted chains are invalid."""
    cols = summary_columns(K, lean=lean)
    W = max(cols.values()) + K
    rng = np.random.default_rng(seed)
    packed = rng.integers(-1000, 1000, (len(rows), W)).astype(np.int32)
    head = np.zeros((len(rows), 3), np.int32)
    for b, (mi, dc, best, chains) in enumerate(rows):
        head[b] = (mi, 7 * b, dc)
        packed[b, cols["best"]] = best
        packed[b, cols["top_valid"]:cols["top_valid"] + K] = 0
        for j, c in enumerate(chains):
            for name, v in c.items():
                packed[b, cols[name] + j] = v
    return head, packed, cols


def walk(rows, lean, nq, qlen=1000, num_seeds=25):
    """The native walk's ``(qi, b, j, rc)`` rows, held equal to the
    Python twin's."""
    head, packed, cols = build(rows, lean)
    qlen = np.zeros(nq, np.int64) + qlen
    seeds = np.zeros(2 * nq, np.int64) + num_seeds
    bounds = np.searchsorted(head[:, 0], np.arange(2 * nq + 1))
    got = native.walk_candidates(bounds, seeds, nq, head, packed, cols,
                                 qlen, KMER, K)
    ref = Mapper._walk_candidates_py(*Mapper._walk_columns(
        bounds, seeds, head, packed, qlen, KMER, K, lean))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return [tuple(int(x) for x in t) for t in zip(*got)]


def _tie(field, low, high):
    """Two chains at one (sq, st) key that tie on the stats before
    ``field``: the one with ``high`` wins, first or last."""
    def case():
        a, b = chain(**{field: low}), chain(**{field: high})
        other = chain(sq=40, st=5000, eq=950, tl=8)
        rows = [row(0, [a, other, b]), row(0, [b, a])]
        return rows, 1, [(0, 0, 2, 0), (0, 0, 1, 0), (0, 1, 0, 0)]
    return case


def _tie_none():
    # a full tie keeps the first chain of the key
    return [row(0, [chain(), chain(), chain(st=1)])], 1, \
        [(0, 0, 0, 0), (0, 0, 2, 0)]


def _invalid():
    # the longest chain is invalid, one falls under the floor (5)
    rows = [row(0, [chain(tl=500, tv=0), chain(st=9, tl=4),
                    chain(st=11, tl=30)]),
            row(1, [chain(tl=500, tv=0)])]
    return rows, 1, [(0, 0, 2, 0)]


def _ratchet():
    # the forward accept at 100 ratchets both floors to 80
    rows = [row(0, [chain(tl=100)]),
            row(0, [chain(st=1, tl=79), chain(st=2, tl=85)]),
            row(0, [chain(st=3, tl=90)], dc=79),
            row(0, [chain(st=4, tl=90)], best=79),
            row(1, [chain(st=5, tl=75)]),
            row(1, [chain(st=6, tl=80)])]
    return rows, 1, [(0, 0, 0, 0), (0, 1, 1, 0), (0, 5, 0, 1)]


def _ok23():
    # window 999: 2/3 is 666; sq + (999 - eq - 11) is 666, then 667
    rows = [row(0, [chain(sq=0, eq=322)]),
            row(2, [chain(sq=0, eq=321)]),
            row(4, [chain(sq=100, eq=422), chain(sq=101, st=3, eq=422)])]
    return rows, 3, [(0, 0, 0, 0), (2, 2, 0, 0)]


def _strands():
    # window 0 forward only, 1 none, 2 reverse only, 3 empty rows
    rows = [row(0, [chain()]), row(5, [chain(st=2)]),
            row(6, [chain(tl=3)])]
    return rows, 4, [(0, 0, 0, 0), (2, 1, 0, 1)]


CASES = {"tie_len": _tie("tl", 40, 50), "tie_cov_t": _tie("ct", 30, 31),
         "tie_eq": _tie("eq", 800, 801), "tie_et": _tie("et", 700, 900),
         "tie_none": _tie_none,
         "invalid": _invalid, "ratchet": _ratchet, "ok23": _ok23,
         "strands": _strands}


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_walk_matches_python(case, lean):
    rows, nq, want = CASES[case]()
    assert walk(rows, lean, nq, qlen=999 if case == "ok23" else 1000) \
        == want


def test_packed_walk_refuses_columns_past_the_row():
    head, packed, cols = build([row(0, [chain()])], lean=True)
    bad = dict(cols, top_len=packed.shape[1] - 1)
    with pytest.raises(ValueError):
        native.walk_candidates(np.array([0, 1, 1]), np.array([25, 25]), 1,
                               head, packed, bad, np.array([1000]), KMER, K)


def test_native_walk_reads_rows_in_place(monkeypatch):
    """The native route unpacks no summary and counts every collected row
    it walked in ``map.walk.native_rows``; the Python route counts none."""
    rng = np.random.default_rng(9)
    genome = Sequence(rng.integers(0, 4, 30000).astype(np.uint8), id=0,
                      name="chr")
    values = score_seed_values(kmer_occurrences([genome], KMER), KMER)
    m = Mapper(genome, False, KMER, values, 40, 1000, 10000, device="cpu")
    g = genome.codes
    reads = [Sequence(g[a:a + n].copy(), id=i, name=f"r{i}")
             for i, (a, n) in enumerate([(0, 1500), (3000, 4000),
                                         (9000, 6000), (20000, 9000)])]
    handed = []
    chunks = m._chunks

    def recorded(queries):
        out = chunks(queries)
        for *_, coll in out:
            if coll is not None:
                head, packed = coll
                assert head.dtype == packed.dtype == np.int32
                assert head.flags.c_contiguous and packed.flags.c_contiguous
                handed.append(head.shape[0])
        return out

    def refused(*a, **kw):
        raise AssertionError("unpack_summary on the native route")

    monkeypatch.setattr(m, "_chunks", recorded)
    name = "map.walk.native_rows"
    with monkeypatch.context() as mp:
        mp.setattr(mapper_mod, "unpack_summary", refused)
        c0 = metrics.counters()[name]
        nat = m.map_batch(reads)
        assert metrics.counters()[name] - c0 == sum(handed) > 0
    handed.clear()
    monkeypatch.setattr(native, "load", lambda: None)
    c0 = metrics.counters()[name]
    py = m.map_batch(reads)
    assert sum(handed) > 0 and metrics.counters()[name] == c0
    assert [[(x.start, x.end, x.rc, x.ids) for x in ms] for ms in nat] == \
        [[(x.start, x.end, x.rc, x.ids) for x in ms] for ms in py]
