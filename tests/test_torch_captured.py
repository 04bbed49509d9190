"""The capture / replay layer (``downpore_tpu_torch.ops.captured``) and the
row buckets it brings back, on the CPU, against the JAX package at
tolerance 0 (every quantity is an integer).

* The cache's keys: one key for the same bucketed shapes and statics, a
  new one for a new budget, ``BB``, ``nq_eff`` or route.
* ``row_bucket`` is the JAX package's accelerator ladder
  (``downpore_tpu.ops.chain._bucket`` with its fixed buckets on).
* Map, overlap and trim dispatches at row counts off the ladder (300 and
  1,100 rows) give the JAX package's outputs: the padding rows pass
  nothing and collect drops them.
* Three dispatches of one key in flight before any collect each give the
  JAX output.
* The seed-sharded routes: a key per seed shard's partial count and one
  for the tail, the same keys at every dispatch once the budget settled.

On the CPU ``captured.run`` calls the block directly; the capture and the
replays themselves are held on the card by ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from downpore_tpu.ops import chain as jchain
from downpore_tpu.ops.map_engine import MapEngine as JaxEngine
from downpore_tpu.overlap import Overlapper as JaxOverlapper
from downpore_tpu_torch.ops import captured
from downpore_tpu_torch.ops import map_engine as tme
from test_torch_binned import build_both, escalation_genome  # noqa: F401
from test_torch_map_engine import K, mappers, windows  # noqa: F401
from test_torch_overlap import K as OV_K, reads, round_setup  # noqa: F401
from test_torch_window_engine import EDGE_W, MID_W, edge_mins, \
    edge_windows, engines, mid_windows  # noqa: F401

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def recorded(monkeypatch):
    """The key of every ``captured.run`` call the engines make."""
    keys = []
    run = captured.run

    def recording(fn, inputs, tables=None, **statics):
        keys.append(captured.key_of(fn, inputs, tables or {}, statics))
        return run(fn, inputs, tables, **statics)
    monkeypatch.setattr(captured, "run", recording)
    return keys


def map_packed(jm, wins):
    packed = jm.engine.pack_query_windows(wins)
    return packed, np.maximum(5, packed[6] // 5).astype(np.int32)


# -- keys ---------------------------------------------------------------------
def test_same_bucket_and_statics_share_a_key(mappers, recorded):
    """Dispatches of 300 and 400 rows (one bucket, 1024) at one budget
    share their key; another budget is another key."""
    genome, jm, _ = mappers
    te = tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True, device=CPU)
    for n, budget in ((150, 4096), (200, 4096), (200, 8192)):
        packed, base_min = map_packed(jm, windows(genome, n, 3))
        assert captured.padded_rows(packed[0].shape[0]) == 1024
        te.collect_arrays_many([te.dispatch_packed(packed, base_min,
                                                   pair_budget=budget)])
    assert len(recorded) == 3
    assert recorded[0] == recorded[1] != recorded[2]
    statics = dict(recorded[2][1])
    assert statics["pair_budget"] == 8192 and recorded[2][0] is \
        tme._fused_map_d


def test_nq_eff_and_route_are_in_the_key(mappers, recorded):
    """Rows whose seeds fit half the seed width run at ``nq_eff`` = nq / 2
    (a narrower ``q_seeds``: another key), and shipped buckets take the
    other route (another function: another key)."""
    genome, jm, _ = mappers
    te = tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True, device=CPU)
    rng = np.random.default_rng(4)
    wins = [genome.subsequence(p, p + 2000)
            for p in rng.integers(0, len(genome) - 2000, 150).tolist()]
    short = [w.subsequence(0, 600) for w in wins]
    for ws, ship in ((wins, False), (short, False), (wins, True)):
        packed, base_min = map_packed(jm, ws)
        if ship:
            packed = packed[:6]
        te.collect_arrays_many([te.dispatch_packed(packed, base_min,
                                                   pair_budget=4096)])
    (f0, s0, i0, t0, _), (f1, s1, i1, _, _), (f2, _, _, _, _) = recorded
    widths = [dict((n, sh) for n, sh, _ in i)["q_seeds"][1] for i in (i0,
                                                                       i1)]
    assert widths == [64, 32] and f0 is f1 and s0 == s1
    assert f0 is tme._fused_map_d and f2 is tme._fused_map_c
    assert len(set(recorded)) == 3


def test_binned_width_is_in_the_key(monkeypatch, escalation_genome,
                                    recorded):
    """A binned dispatch whose passing bins exceed ``BB`` re-runs at the
    width the JAX doubling ends on: the same shapes at another ``BB``,
    so another key; the rows equal the JAX engine's."""
    genome, reads_ = escalation_genome
    jm, tm = build_both(genome, monkeypatch)
    wins = [r.subsequence(0, 1000) for r in reads_]
    packed, base_min = map_packed(jm, wins)
    ref = jm.engine.collect_arrays_many([jm.engine.dispatch_packed(
        packed, base_min)])[0]
    got = tm.engine.collect_arrays_many([tm.engine.dispatch_packed(
        packed, base_min)])[0]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    bbs = [dict(k[1])["BB"] for k in recorded]
    assert len(recorded) == 2 and bbs[0] == 8 and bbs[1] > 8
    assert recorded[0][2:] == recorded[1][2:]


def test_row_bucket_is_the_jax_accelerator_ladder(monkeypatch):
    monkeypatch.setattr(jchain, "_FIXED_BUCKETS", True)
    for n in range(1, 5001):
        assert captured.row_bucket(n) == jchain._bucket(n), n
    assert [captured.padded_rows(300, D) for D in (1, 3)] == [1024, 1026]


# -- off the ladder -----------------------------------------------------------
@pytest.mark.parametrize("rows", [300, 1100])
def test_map_dispatch_off_the_ladder_matches_jax(mappers, rows):
    genome, jm, _ = mappers
    te = tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True, device=CPU)
    packed, base_min = map_packed(jm, windows(genome, rows // 2, 11))
    assert packed[0].shape[0] == rows
    ref = jm.engine.collect_arrays_many([jm.engine.dispatch_packed(
        packed, base_min)])[0]
    got = te.collect_arrays_many([te.dispatch_packed(packed, base_min)])[0]
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])
    assert got[0][:, 0].max() < rows and len(got[0]) >= rows // 4


def overlap_queries(reads, rows):
    """``rows`` overlap queries: the round's edge queries, repeated."""
    jov, jq = round_setup(reads, JaxOverlapper)
    sq = [q.query for q in jq]
    sq = (sq * (rows // len(sq) + 1))[:rows]
    base_min = np.array([int(0.25 * q.num_seeds + 0.5) for q in sq],
                        np.int32)
    return jov.index, sq, base_min


@pytest.mark.parametrize("rows", [300, 1100])
def test_overlap_dispatch_off_the_ladder_matches_jax(reads, rows):
    index, sq, base_min = overlap_queries(reads, rows)
    ref = JaxEngine(index, OV_K, nq=128, nt=256).query_chains(sq, base_min)
    eng = tme.MapEngine(index, OV_K, nq=128, nt=256, device=CPU)
    plan = {}
    got = eng.query_chains(sq, base_min, shape_plan=plan)
    assert got == ref and len(got) == rows
    assert plan["mb"] == captured.row_bucket(rows)
    assert sum(len(r) for r in got) >= rows // 2


@pytest.mark.parametrize("rows", [300, 1100])
def test_trim_dispatch_off_the_ladder_matches_jax(engines, rows):
    """Edge verdicts of both sides, DetermineAdapters' coverage and the
    middle pass's detections over ``rows`` windows."""
    jt, jeng, tt, teng = engines
    rng = np.random.default_rng(8)
    edges = edge_windows(rng)
    edges = (edges * (rows // len(edges) + 1))[:rows]
    for front in (True, False):
        gm, cm = edge_mins(jt, front)
        ref = jeng.edge_verdict_collect(jeng.edge_verdict_dispatch(
            edges, front, gm, cm, EDGE_W), len(gm))
        got = teng.edge_verdict_collect(teng.edge_verdict_dispatch(
            edges, front, gm, cm, EDGE_W), len(gm))
        np.testing.assert_array_equal(ref[0], got[0])
        np.testing.assert_array_equal(ref[1], got[1])
        assert got[0].shape == (rows, 4) and got[0][:, 0].sum() > 0
        np.testing.assert_array_equal(
            jeng.enable_covs(edges, front, gm, cm, EDGE_W),
            teng.enable_covs(edges, front, gm, cm, EDGE_W))
    mids = mid_windows(rng)
    mids = (mids * (rows // len(mids) + 1))[:rows]
    mm = jt._mid_min_matches()
    ref = jeng.window_verdict_collect(jeng.window_verdict_dispatch(
        mids, mm, mm, jt.mid_threshold, MID_W))
    got = teng.window_verdict_collect(teng.window_verdict_dispatch(
        mids, mm, mm, tt.mid_threshold, MID_W))
    np.testing.assert_array_equal(ref, got)
    assert len(got) >= rows // 4 and got[:, 0].max() < rows


# -- in flight ----------------------------------------------------------------
def test_three_dispatches_of_one_key_in_flight_match_jax(mappers, reads,
                                                         engines, recorded):
    """Three map dispatches, three overlap sub-batches and three middle
    batches of one key each, all enqueued before the first collect."""
    genome, jm, _ = mappers
    te = tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True, device=CPU)
    sets = [map_packed(jm, windows(genome, 150, s)) for s in (21, 22, 23)]
    futs = [te.dispatch_packed(p, b, pair_budget=4096) for p, b in sets]
    index, sq, base_min = overlap_queries(reads, 300)
    eng = tme.MapEngine(index, OV_K, nq=128, nt=256, device=CPU)
    subs = [(sq[i:] + sq[:i], np.roll(base_min, -i)) for i in (0, 7, 13)]
    plan = {"budget": 8192}
    ov_futs = [eng.dispatch_chains(q, b, shape_plan=plan) for q, b in subs]
    jt, jeng, tt, teng = engines
    mm = jt._mid_min_matches()
    mids = mid_windows(np.random.default_rng(9))
    batches = [mids[i:] + mids[:i] for i in (0, 5, 11)]
    mid_futs = [teng.window_verdict_dispatch(m, mm, mm, tt.mid_threshold,
                                             MID_W) for m in batches]
    assert len(set(recorded[0:3])) == len(set(recorded[3:6])) \
        == len(set(recorded[6:9])) == 1
    for (p, b), f in zip(sets, futs):
        ref = jm.engine.collect_arrays_many([jm.engine.dispatch_packed(
            p, b)])[0]
        got = te.collect_arrays_many([f])[0]
        np.testing.assert_array_equal(ref[0], got[0])
        np.testing.assert_array_equal(ref[1], got[1])
    jov = JaxEngine(index, OV_K, nq=128, nt=256)
    for (q, b), f in zip(subs, ov_futs):
        assert eng.collect_chains(f) == jov.query_chains(q, b)
    for m, f in zip(batches, mid_futs):
        np.testing.assert_array_equal(
            jeng.window_verdict_collect(jeng.window_verdict_dispatch(
                m, mm, mm, jt.mid_threshold, MID_W)),
            teng.window_verdict_collect(f))


# -- the seed-sharded routes --------------------------------------------------
@pytest.mark.parametrize("path", ["map", "overlap"])
def test_seed_sharded_routes_are_keyed(mappers, reads, recorded, path):
    """On a 2 x 2 grid each dispatch runs one key per seed shard's partial
    count (its row offset ``lo`` among the statics, its membership block a
    table of its own) and one for the tail; once the first collect has
    settled the map budget, every dispatch has the same keys, and each
    result equals the unsharded engine's."""
    from collections import Counter
    from downpore_tpu_torch.parallel import make_mesh
    grid = make_mesh(2, 2, ["cpu"] * 4)
    if path == "map":
        genome, jm, _ = mappers
        packed, base_min = map_packed(jm, windows(genome, 150, 31))
        engs = [tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True,
                              mesh=m, device=CPU) for m in (grid, None)]
        run = lambda e: e.collect_arrays_many([e.dispatch_packed(
            packed, base_min)])[0]
        tail = "_map_from_counts"
    else:
        index, sq, base_min = overlap_queries(reads, 300)
        engs = [tme.MapEngine(index, OV_K, nq=128, nt=256, mesh=m,
                              device=CPU) for m in (grid, None)]
        run = lambda e: e.query_chains(sq, base_min)
        tail = "_overlap_from_counts"
    sharded, plain = engs
    ref = run(plain)
    keys = []
    for _ in range(3):
        recorded.clear()
        got = run(sharded)
        keys.append(set(recorded))
        if path == "map":
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(r, g)
        else:
            assert got == ref
    assert keys[1] == keys[2]
    shard_keys = [{k for k in ks if k[0] is tme._shard_counts}
                  for ks in keys]
    assert shard_keys[0] == shard_keys[1] == shard_keys[2]
    assert Counter(k[0].__name__ for k in keys[0]) == {"_shard_counts": 2,
                                                      tail: 1}
    HL = sharded._mem_shape[0] // 2
    offsets = {dict(k[1])["lo"]: {n for n, _, _ in k[3]} for k in keys[0]
               if k[0] is tme._shard_counts}
    assert offsets == {0: {"mem_block0"}, HL: {"mem_block1"}}


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_sharded_counts_equal_the_whole_membership(recorded, shards):
    """``sharded_counts`` over the membership split into ``shards`` row
    blocks (uneven at 3) equals the count over the whole membership and a
    numpy sum of the int8 rows, with dead (-1) buckets and buckets in
    every block; each block's partial count is a key of its own, by its
    row offset and its table's name."""
    rng = np.random.default_rng(40 + shards)
    H, C, M, R = 64, 24, 50, 12
    mem = rng.integers(0, 2, (H, C), dtype=np.int8)
    buckets = rng.integers(-1, H, (M, R)).astype(np.int32)
    blocks = [torch.from_numpy(b) for b in np.array_split(mem, shards)]
    got = tme.sharded_counts(blocks, torch.from_numpy(buckets), CPU)
    whole = tme._count_rows(torch.from_numpy(mem), torch.from_numpy(buckets))
    ref = np.where((buckets >= 0)[:, :, None], mem[buckets], 0).sum(
        1, dtype=np.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(whole.numpy(), ref)
    starts = np.cumsum([0] + [len(b) for b in blocks[:-1]])
    assert [(dict(k[1])["lo"], [n for n, _, _ in k[3]]) for k in recorded] \
        == [(int(lo), [f"mem_block{s}"]) for s, lo in enumerate(starts)]
