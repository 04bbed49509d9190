"""The port's dispatch / collect contract, on the CPU, against the JAX
package at tolerance 0 (every quantity is an integer).

* Forced small budgets make every re-run path of the collects fire: the
  flat map gate's pair budget, the binned gate's ``n_bin > BB`` (alone and
  with the pair budget), an overlap sub-batch's pair budget, and the
  middle pass's detection budget, where the JAX collect keeps the first
  ``4 * det_budget`` rows of a batch and the port now keeps the same.
  Each collected result must equal the JAX engine's.
* No dispatch reads anything back: while a ``dispatch_*`` call runs,
  every way a tensor reaches the host (``nonzero``, ``item``, ``tolist``,
  ``cpu``, ``numpy`` and the conversions to bool, int, index and float)
  raises (``no_host_reads``; the CPU-only steps that a card never runs
  excepted); the call must still return its pending blocks, and the
  collect after it gives the JAX result.  On the card,
  ``tests/test_torch_kernels.py`` checks the same dispatches under
  ``torch.cuda.set_sync_debug_mode("error")``.
"""
import contextlib

import numpy as np
import pytest
import torch

from downpore_tpu.ops.map_engine import MapEngine as JaxEngine
from downpore_tpu.overlap import Overlapper as JaxOverlapper
from downpore_tpu_torch.ops import captured, cuda_chain, map_engine as tme
from downpore_tpu_torch.ops import window_engine as twe
from downpore_tpu_torch.ops.transfer import Pending
from downpore_tpu_torch.overlap import Overlapper as TorchOverlapper
from downpore_tpu_torch.parallel import make_mesh
from test_torch_binned import build_both, escalation_genome  # noqa: F401
from test_torch_map_engine import K, mappers, windows  # noqa: F401
from test_torch_overlap import K as OV_K, reads, round_setup  # noqa: F401
from test_torch_window_engine import EDGE_W, MID_W, edge_mins, \
    edge_windows, engines, mid_windows  # noqa: F401

torch.set_num_threads(2)

CPU = torch.device("cpu")
HOST_READS = ("nonzero", "item", "tolist", "cpu", "numpy", "__bool__",
              "__int__", "__index__", "__float__")


def _refuse(name):
    def read(*args, **kwargs):
        raise AssertionError(f"a dispatch read a tensor back: {name}")
    return read


_SAVED = {name: getattr(torch.Tensor, name) for name in HOST_READS}
_SAVED["torch.nonzero"] = torch.nonzero


def _set_reads(allowed: bool):
    for name in HOST_READS:
        setattr(torch.Tensor, name,
                _SAVED[name] if allowed else _refuse(f"Tensor.{name}"))
    torch.nonzero = (_SAVED["torch.nonzero"] if allowed
                     else _refuse("torch.nonzero"))


# the CPU-only steps that read their data, as (module, name): the chain
# kernel's plain version, which stands in for the kernel on CPU tensors (a
# CUDA tensor launches the kernel, which reads nothing back), and the
# anchor builds' choice of live slots, which a card never makes
CPU_READERS = ((cuda_chain, "chain_scan_plain"),
               (tme, "anchors_of_slots"), (twe, "anchors_of_slots"))


@contextlib.contextmanager
def no_host_reads():
    """Make every host read of a tensor raise while the block runs, except
    inside the CPU-only steps of ``CPU_READERS``."""
    def allowed(fn):
        def run(*args, **kwargs):
            _set_reads(True)
            try:
                return fn(*args, **kwargs)
            finally:
                _set_reads(False)
        return run
    saved = [(mod, name, getattr(mod, name)) for mod, name in CPU_READERS]
    try:
        _set_reads(False)
        for mod, name, fn in saved:
            setattr(mod, name, allowed(fn))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        _set_reads(True)


def test_no_host_reads_refuses_every_read():
    t = torch.ones(3, dtype=torch.int32)
    reads_of = [lambda: t.nonzero(), lambda: torch.nonzero(t),
                lambda: t[0].item(), lambda: t.tolist(), lambda: t.cpu(),
                lambda: t.numpy(), lambda: bool(t[0]), lambda: int(t[0]),
                lambda: [0, 1][t[0]], lambda: float(t[0]),
                lambda: np.asarray(t)]
    with no_host_reads():
        for read in reads_of:
            with pytest.raises(AssertionError, match="read a tensor back"):
                read()
    assert int(t.sum()) == 3 and t.tolist() == [1, 1, 1]


# -- map engine -------------------------------------------------------------
def map_windows(genome):
    wins = windows(genome, 48, 7)
    return wins + [w.reverse_complement() for w in wins[:8]]


def map_both(je, te, packed, base_min, **kw):
    """The JAX engine's collected rows at its own budget, and the port's
    after a dispatch at ``kw`` that reads nothing back."""
    ref = je.collect_arrays_many([je.dispatch_packed(packed, base_min)])[0]
    te.reruns.clear()
    with no_host_reads():
        futs = te.dispatch_packed(packed, base_min, **kw)
    assert all(isinstance(p, Pending) for p in futs[1])
    return ref, te.collect_arrays_many([futs])[0]


@pytest.mark.parametrize("route", ["_fused_map_d", "_fused_map_c"])
@pytest.mark.parametrize("pair_budget", [0, 5])
def test_flat_map_dispatch_matches_jax(mappers, route, pair_budget):
    """The flat gate at the JAX default budget and at 5 pairs, far below
    the passing count: collect re-runs at 4x until the budget holds it."""
    genome, jm, tm = mappers
    packed = jm.engine.pack_query_windows(map_windows(genome))
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    if route == "_fused_map_c":
        packed = packed[:6]
    tm.engine.routes.clear()
    (h_r, p_r), (h_g, p_g) = map_both(jm.engine, tm.engine, packed,
                                      base_min, pair_budget=pair_budget)
    assert dict(tm.engine.routes) == {route: 1}
    np.testing.assert_array_equal(h_r, h_g)
    np.testing.assert_array_equal(p_r, p_g)
    assert h_g.shape[0] >= 48
    reruns = dict(tm.engine.reruns)
    assert reruns == ({"pair_budget": 1} if pair_budget else {})


def test_map_budget_follows_the_last_count(mappers):
    """A map dispatch runs at the JAX engine's budget until one of its
    route and size is collected; then at a quarter over that count (on a
    256 grid) when that is smaller.  The rows are the JAX engine's
    either way."""
    genome, jm, _ = mappers
    te = tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True, device=CPU)
    packed = jm.engine.pack_query_windows(windows(genome, 400, 3))
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    M = packed[0].shape[0]
    ref = jm.engine.collect_arrays_many(
        [jm.engine.dispatch_packed(packed, base_min)])[0]
    budgets = []
    for _ in range(2):
        futs = te.dispatch_packed(packed, base_min)
        budgets.append(futs[1][0].args[0])
        got = te.collect_arrays_many([futs])[0]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(r, g)
    n_ok = len(ref[0])
    assert budgets[0] == tme.map_budget(M, te.num_seeds > 2 * te.H) == 4096
    assert budgets[1] == tme._tight(n_ok) < 4096 and n_ok >= 400
    assert not te.reruns


@pytest.mark.parametrize("n_data,n_seed", [(4, 1), (2, 2)])
def test_grid_map_dispatch_matches_jax(mappers, n_data, n_seed):
    """A data grid and a seed-sharded grid of CPU entries, each block at a
    budget of 3 pairs: every block that holds query rows re-runs (the
    blocks past them hold only the row bucket's padding, which passes
    nothing), and the rows equal the unsharded JAX engine's."""
    genome, jm, _ = mappers
    te = tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True,
                       mesh=make_mesh(n_data, n_seed,
                                      [CPU] * (n_data * n_seed)))
    packed = jm.engine.pack_query_windows(map_windows(genome))
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    (h_r, p_r), (h_g, p_g) = map_both(jm.engine, te, packed, base_min,
                                      pair_budget=3)
    np.testing.assert_array_equal(h_r, h_g)
    np.testing.assert_array_equal(p_r, p_g)
    M = packed[0].shape[0]
    per_block = captured.padded_rows(M, n_data) // n_data
    assert te.reruns["pair_budget"] == -(-M // per_block)


@pytest.mark.parametrize("route", ["_fused_map_bd", "_fused_map_bc"])
@pytest.mark.parametrize("pair_budget", [0, 6])
def test_binned_map_dispatch_matches_jax(monkeypatch, escalation_genome,
                                         route, pair_budget):
    """The binned gate on windows whose most passing bins exceed the
    starting width 8 (the planted repeat): collect re-runs at the width
    the JAX doubling ends on, with the pair budget too when it is 6."""
    genome, reads_ = escalation_genome
    jm, tm = build_both(genome, monkeypatch)
    wins = [r.subsequence(0, 1000) for r in reads_]
    wins += [r.subsequence(len(r) - 1000, len(r)) for r in reads_]
    packed = jm.engine.pack_query_windows(wins)
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    if route == "_fused_map_bc":
        packed = packed[:6]
    tm.engine.routes.clear()
    tm.engine.bins.clear()
    (h_r, p_r), (h_g, p_g) = map_both(jm.engine, tm.engine, packed,
                                      base_min, pair_budget=pair_budget)
    assert dict(tm.engine.routes) == {route: 1}
    np.testing.assert_array_equal(h_r, h_g)
    np.testing.assert_array_equal(p_r, p_g)
    ((n_bin, BB),) = tm.engine.bins
    assert n_bin > 8 and BB == tme._bb_final(n_bin, 8, tm.engine._NB)
    # the first re-run fixes BB (and grows the budget to the count at
    # width 8); a wider selection may pass more pairs than that
    cause = "pair_budget+BB" if pair_budget else "BB"
    assert tm.engine.reruns[cause] == 1
    assert set(tm.engine.reruns) <= {cause, "pair_budget"}


# -- overlap engine -----------------------------------------------------------
@pytest.mark.parametrize("pair_budget", [0, 4])
def test_overlap_dispatch_matches_jax(reads, pair_budget):
    """One overlap sub-batch at the JAX default budget and at 4 pairs:
    collect re-runs at the JAX escalation's size, and the job plan
    records the need for the next dispatch."""
    jov, jq = round_setup(reads, JaxOverlapper)
    seed_queries = [q.query for q in jq]
    base_min = np.array([int(0.25 * q.num_seeds + 0.5)
                         for q in seed_queries], np.int32)
    ref = JaxEngine(jov.index, OV_K, nq=128, nt=256).query_chains(
        seed_queries, base_min)
    eng = tme.MapEngine(jov.index, OV_K, nq=128, nt=256, device=CPU)
    plan = {}
    with no_host_reads():
        futs = eng.dispatch_chains(seed_queries, base_min,
                                   pair_budget=pair_budget, shape_plan=plan)
    assert eng.collect_chains(futs) == ref
    assert sum(len(r) for r in ref) >= 20
    assert dict(eng.reruns) == ({"pair_budget": 1} if pair_budget else {})
    assert plan["budget"] == 4096


def test_overlapper_dispatch_find_matches_jax(reads):
    """The overlapper's round dispatch reads nothing back either."""
    jov, jq = round_setup(reads, JaxOverlapper)
    tov, tq = round_setup(reads, TorchOverlapper, device="cpu")
    with no_host_reads():
        futs = tov.dispatch_find(tq)
    key = lambda m: (m.seq_a.id, m.seq_a.offset, m.seq_b.id, m.seq_b.offset,
                     m.query_id, m.rc_query, m.match_a, m.match_b)
    got = [key(m) for m in tov.collect_find(tq, futs)]
    assert got == [key(m) for m in jov.find_overlaps(jq)]
    assert len(got) >= 20 and tov.shape_plan["budget"] == 4096


# -- trim window engine -------------------------------------------------------
def test_edge_verdict_dispatch_matches_jax(engines):
    """Both sides' edge verdicts, at the default budget and at 8 pairs."""
    jt, jeng, _, teng = engines
    wins = edge_windows(np.random.default_rng(5))
    for front in (True, False):
        gm, cm = edge_mins(jt, front)
        ref = jeng.edge_verdict_collect(jeng.edge_verdict_dispatch(
            wins, front, gm, cm, EDGE_W), len(gm))
        for budget in (16384, 8):
            teng.reruns.clear()
            with no_host_reads():
                futs = teng.edge_verdict_dispatch(wins, front, gm, cm,
                                                  EDGE_W, pair_budget=budget)
            got = teng.edge_verdict_collect(futs, len(gm))
            np.testing.assert_array_equal(ref[0], got[0])
            np.testing.assert_array_equal(ref[1], got[1])
            assert teng.reruns["edge"] == (budget == 8)
        assert got[0][:, 0].sum() >= 10


@pytest.mark.parametrize("pair_budget", [0, 8])
def test_window_verdict_dispatch_matches_jax(engines, pair_budget):
    """The middle pass in batches of 16 windows, uploaded and dispatched
    without a read, unbudgeted and at 8 pairs."""
    jt, jeng, tt, teng = engines
    rows = mid_windows(np.random.default_rng(7))
    mm = jt._mid_min_matches()
    ref = jeng.window_verdict_collect(jeng.window_verdict_dispatch(
        rows, mm, mm, jt.mid_threshold, MID_W, batch=16))
    teng.reruns.clear()
    with no_host_reads():
        futs = teng.window_verdict_dispatch(
            rows, mm, mm, tt.mid_threshold, MID_W, batch=16,
            pair_budget=pair_budget)
    np.testing.assert_array_equal(ref, teng.window_verdict_collect(futs))
    assert len(ref) >= 20
    assert (teng.reruns["middle_pair_budget"] > 0) == (pair_budget > 0)


def test_detection_budget_truncates_as_jax(engines):
    """Above ``4 * det_budget`` detections in a batch the JAX collect keeps
    the first ``4 * det_budget`` rows of the re-run; the port keeps the
    same rows, where it used to return every detection."""
    jt, jeng, tt, teng = engines
    rows = mid_windows(np.random.default_rng(7))
    mm = jt._mid_min_matches()
    every = teng.window_verdict_collect(teng.window_verdict_dispatch(
        rows, mm, mm, tt.mid_threshold, MID_W))
    ref = jeng.window_verdict_collect(jeng.window_verdict_dispatch(
        rows, mm, mm, jt.mid_threshold, MID_W, det_budget=2))
    teng.reruns.clear()
    got = teng.window_verdict_collect(teng.window_verdict_dispatch(
        rows, mm, mm, tt.mid_threshold, MID_W, det_budget=2))
    np.testing.assert_array_equal(ref, got)
    assert len(got) == 8 < len(every)
    np.testing.assert_array_equal(got, every[:8])
    assert teng.reruns["middle_det_budget"] == 1


@pytest.mark.parametrize("chain_len", [1, 5, 64, 128])
def test_walk_back_matches_the_sequential_walk(chain_len):
    """The overlap engine's pointer-doubling walk against the JAX
    engine's ``chain_len`` sequential backpointer steps, on random
    backpointer forests: chains longer and shorter than ``chain_len``,
    rows with no start."""
    rng = np.random.default_rng(chain_len)
    P, A = 40, 96
    bp = np.full((P, A), -1, np.int32)
    for r in range(P):
        for t in range(1, A):
            if rng.random() < 0.9:
                bp[r, t] = rng.integers(max(0, t - 3), t)
    qi = rng.integers(0, 64, (P, A)).astype(np.int32)
    tj = rng.integers(0, 300, (P, A)).astype(np.int32)
    start = rng.integers(0, A, P)
    start[:3] = -1
    cqs, cts, a = [], [], start.copy()
    for _ in range(chain_len):
        on = a >= 0
        ac = np.maximum(a, 0)
        cqs.append(np.where(on, qi[np.arange(P), ac], -1))
        cts.append(np.where(on, tj[np.arange(P), ac], -1))
        a = np.where(on, bp[np.arange(P), ac], -1)
    cq, ct = tme._walk_back(torch.from_numpy(start), torch.from_numpy(bp),
                            torch.from_numpy(qi), torch.from_numpy(tj),
                            chain_len)
    ref = np.stack(cqs, 1)
    np.testing.assert_array_equal(ref, cq.numpy())
    np.testing.assert_array_equal(np.stack(cts, 1), ct.numpy())
    # empty walks, walks that end early and, short, ones that run through
    assert (ref[:3] == -1).all()
    assert ((ref[:, -1] == -1).sum() > 3) == (chain_len > 1)
    assert (ref[:, -1] >= 0).any() == (chain_len <= 5)


@pytest.mark.parametrize("live_every", [1, 3, 0])
def test_anchors_of_slots_builds_what_the_card_builds(live_every):
    """On the CPU only the live slots are built; the dead ones get the
    anchors that building them (as on a card) gives: empty."""
    from downpore_tpu_torch.ops import chain as tchain
    rng = np.random.default_rng(live_every)
    P, NQ, NT = 12, 6, 20
    qs = torch.from_numpy(rng.integers(0, 9, (P, NQ)).astype(np.int32))
    ts = torch.from_numpy(rng.integers(0, 9, (P, NT)).astype(np.int32))
    qp = torch.from_numpy(rng.integers(0, 500, (P, NQ)).astype(np.int32))
    tp = torch.from_numpy(rng.integers(0, 500, (P, NT)).astype(np.int32))
    live = (torch.arange(P) % live_every == 0) if live_every \
        else torch.zeros(P, dtype=torch.bool)

    def build(rows):
        idx = torch.arange(P) if rows is None else rows
        return tchain.make_anchors_topk(
            torch.where(live[idx, None], qs[idx], -1), qp[idx], ts[idx],
            tp[idx], per_seed=2)
    every = build(None)
    got = tchain.anchors_of_slots(live, build)
    assert got.keys() == every.keys()
    for key in every:
        assert got[key].dtype == every[key].dtype
        assert torch.equal(got[key], every[key]), key
    assert bool(every["valid"].any()) == (live_every > 0)
