"""Parity of the torch port's trim window engine (``downpore_tpu_torch.ops.
window_engine``) with the JAX package's, on the CPU, at tolerance 0 (every
quantity is an integer).

The same seeded numpy windows go through each JAX function and its port:
packing and k-mer unpacking, the gate (counts per position), the top-t
adapter pick, the fused match (against the JAX budget-0 and budgeted
forms), the edge verdict (also against the JAX paired form, which the port
replaces with one verdict per side), DetermineAdapters' coverage and the
middle pass's detection rows, in order.  Cases: windows shorter than W
(some shorter than k), a window of one repeated k-mer, the bundled barcode
family (equal gate counts cut at the top-t boundary, so the tie order
decides which adapters chain), adapter tables that cannot stack (the JAX
per-side route), no enabled adapters, and more gate-passing pairs than the
JAX budgets (the JAX side re-runs unbudgeted).  Each JAX
reference is computed once, in module-scoped fixtures.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downpore_tpu.core import Sequence
from downpore_tpu.data import BACK_ADAPTERS, FRONT_ADAPTERS
from downpore_tpu.ops import window_engine as jwe
from downpore_tpu.trim.trimmer import Trimmer as JaxTrimmer
from downpore_tpu_torch.ops import window_engine as twe
from downpore_tpu_torch.trim.trimmer import Trimmer as TorchTrimmer

torch.set_num_threads(2)

K = 6
EDGE_W = 256 - K + 1
MID_W = 512 - K + 1
BASES = "ACGT"


def rand_bases(n, rng):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def mutate(s, rate, rng):
    return "".join(BASES[rng.integers(0, 4)] if rng.random() < rate else c
                   for c in s)


def as_seqs(records):
    return [Sequence.from_string(s, id=i, name=n)
            for i, (n, s) in enumerate(records)]


def edge_windows(rng):
    """Edge windows (up to 256 bases): planted bundled adapters (front
    and back, barcodes among them) at 0-5% error, random windows, short
    windows (one of 3 bases, below k) and one repeated k-mer."""
    out = []
    for i in range(40):
        n, ad = FRONT_ADAPTERS[(i * 7) % len(FRONT_ADAPTERS)] if i % 2 \
            else BACK_ADAPTERS[(i * 5) % len(BACK_ADAPTERS)]
        at = int(rng.integers(0, 150))
        s = rand_bases(at, rng) + mutate(ad, 0.05 * (i % 3 == 0), rng)
        out.append(s + rand_bases(256 - len(s), rng))
    out += [rand_bases(256, rng) for _ in range(12)]
    out += [rand_bases(n, rng) for n in (3, 6, 40, 151)]
    out.append(FRONT_ADAPTERS[12][1] + rand_bases(30, rng))
    out.append("ACGTAC" * 42)
    return [Sequence.from_string(s, id=i) for i, s in enumerate(out)]


def mid_windows(rng):
    """Interior windows (up to 512 bases) with front adapters planted at
    random offsets; some random, some short, two with two adapters."""
    out = []
    for i in range(24):
        _, ad = FRONT_ADAPTERS[(i * 11) % len(FRONT_ADAPTERS)]
        at = int(rng.integers(0, 400))
        s = rand_bases(at, rng) + mutate(ad, 0.03 * (i % 2), rng)
        out.append(s + rand_bases(512 - len(s), rng))
    out += [rand_bases(512, rng) for _ in range(6)]
    out += [FRONT_ADAPTERS[0][1] + rand_bases(70, rng), rand_bases(4, rng)]
    for a, b in ((0, 2), (40, 1)):
        s = rand_bases(30, rng) + FRONT_ADAPTERS[a][1] + rand_bases(200, rng)
        s += FRONT_ADAPTERS[b][1]
        out.append(s + rand_bases(512 - len(s), rng))
    return [Sequence.from_string(s, id=i) for i, s in enumerate(out)]


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the full bundled adapter set."""
    f, b = as_seqs(FRONT_ADAPTERS), as_seqs(BACK_ADAPTERS)
    jt = JaxTrimmer(f, b, k=K, verbosity=0)
    tt = TorchTrimmer(f, b, k=K, verbosity=0, device="cpu")
    return jt, jt._engine(), tt, tt._engine()


def edge_mins(trimmer, front=True):
    return trimmer._edge_mins(trimmer.front_sets if front
                              else trimmer.back_sets)


def side(eng, front=True):
    """A JAX engine's (km table, seeds, pos, alen, barcode flags) as numpy;
    the port engine's as tensors."""
    s = eng.front if front else eng.back
    km = eng._front_km if front else eng._back_km
    bc = eng._front_bc if front else eng._back_bc
    return (km, *s, bc)


def np_side(eng, front=True):
    return tuple(np.asarray(a) for a in side(eng, front))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def edge_batch(engines):
    """Packed edge windows from both engines' uploads, and padded
    thresholds (front side)."""
    jt, jeng, tt, teng = engines
    wins = edge_windows(np.random.default_rng(5))
    jp, jl, n = jeng.upload(wins, EDGE_W)
    tp, tl, tn = teng.upload(wins, EDGE_W)
    gm, cm = edge_mins(jt)
    jgm, jcm, _ = jeng._pad_mins(jeng._front_km, gm, cm)
    return {"wins": wins, "n": n, "tn": tn,
            "jpacked": np.asarray(jp)[:n], "jlens": np.asarray(jl)[:n],
            "packed": tp.numpy(), "lens": tl.numpy(), "gm": jgm, "cm": jcm}


def test_resident_tables_match(engines):
    jt, jeng, tt, teng = engines
    assert jeng.nq == teng.nq == 48
    for front in (True, False):
        for a, b in zip(np_side(jeng, front), side(teng, front)):
            np.testing.assert_array_equal(a, b.numpy())
            assert a.dtype == b.numpy().dtype
    # the JAX engine's stacked pair tables are the port's two sides
    assert jeng._pair_cache is not False
    for i, a in enumerate(jeng._pair_cache):
        np.testing.assert_array_equal(
            np.asarray(a), np.stack([side(teng, f)[i].numpy()
                                     for f in (True, False)]))


def test_upload_packing_matches(edge_batch):
    b = edge_batch
    assert b["n"] == b["tn"] == len(b["wins"])
    np.testing.assert_array_equal(b["jpacked"], b["packed"])
    np.testing.assert_array_equal(b["jlens"], b["lens"])
    # short windows: fewer k-mers than W, none below k
    assert sorted(b["lens"])[:3] == [0, 1, 35]


def test_unpack_kmers_matches(edge_batch):
    b = edge_batch
    ref = np.asarray(jwe._unpack_kmers(jnp.asarray(b["packed"]), K, EDGE_W))
    got = twe._unpack_kmers(t(b["packed"]), K, EDGE_W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.fixture(scope="module")
def gate(engines, edge_batch):
    """JAX and port gate counts and top-t pairs on the edge windows."""
    _, jeng, _, teng = engines
    b = edge_batch
    km = jwe._unpack_kmers(jnp.asarray(b["packed"]), K, EDGE_W)
    tkm = twe._unpack_kmers(t(b["packed"]), K, EDGE_W)
    table = np.asarray(jeng._front_km)
    ref = np.asarray(jwe._gate_counts(km, jnp.asarray(b["lens"]), table))
    got = twe._gate_counts(tkm, t(b["lens"]), teng._front_km)
    jpairs = jwe._gate_topk_pairs(km, jnp.asarray(b["lens"]), table,
                                  jnp.asarray(b["gm"]), jnp.asarray(b["cm"]),
                                  8)
    tpairs = twe._gate_topk_pairs(tkm, t(b["lens"]), teng._front_km,
                                  t(b["gm"]), t(b["cm"]), 8)
    return ref, got, jpairs, tpairs


def test_gate_counts_match(gate, engines, edge_batch):
    ref, got, _, _ = gate
    np.testing.assert_array_equal(ref, got.numpy())
    # the engine's entry point, on both sides
    _, jeng, _, teng = engines
    b = edge_batch
    for front in (True, False):
        np.testing.assert_array_equal(
            jeng.gate(jnp.asarray(b["packed"]), jnp.asarray(b["lens"]),
                      front, b["n"], EDGE_W),
            teng.gate(t(b["packed"]), t(b["lens"]), front, b["n"], EDGE_W))
    # counts per position: the repeated-k-mer window counts its k-mer
    # once per occurrence
    rep = got[-1]
    assert int(rep.max()) > 6


def test_gate_topk_pairs_tie_order(gate):
    ref_counts, _, jpairs, tpairs = gate
    for a, b in zip(jpairs, tpairs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the barcode family's equal counts straddle the top-8 cut in some
    # windows, so the tie order picks the adapters that chain
    srt = -np.sort(-ref_counts, axis=1)
    assert ((srt[:, 7] == srt[:, 8]) & (srt[:, 7] > 0)).sum() >= 5


def test_fused_match_matches_both_jax_forms(engines, edge_batch):
    _, jeng, _, teng = engines
    b = edge_batch
    gm = b["gm"].copy()
    gm[:] = np.minimum(gm, 2)           # permissive gate: many pairs chain
    jargs = (jnp.asarray(b["packed"]), jnp.asarray(b["lens"]),
             *np_side(jeng)[:1], gm, b["cm"], *np_side(jeng)[1:4])
    targs = (t(b["packed"]), t(b["lens"]), teng._front_km, t(gm),
             t(b["cm"]), *teng.front)
    got = twe._fused_match(*targs, K, EDGE_W, top_t=4).numpy()
    full = np.asarray(jwe._fused_match(*jargs, k=K, W=EDGE_W,
                                       max_anchors=128, top_t=4))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(full, got)
    comp = np.asarray(jwe._fused_match(*jargs, k=K, W=EDGE_W,
                                       max_anchors=128, top_t=4,
                                       pair_budget=1024))
    n_ok = int(comp[-1, 0])
    assert 0 < n_ok <= 1024
    rows = comp[:-1][comp[:-1, 0] >= 0]
    flat = got.reshape(-1, got.shape[2])
    assert len(rows) == n_ok
    np.testing.assert_array_equal(rows[:, 1], flat[rows[:, 0], 0])
    np.testing.assert_array_equal(rows[:, 2:], flat[rows[:, 0], 1:])


@pytest.fixture(scope="module")
def edge_verdicts(engines, edge_batch):
    """JAX edge verdicts, unbudgeted and compacted to a budget that holds
    every passing pair, and the port's in both forms."""
    _, jeng, _, teng = engines
    b = edge_batch
    jargs = (jnp.asarray(b["packed"]), jnp.asarray(b["lens"]),
             np_side(jeng)[0], b["gm"], b["cm"], *np_side(jeng)[1:])
    kw = dict(k=K, W=EDGE_W, max_anchors=128, top_t=8)
    full = [np.asarray(x) for x in jwe._fused_edge_verdict(*jargs, **kw)]
    budgeted = [np.asarray(x) for x in jwe._fused_edge_verdict(
        *jargs, pair_budget=2048, **kw)]
    got = [[x.numpy() for x in twe._fused_edge_verdict(
        t(b["packed"]), t(b["lens"]), *side(teng)[:1], t(b["gm"]),
        t(b["cm"]), *side(teng)[1:], K, EDGE_W, top_t=8, pair_budget=pb)]
        for pb in (0, 2048)]
    return full, budgeted, got


def test_fused_edge_verdict_matches(edge_verdicts):
    (v, c, n_ok), (bv, bc, bn_ok), ((tv, tc, tn), (tbv, tbc, tbn)) = \
        edge_verdicts
    np.testing.assert_array_equal(v, tv)
    np.testing.assert_array_equal(c, tc)
    assert int(n_ok) == int(bn_ok) == int(tn) == int(tbn) <= 2048
    np.testing.assert_array_equal(bv, tv)
    np.testing.assert_array_equal(bc, tc)
    np.testing.assert_array_equal(bv, tbv)
    np.testing.assert_array_equal(bc, tbc)
    # windows found adapters, some as barcodes, and counts landed only
    # on real adapter columns
    assert v[:, 0].sum() >= 30
    assert tc[len(FRONT_ADAPTERS):].sum() == 0 and tc.sum() > 0


def test_fused_edge_pair_matches(engines, edge_batch):
    """The JAX paired form (both sides stacked, one call) against the
    port's verdict of each side."""
    jt, jeng, tt, teng = engines
    b = edge_batch
    rng = np.random.default_rng(6)
    backs = edge_windows(rng)[::-1]
    bp, bl = twe._pack_windows(backs, EDGE_W, K)
    gmb, cmb = edge_mins(jt, front=False)
    jgmb, jcmb, _ = jeng._pad_mins(jeng._back_km, gmb, cmb)
    packed2 = np.stack([b["packed"], bp])
    lens2 = np.stack([b["lens"], bl])
    gm2, cm2 = np.stack([b["gm"], jgmb]), np.stack([b["cm"], jcmb])
    ref = jwe._fused_edge_pair(jnp.asarray(packed2), jnp.asarray(lens2),
                               jeng._pair_cache[0], gm2, cm2,
                               *jeng._pair_cache[1:], k=K, W=EDGE_W,
                               max_anchors=128, top_t=8)
    for i, front in enumerate((True, False)):
        km, *tables = side(teng, front)
        got = twe._fused_edge_verdict(t(packed2[i]), t(lens2[i]), km,
                                      t(gm2[i]), t(cm2[i]), *tables, K,
                                      EDGE_W, top_t=8)
        np.testing.assert_array_equal(np.asarray(ref[0])[i], got[0].numpy())
        np.testing.assert_array_equal(np.asarray(ref[1])[i], got[1].numpy())
    assert got[0][:, 0].sum() >= 30


def test_fused_enable_matches(engines, edge_batch):
    """DetermineAdapters' thresholds (half the adapter's seed set, enabled
    adapters gated off with 1 << 20)."""
    jt, jeng, _, teng = engines
    b = edge_batch
    mh = np.maximum(np.array([len(s) // 2 for s in jt.front_sets]), 1)
    gm = mh.copy()
    gm[[0, 3, 12]] = 1 << 20
    jgm, jcm, _ = jeng._pad_mins(jeng._front_km, gm, mh)
    jargs = (jnp.asarray(b["packed"]), jnp.asarray(b["lens"]),
             np_side(jeng)[0], jgm, jcm, *np_side(jeng)[1:4])
    kw = dict(k=K, W=EDGE_W, max_anchors=128, top_t=8)
    covs, n_ok = jwe._fused_enable(*jargs, **kw)
    got, got_n = twe._fused_enable(t(b["packed"]), t(b["lens"]),
                                   teng._front_km, t(jgm), t(jcm),
                                   *teng.front, K, EDGE_W, top_t=8)
    np.testing.assert_array_equal(np.asarray(covs), got.numpy())
    assert int(got_n) == int(n_ok) > 0
    assert int(got.max()) >= 20 and int(got[12]) == 0


@pytest.fixture(scope="module")
def mid_batch(engines):
    jt, jeng, tt, teng = engines
    wins = mid_windows(np.random.default_rng(7))
    p, l = twe._pack_windows(wins, MID_W, K)
    mm = jt._mid_min_matches()
    gm, cm, _ = jeng._pad_mins(jeng._front_km, mm, mm)
    jargs = (jnp.asarray(p), jnp.asarray(l), np_side(jeng)[0], gm, cm,
             *np_side(jeng)[1:4], jnp.int32(jt.mid_threshold))
    kw = dict(k=K, W=MID_W, max_anchors=128, top_t=8)
    full = np.asarray(jwe._fused_window_verdict(*jargs, **kw))
    budgeted = np.asarray(jwe._fused_window_verdict(*jargs, pair_budget=256,
                                                    **kw))
    got = [twe._fused_window_verdict(t(p), t(l), teng._front_km, t(gm),
                                     t(cm), *teng.front, tt.mid_threshold,
                                     K, MID_W, top_t=8,
                                     pair_budget=pb).numpy()
           for pb in (0, 256)]
    return full, budgeted, got


def detection_rows(arr):
    """The detection rows of a ``[det_budget + 1, 4]`` verdict block."""
    return arr[:-1][arr[:-1, 0] >= 0]


def test_fused_window_verdict_rows_in_order(mid_batch):
    """Both forms in the JAX layout, the trailing (passing pairs,
    detections) row included."""
    full, budgeted, (got, got_b) = mid_batch
    n_det = int(full[-1, 1])
    rows = detection_rows(full)
    assert len(rows) == n_det >= 20
    assert got.dtype == np.int32 and got.shape == full.shape
    np.testing.assert_array_equal(full, got)
    assert 0 < int(budgeted[-1, 0]) <= 256
    np.testing.assert_array_equal(budgeted, got_b)
    np.testing.assert_array_equal(detection_rows(budgeted), rows)
    # several adapters of one window detected, in (pair, rank) order
    assert len(np.unique(rows[:, 0])) < len(rows)


# -- engine entry points ---------------------------------------------------
def _edges_both(jeng, teng, wins, front, gm, cm, budget):
    ref = jeng.edge_verdict_collect(jeng.edge_verdict_dispatch(
        wins, front, gm, cm, EDGE_W, pair_budget=budget), len(gm))
    got = teng.edge_verdict_collect(teng.edge_verdict_dispatch(
        wins, front, gm, cm, EDGE_W, pair_budget=budget), len(gm))
    return ref, got


def test_engine_budget_overflow_reruns_match(engines, edge_batch,
                                             mid_batch):
    """More gate-passing pairs than the budgets (8): both engines re-run
    each batch unbudgeted at collect.  Same results."""
    jt, jeng, tt, teng = engines
    teng.reruns.clear()
    wins = edge_batch["wins"]
    gm, cm = edge_mins(jt)
    (rv, rc), (gv, gc) = _edges_both(jeng, teng, wins, True, gm, cm, 8)
    np.testing.assert_array_equal(rv, gv)
    np.testing.assert_array_equal(rc, gc)
    mh = np.maximum(np.array([len(s) // 2 for s in jt.front_sets]), 1)
    np.testing.assert_array_equal(
        jeng.enable_covs(wins, True, mh, mh, EDGE_W, pair_budget=8),
        teng.enable_covs(wins, True, mh, mh, EDGE_W, pair_budget=8))
    rows = mid_windows(np.random.default_rng(7))
    mm = jt._mid_min_matches()
    ref = jeng.window_verdict_collect(jeng.window_verdict_dispatch(
        rows, mm, mm, jt.mid_threshold, MID_W, pair_budget=8, batch=16))
    got = teng.window_verdict_collect(teng.window_verdict_dispatch(
        rows, mm, mm, tt.mid_threshold, MID_W, pair_budget=8, batch=16))
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(got, detection_rows(mid_batch[0]))
    assert teng.reruns["edge"] > 0 and teng.reruns["enable"] > 0
    assert teng.reruns["middle_pair_budget"] > 0


def test_engine_match_rows_match(engines, edge_batch):
    jt, jeng, _, teng = engines
    wins = edge_batch["wins"]
    gm, cm = edge_mins(jt)
    ref = jeng.match(wins, True, gm, cm, EDGE_W)
    got = teng.match(wins, True, gm, cm, EDGE_W)

    def norm(rows):
        return [[(ai, {k: np.asarray(v).tolist() for k, v in s.items()})
                 for ai, s in row] for row in rows]
    assert norm(ref) == norm(got)
    assert sum(len(r) for r in got) >= 30


def test_per_side_route_when_tables_cannot_stack():
    """136 front adapters (AP 256) against 114 back (AP 128): the JAX
    engine has no stacked tables, so its paired call declines and each
    side runs alone, as every batch does in the port."""
    f = as_seqs(FRONT_ADAPTERS + BACK_ADAPTERS[:20])
    b = as_seqs(BACK_ADAPTERS)
    jt = JaxTrimmer(f, b, k=K, verbosity=0)
    tt = TorchTrimmer(f, b, k=K, verbosity=0, device="cpu")
    jeng, teng = jt._engine(), tt._engine()
    assert jeng._pair_cache is False
    assert teng._front_km.shape[1] == 256 and teng._back_km.shape[1] == 128
    gmf, cmf = edge_mins(jt)
    gmb, cmb = edge_mins(jt, front=False)
    wins = edge_windows(np.random.default_rng(8))[:24]
    assert jeng.edge_pair_dispatch(wins, wins, gmf, cmf, gmb, cmb,
                                   EDGE_W) is None
    for front, gm, cm in ((True, gmf, cmf), (False, gmb, cmb)):
        (rv, rc), (gv, gc) = _edges_both(jeng, teng, wins, front, gm, cm,
                                         16384)
        np.testing.assert_array_equal(rv, gv)
        np.testing.assert_array_equal(rc, gc)
        assert gv[:, 0].sum() > 0


def test_no_enabled_adapters(engines, edge_batch):
    """A == 0 (DetermineAdapters kept none): every entry point reports no
    matches without touching the device tables."""
    _, jeng, _, teng = engines
    wins = edge_batch["wins"][:10]
    none = np.zeros(0, np.int32)
    # (the JAX engine's match_collect cannot unpack its own A == 0 future)
    assert teng.match(wins, True, none, none, EDGE_W) == [[]] * 10
    for eng in (jeng, teng):
        v, c = eng.edge_verdict_collect(eng.edge_verdict_dispatch(
            wins, False, none, none, EDGE_W), 0)
        np.testing.assert_array_equal(v, np.zeros((10, 4), np.int32))
        assert c.shape == (0,)
        assert eng.enable_covs(wins, True, none, none, EDGE_W).shape == (0,)
        assert eng.window_verdict_collect(eng.window_verdict_dispatch(
            wins, none, none, 85, EDGE_W)).shape == (0, 4)
    assert jeng.edge_pair_dispatch(wins, wins, none, none, none, none,
                                   EDGE_W) is None
