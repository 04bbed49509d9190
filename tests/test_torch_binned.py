"""Parity of the port's two-level binned retrieval gate
(``downpore_tpu_torch.ops.map_engine``, binned mode) with the JAX package's,
on the CPU.

Both packages' ``_BINNED_MIN_C`` / ``_BINNED_CB`` are patched to toy scale
(16 chunks, bins of 8) on the recipes of test_binned.py.  The port is held
to the JAX binned engine, not to its own flat gate (under hashing the two
gates may differ): ``map_batch`` PAF, the collected raw ``(head, summary)``
of ``dispatch_packed`` on both binned routes, the resident state, and the
gate's functions on seeded inputs must be exactly equal (tolerance 0: all
quantities are integers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downpore_tpu.core import Sequence
from downpore_tpu.mapping import Mapper as JaxMapper
from downpore_tpu.ops import map_engine as jme
from downpore_tpu.ops import match as jmatch
from downpore_tpu.utils import kmer_occurrences
from downpore_tpu.utils.kmers import score_seed_values
from downpore_tpu_torch.mapping import Mapper as TorchMapper
from downpore_tpu_torch.ops import cuda_counts
from downpore_tpu_torch.ops import map_engine as tme
from downpore_tpu_torch.ops import match as tmatch
from test_binned import _mutate, _rand_seq, _reads

torch.set_num_threads(2)

K = 11
CPU = torch.device("cpu")


def patch_toy(monkeypatch):
    for mod in (jme, tme):
        monkeypatch.setattr(mod, "_BINNED_MIN_C", 16)
        monkeypatch.setattr(mod, "_BINNED_CB", 8)


def build_both(genome, monkeypatch, chunk_size=2000):
    """The JAX and the port's binned mapper on one genome (test_binned.py's
    ``_build``)."""
    patch_toy(monkeypatch)
    ref = Sequence.from_string(genome, id=0, name="ref")
    values = score_seed_values(kmer_occurrences([ref], K), K)
    args = (ref, False, K, values, 40, 1000, chunk_size)
    jm, tm = JaxMapper(*args), TorchMapper(*args, device=CPU)
    assert jm.engine._binned and tm.engine._binned
    return jm, tm


def paf(mapper, results):
    return [mapper.as_string(m) for ms in results for m in ms]


def state(eng, key):
    v = getattr(eng, key)
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


@pytest.fixture
def escalation_genome():
    """test_binned.py's BB-escalation genome: a 1.5 kb repeat planted at 12
    loci between random 18 kb stretches (the selection width starts at
    8), with its reads and a read lying inside the repeat."""
    rng = np.random.default_rng(21)
    repeat = _rand_seq(rng, 1500)
    parts = []
    for _ in range(12):
        parts.append(_rand_seq(rng, 18_000))
        parts.append(repeat)
    parts.append(_rand_seq(rng, 18_000))
    genome = "".join(parts)
    rr = np.random.default_rng(22)
    reads = _reads(rr, genome, 12)
    reads.append(Sequence.from_string(_mutate(rr, repeat[100:1400], 0.02),
                                      id=98, name="rep"))
    return genome, reads


def test_binned_map_batch_matches_jax(monkeypatch):
    rng = np.random.default_rng(11)
    genome = _rand_seq(rng, 150_000)
    reads = _reads(np.random.default_rng(12), genome, 24)
    jm, tm = build_both(genome, monkeypatch)
    assert tm.engine._NB >= 4
    ref = paf(jm, jm.map_batch(reads))
    got = paf(tm, tm.map_batch(reads))
    assert got == ref
    assert len(got) >= 20
    assert set(tm.engine.routes) == {"_fused_map_bd"}


def test_binned_bb_escalation_matches_jax(monkeypatch, escalation_genome):
    genome, reads = escalation_genome
    jm, tm = build_both(genome, monkeypatch)
    assert tm.engine._NB > 8 and tm.engine._BB == 8
    ref = paf(jm, jm.map_batch(reads))
    got = paf(tm, tm.map_batch(reads))
    assert got == ref
    # the repeat read's rows pass more bins than the starting width
    widths = {bb for _, bb in tm.engine.bins}
    assert max(n for n, _ in tm.engine.bins) > 8 and max(widths) > 8
    assert any("rep" in line for line in got)


def dispatch_pair(jm, tm, windows, shipped):
    out = []
    torch_rows = tme.WindowRows.cut(windows, 0, [len(w) for w in windows])
    for eng, wins in ((jm.engine, windows), (tm.engine, torch_rows)):
        packed = eng.pack_query_windows(wins)
        base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
        if shipped:
            packed = packed[:6]          # no num_seeds: buckets shipped
        out.append(eng.collect_arrays_many(
            [eng.dispatch_packed(packed, base_min)])[0])
    return out


@pytest.mark.parametrize("route", ["_fused_map_bd", "_fused_map_bc"])
def test_binned_dispatch_matches_jax(monkeypatch, escalation_genome, route):
    """Raw collected rows of both binned routes, on windows of the
    escalation genome's reads (the repeat read escalates BB)."""
    genome, reads = escalation_genome
    jm, tm = build_both(genome, monkeypatch)
    windows = []
    for r in reads:
        windows.append(r.subsequence(0, 1000))
        windows.append(r.subsequence(len(r) - 1000, len(r)))
    tm.engine.routes.clear()
    (h_r, p_r), (h_g, p_g) = dispatch_pair(jm, tm, windows,
                                           route == "_fused_map_bc")
    assert dict(tm.engine.routes) == {route: 1}
    np.testing.assert_array_equal(h_r, h_g)
    np.testing.assert_array_equal(p_r, p_g)
    assert h_g.dtype == np.int32 and p_g.dtype == np.int32
    assert h_g.shape[0] > 0
    assert max(n for n, _ in tm.engine.bins) > 8


@pytest.mark.parametrize("key", ["_perm", "membership", "t_seeds", "t_pos",
                                 "bin_mem1", "bin_mem2", "chunk_off",
                                 "chunk_len"])
def test_binned_resident_state_matches_jax(monkeypatch, key):
    genome = _rand_seq(np.random.default_rng(31), 120_000)
    jm, tm = build_both(genome, monkeypatch)
    ref, got = state(jm.engine, key), state(tm.engine, key)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(ref, got)
    for attr in ("H", "H1", "_hashed", "_hashed1", "_NB", "_CB", "_BB"):
        assert getattr(tm.engine, attr) == getattr(jm.engine, attr), attr


def test_binned_truncated_tables_match_jax(monkeypatch):
    """Chunk tables narrower than the chunks' seed lists: the bin matrices
    come from the host-built membership (H space), in permuted order."""
    patch_toy(monkeypatch)
    genome = _rand_seq(np.random.default_rng(32), 120_000)
    ref = Sequence.from_string(genome, id=0, name="ref")
    values = score_seed_values(kmer_occurrences([ref], K), K)
    index = JaxMapper(ref, False, K, values, 40, 1000, 2000).index
    nt = 32
    assert max(s.num_seeds for s in index.sequences) > nt
    je = jme.MapEngine(index, K, nq=64, nt=nt, lean=True, binned=True)
    te = tme.MapEngine(index, K, nq=64, nt=nt, lean=True, binned=True,
                       device=CPU)
    assert te._binned and te.H1 == te.H
    for key in ("membership", "t_seeds", "bin_mem1", "bin_mem2"):
        np.testing.assert_array_equal(state(je, key), state(te, key),
                                      err_msg=key)


def test_binned_hashed_matches_jax(monkeypatch):
    """Forced-hash regime with H1 > H (test_binned.py's recall test): the
    port equals the JAX engine exactly, and every planted read but one
    still maps to its locus."""
    orig = jmatch.choose_hash_size

    def forced(n, max_h=1 << 17):
        return orig(n, 512 if max_h == 1 << 17 else 4096)

    monkeypatch.setattr(jmatch, "choose_hash_size", forced)
    monkeypatch.setattr(tmatch, "choose_hash_size", forced)
    genome = _rand_seq(np.random.default_rng(41), 200_000)
    jm, tm = build_both(genome, monkeypatch)
    eng = tm.engine
    assert eng._hashed and eng.H == 512 and eng.H1 == 4096 and eng._hashed1
    for key in ("membership", "bin_mem1", "bin_mem2"):
        np.testing.assert_array_equal(state(jm.engine, key), state(eng, key))
    reads = _reads(np.random.default_rng(42), genome, 16)
    ref = jm.map_batch(reads)
    got = tm.map_batch(reads)
    assert paf(tm, got) == paf(jm, ref)
    placed = sum(any(m.ids > 50 for m in ms) for ms in got)
    assert placed >= 15


def test_binned_load_state_from_jax(monkeypatch, escalation_genome):
    genome, reads = escalation_genome
    jm, tm = build_both(genome, monkeypatch)
    je = jm.engine
    fresh = tme.MapEngine(jm.index, K, nq=je.nq, nt=je.nt, lean=True,
                          binned=True, device=CPU)
    fresh.bin_mem1 = torch.zeros_like(fresh.bin_mem1)
    fresh.membership.zero_()
    keys = tme.MapEngine.STATE_KEYS + tme.MapEngine.BINNED_STATE_KEYS
    fresh.load_state({key: state(je, key) for key in keys})
    for key in keys:
        np.testing.assert_array_equal(state(je, key), state(fresh, key))
    tm.engine = fresh
    assert paf(tm, tm.map_batch(reads)) == paf(jm, jm.map_batch(reads))
    with pytest.raises(KeyError):
        fresh.load_state({key: state(je, key)
                          for key in tme.MapEngine.STATE_KEYS})


# -- the gate's functions on seeded inputs ------------------------------

def test_derive_bin_mem_matches_jax():
    rng = np.random.default_rng(5)
    H, NB, CB = 64, 6, 8
    mem = (rng.random((H, NB * CB)) < 0.05).astype(np.int8)
    ref = np.asarray(jme._derive_bin_mem(jnp.asarray(mem), NB=NB, CB=CB))
    got = tme._derive_bin_mem(torch.from_numpy(mem), NB, CB)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(ref, got.numpy())
    assert 0 < ref.sum() < ref.size


@pytest.mark.parametrize("hashed1", [False, True])
def test_derive_bin_mem_direct_matches_jax(hashed1):
    rng = np.random.default_rng(6)
    CP, nt, NB, CB = 48, 30, 6, 8
    S = 5000 if hashed1 else 1000
    H1 = 1024
    t_seeds = rng.integers(0, S, (CP, nt)).astype(np.int32)
    t_seeds[rng.random((CP, nt)) < 0.3] = -1
    ref = np.asarray(jme._derive_bin_mem_direct(
        jnp.asarray(t_seeds), H1=H1, NB=NB, CB=CB, hashed1=hashed1))
    got = tme._derive_bin_mem_direct(torch.from_numpy(t_seeds), H1, NB, CB,
                                     hashed1)
    np.testing.assert_array_equal(ref, got.numpy())


def gate_inputs(seed=7, M=24, R=12, H=96, NB=10, CB=8, C=75):
    """Seeded toy gate inputs: a sparse membership with a few dense rows
    (many passing bins, tied bin counts), run buckets with duplicate slots
    masked in the distinct buckets, thresholds low enough that rows pass
    several bins."""
    rng = np.random.default_rng(seed)
    mem = (rng.random((H, NB * CB)) < 0.08).astype(np.int8)
    mem[:6] = (rng.random((6, NB * CB)) < 0.7)      # widely shared buckets
    mem[:, C:] = 0                                  # padding chunks
    rb = rng.integers(0, H, (M, R)).astype(np.int32)
    rb[:M // 2, :4] = rng.integers(0, 6, (M // 2, 4))
    rb[rng.random((M, R)) < 0.2] = -1
    db = rb.copy()
    for i in range(M):
        seen = set()
        for j in range(R):
            if db[i, j] in seen:
                db[i, j] = -1
            elif db[i, j] >= 0:
                seen.add(int(db[i, j]))
    min_count = rng.integers(1, 4, M).astype(np.int32)
    min_count[3] = 0                                # a row with no gate
    base_min = rng.integers(1, 3, M).astype(np.int32)
    return mem, rb, db, min_count, base_min


@pytest.mark.parametrize("bound", [None, "lowered"])
def test_binned_counts_pair_matches_jax(monkeypatch, bound):
    mem, rb, db, _, _ = gate_inputs()
    H, NB, CB, BB = mem.shape[0], 10, 8, 4
    rng = np.random.default_rng(8)
    topbin = np.stack([rng.permutation(NB)[:BB] for _ in range(rb.shape[0])]
                      ).astype(np.int32)
    flat = mem.reshape(H * NB, CB)
    c_r, d_r = jme._binned_counts_pair(jnp.asarray(flat), jnp.asarray(rb),
                                       jnp.asarray(db >= 0),
                                       jnp.asarray(topbin), NB, CB)
    if bound:
        monkeypatch.setattr(cuda_counts, "_GATHER_ELEMS", 8 * rb.shape[1] * BB * CB)
        assert len(cuda_counts._row_chunks(rb.shape[0], rb.shape[1], BB * CB)) == 3
    args = (torch.from_numpy(flat), torch.from_numpy(rb))
    c_g, d_g = tme._binned_counts_pair(*args, torch.from_numpy(db >= 0),
                                       torch.from_numpy(topbin), NB, CB)
    np.testing.assert_array_equal(np.asarray(c_r), c_g.numpy())
    np.testing.assert_array_equal(np.asarray(d_r), d_g.numpy())
    c_only, none = tme._binned_counts_pair(*args, None,
                                           torch.from_numpy(topbin), NB, CB)
    assert none is None and torch.equal(c_only, c_g)


@pytest.mark.parametrize("aligned_db", [True, False])
def test_binned_gate_matches_jax(aligned_db):
    """Level-1 gate, ``n_bin``, the top-BB selection with tied bin counts,
    the fine gate and the (row, bin rank, lane) compaction, against the
    JAX gate run at the width the port's escalation ends on."""
    mem, rb, db, min_count, base_min = gate_inputs()
    H, NB, CB, C = mem.shape[0], 10, 8, 75
    jmem = jnp.asarray(mem)
    bin_mem = np.array(jme._derive_bin_mem(jmem, NB=NB, CB=CB))
    if not aligned_db:                 # host layout: sorted distinct slots
        db = np.sort(np.where(db >= 0, db, 1 << 30), axis=1)
        db = np.where(db < (1 << 30), db, -1).astype(np.int32)
    t = [torch.from_numpy(a) for a in (mem, bin_mem, rb, db, rb, db,
                                       min_count, base_min)]
    # the dispatch's width drops bins; the collect's re-run width does not
    n_bin = int(tme._binned_gate(*t, NB=NB, CB=CB, BB=2, C=C,
                                 pair_budget=4096, aligned_db=aligned_db)[5])
    BB = tme._bb_final(n_bin, 2, NB)
    assert n_bin > 2 and BB >= n_bin
    # a budget of every (row, selected bin, lane) slot: the most that
    # can pass at this width
    B = rb.shape[0] * BB * CB
    mi, ci, dc, live, n_ok, n_bin2 = tme._binned_gate(
        *t, NB=NB, CB=CB, BB=BB, C=C, pair_budget=B, aligned_db=aligned_db)
    assert int(n_bin2) == n_bin and int(n_ok) == int(live.sum())
    # some row has passing bins of tied run counts
    c1 = tme._count_rows(t[1], t[4]).numpy()
    d1 = tme._count_rows(t[1], t[5]).numpy()
    okb = (c1 >= min_count[:, None]) & (d1 >= base_min[:, None]) \
        & (min_count[:, None] > 0)
    assert any(len(set(c[o])) < o.sum() for c, o in zip(c1, okb))
    j = [jnp.asarray(a) for a in (mem, bin_mem, rb, db, rb, db, min_count,
                                  base_min)]
    ref = jme._binned_gate(*j, NB=NB, CB=CB, BB=BB, C=C, pair_budget=B,
                           aligned_db=aligned_db)
    r_mi, r_ci, r_dc, r_live, r_n_ok, r_nbin = (np.asarray(a) for a in ref)
    assert int(r_nbin) == n_bin and int(r_n_ok) == int(n_ok) > 0
    # every budget slot, the dead ones (row 0, chunk 0) included
    for r, g in ((r_mi, mi), (r_ci, ci), (r_dc, dc), (r_live, live)):
        np.testing.assert_array_equal(r, g.numpy())
    assert int(ci.max()) < C


def test_bb_final_follows_the_jax_ladder():
    assert tme._bb_final(0, 8, 56) == 8
    assert tme._bb_final(8, 8, 56) == 8
    assert tme._bb_final(9, 8, 56) == 16
    assert tme._bb_final(33, 8, 56) == 56
    assert tme._bb_final(3, 3, 3) == 3


def test_binned_at_full_thresholds():
    """Unpatched thresholds (1024 chunks, bins of 128): a 2.1 Mb genome cut
    into 2 kb chunks engages the binned gate, and the port maps like the
    JAX engine."""
    genome = _rand_seq(np.random.default_rng(51), 2_100_000)
    ref = Sequence.from_string(genome, id=0, name="ref")
    values = score_seed_values(kmer_occurrences([ref], K), K)
    args = (ref, False, K, values, 40, 1000, 2000)
    jm = JaxMapper(*args)
    tm = TorchMapper(*args, device=CPU)
    eng = tm.engine
    assert eng._binned and eng.C >= 1024 and eng._CB == 128
    np.testing.assert_array_equal(state(jm.engine, "bin_mem1"),
                                  state(eng, "bin_mem1"))
    reads = _reads(np.random.default_rng(52), genome, 8)
    got = paf(tm, tm.map_batch(reads))
    assert got == paf(jm, jm.map_batch(reads))
    assert len(got) >= 8 and "_fused_map_bd" in eng.routes
