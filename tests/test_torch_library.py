"""Parity of the port's library surface with the JAX package: the read
simulator (``sim``), the seed-query library (``ops.match``' retrieval
counts and host builders, ``ops.chain``'s ``chain_batch`` family) and the
sharded pipeline step (``parallel.mesh``).

The same numpy inputs, made from seeded generators, go through the JAX
function (on the CPU; conftest's 8 virtual devices for the meshes) and its
port on the CPU (grids of ``[cpu] * 8``).  Every comparison is exact: the
tolerance is 0.  Mirrored JAX cases: test_chain.py through the port's
``run_chain_batch`` and ``chain_pair_np``, test_seeds.py:159 and
test_parallel.py:18,29 with ``__graft_entry__._example_args``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from downpore_tpu import sim as jsim
from downpore_tpu.core import Sequence as JaxSequence
from downpore_tpu.ops import chain as jchain
from downpore_tpu.ops import match as jmatch
from downpore_tpu.parallel import mesh as jmesh
from downpore_tpu.seeds import SeedIndex as JaxSeedIndex
from downpore_tpu_torch import sim as tsim
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.ops import chain as tchain
from downpore_tpu_torch.ops import match as tmatch
from downpore_tpu_torch.parallel import make_mesh
from downpore_tpu_torch.parallel import mesh as tmesh
from downpore_tpu_torch.seeds import SeedIndex, SeedSequence

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BASES = "ACGT"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DOWNPORE_TORCH_DEVICE", "cpu")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def random_seq(n, rng):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


# ---------------------------------------------------------------------
# sim
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_generators_match_jax(seed):
    """Every generator, from the same seed, gives the JAX module's
    output and leaves the generator in the same state."""
    out = {}
    for name, mod in (("jax", jsim), ("port", tsim)):
        rng = np.random.default_rng(seed)
        g = mod.structured_genome(rng, 30_000)
        g2, s1, e1 = mod.plant_tandem_repeat(rng, g, 120, 4)
        g3, s2, e2 = mod.plant_low_complexity(rng, g2, 70, period=2)
        rng_g = mod.random_genome(rng, 500)
        read = mod.ont_read(rng, g3[1000:4000])
        lin = mod.sample_reads(rng, g3, 12, min_len=500, max_len=3000)
        circ = mod.sample_reads(rng, g3, 6, min_len=500, max_len=3000,
                                circular=True, sub_rate=0.01)
        runs = mod._homopolymer_runs(np.frombuffer(b"AAACGGTTTT", np.uint8))
        score = mod.score_mappings(lin[1], [[(s, e)] for s, e, _ in lin[1]],
                                   len(g3))
        out[name] = (g, g2, s1, e1, g3, s2, e2, rng_g, read, lin, circ,
                     runs.tolist(), score, mod.revcomp(read),
                     rng.integers(0, 1 << 30))
    assert out["jax"] == out["port"]


# ---------------------------------------------------------------------
# ops.match
# ---------------------------------------------------------------------

@pytest.mark.parametrize("Q,S,C", [(5, 64, 8), (16, 512, 64),
                                   (33, 203, 19), (0, 16, 8)])
def test_hit_counts_match_jax(Q, S, C):
    rng = np.random.default_rng(Q * 1000 + S)
    V = rng.integers(-128, 128, (Q, S)).astype(np.int8)
    M = rng.integers(0, 2, (S, C)).astype(np.int8)
    want = np.asarray(jmatch.hit_counts(V, M))
    got = tmatch.hit_counts(V, M)
    assert got.dtype == torch.int32 and got.device == CPU
    assert _same(got, want)
    assert np.array_equal(want, V.astype(np.int32) @ M.astype(np.int32))
    # tensors stay on their device; a tensor result feeds the builders
    assert _same(tmatch.hit_counts(torch.from_numpy(V), torch.from_numpy(M)),
                 want)


@pytest.mark.parametrize("Q,S,C", [(6, 64, 8), (9, 203, 17)])
def test_hit_counts_packed_match_jax(Q, S, C):
    rng = np.random.default_rng(S)
    bits = rng.integers(0, 2, (Q, S)).astype(np.uint8)
    packed = np.packbits(bits, axis=1)
    M = rng.integers(0, 2, (S, C)).astype(np.int8)
    want = np.asarray(jmatch.hit_counts_packed(packed, M))
    got = tmatch.hit_counts_packed(packed, M)
    assert _same(got, want)
    assert _same(got, tmatch.hit_counts(bits.astype(np.int8), M))


def _seed_indexes(rng, n_chunks=9, chunk=500, step=300):
    """The same index built by each package (test_seeds.py:159's recipe):
    (jax index, jax queries, port index, port queries)."""
    genome = random_seq(step * n_chunks + chunk, rng)
    foreign = random_seq(400, rng)
    built = []
    for Seq, Index in ((JaxSequence, JaxSeedIndex), (Sequence, SeedIndex)):
        idx = Index(6)
        ref = Seq.from_string(genome, id=0, name="ref")
        idx.add_single_seeds(ref, 40, np.ones(4 ** 6))
        for start in range(0, step * n_chunks, step):
            idx.add_sequence(idx.new_seed_sequence(
                ref.subsequence(start, start + chunk)))
        idx.index_sequences()
        qs = [idx.new_seed_sequence(ref.subsequence(s, s + 400))
              for s in (0, 700, 1400, 2100)]
        qs.append(idx.new_seed_sequence(Seq.from_string(
            foreign, id=9, name="foreign")))
        qs.append(idx.new_seed_sequence(Seq.from_string("ACG", id=10,
                                                        name="short")))
        built += [idx, qs]
    return built


@pytest.mark.parametrize("H", [None, 64, 256])
def test_host_builders_match_jax(H):
    jidx, jqs, tidx, tqs = _seed_indexes(np.random.default_rng(11))
    assert jidx.num_seeds == tidx.num_seeds
    lists = [s.seeds for s in tidx.sequences]
    usable = tidx._seed_counts < tidx.num_sequences
    jusable = jidx._seed_counts < jidx.num_sequences
    assert _same(tmatch.build_membership(lists, tidx.num_seeds, H),
                 jmatch.build_membership([s.seeds for s in jidx.sequences],
                                         jidx.num_seeds, H))
    for got, want in zip(
            tmatch.build_query_rows(tqs, tidx.num_seeds, usable, H),
            jmatch.build_query_rows(jqs, jidx.num_seeds, jusable, H)):
        assert _same(got, want)
    for got, want in zip(
            tmatch.build_query_matrix(tqs, tidx.num_seeds, usable),
            jmatch.build_query_matrix(jqs, jidx.num_seeds, jusable)):
        assert _same(got, want)


@pytest.mark.parametrize("hit_fraction,min_sets", [(0.25, 5), (0.5, 5),
                                                   (0.1, 40)])
def test_candidates_from_counts_match_jax(hit_fraction, min_sets):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 30, (12, 40)).astype(np.int32)
    num_sets = rng.integers(0, 60, 12).astype(np.int32)
    want = jmatch.candidates_from_counts(counts, num_sets, hit_fraction,
                                         min_sets)
    for c in (counts, torch.from_numpy(counts)):
        got = tmatch.candidates_from_counts(c, num_sets, hit_fraction,
                                            min_sets)
        assert len(got) == len(want)
        assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("hit_fraction", [0.25, 0.5])
def test_membership_retrieval_equals_matches_oracle(hit_fraction):
    """The port's ``build_membership`` + ``hit_counts`` +
    ``candidates_from_counts`` on a small ``SeedIndex`` give the
    candidates of ``SeedIndex.matches`` (test_seeds.py:159's oracle), as
    ``SeedIndex.membership``'s error message tells users to do."""
    _, _, idx, queries = _seed_indexes(np.random.default_rng(11))
    usable = idx._seed_counts < idx.num_sequences
    M = tmatch.build_membership([s.seeds for s in idx.sequences],
                                idx.num_seeds)
    V, _, num_sets = tmatch.build_query_rows(queries, idx.num_seeds, usable)
    cands = tmatch.candidates_from_counts(tmatch.hit_counts(V, M), num_sets,
                                          hit_fraction)
    n_hits = 0
    for q, c in zip(queries, cands):
        oracle = idx.matches(q, hit_fraction)
        assert np.array_equal(np.sort(c), np.sort(oracle))
        n_hits += len(c)
    assert n_hits > 0
    # the dense membership of the index gives the same counts
    Vd, _ = tmatch.build_query_matrix(queries, idx.num_seeds, usable)
    assert _same(tmatch.hit_counts(Vd, idx.membership.astype(np.int8)),
                 tmatch.hit_counts(V, M)[:, :idx.num_sequences])


# ---------------------------------------------------------------------
# ops.chain
# ---------------------------------------------------------------------

def seed_batch(rng, P, NQ, NT, alphabet=12, empty_rows=()):
    """Padded [P, N] seed/position arrays with repeated seeds, so that
    pairs have many matches (more than max_anchors for small caps)."""
    def side(n):
        s = rng.integers(0, alphabet, (P, n)).astype(np.int32)
        lens = rng.integers(n // 2, n + 1, P)
        s[np.arange(n)[None, :] >= lens[:, None]] = -1
        pos = np.cumsum(rng.integers(1, 40, (P, n)), axis=1).astype(np.int32)
        return s, np.where(s >= 0, pos, 0).astype(np.int32)
    qs, qp = side(NQ)
    ts, tp = side(NT)
    for r in empty_rows:
        qs[r] = -1
        qp[r] = 0
    return qs, qp, ts, tp


@pytest.mark.parametrize("P,NQ,NT,max_anchors",
                         [(6, 16, 24, 8), (7, 32, 32, 64), (5, 24, 40, 512),
                          (9, 12, 12, 1)])
def test_make_anchors_matches_jax(P, NQ, NT, max_anchors):
    """Row-major order, -1 fills in both qi and tj, zero positions, and
    the overflow count: small caps overflow, a large cap pads; row 0 is
    an empty pair."""
    rng = np.random.default_rng(P * NQ + max_anchors)
    qs, qp, ts, tp = seed_batch(rng, P, NQ, NT, empty_rows=(0,))
    want = jchain.make_anchors(qs, qp, ts, tp, max_anchors)
    got = tchain.make_anchors(*[torch.from_numpy(a) for a in
                                (qs, qp, ts, tp)], max_anchors)
    assert set(got) == set(want)
    for key in want:
        assert _same(got[key], want[key]), key
    assert int(want["overflow"][0]) == 0 and not want["valid"][0].any()
    if max_anchors <= 8:
        assert int(np.asarray(want["overflow"]).max()) > 0


def test_make_anchors_chunks_rows(monkeypatch):
    """Chunking the pairs (a small equality bound) changes nothing."""
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in seed_batch(rng, 11, 16, 16)]
    whole = tchain.make_anchors(*args, 32)
    monkeypatch.setattr(tchain, "_ANCHOR_ELEMS", 3 * 16 * 16)
    chunked = tchain.make_anchors(*args, 32)
    assert all(torch.equal(whole[k], chunked[k]) for k in whole)


@pytest.mark.parametrize("variant", ["extend", "aligner"])
def test_chain_batch_matches_jax(variant):
    rng = np.random.default_rng(21)
    qs, qp, ts, tp = seed_batch(rng, 8, 20, 28, empty_rows=(3,))
    want = jchain.chain_batch(qs, qp, ts, tp, k=6, max_anchors=48,
                              variant=variant)
    got = tchain.chain_batch(qs, qp, ts, tp, k=6, max_anchors=48,
                             variant=variant)
    assert set(got) == set(want)
    for key in want:
        assert _same(got[key], want[key]), key


@pytest.mark.parametrize("top_k", [2, 4])
def test_chain_batch_summary_matches_jax(top_k):
    rng = np.random.default_rng(22)
    qs, qp, ts, tp = seed_batch(rng, 10, 20, 28, alphabet=8)
    mm = rng.integers(1, 4, 10).astype(np.int32)
    alen = rng.integers(100, 400, 10).astype(np.int32)
    want = jchain.chain_batch_summary(qs, qp, ts, tp, mm, alen, k=6,
                                      max_anchors=64, top_k=top_k)
    got = tchain.chain_batch_summary(qs, qp, ts, tp, mm, alen, k=6,
                                     max_anchors=64, top_k=top_k)
    assert _same(got, want)


def _adapters(rng, Seq, Index, n=3):
    idx = Index(6)
    out = []
    for i in range(n):
        s = Seq.from_string(random_seq(int(rng.integers(30, 60)), rng),
                            id=i, name=f"a{i}")
        out.append(idx.new_all_seed_sequence(s))
    return out


def test_device_adapter_tables_match_jax():
    """The resident int16 tables and ``chain_summary_indexed``: the same
    summary rows as the JAX class, int16 targets included."""
    results = []
    for Seq, Index, mod in ((JaxSequence, JaxSeedIndex, jchain),
                            (Sequence, SeedIndex, tchain)):
        rng = np.random.default_rng(31)
        ads = _adapters(rng, Seq, Index)
        tabs = mod.DeviceAdapterTables(ads, k=6, nq=48)
        P = 11
        aidx = rng.integers(0, len(ads), P).astype(np.int32)
        mm = rng.integers(1, 4, P).astype(np.int32)
        tsl, tpl = [], []
        for i in range(P):
            src = ads[aidx[i]]
            n = int(rng.integers(0, 40))
            seeds = np.concatenate([src.seeds[:n], rng.integers(
                0, 4 ** 6, 6)]).astype(np.int32)
            pos = np.cumsum(rng.integers(1, 12, len(seeds))).astype(np.int32)
            tsl.append(seeds)
            tpl.append(pos)
        results.append(tabs.run(aidx, mm, tsl, tpl, nt=40, max_anchors=96,
                                **({"max_pairs": 8} if mod is jchain
                                   else {})))
        assert mod.DeviceAdapterTables(ads, 6, 48).run(
            [], [], [], [], 40, 96) is None
    want, got = results
    assert set(got) == set(want)
    for key in want:
        assert _same(got[key], want[key]), key
    assert want["best"].max() > 3


def _pair_lists(rng, P):
    qs, qp, ts, tp = seed_batch(rng, P, 24, 30, alphabet=10,
                                empty_rows=(1,))
    cut = lambda a, b: [a[i][b[i] >= 0] for i in range(P)]
    return cut(qs, qs), cut(qp, qs), cut(ts, ts), cut(tp, ts)


@pytest.mark.parametrize("keys", [None, ("f", "bp", "through")])
def test_run_chain_batch_matches_jax(keys):
    """More pairs than the JAX ``max_pairs``: the port runs the batch
    whole and gives the sliced JAX run's rows; lists longer than nq/nt
    are cut."""
    lists = _pair_lists(np.random.default_rng(41), 21)
    want = jchain.run_chain_batch(*lists, 6, nq=20, nt=26, max_anchors=40,
                                  max_pairs=8, keys=keys)
    got = tchain.run_chain_batch(*lists, 6, nq=20, nt=26, max_anchors=40,
                                 keys=keys)
    assert set(got) == set(want)
    for key in want:
        assert _same(got[key], want[key]), key
    assert tchain.run_chain_batch([], [], [], [], 6, 8, 8, 16) is None


def test_run_chain_summary_matches_jax():
    rng = np.random.default_rng(42)
    lists = _pair_lists(rng, 19)
    mm = rng.integers(1, 4, 19)
    alen = rng.integers(100, 900, 19)
    want = jchain.run_chain_summary(*lists, mm, alen, 6, nq=24, nt=30,
                                    max_anchors=64, max_pairs=8)
    got = tchain.run_chain_summary(*lists, mm, alen, 6, nq=24, nt=30,
                                   max_anchors=64)
    assert set(got) == set(want)
    for key in want:
        assert _same(got[key], want[key]), key


def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(43)
    lists = _pair_lists(rng, 6)
    out = tchain.run_chain_batch(*lists, 6, nq=24, nt=30, max_anchors=64)
    jout = jchain.run_chain_batch(*lists, 6, nq=24, nt=30, max_anchors=64)
    for p in range(6):
        assert tchain.extract_best_chain(out, p) \
            == jchain.extract_best_chain(jout, p)
        for mm in (1, 3, 50):
            got = tchain.good_chain_stats(out, p, mm)
            want = jchain.good_chain_stats(jout, p, mm)
            assert got[:2] == want[:2] and _same(got[2], want[2])
        qs, qp, ts, tp = (lists[i][p] for i in range(4))
        assert tchain.chain_pair_np(qs, qp, ts, tp, 6) \
            == jchain.chain_pair_np(qs, qp, ts, tp, 6)
    for gq, gt in [(-3, -2), (-3, 1), (30, 14), (30, 52), (0, -6), (9, 0)]:
        assert tchain._window_ok_np(gq, gt, 6) \
            == jchain._window_ok_np(gq, gt, 6)
    assert [tchain._bucket(n) for n in (0, 1, 8, 9, 300, 2049)] \
        == [jchain._bucket(n) for n in (0, 1, 8, 9, 300, 2049)]


# test_chain.py's cases through the port -------------------------------

def random_pair(rng, n_seeds=20, alphabet=12, mutate=0.3):
    """test_chain.py's query and noisy copy with compatible gaps."""
    seeds = rng.integers(0, alphabet, n_seeds).astype(np.int32)
    gaps = rng.integers(0, 30, n_seeds + 1).astype(np.int32)
    q = SeedSequence(gaps, seeds)
    tseeds = seeds.copy()
    repl = rng.random(n_seeds) < mutate
    tseeds[repl] = rng.integers(alphabet, alphabet * 2, repl.sum())
    tgaps = gaps.copy()
    tgaps[1:-1] = (tgaps[1:-1] * rng.uniform(0.9, 1.1, n_seeds - 1)).astype(
        np.int32)
    return q, SeedSequence(tgaps, tseeds)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_device_dp_matches_numpy_oracle(seed):
    rng = np.random.default_rng(seed)
    k = 6
    q, t = random_pair(rng)
    qp = q.seed_positions(k).astype(np.int32)
    tp = t.seed_positions(k).astype(np.int32)
    out = tchain.run_chain_batch([q.seeds], [qp], [t.seeds], [tp], k,
                                 nq=32, nt=32, max_anchors=64)
    anchors, f, cov_q, cov_t = tchain.chain_pair_np(q.seeds, qp, t.seeds,
                                                    tp, k)
    n = len(anchors)
    assert np.array_equal(out["f"][0][:n], np.array(f))
    assert [tuple(a) for a in zip(out["qi"][0][:n], out["tj"][0][:n])] \
        == anchors
    best = int(np.argmax(out["f"][0][:n]))
    assert out["cov_q"][0][best] >= cov_q[best]


def _one(seeds, qpos, tseeds, tpos, nq, max_anchors):
    return tchain.run_chain_batch([seeds], [qpos], [tseeds], [tpos], 6,
                                  nq=nq, nt=nq, max_anchors=max_anchors)


def test_chain_cases_of_test_chain():
    """test_chain.py's fixed cases: identical sequences, negative gaps,
    an incompatible gap, an empty pair and extent propagation."""
    k = 6
    seeds = np.arange(10, dtype=np.int32)
    pos = SeedSequence(np.full(11, 5, np.int32), seeds).seed_positions(
        k).astype(np.int32)
    out = _one(seeds, pos, seeds, pos, 16, 32)
    assert int(out["through"][0].max()) == 10
    best, thr, good = tchain.good_chain_stats(out, 0, 3)
    assert best == 10 and int(out["cov_q"][0][good].max()) == 10 * k

    seeds = np.array([1, 2, 3], dtype=np.int32)
    pos = SeedSequence(np.array([0, -3, -3, 0], np.int32),
                       seeds).seed_positions(k).astype(np.int32)
    out = _one(seeds, pos, seeds, pos, 8, 16)
    assert int(out["through"][0].max()) == 3
    assert int(out["cov_q"][0][np.argmax(out["through"][0])]) == 3 * k - 6

    seeds = np.array([1, 2], dtype=np.int32)
    qpos = SeedSequence(np.array([0, 10, 0], np.int32),
                        seeds).seed_positions(k).astype(np.int32)
    tpos = SeedSequence(np.array([0, 500, 0], np.int32),
                        seeds).seed_positions(k).astype(np.int32)
    assert int(_one(seeds, qpos, seeds, tpos, 8, 16)["through"][0].max()) == 1

    e = np.empty(0, np.int32)
    assert int(_one(e, e, e, e, 8, 16)["through"][0].max()) == 0

    seeds = np.arange(5, dtype=np.int32)
    pos = SeedSequence(np.full(6, 10, np.int32), seeds).seed_positions(
        k).astype(np.int32)
    out = _one(seeds, pos, seeds, pos + 100, 8, 16)
    a = int(np.argmax(out["through"][0]))
    assert (out["start_qp"][0][a], out["start_tp"][0][a]) == (pos[0],
                                                              pos[0] + 100)
    assert (out["end_qp"][0][a], out["end_tp"][0][a]) == (pos[-1],
                                                          pos[-1] + 100)


# ---------------------------------------------------------------------
# parallel.mesh: the sharded query step
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    return (jmesh.make_mesh(n_data=4, n_seed=2),
            make_mesh(n_data=4, n_seed=2, devices=[CPU] * 8))


def test_sharded_hit_counts_matches_dense(meshes):
    """test_parallel.py:18 on both packages' 4 x 2 meshes."""
    jm, tm = meshes
    rng = np.random.default_rng(0)
    V = rng.integers(0, 2, (16, 512)).astype(np.int8)
    M = rng.integers(0, 2, (512, 64)).astype(np.int8)
    want = np.asarray(jmesh.sharded_hit_counts(jm)(V, M))
    got = tmesh.sharded_hit_counts(tm)(V, M)
    assert _same(got, want)
    assert np.array_equal(got, V.astype(np.int32) @ M.astype(np.int32))


@pytest.mark.parametrize("Q", [8, 16])
def test_sharded_pipeline_step_matches_jax(meshes, Q):
    """test_parallel.py:29 with ``__graft_entry__._example_args``: the
    counts equal the unsharded product, the chain output the JAX step's
    and the port's unsharded ``chain_batch``."""
    jm, tm = meshes
    V, M, qs, qp, ts, tp = graft._example_args(Q=Q)
    jc, jt = jmesh.sharded_pipeline_step(jm, k=6, max_anchors=64)(
        V, M, qs, qp, ts, tp)
    counts, through = tmesh.sharded_pipeline_step(tm, k=6, max_anchors=64)(
        V, M, qs, qp, ts, tp)
    assert counts.shape == (Q, M.shape[1])
    assert _same(counts, jc) and _same(through, jt)
    assert np.array_equal(counts, V.astype(np.int32) @ M.astype(np.int32))
    assert _same(through, tchain.chain_batch(qs, qp, ts, tp, k=6,
                                             max_anchors=64)["through"])
    one = make_mesh(1, 1, [CPU])
    c1, t1 = tmesh.sharded_pipeline_step(one)(V, M, qs, qp, ts, tp)
    assert _same(c1, counts) and _same(t1, through)


def test_sharded_chain_matches_jax(meshes):
    jm, tm = meshes
    V, M, qs, qp, ts, tp = graft._example_args(Q=16)
    want = jmesh.sharded_chain(jm, 6, 64)(qs, qp, ts, tp)
    got = tmesh.sharded_chain(tm, 6, 64)(qs, qp, ts, tp)
    assert len(got) == len(want) == 7
    assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["counts_rows", "counts_cols",
                                  "chain_rows", "step_rows"])
def test_sharded_shapes_the_grid_does_not_divide_raise(meshes, case):
    """The JAX functions raise ValueError (shard_map / device_put) on an
    axis the mesh does not divide; so do the port's."""
    jm, tm = meshes
    V, M, qs, qp, ts, tp = graft._example_args(Q=12)
    calls = {
        "counts_rows": lambda m, mod: mod.sharded_hit_counts(m)(
            V[:6], M),
        "counts_cols": lambda m, mod: mod.sharded_hit_counts(m)(
            V[:8, :511], M[:511]),
        "chain_rows": lambda m, mod: mod.sharded_chain(m, 6, 64)(
            qs, qp, ts, tp),
        "step_rows": lambda m, mod: mod.sharded_pipeline_step(m)(
            V[:6], M, qs[:6], qp[:6], ts[:6], tp[:6]),
    }
    for m, mod in ((jm, jmesh), (tm, tmesh)):
        with pytest.raises(ValueError):
            calls[case](m, mod)


@pytest.mark.parametrize("shape", [(4, 2), (2, 1), (3, 1)])
def test_run_chain_grid_equals_single(shape):
    """``run_chain_batch`` / ``run_chain_summary`` with a grid: pairs split
    over the data shards (a padded last block where the grid does not
    divide them) come back in row order, equal to the unsharded run."""
    rng = np.random.default_rng(51)
    lists = _pair_lists(rng, 13)
    grid = make_mesh(*shape, devices=[CPU] * 8)
    got = tchain.run_chain_batch(*lists, 6, 24, 30, 48, mesh=grid)
    want = tchain.run_chain_batch(*lists, 6, 24, 30, 48)
    assert set(got) == set(want)
    assert all(_same(got[k], want[k]) for k in want)
    mm, alen = rng.integers(1, 4, 13), rng.integers(100, 900, 13)
    got = tchain.run_chain_summary(*lists, mm, alen, 6, 24, 30, 48,
                                   mesh=grid)
    want = tchain.run_chain_summary(*lists, mm, alen, 6, 24, 30, 48)
    assert all(_same(got[k], want[k]) for k in want)


def test_library_without_jax_subprocess():
    """The library surface runs with jax and the JAX package blocked from
    import: the verify skill's recipe (seed index, retrieval counts,
    candidates, chain DP, planted positions recovered), the sharded step
    on a grid, and the simulator."""
    code = r'''
import sys
sys.modules["jax"] = None
sys.modules["downpore_tpu"] = None
import numpy as np, torch
torch.set_num_threads(2)
from downpore_tpu_torch import sim
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.seeds import SeedIndex
from downpore_tpu_torch.ops import match, chain
from downpore_tpu_torch.parallel import make_mesh, sharded_pipeline_step
rng = np.random.default_rng(0)
genome = sim.random_genome(rng, 20_000)
ref = Sequence.from_string(genome, id=0, name="ref")
idx = SeedIndex(6)
idx.add_single_seeds(ref, 40, np.ones(4 ** 6))
CH = 1000
for lo in range(0, len(genome), CH):
    idx.add_sequence(idx.new_seed_sequence(ref.subsequence(lo, lo + CH)))
idx.index_sequences()
usable = idx._seed_counts < idx.num_sequences
M = match.build_membership([s.seeds for s in idx.sequences], idx.num_seeds)
starts = [1500, 7200, 13300]
qs = []
for p in starts:
    arr = np.frombuffer(genome[p:p + 600].encode(), np.uint8).copy()
    m = rng.random(600) < 0.03
    arr[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m.sum())]
    qs.append(idx.new_seed_sequence(Sequence.from_string(arr.tobytes().decode())))
V, _, num_sets = match.build_query_rows(qs, idx.num_seeds, usable)
cands = match.candidates_from_counts(match.hit_counts(V, M), num_sets, 0.25)
for q, p, c in zip(qs, starts, cands):
    pairs = list(c)
    tgt = [idx.sequences[ci] for ci in pairs]
    out = chain.run_chain_batch([q.seeds] * len(pairs),
                                [q.seed_positions(6)] * len(pairs),
                                [t.seeds for t in tgt],
                                [t.seed_positions(6) for t in tgt], 6,
                                nq=128, nt=256, max_anchors=512)
    i = int(np.argmax(out["through"].max(axis=1)))
    a = int(np.argmax(out["through"][i]))
    found = pairs[i] * CH + int(out["start_tp"][i][a]) - int(out["start_qp"][i][a])
    assert abs(found - p) <= 6, (found, p)
Vx = rng.integers(0, 2, (8, 64)).astype(np.int8)
Mx = rng.integers(0, 2, (64, 16)).astype(np.int8)
s = rng.integers(0, 20, (8, 16)).astype(np.int32)
pos = np.cumsum(rng.integers(6, 30, (8, 16)), axis=1).astype(np.int32)
counts, through = sharded_pipeline_step(make_mesh(2, 2, ["cpu"] * 4))(
    Vx, Mx, s, pos, s, pos)
assert np.array_equal(counts, Vx.astype(np.int32) @ Mx.astype(np.int32))
assert through.shape == (8, 64) and (through.max(axis=1) == (s >= 0).sum(axis=1)).all()
bad = [m for m, v in sys.modules.items()
       if v is not None and m.split(".")[0] in ("jax", "downpore_tpu")]
assert not bad, bad
print("library ok")
'''
    env = dict(os.environ, DOWNPORE_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "library ok"
