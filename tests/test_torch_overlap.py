"""Parity of the port's overlap engine with the JAX package, on the CPU:
the forward-only chain DP, ``MapEngine.query_chains`` on both fused routes
(buckets derived on the device, and shipped from the host), and
``Overlapper.find_overlaps`` on the 48-read fixture of
test_cli_golden.py.  Results must be identical (tolerance 0).
"""
import numpy as np
import pytest
import torch

from downpore_tpu.ops import chain as jchain
from downpore_tpu.ops.map_engine import MapEngine as JaxEngine
from downpore_tpu.overlap import QUERY_EDGES
from downpore_tpu.overlap import Overlapper as JaxOverlapper
from downpore_tpu.seeds import SeedIndex
from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values
from downpore_tpu_torch.ops import chain as tchain
from downpore_tpu_torch.ops.map_engine import MapEngine as TorchEngine
from downpore_tpu_torch.overlap import Overlapper as TorchOverlapper
from test_torch_correct import overlap_sequences

torch.set_num_threads(2)

K = 10


def test_dp_forward_lean_matches_jax():
    rng = np.random.default_rng(7)
    P, A = 6, 64
    qp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    tp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    qi = np.argsort(np.argsort(qp, axis=1), axis=1).astype(np.int32)
    tj = np.argsort(np.argsort(tp, axis=1), axis=1).astype(np.int32)
    valid = rng.random((P, A)) < 0.85
    anchors = dict(qi=qi, tj=tj, qp=qp, tp=tp, valid=valid)
    ref = jchain.dp_forward_lean(anchors, K, "aligner")
    got = tchain.dp_forward_lean(
        {key: torch.from_numpy(v) for key, v in anchors.items()}, K,
        "aligner")
    for key in ("f", "bp", "qi", "tj"):
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key


@pytest.fixture(scope="module")
def reads():
    return overlap_sequences()


def round_setup(reads, cls, **kw):
    """One overlap round as the overlap command sets it up: edges of the
    first 16 reads as queries, every read chunked and indexed."""
    values = score_seed_values(kmer_occurrences(reads, K), K)
    index = SeedIndex(K)
    ov = cls(index, 10000, 1000, 10, 0.25, **kw)
    queries = ov.prepare_queries(15, 10000, values, iter(reads[:16]),
                                 QUERY_EDGES)
    ov.add_sequences(iter(reads))
    return ov, queries


@pytest.mark.parametrize("nq,route", [(128, "_fused_overlap_d"),
                                      (16, "_fused_overlap")])
def test_query_chains_matches_jax(reads, nq, route):
    """nq = 128 fits every query's seeds (buckets derived on the device);
    nq = 16 does not (buckets shipped from the host)."""
    ov, queries = round_setup(reads, JaxOverlapper)
    index = ov.index
    seed_queries = [q.query for q in queries]
    base_min = np.array([int(0.25 * q.num_seeds + 0.5)
                         for q in seed_queries], np.int32)
    ref = JaxEngine(index, K, nq=nq, nt=256).query_chains(seed_queries,
                                                          base_min)
    eng = TorchEngine(index, K, nq=nq, nt=256, device="cpu")
    got = eng.query_chains(seed_queries, base_min)
    assert dict(eng.routes) == {route: 1}
    assert got == ref
    assert sum(len(r) for r in got) >= 20


def test_find_overlaps_matches_jax(reads):
    jov, jq = round_setup(reads, JaxOverlapper)
    tov, tq = round_setup(reads, TorchOverlapper, device="cpu")
    ref = jov.find_overlaps(jq)
    got = tov.find_overlaps(tq)
    key = lambda m: (m.seq_a.id, m.seq_a.offset, m.seq_b.id, m.seq_b.offset,
                     m.query_id, m.rc_query, m.match_a, m.match_b)
    assert [key(m) for m in got] == [key(m) for m in ref]
    assert len(got) >= 20


def test_overlapper_with_a_grid_matches_jax(reads):
    """A (data 4, seed 2) grid of CPU entries against the JAX overlapper
    on the same mesh shape."""
    from downpore_tpu.parallel.mesh import make_mesh as jax_mesh
    from downpore_tpu_torch.parallel import make_mesh
    jov, jq = round_setup(reads, JaxOverlapper,
                          mesh=jax_mesh(n_data=4, n_seed=2))
    tov, tq = round_setup(reads, TorchOverlapper,
                          mesh=make_mesh(4, 2, ["cpu"] * 8))
    key = lambda m: (m.seq_a.id, m.seq_a.offset, m.seq_b.id, m.seq_b.offset,
                     m.query_id, m.rc_query, m.match_a, m.match_b)
    got = [key(m) for m in tov.find_overlaps(tq)]
    assert got == [key(m) for m in jov.find_overlaps(jq)]
    assert len(got) >= 20


def test_overlap_of_an_empty_round():
    ov = TorchOverlapper(SeedIndex(K), 10000, 1000, 10, 0.25, device="cpu")
    assert ov.find_overlaps([]) == []
