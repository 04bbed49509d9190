"""Parity of the torch port's ``MapEngine`` (``downpore_tpu_torch.ops.
map_engine``) with the JAX package's engine, on the 60 kb synthetic genome
of test_mapping.py, on the CPU.

Resident state, retrieval counts, bucket derivation and the fused
dispatch's collected ``(head, packed)`` rows must be exactly equal
(tolerance 0: all quantities are integers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downpore_tpu.core import Sequence
from downpore_tpu.mapping import Mapper as JaxMapper
from downpore_tpu.ops import map_engine as jme
from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values
from downpore_tpu_torch.mapping import Mapper as TorchMapper
from downpore_tpu_torch.ops import cuda_counts
from downpore_tpu_torch.ops import map_engine as tme

torch.set_num_threads(2)

BASES = "ACGT"
K = 11
CPU = torch.device("cpu")


def rand_bases(n, rng):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def mappers():
    rng = np.random.default_rng(42)
    genome = Sequence.from_string(rand_bases(60000, rng), id=0, name="chr")
    values = score_seed_values(kmer_occurrences([genome], K), K)
    args = (genome, False, K, values, 40, 1000, 10000)
    return genome, JaxMapper(*args), TorchMapper(*args, device=CPU)


def windows(genome, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(0, len(genome) - 1000))
        out.append(genome.subsequence(p, p + 1000))
    return out


def state_of_jax(eng):
    return {key: np.asarray(getattr(eng, key))
            for key in tme.MapEngine.STATE_KEYS}


def state_of_torch(eng):
    out = {}
    for key in tme.MapEngine.STATE_KEYS:
        v = getattr(eng, key)
        out[key] = v.numpy() if torch.is_tensor(v) else v
    return out


@pytest.mark.parametrize("key", tme.MapEngine.STATE_KEYS)
def test_resident_state_matches_jax(mappers, key):
    _, jm, tm = mappers
    ref = state_of_jax(jm.engine)[key]
    got = state_of_torch(tm.engine)[key]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(ref, got)
    assert tm.engine.H == jm.engine.H and tm.engine.C == jm.engine.C


def test_truncated_tables_bitpacked_membership_matches_jax(mappers):
    """Chunk tables narrower than the chunks' seed lists: the membership
    matrix is built on the host and shipped bit-packed."""
    _, jm, _ = mappers
    index = jm.index
    nt = 64
    assert max(s.num_seeds for s in index.sequences) > nt
    ref = jme.MapEngine(index, K, nq=64, nt=nt, lean=True)
    got = tme.MapEngine(index, K, nq=64, nt=nt, lean=True, device=CPU)
    for key in ("membership", "t_seeds", "t_pos", "usable_dev"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, key)),
                                      getattr(got, key).numpy(), err_msg=key)


def test_hashed_membership_and_buckets_match_jax():
    """Seed ids over the bucket space: Knuth hashing in int64, masked."""
    rng = np.random.default_rng(3)
    S, H, CP, nt, M, nq = 5000, 1024, 16, 40, 16, 24
    t_seeds = rng.integers(0, S, (CP, nt)).astype(np.int32)
    t_seeds[rng.random((CP, nt)) < 0.2] = -1
    ref = np.asarray(jme._derive_membership(t_seeds, H=H, hashed=True))
    got = tme._derive_membership(torch.from_numpy(t_seeds), H, True)
    np.testing.assert_array_equal(ref, got.numpy())
    usable = (rng.random(S) < 0.9).astype(np.int8)
    q_seeds = rng.integers(0, S, (M, nq)).astype(np.int32)
    q_seeds[:, 1::3] = q_seeds[:, ::3][:, :q_seeds[:, 1::3].shape[1]]
    q_seeds[np.arange(nq)[None, :] >= rng.integers(3, nq + 1, M)[:, None]] = -1
    rb_r, db_r = jme._derive_buckets(jnp.asarray(q_seeds),
                                     jnp.asarray(usable), H, True)
    rb_g, db_g = tme._derive_buckets(torch.from_numpy(q_seeds),
                                     torch.from_numpy(usable), H, True)
    np.testing.assert_array_equal(np.asarray(rb_r), rb_g.numpy())
    np.testing.assert_array_equal(np.asarray(db_r), db_g.numpy())


def test_derive_buckets_and_counts_match_jax(mappers):
    genome, jm, tm = mappers
    je, te = jm.engine, tm.engine
    packed = je.pack_query_windows(windows(genome, 32, 5))
    q_seeds = packed[0]
    assert int(packed[6].max()) <= q_seeds.shape[1], "fixture must fit"
    rb_r, db_r = jme._derive_buckets(jnp.asarray(q_seeds), je.usable_dev,
                                     je.H, je._hashed)
    rb_g, db_g = tme._derive_buckets(torch.from_numpy(q_seeds),
                                     te.usable_dev, te.H, te._hashed)
    np.testing.assert_array_equal(np.asarray(rb_r), rb_g.numpy())
    np.testing.assert_array_equal(np.asarray(db_r), db_g.numpy())
    c_r, d_r = jme._count_rows_pair(je.membership, rb_r, db_r)
    c_g, d_g = tme._count_rows_pair(te.membership, rb_g, db_g)
    np.testing.assert_array_equal(np.asarray(c_r), c_g.numpy())
    np.testing.assert_array_equal(np.asarray(d_r), d_g.numpy())
    np.testing.assert_array_equal(
        np.asarray(jme._count_rows(je.membership, db_r)),
        tme._count_rows(te.membership, db_g).numpy())


def test_count_rows_bounded_chunks_match_one_block(mappers, monkeypatch):
    genome, _, tm = mappers
    te = tm.engine
    packed = te.pack_query_windows(windows(genome, 40, 6))
    rb, db = tme._derive_buckets(torch.from_numpy(packed[0]),
                                 te.usable_dev, te.H, te._hashed)
    whole = tme._count_rows_pair(te.membership, rb, db)
    monkeypatch.setattr(cuda_counts, "_GATHER_ELEMS", 8 * rb.shape[1]
                        * te.membership.shape[1])
    assert len(cuda_counts._row_chunks(*rb.shape, te.membership.shape[1])) > 1
    parts = tme._count_rows_pair(te.membership, rb, db)
    for w, p in zip(whole, parts):
        assert torch.equal(w, p)
    assert torch.equal(tme._count_rows(te.membership, rb), whole[0])


def _dispatch_both(je, te, packed, base_min):
    ref = je.collect_arrays_many([je.dispatch_packed(packed, base_min)])[0]
    got = te.collect_arrays_many([te.dispatch_packed(packed, base_min)])[0]
    return ref, got


@pytest.mark.parametrize("route", ["_fused_map_d", "_fused_map_c"])
def test_dispatch_collect_matches_jax(mappers, route):
    genome, jm, tm = mappers
    je, te = jm.engine, tm.engine
    wins = windows(genome, 48, 7)
    # reverse-complemented and foreign windows too
    wins += [w.reverse_complement() for w in wins[:8]]
    wins += [Sequence.from_string(rand_bases(1000, np.random.default_rng(9)),
                                  id=99, name="junk")]
    packed = je.pack_query_windows(wins)
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    if route == "_fused_map_c":
        packed = packed[:6]          # no num_seeds: buckets are shipped
    te.routes.clear()
    (h_r, p_r), (h_g, p_g) = _dispatch_both(je, te, packed, base_min)
    assert dict(te.routes) == {route: 1}
    assert h_r.shape[0] >= 48
    np.testing.assert_array_equal(h_r, h_g)
    np.testing.assert_array_equal(p_r, p_g)
    assert h_g.dtype == np.int32 and p_g.dtype == np.int32


def test_load_state_from_jax_engine(mappers):
    genome, jm, tm = mappers
    je = jm.engine
    fresh = tme.MapEngine(jm.index, K, nq=je.nq, nt=je.nt, lean=True,
                          device=CPU)
    fresh.membership.zero_()
    fresh.load_state(state_of_jax(je))
    for key, ref in state_of_jax(je).items():
        np.testing.assert_array_equal(ref, state_of_torch(fresh)[key])
    packed = je.pack_query_windows(windows(genome, 24, 8))
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    (h_r, p_r), (h_g, p_g) = _dispatch_both(je, fresh, packed, base_min)
    np.testing.assert_array_equal(h_r, h_g)
    np.testing.assert_array_equal(p_r, p_g)
    with pytest.raises(ValueError):
        fresh.load_state({**state_of_jax(je),
                          "t_pos": np.zeros((1, 1), np.int32)})


def test_pack_query_windows_matches_jax(mappers, monkeypatch):
    genome, jm, tm = mappers
    wins = windows(genome, 20, 10) + [genome.subsequence(0, 5)]
    ref = jm.engine.pack_query_windows(wins)
    native = tm.engine.pack_query_windows(wins)
    monkeypatch.setattr(tm.engine, "_pack_windows_native",
                        lambda *a: None)
    numpy_path = tm.engine.pack_query_windows(wins)
    for r, n, p in zip(ref, native, numpy_path):
        np.testing.assert_array_equal(r, n)
        np.testing.assert_array_equal(r, p)


@pytest.mark.parametrize("n_data,n_seed", [(8, 1), (4, 2)])
def test_mesh_engine_matches_jax(mappers, n_data, n_seed):
    """An engine on a data grid and on a seed-sharded grid (CPU entries)
    gives the JAX engine's rows on the same mesh shape; a seed-sharded
    grid turns bucket derivation off, as in the JAX engine."""
    from downpore_tpu.parallel.mesh import make_mesh as jax_mesh
    from downpore_tpu_torch.parallel import make_mesh
    genome, jm, _ = mappers
    je = jme.MapEngine(jm.index, K, nq=64, nt=320, lean=True,
                       mesh=jax_mesh(n_data=n_data, n_seed=n_seed))
    te = tme.MapEngine(jm.index, K, nq=64, nt=320, lean=True,
                       mesh=make_mesh(n_data, n_seed,
                                      [CPU] * (n_data * n_seed)))
    packed = je.pack_query_windows(windows(genome, 30, 12))
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    (h_r, p_r), (h_g, p_g) = _dispatch_both(je, te, packed, base_min)
    np.testing.assert_array_equal(h_r, h_g)
    np.testing.assert_array_equal(p_r, p_g)
    assert h_g.shape[0] >= 30
    route = "_map_from_counts" if n_seed > 1 else "_fused_map_d"
    assert dict(te.routes) == {route: n_data}


def test_binned_construction_at_patched_thresholds(mappers, monkeypatch):
    """With the thresholds lowered under the fixture's 6 chunks, a
    ``binned=True`` engine builds the two-level gate's state as the JAX
    engine does; ``binned=False`` stays flat."""
    _, jm, _ = mappers
    for mod in (jme, tme):
        monkeypatch.setattr(mod, "_BINNED_MIN_C", 4)
        monkeypatch.setattr(mod, "_BINNED_CB", 8)
    ref = jme.MapEngine(jm.index, K, lean=True, binned=True)
    got = tme.MapEngine(jm.index, K, lean=True, binned=True, device=CPU)
    assert got._binned and (got._NB, got._CB, got._BB) == (16, 8, 8)
    np.testing.assert_array_equal(ref._perm, got._perm)
    for key in tme.MapEngine.BINNED_STATE_KEYS + ("membership", "t_seeds"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, key)),
                                      getattr(got, key).numpy(), err_msg=key)
    assert not tme.MapEngine(jm.index, K, device=CPU)._binned
