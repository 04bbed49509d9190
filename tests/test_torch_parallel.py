"""Parity of the port's device grid (``downpore_tpu_torch.parallel``) and
its multi-device paths with the JAX package's mesh, on the CPU, at
tolerance 0.

The JAX side runs on conftest's 8 virtual CPU devices; the port's grids
repeat the CPU device (``[cpu] * 8``).  Mirrored: the k-mer histogram and
``kmer_occurrences``' device path (test_parallel.py:40,65), seed-sharded
map and overlap against the JAX package's seed-sharded run and the port's
unsharded run (test_seed_sharding.py:25,53), data-parallel map
(test_mapping.py:133), the trim golden digest on a data grid
(test_trim_golden.py:71), the balance checks (test_seed_sharding.py:98,
134,153), the seed-sharded retrieval counts, ``load_state`` from a JAX
seed-sharded engine, and ``make_mesh``'s error text.
"""
import hashlib
import io

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from downpore_tpu.core import Sequence as JaxSequence
from downpore_tpu.mapping import Mapper as JaxMapper
from downpore_tpu.ops import map_engine as jme
from downpore_tpu.overlap import Overlapper as JaxOverlapper
from downpore_tpu.parallel import mesh as jmesh
from downpore_tpu.utils.kmers import kmer_occurrences as jax_kmers
from downpore_tpu.utils.kmers import score_seed_values
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.io import SequenceSet
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.ops import map_engine as tme
from downpore_tpu_torch.overlap import QUERY_EDGES, Overlapper
from downpore_tpu_torch.parallel import make_mesh, sharded_kmer_histogram
from downpore_tpu_torch.seeds import SeedIndex
from downpore_tpu_torch.trim import load_trimmer
from downpore_tpu_torch.utils import kmer_occurrences

torch.set_num_threads(2)

CPU = torch.device("cpu")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand(rng, n):
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


def _mut(rng, s, rate=0.05):
    a = np.frombuffer(s.encode(), np.uint8).copy()
    m = rng.random(len(a)) < rate
    a[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    return a.tobytes().decode()


@pytest.fixture
def eight_cpus(monkeypatch):
    """The port's default device listing as 8 CPU entries, as conftest
    gives the JAX package 8 virtual CPU devices: the CLI's
    ``-data_parallel`` / ``-seed_shards`` grids then have the JAX meshes'
    shapes."""
    from downpore_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "local_devices", lambda: [CPU] * 8)


def grid(n_data, n_seed=1):
    return make_mesh(n_data=n_data, n_seed=n_seed,
                     devices=[CPU] * (n_data * n_seed))


def paf(mapper, results):
    return ["|".join(mapper.as_string(m) for m in ms) for ms in results]


@pytest.fixture(scope="module")
def map_case():
    """test_seed_sharding.py:25's case: a 30 kb genome, k = 11, 24 reads
    of 2.4 kb at 5% substitutions."""
    rng = np.random.default_rng(7)
    genome = _rand(rng, 30000)
    k = 11
    ref = JaxSequence.from_string(genome, id=0, name="g")
    values = score_seed_values(jax_kmers([ref], k), k)
    reads = []
    for i in range(24):
        p = int(rng.integers(0, 30000 - 2500))
        reads.append((f"r{i}", _mut(rng, genome[p:p + 2400])))
    return genome, k, values, reads


def mappers(case, jax_mesh, port_mesh):
    genome, k, values, reads = case
    args = (False, k, values, 40, 1000, 10000)
    jm = JaxMapper(JaxSequence.from_string(genome, id=0, name="g"), *args,
                   mesh=jax_mesh)
    tm = Mapper(Sequence.from_string(genome, id=0, name="g"), *args,
                mesh=port_mesh, device=CPU)
    return jm, tm


def read_objs(cls, reads):
    return [cls.from_string(s, id=i, name=n) for i, (n, s) in
            enumerate(reads)]


@pytest.mark.parametrize("n_data,n_seed,devices", [
    (None, 2, 1), (3, 3, 8), (0, 1, 8), (None, 1, 8), (4, 2, 8)])
def test_make_mesh_matches_jax(n_data, n_seed, devices):
    """The same grid shape, or the same ValueError text, for the same
    request over the same number of devices."""
    try:
        ref = jmesh.make_mesh(n_data, n_seed, jax.devices()[:devices])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(n_data, n_seed, [CPU] * devices)
        assert str(got.value) == str(e)
        return
    got = make_mesh(n_data, n_seed, [CPU] * devices)
    assert dict(got.shape) == dict(ref.shape)
    assert got.size == ref.size and got.axis_names == ref.axis_names


def test_sharded_kmer_histogram_matches_jax():
    rng = np.random.default_rng(1)
    k = 4
    kmers = rng.integers(0, 4 ** k, (8, 100)).astype(np.int32)
    kmers[rng.random((8, 100)) < 0.1] = -1  # padding
    ref = np.asarray(jmesh.sharded_kmer_histogram(
        jmesh.make_mesh(n_data=4, n_seed=2), k)(kmers))
    got = sharded_kmer_histogram(grid(4, 2), k)(kmers)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(kmers[kmers >= 0], minlength=4 ** k))


def test_kmer_occurrences_device_path_matches_jax():
    rng = np.random.default_rng(21)
    reads = [_rand(rng, int(rng.integers(5, 4000))) for _ in range(40)]
    k = 6
    host = kmer_occurrences([Sequence.from_string(s, id=i)
                             for i, s in enumerate(reads)], k)
    dev = kmer_occurrences([Sequence.from_string(s, id=i)
                            for i, s in enumerate(reads)], k,
                           mesh=grid(4, 2))
    ref = jax_kmers([JaxSequence.from_string(s, id=i)
                     for i, s in enumerate(reads)], k,
                    mesh=jmesh.make_mesh(n_data=4, n_seed=2))
    assert dev.dtype == np.uint64
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(dev, ref)


def test_sharded_counts_match_jax():
    """Each seed shard counts the buckets in its row range; the partial
    counts sum to the dense counts and to the JAX shard_map's."""
    rng = np.random.default_rng(3)
    HP, C, M, R = 64, 16, 8, 12
    mem = rng.integers(0, 2, (HP, C)).astype(np.int8)
    buckets = rng.integers(-1, HP, (M, R)).astype(np.int32)
    jm = jmesh.make_mesh(n_data=4, n_seed=2)
    ref = np.asarray(jme.make_sharded_counts(jm)(
        jax.device_put(mem, NamedSharding(jm, P("seed", None))), buckets))
    blocks = [torch.from_numpy(mem[:HP // 2]), torch.from_numpy(mem[HP // 2:])]
    got = tme.sharded_counts(blocks, torch.from_numpy(buckets), CPU)
    np.testing.assert_array_equal(got.numpy(), ref)
    dense = tme._count_rows(torch.from_numpy(mem), torch.from_numpy(buckets))
    assert torch.equal(got, dense)


def test_seed_sharded_map_matches_jax(map_case):
    """A (data 4, seed 2) grid: the port's PAF equals the JAX package's
    seed-sharded run and the port's unsharded run."""
    jm, tm = mappers(map_case, jmesh.make_mesh(n_data=4, n_seed=2),
                     grid(4, 2))
    assert tm.engine.seed_sharded and not tm.engine._binned
    reads = map_case[3]
    ref = paf(jm, jm.map_batch(read_objs(JaxSequence, reads)))
    got = paf(tm, tm.map_batch(read_objs(Sequence, reads)))
    plain = Mapper(Sequence.from_string(map_case[0], id=0, name="g"), False,
                   *map_case[1:3], 40, 1000, 10000, device=CPU)
    assert got == ref == paf(plain, plain.map_batch(read_objs(Sequence,
                                                               reads)))
    assert set(tm.engine.routes) == {"_map_from_counts"}
    assert sum(1 for p in got if p) >= 20


def test_binned_data_parallel_map_matches_jax(map_case, monkeypatch):
    """The binned gate (thresholds lowered to reach it on 3 chunks) on a
    3-way data grid: each shard reads its own ``n_bin``; the PAF equals
    the JAX package's unsharded binned run."""
    from downpore_tpu.ops import map_engine as jax_engine
    for mod in (jax_engine, tme):
        monkeypatch.setattr(mod, "_BINNED_MIN_C", 2)
        monkeypatch.setattr(mod, "_BINNED_CB", 8)
    jm, tm = mappers(map_case, None, grid(3))
    assert tm.engine._binned and tm.engine.C == jm.engine.C >= 2
    reads = map_case[3]
    ref = paf(jm, jm.map_batch(read_objs(JaxSequence, reads)))
    got = paf(tm, tm.map_batch(read_objs(Sequence, reads)))
    assert got == ref and sum(1 for p in got if p) >= 20
    assert set(tm.engine.routes) == {"_fused_map_bd"}


def test_data_parallel_map_matches_jax(map_case):
    """test_mapping.py:133: 12 reads of 2-4 kb at 8% substitutions over an
    8-way data grid; every shard runs the derived-bucket route."""
    jm, tm = mappers(map_case, jmesh.make_mesh(), grid(8))
    rng = np.random.default_rng(77)
    genome = map_case[0]
    reads = []
    for i in range(12):
        start = int(rng.integers(0, 26000))
        ln = int(rng.integers(2000, 4000))
        reads.append((f"r{i}", _mut(rng, genome[start:start + ln], 0.08)))
    ref = paf(jm, jm.map_batch(read_objs(JaxSequence, reads)))
    got = paf(tm, tm.map_batch(read_objs(Sequence, reads)))
    assert got == ref
    assert sum(p.count("|") + 1 for p in got if p) >= 10
    assert set(tm.engine.routes) == {"_fused_map_d"}
    assert tm.engine.routes["_fused_map_d"] % 8 == 0


def overlap_run(cls, seq_cls, index_cls, mesh, **kw):
    """test_seed_sharding.py:53's round: 32 reads of 2.5 kb at 4%
    substitutions from a 20 kb genome, edges as queries."""
    rng = np.random.default_rng(8)
    genome = _rand(rng, 20000)
    bases = []
    for i in range(32):
        p = int(rng.integers(0, 20000 - 2600))
        bases.append(_mut(rng, genome[p:p + 2500], 0.04))
    reads = [seq_cls.from_string(b, id=i, name=f"o{i}")
             for i, b in enumerate(bases)]
    k = 10
    values = score_seed_values(jax_kmers(
        [JaxSequence.from_string(b, id=i) for i, b in enumerate(bases)], k),
        k)
    ov = cls(index_cls(k), 10000, 1000, 15, 0.25, mesh=mesh, **kw)
    queries = ov.prepare_queries(15, 10000, values, iter(reads), QUERY_EDGES)
    ov.add_sequences(iter(reads))
    ms = ov.find_overlaps(queries)
    return [(m.query_id, m.seq_b.id, m.rc_query, tuple(m.match_a),
             tuple(m.match_b)) for m in ms]


def test_seed_sharded_overlap_matches_jax():
    from downpore_tpu.seeds import SeedIndex as JaxSeedIndex
    ref = overlap_run(JaxOverlapper, JaxSequence, JaxSeedIndex,
                      jmesh.make_mesh(n_data=4, n_seed=2))
    got = overlap_run(Overlapper, Sequence, SeedIndex, grid(4, 2),
                      device=CPU)
    plain = overlap_run(Overlapper, Sequence, SeedIndex, None, device=CPU)
    assert got == ref == plain and len(got) > 0


def test_trim_data_parallel_golden(tmp_path):
    """test_trim_golden.py:71: window batches over an 8-way data grid give
    the JAX package's recorded golden digest."""
    from test_torch_trim import GOLDEN_DIGEST, golden_records, write_reads
    g = grid(8)
    trimmer = load_trimmer("", "", 6, verbosity=0, mesh=g)
    assert trimmer._engine().mesh is g
    path = write_reads(tmp_path / "reads.fastq", golden_records(),
                       fastq=True)
    seq_set = SequenceSet(path, min_length=50)
    trimmer.determine_adapters(seq_set, 10000, 90)
    trimmer.set_trim_params(85, 5, 50, 1000, True, True, False)
    trimmer.trim(seq_set)
    out = io.StringIO()
    seq_set.write(out, True)
    assert hashlib.sha256(out.getvalue().encode()).hexdigest() \
        == GOLDEN_DIGEST


def test_load_state_from_jax_seed_sharded_engine(map_case):
    """The JAX seed-sharded engine's padded [HP, CP] membership lands in
    the port's per-shard row blocks; dispatches then equal the JAX
    engine's."""
    jm, tm = mappers(map_case, jmesh.make_mesh(n_data=4, n_seed=2),
                     grid(4, 2))
    je = jm.engine
    state = {key: np.asarray(getattr(je, key))
             for key in tme.MapEngine.STATE_KEYS}
    assert state["membership"].shape[0] % 2 == 0
    fresh = tme.MapEngine(tm.index, je.k, nq=je.nq, nt=je.nt, lean=True,
                          mesh=grid(4, 2))
    for tabs in fresh._shards.values():
        for blk in tabs["mem_blocks"]:
            blk.zero_()
    fresh.load_state(state)
    for tabs in fresh._shards.values():
        np.testing.assert_array_equal(
            torch.cat(tabs["mem_blocks"]).numpy(), state["membership"])
    rng = np.random.default_rng(8)
    genome = JaxSequence.from_string(map_case[0], id=0, name="g")
    wins = []
    for _ in range(20):
        p = int(rng.integers(0, len(genome) - 1000))
        wins.append(genome.subsequence(p, p + 1000))
    packed = je.pack_query_windows(wins)
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    ref = je.collect_arrays_many([je.dispatch_packed(packed, base_min)])[0]
    got = fresh.collect_arrays_many([fresh.dispatch_packed(packed,
                                                           base_min)])[0]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    assert ref[0].shape[0] >= 20
    with pytest.raises(ValueError):
        fresh.load_state({**state, "membership": state["membership"][:-2]})


def _assert_balanced(counts, tol=0.1):
    """Every shard's share within ~10% of the mean
    (test_seed_sharding.py:87)."""
    assert len(counts) > 1
    mean = sum(counts) / len(counts)
    for c in counts:
        assert abs(c - mean) <= tol * mean + 1, counts


def test_data_parallel_work_balance(map_case):
    """Every array the data-parallel map ships is split into equal shard
    blocks (recorded at the grid's row split)."""
    g = grid(8)
    _, tm = mappers(map_case, jmesh.make_mesh(), g)
    recorded = []
    orig = g.split_rows

    def rec(*args, **kwargs):
        out = orig(*args, **kwargs)
        recorded.append(out)
        return out

    g.split_rows = rec
    tm.map_batch(read_objs(Sequence, map_case[3]))
    assert recorded, "no data-parallel split recorded"
    for blocks in recorded:
        assert len(blocks) == 8
        for i in range(len(blocks[0][2])):
            _assert_balanced([b[2][i].numel() for b in blocks])


def test_seed_sharded_membership_balance(map_case):
    """Every (data, seed) shard holds an equal hash-bucket row range."""
    _, tm = mappers(map_case, jmesh.make_mesh(n_data=4, n_seed=2),
                    grid(4, 2))
    shards = tm.engine.shard_tensors()
    assert len(shards) == 4
    sizes = [t.numel() for tabs in shards.values()
             for name, t in tabs.items() if name.startswith("mem_block")]
    assert len(sizes) == 8
    _assert_balanced(sizes)
    assert sum(sizes) // 4 == tm.engine._mem_shape[0] \
        * tm.engine._mem_shape[1]


def test_balance_check_catches_skew():
    with pytest.raises(AssertionError):
        _assert_balanced([7 * 4, 4, 4, 4, 4, 4, 4, 4])
    with pytest.raises(AssertionError):
        _assert_balanced([2048, 2048, 2048, 2048, 2048, 2048, 2048, 0])
    _assert_balanced([2048] * 8)
