"""Parity of the port's consensus engine with the JAX package, on the CPU:
the band update against the Pallas band kernel and the numpy oracle, the
beam scan's plain version against the XLA engine (both measures, the five
job families of test_pallas_beam.py) and the Pallas kernel, and the
consensus wrappers and module.  Tolerance 0 everywhere: integer bands and
costs, float32 votes computed in the same order.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downpore_tpu.align import SimpleMeasure, update_offsets_np
from downpore_tpu.align.model import Model
from downpore_tpu.consensus import consensus as jcons
from downpore_tpu.core.sequence import Sequence, encode_bases
from downpore_tpu.ops import dtw as jdtw
from downpore_tpu.ops.pallas_band import pallas_update_bands
from downpore_tpu.ops.pallas_beam import JB, pallas_consensus
from downpore_tpu.ops.pallas_beam import PAD as PALLAS_PAD
from downpore_tpu.overlap.combine import SeedContig
from downpore_tpu_torch.consensus import consensus as tcons
from downpore_tpu_torch.ops import cuda_band, cuda_beam
from downpore_tpu_torch.ops import dtw as tdtw
from test_pallas_beam import K, make_jobs

torch.set_num_threads(2)

THRESHOLD, GAP = 300, 8


# ---- band update -----------------------------------------------------------

def test_update_bands_plain_matches_pallas_and_oracle():
    """test_align.py's recipe: the plain version (through the wrapper, on
    CPU tensors) against pallas_update_bands(interpret=True) and the numpy
    oracle update_offsets_np."""
    rng = np.random.default_rng(21)
    B, W = 37, 32
    ds = rng.integers(0, 40, (B, W)).astype(np.int32)
    poffs = rng.integers(0, 500, (B, W)).astype(np.int32)
    poffs[rng.random((B, W)) < 0.25] = cuda_band.BAND_FULL
    out, m = cuda_band.update_bands(torch.from_numpy(ds),
                                    torch.from_numpy(poffs), 300)
    p_out, p_m = pallas_update_bands(ds, poffs, 300, interpret=True)
    o_out, o_m = update_offsets_np(ds.astype(np.uint16),
                                   poffs.astype(np.uint16), 300)
    assert np.array_equal(out.numpy(), np.asarray(p_out))
    assert np.array_equal(m.numpy(), np.asarray(p_m))
    assert np.array_equal(out.numpy(), o_out.astype(np.int32))
    assert np.array_equal(m.numpy(), o_m.astype(np.int32))


def test_band_update_matches_xla_engine_step():
    """The beam engine's FULL = 0x7FFF band update against the JAX
    engine's _band_update on broadcast [B, 4, N, W] bands."""
    rng = np.random.default_rng(3)
    poffs = rng.integers(0, 300, (3, 1, 5, 32)).astype(np.int32)
    poffs[rng.random(poffs.shape) < 0.3] = tdtw.FULL
    ds = rng.integers(0, 30, (3, 4, 5, 32)).astype(np.int32)
    ds[rng.random(ds.shape) < 0.1] = tdtw.FULL
    out, m = tdtw._band_update(torch.from_numpy(poffs), torch.from_numpy(ds),
                               200)
    j_out, j_m = jdtw._band_update(jnp.broadcast_to(poffs, ds.shape), ds,
                                   200)
    assert np.array_equal(out.numpy(), np.asarray(j_out))
    assert np.array_equal(m.numpy(), np.asarray(j_m))


def test_helpers_match_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (6, 32)).astype(np.int32)    # many ties
    assert np.array_equal(tdtw._argmin_last(torch.from_numpy(x)).numpy(),
                          np.asarray(jdtw._argmin_last(x)))
    shift = rng.integers(-20, 21, 6).astype(np.int32)
    assert np.array_equal(
        tdtw._barrel_shift(torch.from_numpy(x), torch.from_numpy(shift),
                           tdtw.FULL).numpy(),
        np.asarray(jdtw._barrel_shift(x, shift, jnp.int32(tdtw.FULL))))
    a = rng.integers(0, 4 ** K, 50).astype(np.int32)
    b = rng.integers(0, 4 ** K, 50).astype(np.int32)
    assert np.array_equal(
        tdtw._simple_distance(torch.from_numpy(a), torch.from_numpy(b),
                              K).numpy(),
        np.asarray(jdtw._simple_distance(a, b, K)))
    assert np.array_equal(
        tdtw._simple_distance(torch.from_numpy(a), torch.from_numpy(b),
                              K).numpy(),
        SimpleMeasure(K).pair_table()[a, b].astype(np.int32))
    for L in (60, 128, 600, 1200):
        assert tdtw._win_params(L) == jdtw._win_params(L)
        for t in (0, 100, 700, 1500):
            assert tdtw._win_base(t, L) == int(jdtw._win_base(t, L))


# ---- the beam scan's plain version ----------------------------------------

def families():
    """The five job families of test_pallas_beam.py (same seeds and error
    mixes, fewer jobs): (jobs, t_max)."""
    out = {}
    out["substitutions"] = (make_jobs(np.random.default_rng(10), 8, 60,
                                      sub=0.06, ins=0.0, dele=0.0), 96)
    out["indels"] = (make_jobs(np.random.default_rng(11), 8, 60, sub=0.03,
                               ins=0.03, dele=0.03), 96)
    out["deletion_drift"] = (make_jobs(np.random.default_rng(12), 8, 70,
                                       sub=0.02, ins=0.0, dele=0.08), 128)
    out["long_cores"] = (make_jobs(np.random.default_rng(13), 3, 600,
                                   n_members=3, sub=0.04, ins=0.01,
                                   dele=0.01), 832)
    jobs = make_jobs(np.random.default_rng(13), 8, 50, sub=0.05, ins=0.01,
                     dele=0.01)
    jobs[2] = jobs[2][:2]
    jobs[4] = jobs[4][:6] + jobs[4][:2]
    out["mixed_members"] = (jobs, 96)
    return out


FAMILIES = families()


def padded_block(jobs, N=8):
    L = max(max(len(m) for m in j) for j in jobs)
    L = ((L + 127) // 128) * 128
    seqs = np.empty((len(jobs), N, L), np.int32)
    lens = np.zeros((len(jobs), N), np.int32)
    firsts = np.zeros(len(jobs), np.int32)
    for i, j in enumerate(jobs):
        seqs[i], lens[i], firsts[i] = jdtw._pad_job(j, N, L)
    return seqs, lens, firsts


def table_args(simple_k):
    table = SimpleMeasure(K).pair_table().astype(np.uint16)
    return table, (None if simple_k else
                   torch.from_numpy(table.view(np.int16)))


def plain(seqs, lens, firsts, tab, beam, t_max, simple_k, **kw):
    return cuda_beam.beam_consensus(
        torch.from_numpy(seqs), torch.from_numpy(lens),
        torch.from_numpy(firsts), tab, K, beam, t_max, THRESHOLD, GAP,
        simple_k, **kw)


@pytest.mark.parametrize("simple_k", [K, 0], ids=["simple", "table"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_beam_plain_matches_xla_engine(family, simple_k):
    jobs, t_max = FAMILIES[family]
    seqs, lens, firsts = padded_block(jobs)
    table, tab = table_args(simple_k)
    beam = 8
    xc, xn = jdtw._device_consensus_vmapped(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(table),
        jnp.asarray(firsts), K, beam, t_max, THRESHOLD, GAP, simple_k)
    pc, pn = plain(seqs, lens, firsts, tab, beam, t_max, simple_k)
    assert np.array_equal(pn.numpy(), np.asarray(xn))
    assert np.array_equal(pc.numpy(), np.asarray(xc))
    assert (pn.numpy() > 20).all()


def test_beam_plain_matches_pallas_kernel():
    """One JB-job block of the substitution family against the Pallas
    kernel in interpret mode."""
    jobs = make_jobs(np.random.default_rng(10), JB, 60, sub=0.06, ins=0.0,
                     dele=0.0)
    seqs, lens, firsts = padded_block(jobs)
    J, N, L = seqs.shape
    LP = ((L + 2 * 32 + 127) // 128) * 128
    pseqs = np.full((J, N, LP), -1, np.int32)
    pseqs[:, :, PALLAS_PAD:PALLAS_PAD + L] = seqs
    xc, xn = pallas_consensus(jnp.asarray(pseqs), jnp.asarray(lens),
                              jnp.asarray(firsts), K, 8, 96, THRESHOLD, GAP,
                              K, interpret=True)
    pc, pn = plain(seqs, lens, firsts, None, 8, 96, K)
    xc, xn = np.asarray(xc), np.asarray(xn)
    assert np.array_equal(pn.numpy(), xn)
    for i in range(J):
        assert np.array_equal(pc.numpy()[i, :xn[i]], xc[i, :xn[i]]), i


def test_beam_early_exit_equals_records_path():
    """A mixed-length batch: the scan that stops once every job has
    finished, with its traceback, equals the traceback of the full
    t_max-step records; the records equal the XLA engine's."""
    rng = np.random.default_rng(9)
    jobs = (make_jobs(rng, 3, 40, sub=0.04, ins=0.0, dele=0.0)
            + make_jobs(rng, 3, 110, sub=0.04, ins=0.01, dele=0.01))
    seqs, lens, firsts = padded_block(jobs, N=4)
    beam, t_max = 4, 192
    rec = plain(seqs, lens, firsts, None, beam, t_max, K,
                return_records=True)
    assert rec.shape == (len(jobs), t_max, 4, beam)
    chains, ns = plain(seqs, lens, firsts, None, beam, t_max, K)
    walked, wn = cuda_beam.traceback_plain(rec, t_max)
    assert torch.equal(walked, chains) and torch.equal(wn, ns)
    assert len(set(ns.tolist())) == len(jobs)   # jobs finish apart
    one = jax.vmap(lambda s, ln, f: jdtw.device_consensus(
        s, ln, jnp.zeros((1, 1), jnp.uint16), f, K, beam=beam, t_max=t_max,
        threshold=THRESHOLD, gap_cost=GAP, simple_k=K, return_records=True))
    km, par, fin, cost = (np.asarray(a) for a in one(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(firsts)))
    r = rec.numpy()
    assert np.array_equal(r[:, :, 0], km)
    assert np.array_equal(r[:, :, 1], par)
    assert np.array_equal(r[:, :, 2], fin.astype(np.int32))
    assert np.array_equal(r[:, :, 3], cost)


def test_member_padding_is_inert():
    """Padded (zero-length) members change nothing: the same jobs padded
    to 4, 8 and 12 members give the same chains."""
    jobs, t_max = FAMILIES["mixed_members"]
    jobs = [j for j in jobs if len(j) <= 4]
    got = []
    for N in (4, 8, 12):
        seqs, lens, firsts = padded_block(jobs, N=N)
        chains, ns = plain(seqs, lens, firsts, None, 4, t_max, K)
        got.append((chains, ns))
    for chains, ns in got[1:]:
        assert torch.equal(chains, got[0][0]) and torch.equal(ns, got[0][1])


# ---- wrappers and the consensus module -------------------------------------

@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A k = 5 current-level model file with seeded random levels."""
    rng = np.random.default_rng(8)
    path = tmp_path_factory.mktemp("model") / "model.txt"
    with open(path, "w") as f:
        f.write("kmer\tlevel_mean\n")
        for v in range(4 ** 5):
            km = "".join("ACGT"[(v >> (2 * (4 - i))) & 3] for i in range(5))
            f.write(f"{km}\t{rng.uniform(60.0, 120.0):.3f}\n")
    return Model(str(path), False)


@pytest.mark.parametrize("simple_k", [K, 0], ids=["simple", "table"])
def test_consensus_kmers_wrappers_match_jax(simple_k):
    rng = np.random.default_rng(14)
    jobs = make_jobs(rng, 5, 50, n_members=5, sub=0.05, ins=0.01,
                     dele=0.01)
    jobs.append([])                                       # empty job
    jobs.append(jobs[0][:3] + [np.zeros(0, np.int32)])    # empty member
    table = SimpleMeasure(K).pair_table()
    ref = jdtw.consensus_kmers_bulk(jobs, table, K, simple_k=simple_k)
    got = tdtw.consensus_kmers_bulk(jobs, table, K, simple_k=simple_k,
                                    device="cpu")
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    assert got[5].size == 0 and got[0].size > 30
    one = tdtw.consensus_kmers(jobs[1], table, K, simple_k=simple_k,
                               device="cpu")
    assert np.array_equal(one, jdtw.consensus_kmers(jobs[1], table, K,
                                                    simple_k=simple_k))


def ragged_jobs():
    """Jobs of three (N, L) buckets, interleaved: (4, 128), (8, 256) and
    (12, 256)."""
    rng = np.random.default_rng(15)
    err = dict(sub=0.05, ins=0.01, dele=0.01)
    small = make_jobs(rng, 2, 60, n_members=3, **err)
    mid = make_jobs(rng, 2, 180, n_members=6, **err)
    wide = make_jobs(rng, 1, 200, n_members=10, **err)
    return [small[0], mid[0], wide[0], small[1], mid[1]]


def test_ragged_plain_matches_buckets_and_jax():
    """consensus_kmers_bulk's one ragged scan equals the JAX package's
    per-bucket scans, and the ragged plain scan equals each bucket's own
    uniform plain scan, chains -1 past the bucket's t_max."""
    jobs = ragged_jobs()
    table = SimpleMeasure(K).pair_table()
    ref = jdtw.consensus_kmers_bulk(jobs, table, K, simple_k=K)
    got = tdtw.consensus_kmers_bulk(jobs, table, K, simple_k=K,
                                    device="cpu")
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    shapes, blocks, rows, firsts = [], [], [], []
    for job in jobs:
        N = ((len(job) + 3) // 4) * 4
        L = ((max(len(s) for s in job) + 127) // 128) * 128
        seq, lens, first = tdtw._pad_job(job, N, L)
        shapes.append((N, L, tdtw._t_max(L)))
        blocks.append(seq.reshape(-1))
        rows.append(lens)
        firsts.append(first)
    assert len(set(shapes)) >= 3
    chains, ns = cuda_beam.beam_consensus_ragged(
        torch.from_numpy(np.concatenate(blocks)),
        torch.from_numpy(np.concatenate(rows)),
        torch.tensor(firsts, dtype=torch.int32), shapes, None, K, 4,
        THRESHOLD, GAP, K)
    assert chains.shape == (len(jobs), max(T for _, _, T in shapes))
    for j, (N, L, T) in enumerate(shapes):
        one_c, one_n = plain(blocks[j].reshape(1, N, L), rows[j][None],
                             np.array(firsts[j:j + 1], np.int32), None, 4, T,
                             K)
        assert torch.equal(chains[j, :T], one_c[0]) and ns[j] == one_n[0]
        assert bool((chains[j, T:] == -1).all())


def make_contigs():
    """Contigs of 5 noisy copies of random truths (test_align.py's
    recipe, with reverse-complemented parts), plus one with two parts."""
    rng = np.random.default_rng(53)
    contigs, sequences = [], {}
    rid = 0
    for length, n_parts in ((200, 5), (260, 5), (330, 6), (220, 2)):
        truth = encode_bases("".join("ACGT"[i]
                                     for i in rng.integers(0, 4, length)))
        c = SeedContig.__new__(SeedContig)
        c.parts, c.offsets, c.lengths = [], [], []
        c.reverse_complement, c.approximate = [], []
        for p in range(n_parts):
            codes = truth.copy()
            m = rng.random(len(codes)) < 0.05
            codes[m] = rng.integers(0, 4, int(m.sum()))
            seq = Sequence(codes, id=rid)
            rc = p % 3 == 2
            if rc:
                seq = Sequence(seq.reverse_complement().codes, id=rid)
            sequences[rid] = seq
            c.parts.append(rid)
            c.offsets.append(0)
            c.lengths.append(len(codes))
            c.reverse_complement.append(rc)
            c.approximate.append(False)
            rid += 1
        c.matches = None
        c.seq_lengths = [len(sequences[p]) for p in c.parts]
        contigs.append(c)
    return contigs, sequences


def same_result(a, b):
    (ca, sa), (cb, sb) = a, b
    if sa is None or sb is None:
        return sa is None and sb is None and ca is None and cb is None
    return (np.array_equal(sa.codes, sb.codes) and sa.id == sb.id
            and ca.lengths == cb.lengths and ca.approximate == cb.approximate)


@pytest.mark.parametrize("measure", ["simple", "model"])
def test_build_consensus_matches_jax(measure, model):
    mod = model if measure == "model" else None
    contigs, sequences = make_contigs()
    ref = jcons.build_consensus_bulk(copy.deepcopy(contigs), sequences, mod)
    got = tcons.build_consensus_bulk(copy.deepcopy(contigs), sequences, mod,
                                     device="cpu")
    assert all(same_result(a, b) for a, b in zip(ref, got))
    assert sum(1 for _, s in got if s is not None) == 3
    for c in contigs:
        r = jcons.build_consensus(copy.deepcopy(c), sequences, mod,
                                  engine="device")
        g = tcons.build_consensus(copy.deepcopy(c), sequences, mod,
                                  engine="device", device="cpu")
        assert same_result(r, g)
    # the host engine is the JAX package's own
    r = jcons.build_consensus(copy.deepcopy(contigs[0]), sequences, mod)
    g = tcons.build_consensus(copy.deepcopy(contigs[0]), sequences, mod)
    assert same_result(r, g)
