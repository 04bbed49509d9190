"""The port's CUDA kernels against their plain torch versions, and the
kernel wrappers' contracts.  This file imports no JAX, so it also runs on a card
machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX).  Tests
marked ``cuda`` skip without a card.  Kernel and plain version must agree
exactly (tolerance 0: integer DP and float32 votes computed in one
order).
"""
import os

import numpy as np
import pytest
import torch

from downpore_tpu_torch.ops import _build, cuda_band, cuda_beam, cuda_chain

torch.set_num_threads(2)

SCAN_NAMES = ["score", "cov_q", "cov_t", "s_qp", "s_tp", "bp"]
VARIANTS = ["extend", "aligner"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def anchor_batch(rng, P, A, levels=False):
    """Random anchors: sorted positions, rank indices with swapped
    neighbours, 85% valid (the recipe of test_align.py's Pallas test).
    With ``levels``, make_anchors_topk's layout: two anchors a query seed,
    side by side, sharing its index and position."""
    qp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    tp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    qi = np.argsort(np.argsort(qp, axis=1), axis=1).astype(np.int32)
    if levels:
        qi //= 2
        qp = np.repeat(qp[:, ::2], 2, axis=1)[:, :A]
    tj = np.argsort(np.argsort(tp, axis=1), axis=1).astype(np.int32)
    for p in range(P):
        for s in rng.integers(0, A - 1, 20):
            tj[p, s], tj[p, s + 1] = tj[p, s + 1], tj[p, s]
    valid = (rng.random((P, A)) < 0.85).astype(np.int32)
    return [torch.from_numpy(a) for a in (qi, tj, qp, tp, valid)]


def test_chain_scan_checks_inputs():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_chain.chain_scan(a.long(), a, a, a, a, 10)
    with pytest.raises(ValueError):
        cuda_chain.chain_scan(a, a, a, a, a[:, :4], 10)
    with pytest.raises(ValueError):
        cuda_chain.chain_scan(a, a, a, a, a.t().contiguous().t(), 10)
    with pytest.raises(ValueError):
        cuda_chain.chain_scan(a, a, a, a, a, 10, "greedy")


def test_chain_scan_empty_batch():
    a = torch.zeros((0, 16), dtype=torch.int32)
    outs = cuda_chain.chain_scan(a, a, a, a, a, 11)
    assert len(outs) == 6 and all(o.shape == (0, 16) for o in outs)


def test_chain_scan_plain_planted_chain():
    """Four colinear anchors 20 bases apart chain 1-2-3-4; an anchor out of
    order in the target and an invalid one start nothing."""
    k = 11
    qp = torch.tensor([[0, 20, 40, 45, 60, 80]], dtype=torch.int32)
    tp = torch.tensor([[100, 120, 140, 10, 160, 180]], dtype=torch.int32)
    qi = torch.tensor([[0, 1, 2, 3, 4, 5]], dtype=torch.int32)
    tj = torch.tensor([[5, 6, 7, 0, 8, 9]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 1, 1, 0]], dtype=torch.int32)
    score, cov_q, cov_t, s_qp, s_tp, bp = cuda_chain.chain_scan(
        qi, tj, qp, tp, valid, k)
    assert score.tolist() == [[1, 2, 3, 1, 4, 0]]
    assert bp.tolist() == [[-1, 0, 1, -1, 2, -1]]
    assert cov_q.tolist() == [[11, 22, 33, 11, 44, 0]]
    assert s_qp.tolist() == [[0, 0, 0, 45, 0, 0]]
    assert s_tp.tolist() == [[100, 100, 100, 10, 100, 0]]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_scan_kernel_matches_plain_on_card(cuda_device, variant):
    rng = np.random.default_rng(0)
    for A in (64, 128, 384):
        arrs = [a.to(cuda_device) for a in anchor_batch(rng, 256, A)]
        for ins in (arrs, [torch.flip(-a, dims=(1,)) for a in arrs[:4]]
                    + [torch.flip(arrs[4], dims=(1,))]):
            before = cuda_chain.chain_scan.launches
            got = cuda_chain.chain_scan(*ins, 10, variant)
            ref = cuda_chain.chain_scan_plain(*ins, 10, variant)
            torch.cuda.synchronize()
            assert cuda_chain.chain_scan.launches == before + 1
            for name, r, g in zip(SCAN_NAMES, ref, got):
                assert torch.equal(r, g), f"A={A} {variant}:{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [False, True], ids=["distinct", "paired"])
@pytest.mark.parametrize("A", [64, 96, 128, 256, 384, 640])
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_scan_modes_on_card(cuda_device, A, variant, levels):
    """Each entry point (forward, forward + backward in one launch, lean)
    equals its plain version exactly, at the register forms' A (64 to 384
    = 32 x 12) and at one A above them (the shared-memory form), with
    distinct query seeds and with two anchors a seed (the paired steps)."""
    assert cuda_chain._lib().chain_scan_max_register_a() == 384
    rng = np.random.default_rng(A + len(variant))
    ins = [a.to(cuda_device) for a in anchor_batch(rng, 96, A, levels)]
    for fn, mode in ((cuda_chain.chain_scan, "forward"),
                     (cuda_chain.chain_scan_fb, "fb"),
                     (cuda_chain.chain_scan_lean, "lean")):
        before = cuda_chain.chain_scan.launches
        got = fn(*ins, 10, variant)
        ref = cuda_chain.chain_scan_plain(*ins, 10, variant, mode)
        torch.cuda.synchronize()
        assert cuda_chain.chain_scan.launches == before + 1
        assert len(got) == len(ref) == cuda_chain.N_OUT[mode]
        for i, (r, g) in enumerate(zip(ref, got)):
            assert torch.equal(r, g), f"A={A} {variant} {mode}: output {i}"


@pytest.mark.cuda
def test_dp_from_anchors_is_one_launch_on_card(cuda_device):
    from downpore_tpu_torch.ops import chain
    rng = np.random.default_rng(3)
    qi, tj, qp, tp, valid = (a.to(cuda_device)
                             for a in anchor_batch(rng, 64, 128))
    anchors = {"qi": qi, "tj": tj, "qp": qp, "tp": tp,
               "valid": valid.bool(), "overflow": torch.zeros_like(qi[:, 0])}
    before = cuda_chain.chain_scan.launches
    got = chain.dp_from_anchors(anchors, 11)
    assert cuda_chain.chain_scan.launches == before + 1
    ref = chain.dp_from_anchors({k: v.cpu() for k, v in anchors.items()}, 11)
    for key in ref:
        assert torch.equal(got[key].cpu(), ref[key]), key


@pytest.mark.cuda
def test_map_batch_on_card_matches_cpu(cuda_device):
    from downpore_tpu_torch.core import Sequence
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = Sequence.from_string(
        bases[rng.integers(0, 4, 60000)].tobytes().decode(), id=0,
        name="chr")
    values = score_seed_values(kmer_occurrences([genome], 11), 11)
    args = (genome, False, 11, values, 40, 1000, 10000)
    on_card = Mapper(*args, device=cuda_device)
    on_cpu = Mapper(*args, device="cpu")
    reads = []
    for i in range(24):
        p = int(rng.integers(0, 55000))
        codes = genome.codes[p:p + int(rng.integers(1500, 5000))].copy()
        m = rng.random(len(codes)) < 0.08
        codes[m] = (codes[m] + rng.integers(1, 4, int(m.sum()))) % 4
        reads.append(Sequence(codes, id=i, name=f"r{i}"))
    before = cuda_chain.chain_scan.launches
    got = [[on_card.as_string(m) for m in ms]
           for ms in on_card.map_batch(reads)]
    assert cuda_chain.chain_scan.launches > before
    ref = [[on_cpu.as_string(m) for m in ms]
           for ms in on_cpu.map_batch(reads)]
    assert got == ref
    assert sum(1 for ms in got if ms) >= 22


@pytest.mark.cuda
@pytest.mark.parametrize("shipped", [False, True], ids=["bd", "bc"])
def test_binned_dispatch_on_card_matches_cpu(cuda_device, monkeypatch,
                                             shipped):
    """A toy binned engine (16-chunk threshold, bins of 8) on the card and
    on the CPU: equal collected (head, summary) on both binned routes."""
    from downpore_tpu_torch.core import Sequence
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.ops import map_engine
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    monkeypatch.setattr(map_engine, "_BINNED_MIN_C", 16)
    monkeypatch.setattr(map_engine, "_BINNED_CB", 8)
    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", np.uint8)
    text = bases[rng.integers(0, 4, 120_000)].tobytes().decode()
    genome = Sequence.from_string(text, id=0, name="ref")
    values = score_seed_values(kmer_occurrences([genome], 11), 11)
    args = (genome, False, 11, values, 40, 1000, 2000)
    engines = [Mapper(*args, device=d).engine for d in (cuda_device, "cpu")]
    windows = []
    for i in range(16):
        p = int(rng.integers(0, 115_000))
        windows.append(genome.subsequence(p, p + 1000))
    route = "_fused_map_bc" if shipped else "_fused_map_bd"
    out = []
    for eng in engines:
        assert eng._binned
        packed = eng.pack_query_windows(windows)
        base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
        if shipped:
            packed = packed[:6]
        eng.routes.clear()
        out.append(eng.collect_arrays_many(
            [eng.dispatch_packed(packed, base_min)])[0])
        assert dict(eng.routes) == {route: 1}
    (h_g, p_g), (h_c, p_c) = out
    assert h_g.shape[0] >= 16
    np.testing.assert_array_equal(h_g, h_c)
    np.testing.assert_array_equal(p_g, p_c)


def trim_windows(rng, n, length, adapters):
    """``n`` windows of ``length`` random bases, every other one with a
    bundled adapter planted at a random offset."""
    from downpore_tpu_torch.core import Sequence
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        s = bases[rng.integers(0, 4, length)].tobytes().decode()
        if i % 2:
            ad = adapters[i % len(adapters)][1]
            at = int(rng.integers(0, length - len(ad)))
            s = s[:at] + ad + s[at + len(ad):]
        out.append(Sequence.from_string(s, id=i))
    return out


@pytest.mark.cuda
def test_trim_engine_on_card_matches_cpu(cuda_device):
    """The trim engine's edge verdicts of both sides and middle-pass
    detections on the card and on the CPU (bundled adapters, 96-anchor extend DP)."""
    from downpore_tpu_torch.trim import BACK_ADAPTERS, FRONT_ADAPTERS
    from downpore_tpu_torch.trim import load_trimmer
    from downpore_tpu_torch.ops import window_engine as we

    rng = np.random.default_rng(12)
    fronts = trim_windows(rng, 256, 150, FRONT_ADAPTERS)
    backs = trim_windows(rng, 256, 150, BACK_ADAPTERS)
    mids = trim_windows(rng, 128, 512, FRONT_ADAPTERS)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        t = load_trimmer("", "", 6, verbosity=0, device=dev)
        eng = t._engine()
        assert eng.nq == 48
        W = t.WINDOW - t.k + 1
        gmf, cmf = t._edge_mins(t.front_sets)
        gmb, cmb = t._edge_mins(t.back_sets)
        before = cuda_chain.chain_scan.launches
        edges = eng.edge_verdict_collect(eng.edge_verdict_dispatch(
            fronts, True, gmf, cmf, W), len(gmf)) \
            + eng.edge_verdict_collect(eng.edge_verdict_dispatch(
                backs, False, gmb, cmb, W), len(gmb))
        mm = t._mid_min_matches()
        p, lens = we._pack_windows(mids, 512 - t.k + 1, t.k)
        dets = eng.window_verdict_collect(eng.window_verdict_dispatch_packed(
            [eng.upload_rows(p, lens, len(mids)) + (0,)], mm, mm,
            t.mid_threshold, 512 - t.k + 1))
        launched = cuda_chain.chain_scan.launches - before
        assert launched > 0 if dev.type == "cuda" else launched == 0
        out.append((edges, dets))
    (e_g, d_g), (e_c, d_c) = out
    for g, c in zip(e_g, e_c):
        np.testing.assert_array_equal(g, c)
    np.testing.assert_array_equal(d_g, d_c)
    assert e_g[0][:, 0].sum() >= 100 and len(d_g) >= 50


@pytest.mark.cuda
def test_chain_scan_kernel_at_the_trim_shape(cuda_device):
    """A = 96 (2 x nq for the bundled adapters), extend variant, forward
    and backward inputs."""
    rng = np.random.default_rng(96)
    arrs = [a.to(cuda_device) for a in anchor_batch(rng, 2048, 96)]
    for ins in (arrs, [torch.flip(-a, dims=(1,)) for a in arrs[:4]]
                + [torch.flip(arrs[4], dims=(1,))]):
        ins = [a.contiguous() for a in ins]
        got = cuda_chain.chain_scan(*ins, 6, "extend")
        ref = cuda_chain.chain_scan_plain(*ins, 6, "extend")
        torch.cuda.synchronize()
        for name, r, g in zip(SCAN_NAMES, ref, got):
            assert torch.equal(r, g), name


def test_build_tag_covers_included_headers(tmp_path):
    """An edited header changes the build tag of every source that
    includes it, directly or through another header."""
    (tmp_path / "a.cuh").write_text("#pragma once\nconstexpr int X = 1;\n")
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    (tmp_path / "k.cu").write_text('#include "b.cuh"\n#include <cstdio>\n')
    (tmp_path / "other.cu").write_text("int f() { return 0; }\n")
    tag = _build.source_tag("k", str(tmp_path))
    other = _build.source_tag("other", str(tmp_path))
    (tmp_path / "a.cuh").write_text("#pragma once\nconstexpr int X = 2;\n")
    assert _build.source_tag("k", str(tmp_path)) != tag
    assert _build.source_tag("other", str(tmp_path)) == other
    assert _build.source_tag("beam_consensus") != \
        _build.source_tag("band_update")


def band_batch(rng, B, W=32):
    """test_align.py's recipe: distances in [0, 40), bands in [0, 500)
    with a quarter of the lanes pruned to BAND_FULL."""
    ds = rng.integers(0, 40, (B, W)).astype(np.int32)
    poffs = rng.integers(0, 500, (B, W)).astype(np.int32)
    poffs[rng.random((B, W)) < 0.25] = cuda_band.BAND_FULL
    return torch.from_numpy(ds), torch.from_numpy(poffs)


def test_update_bands_checks_inputs():
    a = torch.zeros((4, 32), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_band.update_bands(a.long(), a, 300)
    with pytest.raises(ValueError):
        cuda_band.update_bands(a, a[:, :16].contiguous(), 300)
    with pytest.raises(ValueError):
        cuda_band.update_bands(a[0], a[0], 300)


def beam_jobs(rng, J, N, L, core=None, err=0.06):
    """Member k-mer arrays (k = 5) of noisy copies of a random core, the
    members of a job cut to differing lengths."""
    seqs = np.full((J, N, L), -1, np.int32)
    lens = np.zeros((J, N), np.int32)
    firsts = np.zeros(J, np.int32)
    for j in range(J):
        base = rng.integers(0, 4, (core or L) + 4)
        for n in range(N):
            codes = base.copy()
            m = rng.random(len(codes)) < err
            codes[m] = rng.integers(0, 4, int(m.sum()))
            ln = int(rng.integers(L * 3 // 4, L + 1))
            km = np.zeros(ln, np.int64)
            for i in range(5):
                km = (km << 2) | codes[i:i + ln]
            seqs[j, n, :ln] = km
            lens[j, n] = ln
        firsts[j] = seqs[j, 0, 0]
    return [torch.from_numpy(a) for a in (seqs, lens, firsts)]


def test_beam_consensus_checks_inputs():
    seqs, lens, firsts = beam_jobs(np.random.default_rng(0), 2, 3, 40)
    with pytest.raises(TypeError):
        cuda_beam.beam_consensus(seqs.long(), lens, firsts, None, 5, 4, 64,
                                 300, 8, 5)
    with pytest.raises(ValueError):
        cuda_beam.beam_consensus(seqs, lens[:1], firsts, None, 5, 4, 64,
                                 300, 8, 5)
    with pytest.raises(ValueError):     # 4 * beam candidates > one warp
        cuda_beam.beam_consensus(seqs, lens, firsts, None, 5, 9, 64, 300,
                                 8, 5)
    with pytest.raises(ValueError):     # the table measure needs a table
        cuda_beam.beam_consensus(seqs, lens, firsts, None, 5, 4, 64, 300,
                                 8, 0)


def test_beam_consensus_ragged_checks_inputs():
    seqs, lens, firsts, shapes = ragged_set(np.random.default_rng(1),
                                            [(4, 40), (8, 60)])
    args = (None, 5, 4, 300, 8, 5)
    with pytest.raises(ValueError):     # one shape short
        cuda_beam.beam_consensus_ragged(seqs, lens, firsts[:1], shapes[:1],
                                        *args)
    with pytest.raises(ValueError):     # k-mers of another size
        cuda_beam.beam_consensus_ragged(seqs[:-1].contiguous(), lens, firsts,
                                        shapes, *args)
    with pytest.raises(ValueError):     # (N, L, T) per job
        cuda_beam.beam_consensus_ragged(seqs, lens, firsts,
                                        [s[:2] for s in shapes], *args)
    with pytest.raises(TypeError):
        cuda_beam.beam_consensus_ragged(seqs.long(), lens, firsts, shapes,
                                        *args)
    with pytest.raises(ValueError):     # records mode takes one shape
        cuda_beam.beam_consensus_ragged_plain(seqs, lens, firsts, shapes,
                                              *args, return_records=True)
    for thr, gap in ((0, 8), (300, -1)):  # the kernel's band range
        with pytest.raises(ValueError):
            cuda_beam._launch(seqs, lens, firsts, shapes, None, 5, 4, thr,
                              gap, 5, False)
    chains, ns = cuda_beam.beam_consensus_ragged(seqs, lens, firsts, shapes,
                                                 *args)
    assert chains.shape == (2, t_max_of(60)) and ns.shape == (2,)


def test_beam_consensus_uniform_is_the_ragged_case():
    """beam_consensus on [J, N, L] equals the ragged form with J equal
    shapes (plain versions, CPU)."""
    seqs, lens, firsts = beam_jobs(np.random.default_rng(2), 3, 4, 48)
    t_max = t_max_of(48)
    args = (None, 5, 4, 300, 8, 5)
    chains, ns = cuda_beam.beam_consensus(seqs, lens, firsts, None, 5, 4,
                                          t_max, 300, 8, 5)
    r_chains, r_ns = cuda_beam.beam_consensus_ragged(
        seqs.view(-1), lens.view(-1), firsts, [(4, 48, t_max)] * 3, *args)
    assert torch.equal(chains, r_chains) and torch.equal(ns, r_ns)


@pytest.mark.parametrize("J, N, beam, sms, warps", [
    (1, 12, 4, 132, 24), (2, 12, 4, 132, 24), (1, 8, 4, 132, 32),
    (1, 4, 4, 132, 16), (2, 4, 4, 132, 16), (1024, 8, 4, 132, 4),
    (40, 4, 4, 132, 16), (6, 5, 8, 132, 20), (300, 12, 4, 132, 12),
    (1, 600, 4, 132, 32), (1, 1, 1, 132, 4), (300, 12, 4, 66, 7),
    (300, 12, 4, 100, 10), (40, 12, 4, 20, 16)])
def test_beam_warps_geometry(J, N, beam, sms, warps):
    """Few jobs get up to 32 warps each, evened over the beam x N tasks of
    a step; many jobs get fewer (at least 4) so the card's ``sms`` SMs
    stay full."""
    assert cuda_beam.beam_warps(J, N, beam, sms) == warps


@pytest.mark.cuda
def test_update_bands_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(21)
    for B, W in ((37, 32), (4096, 32), (100, 20)):
        ds, poffs = (a.to(cuda_device) for a in band_batch(rng, B, W))
        before = cuda_band.update_bands.launches
        out, m = cuda_band.update_bands(ds, poffs, 300)
        ref_out, ref_m = cuda_band.update_bands_plain(ds, poffs, 300)
        torch.cuda.synchronize()
        assert cuda_band.update_bands.launches == before + 1
        assert torch.equal(out, ref_out) and torch.equal(m, ref_m), (B, W)


def simple_table(k=5):
    """The simple measure's [4^k, 4^k] distance table as int16 bits."""
    from downpore_tpu_torch.ops.dtw import _simple_distance
    ar = torch.arange(4 ** k, dtype=torch.int32)
    return _simple_distance(ar[:, None], ar[None, :], k).to(torch.int16)


def t_max_of(L):
    return ((int(L * 1.3) + 32 + 31) // 32) * 32


# (J, N, L, beam): the earlier mixed shapes, correct's recorded shapes
# (1-2 jobs, 4-12 members, L 640 and 1024) and bench.py's 1024-job bucket
BEAM_SHAPES = [(40, 4, 128, 4), (9, 8, 640, 4), (6, 5, 128, 8)] + [
    (J, N, L, 4) for J in (1, 2) for N in (4, 8, 12) for L in (640, 1024)
] + [(1024, 8, 512, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BEAM_SHAPES,
                         ids=["x".join(map(str, s)) for s in BEAM_SHAPES])
@pytest.mark.parametrize("measure", ["simple", "table"])
def test_beam_consensus_kernel_matches_plain_on_card(cuda_device, measure,
                                                     shape):
    """Chains and n_valid (early exit, traceback in the kernel) and the
    records of all t_max steps equal the plain version's."""
    J, N, L, beam = shape
    rng = np.random.default_rng(5 + J + N + L)
    simple_k = 5 if measure == "simple" else 0
    table = None if simple_k else simple_table().to(cuda_device)
    seqs, lens, firsts = (a.to(cuda_device) for a in beam_jobs(rng, J, N, L))
    t_max = t_max_of(L)
    args = (seqs, lens, firsts, table, 5, beam, t_max, 300, 8, simple_k)
    before = cuda_beam.beam_consensus.launches
    chains, ns = cuda_beam.beam_consensus(*args)
    rec = cuda_beam.beam_consensus(*args, return_records=True)
    ref_chains, ref_ns = cuda_beam.beam_consensus_plain(*args)
    ref_rec = cuda_beam.beam_consensus_plain(*args, return_records=True)
    torch.cuda.synchronize()
    assert cuda_beam.beam_consensus.launches == before + 2
    assert torch.equal(ns, ref_ns) and torch.equal(chains, ref_chains)
    assert torch.equal(rec, ref_rec)
    # early exit + in-kernel traceback == the full records' traceback
    walked = cuda_beam.traceback_plain(rec, t_max)
    assert torch.equal(walked[0], chains) and torch.equal(walked[1], ns)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4, 6])
def test_beam_consensus_kernel_other_simple_k_on_card(cuda_device, k):
    """The simple measure's other schedules (the kernel sums them as
    popcounts under per-weight masks) equal the plain version."""
    rng = np.random.default_rng(30 + k)
    seqs, lens, firsts = beam_jobs(rng, 3, 6, 200)
    seqs = torch.where(seqs >= 0, seqs & (4 ** k - 1), seqs)
    firsts = seqs[:, 0, 0].contiguous()
    args = (seqs.to(cuda_device), lens.to(cuda_device),
            firsts.to(cuda_device), None, k, 4, t_max_of(200), 300, 8, k)
    got = cuda_beam.beam_consensus(*args)
    ref = cuda_beam.beam_consensus_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def ragged_set(rng, specs):
    """A ragged job set: per (N, L) in ``specs`` one beam_jobs job, as flat
    k-mers and lengths, firsts and (N, L, t_max) shapes."""
    blocks, rows, firsts, shapes = [], [], [], []
    for N, L in specs:
        seqs, lens, first = beam_jobs(rng, 1, N, L)
        blocks.append(seqs.reshape(-1))
        rows.append(lens.reshape(-1))
        firsts.append(first)
        shapes.append((N, L, t_max_of(L)))
    return (torch.cat(blocks), torch.cat(rows), torch.cat(firsts), shapes)


RAGGED_SPECS = [(8, 640), (4, 1024), (12, 640), (8, 640), (4, 128),
                (12, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("measure", ["simple", "table"])
def test_beam_consensus_ragged_one_launch_on_card(cuda_device, measure):
    """Jobs of five (N, L, T) shapes in one launch equal the ragged plain
    version (each job its own bucket's uniform scan)."""
    simple_k = 5 if measure == "simple" else 0
    table = None if simple_k else simple_table().to(cuda_device)
    seqs, lens, firsts, shapes = ragged_set(np.random.default_rng(17),
                                            RAGGED_SPECS)
    seqs, lens, firsts = (a.to(cuda_device) for a in (seqs, lens, firsts))
    args = (seqs, lens, firsts, shapes, table, 5, 4, 300, 8, simple_k)
    before = cuda_beam.beam_consensus.launches
    chains, ns = cuda_beam.beam_consensus_ragged(*args)
    torch.cuda.synchronize()
    assert cuda_beam.beam_consensus.launches == before + 1
    ref_chains, ref_ns = cuda_beam.beam_consensus_ragged_plain(*args)
    assert torch.equal(ns, ref_ns) and torch.equal(chains, ref_chains)
    assert chains.shape == (len(shapes), t_max_of(1024))


EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_emu")


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """csrc/beam_consensus.cu compiled for the CPU against
    tests/cuda_emu/cuda_runtime.h (g++, C++20): its dynamic shared array
    made a pointer to the emulated block's buffer and its launch a call of
    emu_launch; loaded with ctypes."""
    import ctypes
    import re
    import shutil
    import subprocess
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    with open(os.path.join(_build.CSRC, "beam_consensus.cu")) as f:
        src = f.read()
    src, n_smem = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
        "unsigned char* smem = emu_smem;", src)
    src, n_launch = re.subn(
        r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*\(cudaStream_t\)stream"
        r">>>\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \5);", src)
    assert (n_smem, n_launch) == (1, 1)
    out = tmp_path_factory.mktemp("beam_emu")
    cpp, so = out / "beam_consensus.cpp", out / "beam_consensus.so"
    cpp.write_text(src)
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", EMU_DIR, "-I", _build.CSRC, "-o", str(so), str(cpp),
         "-lpthread"], capture_output=True, text=True)
    if proc.returncode and "<barrier>" in proc.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.beam_consensus_launch.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.beam_consensus_launch.restype = ctypes.c_int
    lib.beam_consensus_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.beam_consensus_scratch_bytes.restype = ctypes.c_longlong
    return lib


def emulated_launch(lib, seqs, lens, firsts, shapes, table, simple_k,
                    records):
    """cuda_beam._launch's call of the kernel (k = 5, beam 4, threshold
    300, gap 8, beam_warps' warps on an H100's 132 SMs) on CPU tensors,
    into the emulation."""
    J, beam = len(shapes), 4
    t_top = max(T for _, _, T in shapes)
    meta, n_top, sw_top = cuda_beam.plan(shapes)
    chains = torch.full((J, t_top), -7, dtype=torch.int32)
    n_valid = torch.full((J,), -7, dtype=torch.int32)
    rec = torch.full((J, t_top, 4, beam), -7, dtype=torch.int32)
    need = lib.beam_consensus_scratch_bytes(n_top, beam, sw_top, t_top)
    scratch = torch.zeros(J * need, dtype=torch.uint8) if need else None
    err = lib.beam_consensus_launch(
        seqs.data_ptr(), lens.data_ptr(), firsts.data_ptr(), meta.data_ptr(),
        None if table is None else table.data_ptr(), chains.data_ptr(),
        n_valid.data_ptr(), rec.data_ptr(),
        None if scratch is None else scratch.data_ptr(), J, n_top, t_top,
        sw_top, 5, beam, 300, 8, simple_k, 0 if records else 1,
        cuda_beam.beam_warps(J, n_top, beam, 132), None)
    assert err == 0
    return rec if records else (chains, n_valid)


@pytest.mark.parametrize("measure", ["simple", "table"])
def test_beam_kernel_source_emulated_matches_plain(emulated_kernel,
                                                   measure):
    """The kernel's source, run on the CPU under the emulation of its CUDA
    intrinsics, equals the plain version: chains and n_valid (early exit,
    in-kernel traceback) and the records of all steps, with a member that
    has no k-mers (bucket padding)."""
    simple_k = 5 if measure == "simple" else 0
    table = None if simple_k else simple_table()
    seqs, lens, firsts = beam_jobs(np.random.default_rng(40), 2, 4, 96)
    seqs[1, 3] = -1
    lens[1, 3] = 0
    T = t_max_of(96)
    shapes = [(4, 96, T)] * 2
    args = (seqs.view(-1), lens.view(-1), firsts, shapes, table, simple_k)
    chains, ns = emulated_launch(emulated_kernel, *args, False)
    plain = (seqs, lens, firsts, table, 5, 4, T, 300, 8, simple_k)
    ref_chains, ref_ns = cuda_beam.beam_consensus_plain(*plain)
    assert torch.equal(ns, ref_ns) and torch.equal(chains, ref_chains)
    rec = emulated_launch(emulated_kernel, *args, True)
    assert torch.equal(rec, cuda_beam.beam_consensus_plain(
        *plain, return_records=True))


@pytest.mark.parametrize("route", ["shared", "scratch"])
def test_beam_kernel_source_emulated_ragged(emulated_kernel, route):
    """One emulated launch over jobs of three shapes, one long enough that
    its window base moves (restaged in shared memory), equals the ragged
    plain version, on the shared route and on the device-scratch route
    (the emulated card's shared memory cut to 4 KB)."""
    import ctypes
    seqs, lens, firsts, shapes = ragged_set(np.random.default_rng(41),
                                            [(4, 64), (6, 520), (3, 96)])
    limit = ctypes.c_int.in_dll(emulated_kernel, "emu_max_smem")
    saved = limit.value
    if route == "scratch":
        limit.value = 4096
    try:
        got = emulated_launch(emulated_kernel, seqs, lens, firsts, shapes,
                              None, 5, False)
    finally:
        limit.value = saved
    ref = cuda_beam.beam_consensus_ragged_plain(seqs, lens, firsts, shapes,
                                                None, 5, 4, 300, 8, 5)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


@pytest.mark.cuda
def test_consensus_kmers_bulk_is_one_launch_on_card(cuda_device):
    """consensus_kmers_bulk over jobs of three buckets: one launch, the
    CPU's consensus k-mers."""
    from downpore_tpu_torch.ops import dtw
    rng = np.random.default_rng(18)
    jobs = []
    for n, core in ((3, 500), (6, 700), (9, 500), (3, 90)):
        seqs, lens, _ = beam_jobs(rng, 1, n, core)
        jobs.append([seqs[0, i, :lens[0, i]].numpy() for i in range(n)])
    table = simple_table().numpy().view(np.uint16)
    before = cuda_beam.beam_consensus.launches
    got = dtw.consensus_kmers_bulk(jobs, table, 5, simple_k=5,
                                   device=cuda_device)
    assert cuda_beam.beam_consensus.launches == before + 1
    ref = dtw.consensus_kmers_bulk(jobs, table, 5, simple_k=5, device="cpu")
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    assert all(len(a) > 50 for a in got)


@pytest.mark.cuda
def test_beam_consensus_kernel_scratch_route_on_card(cuda_device):
    """A bucket whose per-member state overflows shared memory keeps it in
    a device scratch, with the same result."""
    rng = np.random.default_rng(6)
    N = 600
    seqs, lens, firsts = (a.to(cuda_device)
                          for a in beam_jobs(rng, 2, N, 96, err=0.04))
    args = (seqs, lens, firsts, None, 5, 4, 160, 300, 8, 5)
    got = cuda_beam.beam_consensus(*args)
    ref = cuda_beam.beam_consensus_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_correct_on_card_matches_cpu(cuda_device):
    """The correct path on the card launches the beam kernel and prints
    the same fasta as on the CPU (chip_smoke.py's 48-read fixture)."""
    import importlib.util
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    records = smoke.golden_overlap_records()[:32]
    before = cuda_beam.beam_consensus.launches
    on_card, err = smoke.run_correct(records, "cuda")
    assert smoke.FALLBACK_LINE not in err
    assert cuda_beam.beam_consensus.launches > before
    on_cpu, _ = smoke.run_correct(records, "cpu")
    assert on_card == on_cpu and on_card.count(">") >= 1


@pytest.mark.cuda
def test_correct_on_card_does_not_fall_back(cuda_device, monkeypatch):
    """On the card a device consensus that raises ends the run: the host
    engine never takes over the kernel's work (on the CPU the JAX
    command's fallback line and host rerun are kept)."""
    import importlib.util
    import os
    import downpore_tpu_torch.consensus as torch_consensus
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def fail(*a, **kw):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(torch_consensus, "build_consensus_bulk", fail)
    with pytest.raises(RuntimeError, match="kernel failed"):
        smoke.run_correct(smoke.golden_overlap_records()[:32], "cuda")


def test_hit_counts_checks_shapes():
    from downpore_tpu_torch.ops import match
    v = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        match.hit_counts(v, torch.zeros((15, 8), dtype=torch.int8))
    got = match.hit_counts(v, torch.ones((16, 8), dtype=torch.int8))
    assert got.dtype == torch.int32 and got.shape == (4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,S,C", [(5, 203, 19), (17, 64, 8),
                                   (64, 1000, 130)])
def test_hit_counts_on_card_matches_int32_product(cuda_device, Q, S, C):
    """``torch._int_mm``'s shape rules (more than 16 rows, K and N
    multiples of 8) met by zero padding: the counts equal numpy's int32
    product, negative multiplicities included; the bit-packed route equals
    the unpacked one."""
    from downpore_tpu_torch.ops import match
    rng = np.random.default_rng(Q + S + C)
    V = rng.integers(-128, 128, (Q, S)).astype(np.int8)
    M = rng.integers(0, 2, (S, C)).astype(np.int8)
    got = match.hit_counts(V, M, device=cuda_device)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert np.array_equal(got.cpu().numpy(),
                          V.astype(np.int32) @ M.astype(np.int32))
    bits = (V > 0).astype(np.uint8)
    packed = torch.from_numpy(np.packbits(bits, axis=1)).to(cuda_device)
    assert torch.equal(match.hit_counts_packed(packed, M),
                       match.hit_counts(bits.astype(np.int8), M,
                                        device=cuda_device))


@pytest.mark.cuda
def test_chain_batch_on_card_matches_cpu(cuda_device):
    """``chain_batch`` (make_anchors, overflow included, then one fb
    launch) on the card equals the CPU's plain run."""
    from downpore_tpu_torch.ops import chain
    rng = np.random.default_rng(8)
    P, NQ, NT = 48, 24, 40
    qs = rng.integers(0, 10, (P, NQ)).astype(np.int32)
    ts = rng.integers(0, 10, (P, NT)).astype(np.int32)
    qs[0] = -1
    qp = np.cumsum(rng.integers(1, 30, (P, NQ)), axis=1).astype(np.int32)
    tp = np.cumsum(rng.integers(1, 30, (P, NT)), axis=1).astype(np.int32)
    before = cuda_chain.chain_scan.launches
    got = chain.chain_batch(qs, qp, ts, tp, k=6, max_anchors=64,
                            device=cuda_device)
    assert cuda_chain.chain_scan.launches == before + 1
    ref = chain.chain_batch(qs, qp, ts, tp, k=6, max_anchors=64,
                            device="cpu")
    assert int(ref["overflow"].max()) > 0
    for key in ref:
        assert torch.equal(got[key].cpu(), ref[key]), key
