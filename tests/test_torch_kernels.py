"""The port's CUDA kernels against their plain torch versions, and the
kernel wrappers' contracts.  This file imports no JAX, so it also runs on a card
machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX).  Tests
marked ``cuda`` skip without a card.  Kernel and plain version must agree
exactly (tolerance 0: integer DP and float32 votes computed in one
order).
"""
import contextlib
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


def emulated_source(name, out_dir):
    """csrc/<name>.cu compiled for the CPU against tests/cuda_emu/
    cuda_runtime.h (g++, C++20): its dynamic shared array made a pointer to
    the emulated block's buffer and its launch a call of emu_launch; loaded
    with ctypes (skips without g++ or C++20's <barrier>)."""
    import ctypes
    import re
    import shutil
    import subprocess
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        src = f.read()
    src, n_smem = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
        "unsigned char* smem = emu_smem;", src)
    src, n_launch = re.subn(
        r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*\(cudaStream_t\)stream"
        r">>>\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \5);", src)
    assert (n_smem, n_launch) == (1, 1)
    cpp, so = out_dir / (name + ".cpp"), out_dir / (name + ".so")
    cpp.write_text(src)
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", EMU_DIR, "-I", _build.CSRC, "-o", str(so), str(cpp),
         "-lpthread"], capture_output=True, text=True)
    if proc.returncode and "<barrier>" in proc.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """csrc/beam_consensus.cu under the emulation (``emulated_source``)."""
    import ctypes
    lib = emulated_source("beam_consensus",
                          tmp_path_factory.mktemp("beam_emu"))
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


def seed_rows(rng, P, NQ, NT, alphabet):
    """Anchor-build inputs: ``[P, NQ]`` query and ``[P, NT]`` target seed
    rows from a small alphabet (targets hold a seed more than twice, query
    seeds repeat), -1 padded at random lengths, one row of each all -1,
    with increasing int32 positions."""
    qs = rng.integers(0, alphabet, (P, NQ)).astype(np.int32)
    ts = rng.integers(0, alphabet, (P, NT)).astype(np.int32)
    qs[np.arange(NQ)[None, :] >= rng.integers(0, NQ + 1, P)[:, None]] = -1
    ts[np.arange(NT)[None, :] >= rng.integers(0, NT + 1, P)[:, None]] = -1
    qs[P // 2] = -1
    ts[P // 3] = -1
    qpos = np.cumsum(rng.integers(1, 40, (P, NQ)), axis=1).astype(np.int32)
    tpos = np.cumsum(rng.integers(1, 40, (P, NT)), axis=1).astype(np.int32)
    return [torch.from_numpy(a) for a in (qs, qpos, ts, tpos)]


def slot_rows(rng, P, M, C):
    """An engine's pair-budget slots: int64 rows into ``M`` query and ``C``
    target rows, the first of them live, the rest dead at row 0."""
    n_live = int(rng.integers(1, P))
    live = torch.arange(P) < n_live
    mi = torch.from_numpy(rng.integers(0, M, P)).where(live, 0)
    ci = torch.from_numpy(rng.integers(0, C, P)).where(live, 0)
    return mi, ci, live


def count_inputs(rng, H, W, M, R, lo=0):
    """Retrieval-count inputs: an int8 ``[H, W]`` membership (values in
    [lo, 1], so a sign or a byte-order slip shows), ``[M, R]`` int32
    buckets, -1 padded at random lengths with one row all -1, and a
    ``first`` mask over the live slots."""
    mem = rng.integers(lo, 2, (H, W)).astype(np.int8)
    b = rng.integers(0, H, (M, R)).astype(np.int32)
    b[np.arange(R)[None, :] >= rng.integers(0, R + 1, M)[:, None]] = -1
    b[M // 2] = -1
    first = (b >= 0) & (rng.random((M, R)) < 0.6)
    return [torch.from_numpy(a) for a in (mem, b, first)]


@pytest.fixture(scope="module")
def emulated_anchors(tmp_path_factory):
    """csrc/anchors_topk.cu under the emulation (``emulated_source``)."""
    from downpore_tpu_torch.ops import cuda_anchors
    return cuda_anchors._bind(emulated_source(
        "anchors_topk", tmp_path_factory.mktemp("anchors_emu")))


@pytest.fixture(scope="module")
def emulated_counts(tmp_path_factory):
    """csrc/retrieval_count.cu under the emulation (``emulated_source``)."""
    from downpore_tpu_torch.ops import cuda_counts
    return cuda_counts._bind(emulated_source(
        "retrieval_count", tmp_path_factory.mktemp("counts_emu")))


def _emulated_anchors(lib, *args):
    from downpore_tpu_torch.ops import cuda_anchors
    qs, mi = args[0], (args[4] if len(args) > 4 else None)
    P = (qs if mi is None else mi).shape[0]
    outs = cuda_anchors._outputs(P, qs.shape[1], qs.device)
    for o in outs:
        o.fill_(True if o.dtype == torch.bool else -7)
    assert cuda_anchors._call(lib, outs, *args) == 0
    return outs


@pytest.mark.parametrize("NQ, NT, alphabet", [(70, 1100, 50), (32, 1, 3),
                                               (5, 9, 3)])
def test_anchor_kernel_source_emulated_rows(emulated_anchors, NQ, NT,
                                            alphabet):
    """The anchor kernel's source, run on the CPU under the emulation,
    equals the plain version on rows: three seeds a lane in a tile of 1024
    and a second tile, NT = 1, NQ below a warp."""
    from downpore_tpu_torch.ops import cuda_anchors
    args = seed_rows(np.random.default_rng(NQ + NT), 9, NQ, NT, alphabet)
    got = _emulated_anchors(emulated_anchors, *args)
    ref = cuda_anchors.anchors_topk_plain(*args)
    assert int(ref[5].sum()) > 0 or NT == 1
    for name, g, r in zip(cuda_anchors.KEYS, got, ref):
        assert torch.equal(g, r), name


def test_anchor_kernel_source_emulated_indexed(emulated_anchors):
    """The indexed entry under the emulation equals the plain indexed
    build: rows read by index, dead slots empty, over two query groups
    (NQ = 300 > 8 seeds a lane)."""
    from downpore_tpu_torch.ops import cuda_anchors
    rng = np.random.default_rng(3)
    tables = seed_rows(rng, 7, 300, 90, 40)
    mi, ci, live = slot_rows(rng, 11, 7, 7)
    got = _emulated_anchors(emulated_anchors, *tables, mi, ci, live)
    ref = cuda_anchors.anchors_topk_plain(*tables, mi, ci, live)
    assert not bool(got[4][~live].any()) and int(got[5][~live].abs().sum()) \
        == 0
    for name, g, r in zip(cuda_anchors.KEYS, got, ref):
        assert torch.equal(g, r), name


def _emulated_counts(lib, mem, b, first=None, topbin=None, NB=1):
    from downpore_tpu_torch.ops import cuda_counts
    outs = cuda_counts._outputs(mem, b, first, topbin)
    for o in outs:
        o.fill_(-7)
    assert cuda_counts._call(lib, outs, mem, b, first, topbin, NB) == 0
    return outs


@pytest.mark.parametrize("W, R, with_first", [
    (64, 20, True), (70, 20, True), (300, 40, False), (4200, 300, True)],
    ids=["vec16", "bytes", "vec4", "two_tiles"])
def test_count_kernel_source_emulated_flat(emulated_counts, W, R,
                                           with_first):
    """The retrieval-count kernel's source under the emulation equals the
    plain version: 16-byte, 4-byte and 1-byte loads, a ragged tail (C not a
    multiple of 16), two column tiles and two staging rounds (R = 300),
    all-pad rows, with and without the ``first`` mask."""
    from downpore_tpu_torch.ops import cuda_counts
    mem, b, first = count_inputs(np.random.default_rng(W), 50, W, 5, R,
                                 lo=-2)
    first = first if with_first else None
    got = _emulated_counts(emulated_counts, mem, b, first)
    ref = cuda_counts.retrieval_count_plain(mem, b, first)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_count_kernel_source_emulated_binned(emulated_counts):
    """The binned form under the emulation equals the plain version with
    BB = NB (every bin selected, in a shuffled order) and the first mask."""
    from downpore_tpu_torch.ops import cuda_counts
    rng = np.random.default_rng(12)
    H0, NB, CB = 20, 6, 24
    mem, b, first = count_inputs(rng, H0, NB * CB, 7, 30)
    flat = mem.reshape(H0 * NB, CB)
    topbin = torch.from_numpy(np.stack([rng.permutation(NB)
                                        for _ in range(7)]))
    got = _emulated_counts(emulated_counts, flat, b, first, topbin, NB)
    ref = cuda_counts.retrieval_count_plain(flat, b, first, topbin, NB)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def load_chip_smoke():
    """chip_smoke.py loaded as a module (its input recipes)."""
    import importlib.util
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("NQ, NT", [
    (64, 640), (32, 251), (128, 2048), (300, 90), (128, 4096), (64, 4077)],
    ids=["map", "trim", "overlap", "nq300", "nt4096", "nt_ragged"])
def test_anchor_kernel_source_emulated_hard_rows(emulated_anchors, NQ, NT):
    """The anchor kernel's source under the emulation equals the plain
    version on ``chip_smoke.hard_anchor_rows``, on rows and through the
    indexed entry with dead slots: query values that all probe the hash
    table's last entry first (picked with the kernel's own hash,
    ``anchors_topk_first_slot``, so the probes collide and wrap), duplicate
    query values, a value repeated more than twice inside one 32-seed step
    and across steps, second hits in a later step than the first, rows
    without a live query or target seed; NQ = 300 and NT = 4096, 4077."""
    from downpore_tpu_torch.ops import cuda_anchors
    smoke = load_chip_smoke()
    rng = np.random.default_rng(7 * NQ + NT)
    first_slot = emulated_anchors.anchors_topk_first_slot
    rows = [torch.from_numpy(a) for a in smoke.hard_anchor_rows(
        rng, 8, NQ, NT, first_slot)]
    hot = rows[0][0][rows[0][0] >= 0].tolist()
    assert len(set(hot)) == min(NQ, 48) and {
        first_slot(v, NQ) for v in hot} == {smoke.table_size(NQ) - 1}
    mi, ci, live = slot_rows(rng, 12, 8, 8)
    for args in (rows, rows + [mi, ci, live]):
        got = _emulated_anchors(emulated_anchors, *args)
        ref = cuda_anchors.anchors_topk_plain(*args)
        for name, g, r in zip(cuda_anchors.KEYS, got, ref):
            assert torch.equal(g, r), name
    ref = cuda_anchors.anchors_topk_plain(*rows)
    assert int(ref[5][1]) > 0 and int(ref[5][0]) > 0
    assert not bool(ref[4][3].any()) and not bool(ref[4][4].any())


def test_anchor_kernel_launcher_refuses_wide_queries(emulated_anchors):
    """The kernel's table holds at most ``cuda_anchors.MAX_NQ`` query seeds
    a row: the launcher refuses one more and takes exactly that many."""
    from downpore_tpu_torch.ops import cuda_anchors
    rng = np.random.default_rng(5)
    for NQ, refused in ((cuda_anchors.MAX_NQ + 1, True),
                        (cuda_anchors.MAX_NQ, False)):
        args = seed_rows(rng, 2, NQ, 40, 500)
        outs = cuda_anchors._outputs(2, NQ, torch.device("cpu"))
        err = cuda_anchors._call(emulated_anchors, outs, *args)
        assert (err != 0) == refused
        if not refused:
            for g, r in zip(outs, cuda_anchors.anchors_topk_plain(*args)):
                assert torch.equal(g, r)


@pytest.mark.parametrize("W, R", [(56, 300), (13, 300), (512, 300),
                                  (4200, 40), (13, 12)],
                         ids=["bins_vec8", "bytes", "vec16", "vec4",
                              "unsplit"])
def test_count_kernel_source_emulated_full_range(emulated_counts, W, R):
    """The retrieval-count kernel's source under the emulation equals the
    plain version on ``chip_smoke.hard_count_inputs``: int8 values over
    [-128, 127], a row that names the all-127 row in each of its R slots
    and one the all -128 row, a row with no live slot; W = 56 (8-byte
    loads, 4 teams a row summed by shuffles), 13 (1-byte loads, 8 teams a
    row), 512 (16-byte loads, a 512-byte tile, one team a row: at R = 300
    a thread adds 256 slots of 255 into its packed 16-bit lanes before
    they go into the int32 sums), 4200 (4-byte loads, a ragged tile), 13
    at R = 12 (too few slots to split); with and without ``first``."""
    from downpore_tpu_torch.ops import cuda_counts
    smoke = load_chip_smoke()
    mem, b, first = (torch.from_numpy(a) for a in smoke.hard_count_inputs(
        np.random.default_rng(W + R), 40, W, 6, R))
    for f in (first, None):
        got = _emulated_counts(emulated_counts, mem, b, f)
        ref = cuda_counts.retrieval_count_plain(mem, b, f)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert int(ref[0][0].min()) == 127 * R and int(ref[0][2].abs().max()) \
        == 0


def test_count_kernel_source_emulated_binned_full_range(emulated_counts):
    """The binned form under the emulation equals the plain version on
    whole-range int8 values with the ``first`` mask and without, at R =
    270 (two staging rounds) and BB < NB."""
    from downpore_tpu_torch.ops import cuda_counts
    smoke = load_chip_smoke()
    rng = np.random.default_rng(13)
    H0, NB, CB, M = 20, 6, 24, 7
    flat, b, first = (torch.from_numpy(a) for a in smoke.hard_count_inputs(
        rng, H0 * NB, CB, M, 270, NB))
    topbin = torch.from_numpy(np.stack([rng.permutation(NB)[:4]
                                        for _ in range(M)]))
    for f in (first, None):
        got = _emulated_counts(emulated_counts, flat, b, f, topbin, NB)
        ref = cuda_counts.retrieval_count_plain(flat, b, f, topbin, NB)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def _indexed_block(mi, ci, live, q_seeds, q_pos, t_seeds, t_pos):
    from downpore_tpu_torch.ops import cuda_anchors
    return cuda_anchors.anchors_topk_indexed(mi, ci, live, q_seeds, q_pos,
                                             t_seeds, t_pos)


def _count_block(mem, b, first=None, topbin=None, NB=1):
    from downpore_tpu_torch.ops import cuda_counts
    return cuda_counts.retrieval_count(mem, b, first, topbin, NB)


def _replayed(fn, inputs, tables, **statics):
    """``fn``'s block captured as a CUDA graph (``captured.GraphCache``,
    a cache of its own) and then replayed on ``inputs``: returns the
    replay's outputs and the launches that replay counted (each kernel's
    ``launches`` before and after it)."""
    from downpore_tpu_torch.ops import captured, cuda_anchors, cuda_counts
    G = captured.GraphCache()
    warm = {n: t.clone() for n, t in inputs.items()}
    G.run(fn, warm, tables, **statics)
    torch.cuda.synchronize()
    kerns = (cuda_anchors.anchors_topk, cuda_counts.retrieval_count)
    before = [k.launches for k in kerns]
    out = G.run(fn, inputs, tables, **statics)
    torch.cuda.synchronize()
    assert sum(e.replays for e in G.entries.values()) == 1
    return out, [k.launches - n for k, n in zip(kerns, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("NQ, NT, alphabet", [
    (64, 320, 40), (128, 4096, 300), (70, 1100, 50), (300, 90, 40),
    (5, 1, 3), (32, 64, 8)])
def test_anchors_topk_kernel_matches_plain_on_card(cuda_device, NQ, NT,
                                                  alphabet):
    """The anchor kernel on rows equals its plain version: the map and
    overlap engines' widths, a second tile of targets, eight seeds a lane
    and a second query group, NT = 1, dense repeats; one launch each."""
    from downpore_tpu_torch.ops import cuda_anchors
    rows = [a.to(cuda_device) for a in seed_rows(
        np.random.default_rng(NQ * NT), 64, NQ, NT, alphabet)]
    n0 = cuda_anchors.anchors_topk.launches
    got = cuda_anchors.anchors_topk(*rows)
    assert cuda_anchors.anchors_topk.launches == n0 + 1
    ref = cuda_anchors.anchors_topk_plain(*rows)
    torch.cuda.synchronize()
    for name, g, r in zip(cuda_anchors.KEYS, got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name


@pytest.mark.cuda
def test_anchors_topk_indexed_on_card_eager_and_replayed(cuda_device):
    """The indexed entry equals the plain indexed build eagerly and
    replayed inside a captured graph (other slots than the capture's), one
    launch each, counted at the replay; ``map_engine._build_anchors`` is
    that one launch."""
    from downpore_tpu_torch.ops import cuda_anchors
    from downpore_tpu_torch.ops import map_engine as tme
    rng = np.random.default_rng(17)
    tables = [a.to(cuda_device) for a in seed_rows(rng, 40, 128, 700, 90)]
    names = ("q_seeds", "q_pos", "t_seeds", "t_pos")
    slots = [a.to(cuda_device) for a in slot_rows(rng, 500, 40, 40)]
    ref = cuda_anchors.anchors_topk_plain(*tables, *slots)
    n0 = cuda_anchors.anchors_topk.launches
    for got in (cuda_anchors.anchors_topk_indexed(*slots, *tables),
                tuple(tme._build_anchors(*slots, *tables).values())):
        for name, g, r in zip(cuda_anchors.KEYS, got, ref):
            assert torch.equal(g, r), name
    assert cuda_anchors.anchors_topk.launches == n0 + 2
    other = [a.to(cuda_device) for a in slot_rows(rng, 500, 40, 40)]
    out, launched = _replayed(_indexed_block,
                              dict(zip(("mi", "ci", "live"), other)),
                              dict(zip(names, tables)))
    assert launched == [1, 0]
    for name, g, r in zip(cuda_anchors.KEYS, out, cuda_anchors.
                          anchors_topk_plain(*tables, *other)):
        assert torch.equal(g, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("W, R, with_first", [
    (512, 64, True), (64, 20, True), (70, 20, True), (300, 40, False),
    (12288, 300, True), (56, 130, True)],
    ids=["map", "vec16", "bytes", "vec4", "overlap", "bins"])
def test_retrieval_count_kernel_matches_plain_on_card(cuda_device, W, R,
                                                     with_first):
    """The retrieval-count kernel equals its plain version, eagerly and
    replayed inside a captured graph on other buckets: the map and overlap
    widths, 16-, 4- and 1-byte loads, a ragged tail, several column tiles
    and staging rounds, the level-1 bin width; one launch each."""
    from downpore_tpu_torch.ops import cuda_counts
    rng = np.random.default_rng(W + R)
    mem, b, first = (a.to(cuda_device) for a in count_inputs(
        rng, 3000, W, 96, R, lo=-2))
    first = first if with_first else None
    n0 = cuda_counts.retrieval_count.launches
    got = cuda_counts.retrieval_count(mem, b, first)
    assert cuda_counts.retrieval_count.launches == n0 + 1
    ref = cuda_counts.retrieval_count_plain(mem, b, first)
    assert len(got) == len(ref) == (2 if with_first else 1)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    _, b2, f2 = (a.to(cuda_device) for a in count_inputs(rng, 3000, W, 96,
                                                          R))
    inputs = dict(b=b2) if first is None else dict(b=b2, first=f2)
    out, launched = _replayed(_count_block, inputs, dict(mem=mem))
    assert launched == [0, 1]
    ref = cuda_counts.retrieval_count_plain(mem, b2, f2 if with_first
                                            else None)
    for g, r in zip(out, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("BB", [3, 7])
def test_binned_counts_kernel_matches_plain_on_card(cuda_device, BB):
    """The binned form (level 2) equals its plain version with the first
    mask and without, at BB < NB and BB = NB."""
    from downpore_tpu_torch.ops import cuda_counts
    rng = np.random.default_rng(BB)
    H0, NB, CB, M = 400, 7, 128, 64
    mem, b, first = (a.to(cuda_device) for a in count_inputs(
        rng, H0, NB * CB, M, 48))
    flat = mem.reshape(H0 * NB, CB)
    topbin = torch.from_numpy(np.stack([rng.permutation(NB)[:BB]
                                        for _ in range(M)])).to(cuda_device)
    for f in (first, None):
        got = cuda_counts.retrieval_count(flat, b, f, topbin, NB)
        ref = cuda_counts.retrieval_count_plain(flat, b, f, topbin, NB)
        assert len(got) == len(ref) == (1 if f is None else 2)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


@pytest.mark.cuda
def test_engine_counts_and_anchors_never_run_plain_on_card(cuda_device,
                                                           monkeypatch):
    """On a card the engines' counts and anchor builds are one kernel
    launch each and never the plain versions (patched here to raise): no
    retrieval count builds an [m, R, C] block (the peak memory stays below
    one such block's bytes, at a shape the plain version would chunk)."""
    from downpore_tpu_torch.ops import cuda_anchors, cuda_counts
    from downpore_tpu_torch.ops import map_engine as tme

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(cuda_counts, "retrieval_count_plain", plain)
    monkeypatch.setattr(cuda_anchors, "anchors_topk_plain", plain)
    monkeypatch.setattr(cuda_anchors, "_topk_rows", plain)
    rng = np.random.default_rng(5)
    M, R, C = 2048, 128, 4096
    mem, rb, first = (a.to(cuda_device) for a in count_inputs(
        rng, 1 << 14, C, M, R))
    db = torch.where(first, rb, -1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n0 = cuda_counts.retrieval_count.launches
    c, d = tme._count_rows_pair(mem, rb, db)
    torch.cuda.synchronize()
    assert cuda_counts.retrieval_count.launches == n0 + 1
    assert torch.cuda.max_memory_allocated() - base < M * R * C // 4
    assert torch.equal(tme._count_rows(mem, db), d)
    tables = [a.to(cuda_device) for a in seed_rows(rng, 64, 64, 320, 30)]
    slots = [a.to(cuda_device) for a in slot_rows(rng, 9000, 64, 64)]
    a0 = cuda_anchors.anchors_topk.launches
    tme._build_anchors(*slots, *tables)
    assert cuda_anchors.anchors_topk.launches == a0 + 1


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


# -- the dispatch / collect contract on the card ------------------------------
@contextlib.contextmanager
def sync_errors():
    """Any call that waits for the card raises while the block runs."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def random_genome(rng, n):
    from downpore_tpu_torch.core import Sequence
    bases = np.frombuffer(b"ACGT", np.uint8)
    return Sequence.from_string(bases[rng.integers(0, 4, n)].tobytes()
                                .decode(), id=0, name="chr")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flat", "binned", "seed_sharded"])
def test_map_dispatch_does_not_wait_on_card(cuda_device, monkeypatch, case):
    """A map dispatch (after one warm dispatch at the same budget, which
    captures its graph: a capture waits for the card) enqueues and returns
    under ``set_sync_debug_mode("error")``, at a budget of 4 pairs; its
    collect re-runs and equals the CPU engine's rows."""
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.ops import map_engine
    from downpore_tpu_torch.parallel import make_mesh
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    if case == "binned":
        monkeypatch.setattr(map_engine, "_BINNED_MIN_C", 16)
        monkeypatch.setattr(map_engine, "_BINNED_CB", 8)
    rng = np.random.default_rng(33)
    genome = random_genome(rng, 120_000)
    values = score_seed_values(kmer_occurrences([genome], 11), 11)
    args = (genome, False, 11, values, 40, 1000, 2000)
    windows = []
    for _ in range(32):
        p = int(rng.integers(0, 115_000))
        windows.append(genome.subsequence(p, p + 1000))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        eng = Mapper(*args, device=dev).engine
        if case == "seed_sharded":
            eng = map_engine.MapEngine(eng.index, 11, nq=64, nt=eng.nt,
                                       lean=True,
                                       mesh=make_mesh(1, 2, [dev] * 2))
        assert eng._binned == (case == "binned")
        packed = eng.pack_query_windows(windows)
        base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
        eng.collect_arrays_many([eng.dispatch_packed(packed, base_min)])
        eng.collect_arrays_many([eng.dispatch_packed(packed, base_min,
                                                     pair_budget=4)])
        eng.reruns.clear()
        with (sync_errors() if dev.type == "cuda"
              else contextlib.nullcontext()):
            futs = eng.dispatch_packed(packed, base_min, pair_budget=4)
        out.append(eng.collect_arrays_many([futs])[0])
        assert eng.reruns and sum(eng.reruns.values()) >= 1
    (h_g, p_g), (h_c, p_c) = out
    assert h_g.shape[0] >= 32
    np.testing.assert_array_equal(h_g, h_c)
    np.testing.assert_array_equal(p_g, p_c)


@pytest.mark.cuda
def test_overlap_dispatch_does_not_wait_on_card(cuda_device):
    """An overlap engine's sub-batch dispatch at a budget of 4 pairs under
    ``set_sync_debug_mode("error")``, after one warm dispatch at that
    budget (its capture); collect equals the CPU engine's."""
    from downpore_tpu_torch.core import Sequence
    from downpore_tpu_torch.overlap import QUERY_EDGES, Overlapper
    from downpore_tpu_torch.ops.map_engine import MapEngine
    from downpore_tpu_torch.seeds import SeedIndex
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    rng = np.random.default_rng(34)
    genome = random_genome(rng, 60_000)
    reads = []
    for i in range(40):
        p = int(rng.integers(0, 54_000))
        codes = genome.codes[p:p + 6000].copy()
        m = rng.random(len(codes)) < 0.03
        codes[m] = (codes[m] + rng.integers(1, 4, int(m.sum()))) % 4
        reads.append(Sequence(codes, id=i, name=f"r{i}"))
    values = score_seed_values(kmer_occurrences(reads, 10), 10)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        ov = Overlapper(SeedIndex(10), 10000, 1000, 10, 0.25, device=dev)
        queries = ov.prepare_queries(15, 10000, values, iter(reads[:16]),
                                     QUERY_EDGES)
        ov.add_sequences(iter(reads))
        ov.index.index_sequences()
        eng = MapEngine(ov.index, 10, nq=128, nt=256, device=dev)
        sq = [q.query for q in queries]
        base_min = np.array([int(0.25 * q.num_seeds + 0.5) for q in sq],
                            np.int32)
        eng.collect_chains(eng.dispatch_chains(sq, base_min))
        eng.collect_chains(eng.dispatch_chains(sq, base_min, pair_budget=4))
        eng.reruns.clear()
        with (sync_errors() if dev.type == "cuda"
              else contextlib.nullcontext()):
            futs = eng.dispatch_chains(sq, base_min, pair_budget=4)
        out.append(eng.collect_chains(futs))
        assert eng.reruns["pair_budget"] == 1
    assert out[0] == out[1] and sum(len(r) for r in out[0]) >= 20


@pytest.mark.cuda
def test_trim_dispatch_does_not_wait_on_card(cuda_device):
    """The edge verdict (at 8 pairs) and the middle-pass upload and
    dispatch (at 8 pairs and 2 detections) under
    ``set_sync_debug_mode("error")``, each after one warm dispatch at
    those budgets (their captures); their collects re-run and equal the
    CPU engine's."""
    from downpore_tpu_torch.ops import window_engine as we
    from downpore_tpu_torch.trim import FRONT_ADAPTERS, load_trimmer

    rng = np.random.default_rng(35)
    fronts = trim_windows(rng, 256, 150, FRONT_ADAPTERS)
    mids = trim_windows(rng, 128, 512, FRONT_ADAPTERS)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        t = load_trimmer("", "", 6, verbosity=0, device=dev)
        eng = t._engine()
        W = t.WINDOW - t.k + 1
        gm, cm = t._edge_mins(t.front_sets)
        mm = t._mid_min_matches()
        p, lens = we._pack_windows(mids, 512 - t.k + 1, t.k)
        eng.edge_verdict_collect(eng.edge_verdict_dispatch(
            fronts, True, gm, cm, W), len(gm))

        def dispatch():
            edge = eng.edge_verdict_dispatch(fronts, True, gm, cm, W,
                                             pair_budget=8)
            keep = []
            mid = eng.window_verdict_dispatch_packed(
                [eng.upload_rows(p, lens, len(mids), keep) + (0,)], mm, mm,
                t.mid_threshold, 512 - t.k + 1, pair_budget=8,
                det_budget=2, keep=keep)
            return edge, mid
        edge, mid = dispatch()
        eng.edge_verdict_collect(edge, len(gm))
        eng.window_verdict_collect(mid)
        eng.reruns.clear()
        with (sync_errors() if dev.type == "cuda"
              else contextlib.nullcontext()):
            edge, mid = dispatch()
        out.append((eng.edge_verdict_collect(edge, len(gm)),
                    eng.window_verdict_collect(mid)))
        assert eng.reruns["edge"] == 1 and eng.reruns["middle_det_budget"]
    ((v_g, c_g), d_g), ((v_c, c_c), d_c) = out
    np.testing.assert_array_equal(v_g, v_c)
    np.testing.assert_array_equal(c_g, c_c)
    np.testing.assert_array_equal(d_g, d_c)
    assert v_g[:, 0].sum() >= 50 and len(d_g) == 8


# -- the dispatch blocks captured as CUDA graphs ------------------------------
GRAPH_CASES = {
    # case: the route captured
    "map_d": "_fused_map_d", "map_c": "_fused_map_c",
    "map_bd": "_fused_map_bd", "map_bc": "_fused_map_bc",
    "overlap_d": "_fused_overlap_d", "overlap": "_fused_overlap",
    "edge": "_fused_edge_verdict", "enable": "_fused_enable",
    "middle": "_fused_window_verdict",
    "map_shard": "_shard_counts", "map_sharded": "_map_from_counts",
    "overlap_sharded": "_overlap_from_counts",
}
# the routes whose block launches no chain kernel
NO_CHAIN = ("_shard_counts",)


def graph_case(case, dev, monkeypatch):
    """Drive one dispatch and collect of ``case``'s route on ``dev``."""
    from downpore_tpu_torch.core import Sequence
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.ops import map_engine
    from downpore_tpu_torch.ops.map_engine import MapEngine
    from downpore_tpu_torch.overlap import QUERY_EDGES, Overlapper
    from downpore_tpu_torch.parallel import make_mesh
    from downpore_tpu_torch.seeds import SeedIndex
    from downpore_tpu_torch.trim import FRONT_ADAPTERS, load_trimmer
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    rng = np.random.default_rng(36)
    # the seed-sharded cases: a 1 x 2 grid, both seed shards on the card
    grid = make_mesh(1, 2, [dev] * 2) if "shard" in case else None
    if case.startswith("map"):
        if case.startswith("map_b"):
            monkeypatch.setattr(map_engine, "_BINNED_MIN_C", 16)
            monkeypatch.setattr(map_engine, "_BINNED_CB", 8)
        genome = random_genome(rng, 120_000)
        values = score_seed_values(kmer_occurrences([genome], 11), 11)
        eng = Mapper(genome, False, 11, values, 40, 1000, 2000,
                     device=dev).engine
        if grid is not None:
            eng = MapEngine(eng.index, 11, nq=64, nt=eng.nt, lean=True,
                            mesh=grid)
        wins = []
        for _ in range(150):          # 300 rows: off the row ladder
            p = int(rng.integers(0, 115_000))
            wins.append(genome.subsequence(p, p + 1000))
        packed = eng.pack_query_windows(wins)
        base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
        if case in ("map_c", "map_bc"):
            packed = packed[:6]
        eng.collect_arrays_many([eng.dispatch_packed(packed, base_min)])
    elif case.startswith("overlap"):
        genome = random_genome(rng, 60_000)
        reads = []
        for i in range(40):
            p = int(rng.integers(0, 54_000))
            codes = genome.codes[p:p + 6000].copy()
            reads.append(Sequence(codes, id=i, name=f"r{i}"))
        values = score_seed_values(kmer_occurrences(reads, 10), 10)
        ov = Overlapper(SeedIndex(10), 10000, 1000, 10, 0.25, device=dev)
        queries = ov.prepare_queries(15, 10000, values, iter(reads[:16]),
                                     QUERY_EDGES)
        ov.add_sequences(iter(reads))
        ov.index.index_sequences()
        eng = MapEngine(ov.index, 10, nq=128 if case == "overlap_d" else 16,
                        nt=256, device=dev, mesh=grid)
        sq = [q.query for q in queries]
        base_min = np.array([int(0.25 * q.num_seeds + 0.5) for q in sq],
                            np.int32)
        eng.collect_chains(eng.dispatch_chains(sq, base_min))
    else:
        t = load_trimmer("", "", 6, verbosity=0, device=dev)
        eng = t._engine()
        W = t.WINDOW - t.k + 1
        gm, cm = t._edge_mins(t.front_sets)
        if case == "edge":
            fronts = trim_windows(rng, 300, 150, FRONT_ADAPTERS)
            eng.edge_verdict_collect(eng.edge_verdict_dispatch(
                fronts, True, gm, cm, W), len(gm))
        elif case == "enable":
            fronts = trim_windows(rng, 300, 150, FRONT_ADAPTERS)
            eng.enable_covs(fronts, True, gm, cm, W)
        else:
            mids = trim_windows(rng, 300, 512, FRONT_ADAPTERS)
            mm = t._mid_min_matches()
            eng.window_verdict_collect(eng.window_verdict_dispatch(
                mids, mm, mm, t.mid_threshold, 512 - t.k + 1))


def recorded_runs(monkeypatch):
    """A fresh graph cache that the engines' ``captured.run`` goes
    through, and the list of its calls ``(fn, inputs, tables,
    statics)``."""
    from downpore_tpu_torch.ops import captured
    cache = captured.GraphCache()
    calls = []

    def run(fn, inputs, tables=None, **statics):
        calls.append((fn, inputs, tables or {}, statics))
        return cache.run(fn, inputs, tables, **statics)
    monkeypatch.setattr(captured, "run", run)
    return cache, calls


def outputs(res):
    return (res,) if torch.is_tensor(res) else tuple(res)


def rolled(inputs, shift):
    """Per-dispatch inputs of another dispatch of the same key: every
    tensor's rows rolled by ``shift``."""
    return {n: torch.roll(t, shift, dims=0) for n, t in inputs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_captured_replay_matches_eager_on_card(cuda_device, monkeypatch,
                                               case):
    """Each route's block, captured at its first dispatch, replays bit for
    bit what the function computes when called directly (the graph's
    output buffers filled with -3 before each replay, so a replay whose
    work did not run fails), and each replay adds the chain launches the
    function makes to ``chain_scan.launches``."""
    cache, calls = recorded_runs(monkeypatch)
    graph_case(case, cuda_device, monkeypatch)
    fn, inputs, tables, statics = next(c for c in calls
                                       if c[0].__name__ == GRAPH_CASES[case])
    assert len(cache.entries) >= 1
    for shift in (0, 5):
        ins = rolled(inputs, shift)
        for e in cache.entries.values():
            for o in e.outputs:
                o.fill_(True if o.dtype == torch.bool else -3)
        before = cuda_chain.chain_scan.launches
        got = outputs(cache.run(fn, ins, tables, **statics))
        replay_launches = cuda_chain.chain_scan.launches - before
        before = cuda_chain.chain_scan.launches
        ref = outputs(fn(**ins, **tables, **statics))
        assert replay_launches == cuda_chain.chain_scan.launches - before
        assert replay_launches >= (0 if fn.__name__ in NO_CHAIN else 1)
        torch.cuda.synchronize()
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)
    assert sum(e.replays for e in cache.entries.values()) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["map_d", "overlap_d", "middle"])
def test_captured_replays_in_flight_on_card(cuda_device, monkeypatch, case):
    """Three replays of one key enqueued before any is read do not
    overwrite each other's outputs: each equals the function on its own
    inputs."""
    cache, calls = recorded_runs(monkeypatch)
    graph_case(case, cuda_device, monkeypatch)
    fn, inputs, tables, statics = next(c for c in calls
                                       if c[0].__name__ == GRAPH_CASES[case])
    n = len(cache.entries)
    ins = [rolled(inputs, s) for s in (1, 2, 3)]
    got = [outputs(cache.run(fn, i, tables, **statics)) for i in ins]
    assert len(cache.entries) == n
    for i, g in zip(ins, got):
        for a, b in zip(g, outputs(fn(**i, **tables, **statics))):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_capture_of_a_host_read_raises_on_card(cuda_device):
    """A block that reads the card back cannot be captured: the capture
    raises (its warm-up ran eagerly) and nothing is cached."""
    from downpore_tpu_torch.ops import captured
    cache = captured.GraphCache()

    def reads_back(x):
        return x * int(x.sum())

    x = torch.arange(8, device=cuda_device)
    with pytest.raises(Exception):
        cache.run(reads_back, dict(x=x))
    torch.cuda.synchronize()
    assert not cache.entries
    assert int(x.sum()) == 28
