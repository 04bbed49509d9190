"""Parity of the torch port's chain DP (``downpore_tpu_torch.ops.chain`` and
``ops.cuda_chain``) with the JAX package's ``ops.chain`` / ``ops.pallas_chain``.

The same numpy inputs, made from seeded generators, go through the JAX
function and its torch counterpart on the CPU (the wrapper runs the plain
torch version for CPU tensors).  Every comparison is exact integer
equality: the tolerance is 0.  The CUDA kernel itself is held against the
plain version in test_torch_kernels.py, on a card.
"""
import jax
import numpy as np
import pytest
import torch

from downpore_tpu.ops import chain as jchain
from downpore_tpu.ops.pallas_chain import pallas_chain_scan
from downpore_tpu_torch.ops import chain as tchain
from downpore_tpu_torch.ops import cuda_chain

torch.set_num_threads(2)

SCAN_NAMES = ["score", "cov_q", "cov_t", "s_qp", "s_tp", "bp"]
VARIANTS = ["extend", "aligner"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def anchor_batch(rng, P, A, span=400):
    """Random [P, A] anchors in the recipe of test_align.py's Pallas
    parity test: sorted positions, rank indices, swapped neighbours,
    85% valid."""
    qp = np.sort(rng.integers(0, span, (P, A)), axis=1).astype(np.int32)
    tp = np.sort(rng.integers(0, span, (P, A)), axis=1).astype(np.int32)
    qi = np.argsort(np.argsort(qp, axis=1), axis=1).astype(np.int32)
    tj = np.argsort(np.argsort(tp, axis=1), axis=1).astype(np.int32)
    sw = rng.integers(0, A - 1, (P, 20))
    for p in range(P):
        for s in sw[p]:
            tj[p, s], tj[p, s + 1] = tj[p, s + 1], tj[p, s]
    valid = (rng.random((P, A)) < 0.85).astype(np.int32)
    return qi, tj, qp, tp, valid


@pytest.mark.parametrize("variant", VARIANTS)
def test_window_ok_matches_jax(variant):
    g = np.arange(-80, 81, dtype=np.int32)
    gap_q, gap_t = (a.ravel() for a in np.meshgrid(g, g))
    for k in (10, 11, 15):
        ref = np.asarray(jchain._window_ok(gap_q, gap_t, k, variant))
        got = tchain._window_ok(_t(gap_q), _t(gap_t), k, variant).numpy()
        np.testing.assert_array_equal(ref, got, err_msg=f"k={k}")


def test_window_ok_floors_negative_target_gaps():
    """aligner, g = -3, k = 10: max_gap = (-9)//2 + 11 = 6 under floor
    division (7 under truncation), so gap_q = 7 is outside the window."""
    gt = torch.tensor([-3, -3, -3], dtype=torch.int32)
    gq = torch.tensor([6, 7, -10], dtype=torch.int32)
    got = cuda_chain.window_ok(gq, gt, 10, "aligner").tolist()
    ref = np.asarray(jchain._window_ok(gq.numpy(), gt.numpy(), 10,
                                       "aligner")).tolist()
    assert got == ref == [True, False, True]


@pytest.mark.parametrize("A", [64, 128, 384])
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_scan_plain_matches_jax_scan(A, variant):
    rng = np.random.default_rng(A + len(variant))
    k = 10
    qi, tj, qp, tp, valid = anchor_batch(rng, 4, A, span=3 * A)
    ref = jax.vmap(jchain._chain_scan,
                   in_axes=(0, 0, 0, 0, 0, None, None))(
        qi, tj, qp, tp, valid.astype(bool), k, variant)
    got = cuda_chain.chain_scan(*(_t(a) for a in (qi, tj, qp, tp, valid)),
                                k, variant)
    for name, r, g in zip(SCAN_NAMES, ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=f"{variant}:{name}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_scan_plain_matches_pallas_interpret(variant):
    rng = np.random.default_rng(7)
    qi, tj, qp, tp, valid = anchor_batch(rng, 6, 128)
    ref = pallas_chain_scan(qi, tj, qp, tp, valid, 10, variant=variant,
                            interpret=True)
    got = cuda_chain.chain_scan_plain(
        *(_t(a) for a in (qi, tj, qp, tp, valid)), 10, variant)
    for name, r, g in zip(SCAN_NAMES, ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=f"{variant}:{name}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_window_divfree_matches_window_ok(variant):
    """The kernel's division-free window test (compares of anchor forms
    with step thresholds, at random anchor positions p and t = p + gap + k)
    equals the flooring one over every (gap_q, gap_t) in [-3000, 3000]^2
    (row blocks bound memory)."""
    g = torch.arange(-3000, 3001, dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    for k in (5, 10, 11, 13):
        inside = 0
        for lo in range(0, g.numel(), 1000):
            gq = g[lo:lo + 1000, None].expand(-1, g.numel())
            gt = g[None, :].expand(gq.shape[0], -1)
            ref = cuda_chain.window_ok(gq, gt, k, variant)
            qp_p = torch.randint(-5000, 5000, gq.shape, generator=gen,
                                 dtype=torch.int32)
            tp_p = torch.randint(-5000, 5000, gq.shape, generator=gen,
                                 dtype=torch.int32)
            got = cuda_chain.window_ok_linear(qp_p, tp_p, qp_p + gq + k,
                                              tp_p + gt + k, k, variant)
            assert torch.equal(ref, got), (k, lo)
            inside += int(ref.sum())
        assert 0 < inside < g.numel() ** 2


@pytest.mark.parametrize("A", [64, 96, 256])
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_scan_fb_plain_matches_jax(A, variant):
    """``chain_scan_fb``'s plain version: the forward scan, then the JAX
    module's backward scan (reversed, negated row) already un-reversed,
    with its start positions negated back."""
    rng = np.random.default_rng(A + 3 * len(variant))
    k = 11
    qi, tj, qp, tp, valid = anchor_batch(rng, 3, A, span=3 * A)
    scan = jax.vmap(jchain._chain_scan, in_axes=(0, 0, 0, 0, 0, None, None))
    fwd = scan(qi, tj, qp, tp, valid.astype(bool), k, variant)
    rev = lambda x: np.ascontiguousarray(np.asarray(x)[:, ::-1])
    bwd = scan(rev(-qi), rev(-tj), rev(-qp), rev(-tp),
               rev(valid).astype(bool), k, variant)
    ref = [np.asarray(a) for a in fwd] + [rev(bwd[0]), rev(bwd[1]),
                                          rev(bwd[2]), -rev(bwd[3]),
                                          -rev(bwd[4])]
    got = cuda_chain.chain_scan_fb(*(_t(a) for a in (qi, tj, qp, tp, valid)),
                                   k, variant)
    names = SCAN_NAMES + ["b", "cov_qb", "cov_tb", "e_qp", "e_tp"]
    assert len(got) == len(names) == 11
    for name, r, g in zip(names, ref, got):
        np.testing.assert_array_equal(r, g.numpy(), err_msg=name)


@pytest.mark.parametrize("A", [64, 256])
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_scan_lean_plain_matches_jax(A, variant):
    rng = np.random.default_rng(A + 5 * len(variant))
    qi, tj, qp, tp, valid = anchor_batch(rng, 4, A, span=3 * A)
    ref = jax.vmap(jchain._chain_scan_lean,
                   in_axes=(0, 0, 0, 0, 0, None, None))(
        qi, tj, qp, tp, valid.astype(bool), 10, variant)
    got = cuda_chain.chain_scan_lean(
        *(_t(a) for a in (qi, tj, qp, tp, valid)), 10, variant)
    assert len(got) == 2
    for name, r, g in zip(("score", "bp"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(),
                                      err_msg=f"{variant}:{name}")


@pytest.mark.parametrize("scan", ["chain_scan", "chain_scan_fb",
                                  "chain_scan_lean"])
def test_chain_scan_refuses_key_overflow(scan):
    """The kernel's argmax key packs (score, 0xFFFF - p) into 32 bits:
    every wrapper refuses A >= 2^15 before any scan."""
    ok = torch.zeros((1, cuda_chain.MAX_A), dtype=torch.int32)
    assert cuda_chain.MAX_A == (1 << 15) - 1
    big = torch.zeros((1, 1 << 15), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflow"):
        getattr(cuda_chain, scan)(big, big, big, big, big, 10)
    cuda_chain._check((ok,) * 5, ok.device)


def seed_batch(rng, P, NQ, NT, alphabet):
    """[P, NQ] query / [P, NT] target seed ids (pad -1) drawn from a small
    alphabet so seeds repeat, with positions ascending along each row."""
    qs = rng.integers(0, alphabet, (P, NQ)).astype(np.int32)
    ts = rng.integers(0, alphabet, (P, NT)).astype(np.int32)
    nq = rng.integers(NQ // 2, NQ + 1, P)
    nt = rng.integers(NT // 2, NT + 1, P)
    qs[np.arange(NQ)[None, :] >= nq[:, None]] = -1
    ts[np.arange(NT)[None, :] >= nt[:, None]] = -1
    qpos = np.cumsum(rng.integers(1, 40, (P, NQ)), axis=1).astype(np.int32)
    tpos = np.cumsum(rng.integers(1, 40, (P, NT)), axis=1).astype(np.int32)
    return qs, qpos, ts, tpos


def test_make_anchors_topk_matches_jax():
    rng = np.random.default_rng(5)
    qs, qpos, ts, tpos = seed_batch(rng, 12, 32, 96, alphabet=40)
    ref = jchain.make_anchors_topk(qs, qpos, ts, tpos, per_seed=2)
    got = tchain.make_anchors_topk(_t(qs), _t(qpos), _t(ts), _t(tpos),
                                   per_seed=2)
    assert set(ref) == set(got)
    assert int(np.asarray(ref["overflow"]).sum()) > 0
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key]),
                                      got[key].numpy(), err_msg=key)


def _anchors_pair(rng):
    qs, qpos, ts, tpos = seed_batch(rng, 10, 48, 160, alphabet=60)
    jan = jchain.make_anchors_topk(qs, qpos, ts, tpos, per_seed=2)
    tan = tchain.make_anchors_topk(_t(qs), _t(qpos), _t(ts), _t(tpos),
                                   per_seed=2)
    return jan, tan


@pytest.mark.parametrize("variant", VARIANTS)
def test_dp_from_anchors_matches_jax(variant):
    rng = np.random.default_rng(11)
    jan, tan = _anchors_pair(rng)
    ref = jchain.dp_from_anchors(jan, 11, variant, small=True)
    got = tchain.dp_from_anchors(tan, 11, variant)
    assert set(ref) == set(got)
    assert int(np.asarray(ref["f"]).max()) > 2
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key]),
                                      got[key].numpy(), err_msg=key)


@pytest.mark.parametrize("lean", [True, False])
def test_summarize_dp_matches_jax_with_ties(lean):
    rng = np.random.default_rng(13)
    jan, tan = _anchors_pair(rng)
    out = {k: v.numpy() for k, v in tchain.dp_from_anchors(tan, 11).items()}
    P, A = out["f"].shape
    # tied top-k keys: few distinct coverages, many chain starts
    out["cov_q"] = rng.integers(0, 3, (P, A)).astype(np.int32) * 11
    out["f"] = np.where(rng.random((P, A)) < 0.6, 1, out["f"]).astype(
        np.int32)
    min_match = rng.integers(1, 4, P).astype(np.int32)
    alen = rng.integers(500, 2000, P).astype(np.int32)
    ref = jchain.summarize_dp(out, min_match, alen, 11, 4, lean=lean)
    got = tchain.summarize_dp({k: _t(v) for k, v in out.items()},
                              _t(min_match), _t(alen), 11, 4, lean=lean)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    width = 1 + 7 * 4 if lean else 5 + 8 * 4
    assert got.shape == (P, width)
    unpacked = tchain.unpack_summary(got.numpy(), 4, lean=lean)
    ref_unpacked = jchain.unpack_summary(np.asarray(ref), 4, lean=lean)
    assert unpacked.keys() == ref_unpacked.keys()
    for key in unpacked:
        np.testing.assert_array_equal(unpacked[key], ref_unpacked[key])


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_compact_indices_matches_jax(density):
    """The first ``size`` set indices, padded with the mask's length, and
    the total count as a 0-d tensor: at a size above the count and at one
    that truncates it."""
    rng = np.random.default_rng(17)
    mask = rng.random(3000) < density
    n_set = int(mask.sum())
    for size in (n_set + 7, n_set // 2 + 1):
        ref_idx, ref_n = jchain.compact_indices(mask, size)
        got_idx, got_n = tchain.compact_indices(_t(mask), size)
        assert got_n.dim() == 0 and int(got_n) == int(ref_n) == n_set
        np.testing.assert_array_equal(np.asarray(ref_idx), got_idx.numpy())
    assert (np.asarray(ref_idx)[n_set:] == mask.size).all()
