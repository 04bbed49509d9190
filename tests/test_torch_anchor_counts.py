"""The anchor build and the retrieval counts of the port against the JAX
package's functions, on the CPU (the plain versions of the anchor and
retrieval-count kernels), at tolerance 0: the same seeded numpy inputs go
through ``downpore_tpu.ops.chain.make_anchors_topk`` and
``downpore_tpu.ops.map_engine``'s ``_count_rows`` / ``_count_rows_pair`` /
``_binned_counts_pair`` and through the port's counterparts.  The kernels
themselves are held against these plain versions in
tests/test_torch_kernels.py (on a card, and their sources under the CPU
emulation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downpore_tpu.ops import chain as jchain
from downpore_tpu.ops import map_engine as jme
from downpore_tpu_torch.ops import chain as tchain
from downpore_tpu_torch.ops import cuda_anchors, cuda_counts
from downpore_tpu_torch.ops import map_engine as tme
from test_torch_kernels import count_inputs, seed_rows, slot_rows

torch.set_num_threads(2)


def _jax_anchors(qs, qpos, ts, tpos):
    ref = jchain.make_anchors_topk(*(jnp.asarray(a.numpy())
                                     for a in (qs, qpos, ts, tpos)),
                                   per_seed=2)
    return {k: np.asarray(v) for k, v in ref.items()}


def _same_anchors(ref: dict, got: dict):
    assert set(ref) == set(got) == set(cuda_anchors.KEYS)
    for key in ref:
        assert got[key].dtype == (torch.bool if key == "valid"
                                  else torch.int32), key
        np.testing.assert_array_equal(ref[key], got[key].numpy(),
                                      err_msg=key)


# (P, NQ, NT, alphabet): seeds held more than twice in a target and
# repeated in a query; NQ not a multiple of 32; NT = 1; several lanes'
# worth of query seeds against a long target
ANCHOR_CASES = {"repeats": (12, 32, 96, 6), "nq_37": (9, 37, 50, 8),
                "nt_1": (7, 20, 1, 3), "wide": (5, 300, 700, 60)}


@pytest.mark.parametrize("case", list(ANCHOR_CASES))
def test_anchors_topk_matches_jax(case):
    P, NQ, NT, alphabet = ANCHOR_CASES[case]
    qs, qpos, ts, tpos = seed_rows(np.random.default_rng(len(case)), P, NQ,
                                   NT, alphabet)
    ref = _jax_anchors(qs, qpos, ts, tpos)
    got = cuda_anchors.as_dict(cuda_anchors.anchors_topk(qs, qpos, ts,
                                                         tpos))
    _same_anchors(ref, got)
    # the all -1 query row and the all -1 target row have no anchor
    assert not ref["valid"][P // 2].any() and not ref["valid"][P // 3].any()
    if case == "repeats":
        # a target holding a seed more than twice overflows
        assert int(ref["overflow"].sum()) > 0
        assert (np.bincount(ts[0][ts[0] >= 0].numpy()).max()) > 2
    # chain.make_anchors_topk is the wrapper's dict
    _same_anchors(ref, tchain.make_anchors_topk(qs, qpos, ts, tpos))


def test_anchors_topk_indexed_matches_jax():
    """The indexed entry's plain version equals the JAX function on the
    slots' gathered rows, a dead slot's query row made all -1 (the port's
    empty dead slots); through ``map_engine._build_anchors``, which builds
    only the live slots on the CPU, too."""
    rng = np.random.default_rng(21)
    tables = seed_rows(rng, 8, 40, 120, 12)
    mi, ci, live = slot_rows(rng, 19, 8, 8)
    q_seeds, q_pos, t_seeds, t_pos = tables
    ref = _jax_anchors(torch.where(live[:, None], q_seeds[mi], -1),
                       q_pos[mi], t_seeds[ci], t_pos[ci])
    assert not ref["valid"][~live.numpy()].any()
    got = cuda_anchors.anchors_topk_indexed(mi, ci, live, *tables)
    _same_anchors(ref, cuda_anchors.as_dict(got))
    _same_anchors(ref, tme._build_anchors(mi, ci, live, *tables))


def test_anchors_topk_indexed_plain_steps_match_one_step(monkeypatch):
    """The plain indexed build's steps of ``_anchor_chunk`` slots give the
    one-step result."""
    rng = np.random.default_rng(22)
    tables = seed_rows(rng, 6, 24, 64, 10)
    mi, ci, live = slot_rows(rng, 300, 6, 6)
    whole = cuda_anchors.anchors_topk_plain(*tables, mi, ci, live)
    monkeypatch.setattr(cuda_anchors, "_anchor_chunk", lambda nq, nt: 128)
    for a, b in zip(whole, cuda_anchors.anchors_topk_plain(*tables, mi, ci,
                                                           live)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("W", [64, 70])
def test_count_rows_matches_jax(W):
    """Flat counts, run and distinct, with all-pad rows, at a width that is
    and one that is not a multiple of 16."""
    mem, rb, first = count_inputs(np.random.default_rng(W), 40, W, 9, 24,
                                  lo=-1)
    db = torch.where(first, rb, -1)
    jm, jrb, jdb = (jnp.asarray(a.numpy()) for a in (mem, rb, db))
    c_ref = np.asarray(jme._count_rows(jm, jrb))
    np.testing.assert_array_equal(c_ref, tme._count_rows(mem, rb).numpy())
    assert not c_ref[9 // 2].any()          # the all-pad row
    c_r, d_r = jme._count_rows_pair(jm, jrb, jdb)
    c_g, d_g = tme._count_rows_pair(mem, rb, db)
    np.testing.assert_array_equal(np.asarray(c_r), c_g.numpy())
    np.testing.assert_array_equal(np.asarray(d_r), d_g.numpy())
    np.testing.assert_array_equal(np.asarray(jme._count_rows(jm, jdb)),
                                  d_g.numpy())


def test_binned_counts_match_jax_with_every_bin():
    """Level-2 counts with BB = NB (every bin selected, shuffled) and the
    first mask, against the JAX function."""
    rng = np.random.default_rng(31)
    H0, NB, CB, M = 16, 5, 24, 8
    mem, rb, first = count_inputs(rng, H0, NB * CB, M, 20)
    flat = mem.reshape(H0 * NB, CB)
    topbin = np.stack([rng.permutation(NB) for _ in range(M)])
    c_r, d_r = jme._binned_counts_pair(
        jnp.asarray(flat.numpy()), jnp.asarray(rb.numpy()),
        jnp.asarray(first.numpy()), jnp.asarray(topbin.astype(np.int32)),
        NB, CB)
    c_g, d_g = tme._binned_counts_pair(flat, rb, first,
                                       torch.from_numpy(topbin), NB, CB)
    np.testing.assert_array_equal(np.asarray(c_r), c_g.numpy())
    np.testing.assert_array_equal(np.asarray(d_r), d_g.numpy())


def test_shard_counts_offsets_match_jax():
    """Each seed shard's partial count (``_shard_counts``, its block's row
    offset ``lo``) equals the JAX shard's count of the buckets in its range
    (``make_sharded_counts``' per-shard step, ``_count_rows`` of the block
    over the shifted buckets), and the partial counts sum to the whole
    membership's count."""
    mem, b, _ = count_inputs(np.random.default_rng(41), 60, 48, 7, 30)
    jm, jb = jnp.asarray(mem.numpy()), jnp.asarray(b.numpy())
    total = np.zeros((7, 48), np.int32)
    for lo, hi in ((0, 25), (25, 40), (40, 60)):
        part = tme._shard_counts(b, lo=lo, mem_block0=mem[lo:hi])
        rel = jb - lo
        live = (jb >= 0) & (rel >= 0) & (rel < hi - lo)
        ref = np.asarray(jme._count_rows(jm[lo:hi], jnp.where(live, rel, -1)))
        np.testing.assert_array_equal(ref, part.numpy())
        total += ref
    np.testing.assert_array_equal(total, np.asarray(jme._count_rows(jm, jb)))


def test_anchor_wrappers_check_inputs():
    q = torch.zeros((3, 8), dtype=torch.int32)
    t = torch.zeros((3, 12), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_anchors.anchors_topk(q.long(), q, t, t)
    with pytest.raises(ValueError):
        cuda_anchors.anchors_topk(q, q, t.t().contiguous().t(), t)
    with pytest.raises(ValueError):
        cuda_anchors.anchors_topk(q, q, t, t, per_seed=3)
    with pytest.raises(ValueError):
        tchain.make_anchors_topk(q, q, t, t, per_seed=1)
    with pytest.raises(ValueError):
        cuda_anchors.anchors_topk(q, q[:2], t, t)
    mi = torch.zeros(4, dtype=torch.int64)
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        cuda_anchors.anchors_topk_indexed(mi.int(), mi, live, q, q, t, t)
    with pytest.raises(TypeError):
        cuda_anchors.anchors_topk_indexed(mi, mi, live.int(), q, q, t, t)
    with pytest.raises(ValueError):
        cuda_anchors.anchors_topk_indexed(mi, mi[:3], live, q, q, t, t)
    with pytest.raises(ValueError):
        cuda_anchors.anchors_topk_indexed(
            torch.zeros(8, dtype=torch.int64)[::2], mi, live, q, q, t, t)


def test_count_wrappers_check_inputs():
    mem = torch.zeros((10, 32), dtype=torch.int8)
    b = torch.zeros((4, 6), dtype=torch.int32)
    first = torch.ones((4, 6), dtype=torch.bool)
    with pytest.raises(TypeError):
        cuda_counts.retrieval_count(mem.int(), b)
    with pytest.raises(TypeError):
        cuda_counts.retrieval_count(mem, b.long())
    with pytest.raises(TypeError):
        cuda_counts.retrieval_count(mem, b, first.int())
    with pytest.raises(ValueError):
        cuda_counts.retrieval_count(mem, b.t().contiguous().t())
    with pytest.raises(ValueError):
        cuda_counts.retrieval_count(mem, b, first[:3])
    with pytest.raises(ValueError):
        cuda_counts.retrieval_count(mem[:0], b)
    with pytest.raises(TypeError):
        cuda_counts.retrieval_count(mem, b, first,
                                    torch.zeros((4, 2), dtype=torch.int32), 2)
    (c,) = cuda_counts.retrieval_count(mem, b)
    assert c.shape == (4, 32) and c.dtype == torch.int32
