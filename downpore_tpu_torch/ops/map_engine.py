"""Device-resident fused mapping engine (torch port of
``downpore_tpu/ops/map_engine.py``: the flat and the binned retrieval
gates, and the overlapper's half).

Resident state on the engine's device:

* ``membership [H, CP] int8`` — hashed seed-bucket -> chunk matrix,
* ``t_seeds / t_pos [CP, nt] int32`` — padded per-chunk seed tables,
* ``usable_dev [UL] int8`` — seeds that carry information (not in every
  chunk),
* binned mode only: ``bin_mem1 [H1, NB]`` / ``bin_mem2 [H, NB] int8`` —
  seed-bucket -> genome-bin matrices of the two-level gate.

Per batch of query windows, one ``dispatch_packed`` call enqueues
retrieval counts and the distinct-seed gate (int8 membership rows
gathered and summed), compacts the passing (query, chunk) pairs to a
fixed pair budget (``compact_indices``: query-major, chunk-ascending,
dead slots after them), builds anchors against the resident chunk tables,
runs the chain DP (``cuda_chain.chain_scan_fb``, forward and backward) and
packs the lean top-4 summaries, and returns without reading anything
back; the host copy of the rows and of the passing count starts behind
the work (``transfer.HostCopy``).  ``collect_arrays_many`` waits for it;
a block whose count exceeded its budget is re-run there with the budget
grown 4x, as the JAX collect does, so the output never depends on the
budget.  The budgets start as the JAX engine's (``map_budget``,
``overlap_budget``); a map dispatch of a route and size already
collected runs at a quarter over the largest count collected there when
smaller (``_map_budget``), and overlap dispatches at the job plan's
(``query_chains``).

As in the JAX engine, a batch's rows are padded to a shape bucket
(``captured.row_bucket``: 256, 1024, then the 2048 grid; for an overlap
job at least the plan's ``mb``, the shape half of its shape plan) with
rows that never pass the gate, and each block runs through
``captured.run``: on a card it is captured once per (route, bucket,
budgets, statics, table shapes) as a CUDA graph and replayed after, the
counterpart of the JAX engine's ``jax.jit`` per shape.  The seed-sharded
routes are a graph per seed shard's partial count (on its card) and one
for the tail on the data shard's card; the partial counts' copies
between cards and their sum stay eager, since a graph stays on one
device.

At ``_BINNED_MIN_C`` chunks or more a ``binned=True`` engine takes the
two-level gate instead (``_binned_gate``): chunks are permuted into
genome-position order and cut into bins of ``_BINNED_CB``; level 1 gates
bins on ``bin_mem``, level 2 counts chunks only inside each query row's
top-``BB`` passing bins.  The dispatch runs at the JAX engine's starting
``BB`` and returns ``n_bin`` (the most passing bins of any row) as a
device scalar; when it exceeds ``BB``, collect re-runs level 2 at the
width the JAX engine's doubling ends on (``_bb_final``).  Collected chunk
ids are translated back to the index's order.

The overlapper's half: ``dispatch_chains`` runs the same retrieval and
gate on seed-sequence queries, the forward-only aligner-variant chain DP
(``chain.dp_forward_lean``) and a walk of each passing pair's best chain
back through its backpointers (``_overlap_from_counts``), with the kept
rows compacted to the front; ``collect_chains`` reads the counts, slices
the rows to the kept ones and the real chain length on the device,
fetches them and turns them into per-query candidate lists.

Dropped from the JAX engine because no output depends on them: the
speculative chain prefetch, combined int16 uploads and clipped
gathers.

With a device grid (``parallel.make_mesh``) every batch splits into the
grid's data shards (contiguous, equal row blocks, the tail padded with
rows that never pass the gate), each enqueued on its shard's device
against a replica of the chunk tables without waiting, so the blocks of
one dispatch run at the same time on distinct cards; the collect makes
each block exact, offsets its query rows by its first row and
concatenates the blocks in order, so the walk order is unchanged.  A grid
with a ``seed`` axis above 1 shards the membership's hash-bucket rows
instead (``seed_sharded``): each (data, seed) device holds ``HP /
n_seed`` rows, the partial counts of the seed shards are summed on the
data shard's device (``sharded_counts``), and the binned gate and the
on-device bucket derivation are off, as in the JAX engine.
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import DeviceGrid
from . import captured
from . import match as match_ops
from . import cuda_anchors, cuda_counts
from .chain import anchors_of_slots, dp_from_anchors, dp_forward_lean, \
    summarize_dp, compact_indices
from .transfer import HostCopy, Pending, on_device

# binned-retrieval engagement threshold and bin width, the JAX engine's
# (module-level and read at construction, so tests can patch them to toy
# scale)
_BINNED_MIN_C = 1024
_BINNED_CB = 128

def _count_rows(membership, buckets):
    """Retrieval hit counts: ``buckets [M, R]`` (pad -1) -> ``[M, C]``
    int32, the sum of the int8 membership rows of each row's live
    buckets (``cuda_counts``: one kernel launch on a card)."""
    return cuda_counts.retrieval_count(membership, buckets)[0]


def _count_rows_pair(membership, rb, db):
    """Run and distinct retrieval counts from one gather: on the derived
    path the distinct buckets ``db`` are ``rb`` with duplicate slots
    masked to -1 (same slot layout), so the ``rb`` rows serve both sums."""
    return cuda_counts.retrieval_count(membership, rb, db >= 0)


def _shard_counts(buckets, *, lo: int, **block):
    """One seed shard's partial retrieval counts: ``block`` holds its one
    membership row block (named after the shard, so that each shard's
    block is a table of its own in the graph cache), rows ``lo`` on of the
    full membership; the query buckets that fall in its range (``rel = b
    - lo``, live when ``0 <= rel < H_loc``) are counted, the rest are
    not."""
    (m_local,) = block.values()
    rel = buckets - lo
    live = (buckets >= 0) & (rel >= 0) & (rel < m_local.shape[0])
    return _count_rows(m_local, torch.where(live, rel, -1))


def sharded_counts(mem_blocks, buckets, device):
    """Seed-sharded retrieval counts (the JAX engine's
    ``make_sharded_counts``): ``mem_blocks`` are the membership's row
    blocks in order, one per seed shard and on its device; each shard's
    partial count (``_shard_counts``, through ``captured.run``: a graph
    per shard, keyed by its row offset ``lo``) is enqueued on its own
    card, and the int32 partial counts are copied to ``device`` and summed
    there eagerly, without waiting on the host."""
    total = None
    lo = 0
    for s, m_local in enumerate(mem_blocks):
        with on_device(m_local.device):
            part = captured.run(
                _shard_counts,
                dict(buckets=buckets.to(m_local.device, non_blocking=True)),
                {f"mem_block{s}": m_local}, lo=lo)
        part = part.to(device, non_blocking=True)
        total = part if total is None else total + part
        lo += m_local.shape[0]
    return total


def _hash(ids, H: int, hashed: bool):
    """Device twin of ``match.hash_ids``: int64 product masked to the
    power-of-two ``H`` keeps the same low bits as numpy's 64-bit
    ``(id * knuth) % H``."""
    if not hashed:
        return ids
    return ((ids.long() * match_ops.KNUTH) & (H - 1)).to(torch.int32)


def _derive_membership(t_seeds, H: int, hashed: bool):
    """Resident ``[H, CP]`` int8 membership scattered from the chunk seed
    tables: the host build's unique-seed -> bucket assignment.  Valid
    only when no chunk's seed list was truncated to the table width."""
    CP, nt = t_seeds.shape
    live = t_seeds >= 0
    rows = torch.where(live, _hash(t_seeds, H, hashed), H).long()
    cols = torch.arange(CP, device=t_seeds.device)[:, None].expand(CP, nt)
    mem = torch.zeros((H + 1, CP), dtype=torch.int8, device=t_seeds.device)
    mem[rows.reshape(-1), cols.reshape(-1)] = 1
    return mem[:H].contiguous()


def _unpack_membership(packed, C: int):
    """``[H, ceil(C/8)]`` uint8 bit-rows -> resident ``[H, C]`` int8 0/1."""
    H, CB = packed.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(H, CB * 8)[:, :C].to(torch.int8).contiguous()


def _derive_buckets(q_seeds, usable, H: int, hashed: bool):
    """Run and distinct buckets of each query row, from its seed ids:
    run-collapse over usable seeds (ref Matches semantics,
    seeds/seeds.go:335-353), hash to buckets, mark first occurrences.
    Exact whenever every extracted seed of a row fits ``q_seeds``."""
    M, nq = q_seeds.shape
    dev = q_seeds.device
    live = q_seeds >= 0
    us = live & (usable[q_seeds.clamp(0, usable.shape[0] - 1).long()] > 0)
    slot = torch.arange(nq, dtype=torch.int32, device=dev)
    idx = torch.where(us, slot[None, :], -1)
    pa = torch.cummax(idx, dim=1).values
    prev = torch.cat([torch.full((M, 1), -1, dtype=pa.dtype, device=dev),
                      pa[:, :-1]], dim=1)
    pv = torch.gather(q_seeds, 1, prev.clamp(min=0).long())
    pv = torch.where(prev >= 0, pv, -2)
    run_start = us & (pv != q_seeds)
    rb = torch.where(run_start, _hash(q_seeds, H, hashed), -1)
    eq = (rb[:, :, None] == rb[:, None, :]) \
        & (rb[:, :, None] >= 0) & (rb[:, None, :] >= 0)
    earlier = torch.tril(torch.ones((nq, nq), dtype=torch.bool, device=dev),
                         -1)[None]
    dup = (eq & earlier).any(dim=2)
    db = torch.where(run_start & ~dup, rb, -1)
    return rb, db


def _build_anchors(mi, ci, live, q_seeds, q_pos, t_seeds, t_pos):
    """Anchors (``make_anchors_topk``, 2 target occurrences per query
    seed) of the selected (query row, chunk) pairs: on a card one launch of
    the anchor kernel over every budget slot, reading the rows by index
    (``cuda_anchors.anchors_topk_indexed``).  A budget slot past the
    passing count (``live`` False) points at row 0 and gets no query seed,
    so it has no valid anchor and its chain is empty."""
    def build(rows):
        m, c, on = (mi, ci, live) if rows is None \
            else (mi[rows], ci[rows], live[rows])
        return cuda_anchors.as_dict(cuda_anchors.anchors_topk_indexed(
            m, c, on, q_seeds, q_pos, t_seeds, t_pos))
    return anchors_of_slots(live, build)


def _budget_slots(sel, N: int, C: int):
    """Budget slots of a compacted ``[M, C]`` gate (``compact_indices``
    of its flattening, padded with ``N = M * C``): ``(live, row, column)``,
    dead slots at row and column 0."""
    live = sel < N
    cl = sel.clamp(max=max(0, N - 1))
    return (live, torch.where(live, torch.div(cl, C, rounding_mode="floor"),
                              0),
            torch.where(live, cl % C, 0))


def _chain_pack_tail(mi, ci, dc, live, q_seeds, q_pos, base_min, q_len,
                     t_seeds, t_pos, *, k: int, top_k: int, lean: bool):
    """Chain DP + summary packing over the pair budget's slots: the shared
    tail of the flat and binned gates.  Returns ``(head [B, 3] int32
    (query row, chunk, distinct count), packed [B, W] int16)``; a dead
    slot has query row -1 (collect drops it), min-match ``1 << 20`` and
    no anchor."""
    mm = torch.where(live, base_min[mi], 1 << 20)
    anchors = _build_anchors(mi, ci, live, q_seeds, q_pos, t_seeds, t_pos)
    out = dp_from_anchors(anchors, k)
    packed = summarize_dp(out, mm, q_len[mi], k, top_k, lean=lean)
    head = torch.stack([torch.where(live, mi, -1).to(torch.int32),
                        ci.to(torch.int32), dc.to(torch.int32)], dim=1)
    # summaries fit int16 for <= 10 kb chunks; the JAX engine clamps the
    # fetched rows to int16, and empty-row sentinels clamp with them
    packed16 = packed.clamp(-32768, 32767).to(torch.int16)
    return head, packed16


def _map_from_counts(counts, dcounts, q_seeds, q_pos, min_count, base_min,
                     q_len, t_seeds, t_pos, *, k: int, pair_budget: int,
                     top_k: int = 4, lean: bool = False):
    """Gate + chain + summary from retrieval counts, over the first
    ``pair_budget`` passing pairs.  Passing pairs come out query-major,
    chunk-ascending (the order the reference walks candidates), dead
    slots after them.  Returns ``(head, packed16, n_ok)``, ``n_ok`` the
    passing count as a 0-d device tensor (collect re-runs above the
    budget)."""
    M, C = counts.shape
    ok = (counts >= min_count[:, None]) & (dcounts >= base_min[:, None]) \
        & (min_count[:, None] > 0)
    # no more pairs can pass than the gate has
    sel, n_ok = compact_indices(ok.reshape(-1), min(pair_budget, M * C))
    live, mi, ci = _budget_slots(sel, M * C, C)
    dc = dcounts[mi, ci]
    return _chain_pack_tail(mi, ci, dc, live, q_seeds, q_pos, base_min,
                            q_len, t_seeds, t_pos, k=k, top_k=top_k,
                            lean=lean) + (n_ok,)


def _fused_map_c(q_pos, q_rb, q_db, min_count, base_min, q_len, q_seeds,
                 membership, t_seeds, t_pos, *, k: int, pair_budget: int,
                 top_k: int = 4, lean: bool = False):
    """Retrieval + gate + chain + summary with the run/distinct bucket
    arrays shipped from the host (rows whose seeds overflow ``nq``)."""
    counts = _count_rows(membership, q_rb)
    dcounts = _count_rows(membership, q_db)
    return _map_from_counts(counts, dcounts, q_seeds, q_pos, min_count,
                            base_min, q_len, t_seeds, t_pos, k=k,
                            pair_budget=pair_budget, top_k=top_k, lean=lean)


def _fused_map_d(q_pos, min_count, base_min, q_len, q_seeds, usable,
                 membership, t_seeds, t_pos, *, k: int, pair_budget: int,
                 top_k: int = 4, hashed: bool = False, lean: bool = False):
    """``_fused_map_c`` with the run/distinct buckets derived on the
    device from the seed ids (``_derive_buckets``): the standard map
    path."""
    q_rb, q_db = _derive_buckets(q_seeds, usable, membership.shape[0],
                                 hashed)
    counts, dcounts = _count_rows_pair(membership, q_rb, q_db)
    return _map_from_counts(counts, dcounts, q_seeds, q_pos, min_count,
                            base_min, q_len, t_seeds, t_pos, k=k,
                            pair_budget=pair_budget, top_k=top_k, lean=lean)


def _derive_bin_mem(membership, NB: int, CB: int):
    """Level-1 bin membership ``[H, NB]`` int8: bin b's row is the OR of
    its ``CB`` chunk columns.  Bins are contiguous ranges of the
    genome-position-permuted chunk axis, so a bin's count bounds the count
    of every chunk in it: gating bins at the chunk thresholds keeps
    recall."""
    H = membership.shape[0]
    return membership.reshape(H, NB, CB).any(dim=2).to(torch.int8)


def _derive_bin_mem_direct(t_seeds, H1: int, NB: int, CB: int,
                           hashed1: bool):
    """Level-1 bin membership ``[H1, NB]`` int8 in its own, wider hash
    space, scattered straight from the resident chunk seed tables.  The
    ``[H, CP]`` membership caps ``H`` for memory; the bin matrix is small
    enough to afford ``H1`` (up to 2^20), where collision noise passes far
    fewer bins.  Valid only when no chunk's seed list was truncated."""
    CP, nt = t_seeds.shape
    dev = t_seeds.device
    rows = torch.where(t_seeds >= 0, _hash(t_seeds, H1, hashed1),
                       H1).long()
    bins = torch.div(torch.arange(CP, device=dev), CB,
                     rounding_mode="floor")[:, None].expand(CP, nt)
    mem = torch.zeros((H1 + 1, NB), dtype=torch.int8, device=dev)
    mem[rows.reshape(-1), bins.reshape(-1)] = 1
    return mem[:H1].contiguous()


def _binned_counts_pair(flat, rb, first, topbin, NB: int, CB: int):
    """Level-2 fine counts inside each row's selected bins from one
    membership gather: ``flat [H * NB, CB]`` (the membership reshaped),
    ``rb [M, R]`` buckets (pad -1), ``first [M, R]`` mask of the slots the
    distinct count sums (None: no distinct count), ``topbin [M, BB]``
    selected bins.  Returns ``(counts, dcounts)`` ``[M, BB, CB]`` int32
    (``dcounts`` None without ``first``; ``cuda_counts``: one kernel launch
    on a card)."""
    out = cuda_counts.retrieval_count(flat, rb, first, topbin.long(), NB)
    return out[0], (None if first is None else out[1])


def _bb_final(n_bin: int, BB: int, NB: int) -> int:
    """The bin-selection width the JAX engine's escalation ends on: ``BB``
    doubled, capped at ``NB``, until it covers ``n_bin``."""
    while n_bin > BB:
        BB = min(NB, BB * 2)
    return BB


def _binned_gate(membership, bin_mem, q_rb, q_db, rb1, db1, min_count,
                 base_min, *, NB: int, CB: int, BB: int, C: int,
                 pair_budget: int, aligned_db: bool):
    """Two-level retrieval gate: level 1 gates genome bins on ``bin_mem``
    with the buckets ``rb1``/``db1`` of its hash space, level 2 counts
    chunks only inside each row's top-``BB`` passing bins.  ``aligned_db``
    says ``q_db``/``db1`` share the run arrays' slot layout (the
    ``_derive_buckets`` form), so one gather serves both counts.

    Returns ``(mi, ci, dc, live, n_ok, n_bin)``: the budget's slots of
    passing (query row, engine chunk, distinct count) triples in (row, bin
    rank, lane) order, dead slots after them, the passing count, and the
    most passing bins of any row (0-d device tensors).  With ``n_bin >
    BB`` the selection may have dropped chunks: collect re-runs at
    ``_bb_final(n_bin, BB, NB)``, the width the JAX engine's doubling
    ends on."""
    M = q_rb.shape[0]
    H = membership.shape[0]
    dev = membership.device
    if aligned_db:
        c1, d1 = _count_rows_pair(bin_mem, rb1, db1)
    else:
        c1 = _count_rows(bin_mem, rb1)
        d1 = _count_rows(bin_mem, db1)
    okb = (c1 >= min_count[:, None]) & (d1 >= base_min[:, None]) \
        & (min_count[:, None] > 0)
    n_bin = okb.sum(dim=1, dtype=torch.int32).amax()
    # top-BB bins by run count, ties to the lower bin (jax.lax.top_k's
    # order): a stable descending sort, not torch.topk
    key = torch.where(okb, c1, -1)
    topbin = torch.sort(key, dim=1, descending=True,
                        stable=True).indices[:, :BB].contiguous()
    sel_live = torch.gather(okb, 1, topbin)
    flat = membership.reshape(H * NB, CB)
    if aligned_db:
        c2, d2 = _binned_counts_pair(flat, q_rb, q_db >= 0, topbin, NB, CB)
    else:
        c2, _ = _binned_counts_pair(flat, q_rb, None, topbin, NB, CB)
        d2, _ = _binned_counts_pair(flat, q_db, None, topbin, NB, CB)
    ci_all = topbin[:, :, None] * CB \
        + torch.arange(CB, device=dev)[None, None, :]        # [M, BB, CB]
    okf = (c2 >= min_count[:, None, None]) \
        & (d2 >= base_min[:, None, None]) \
        & (min_count[:, None, None] > 0) \
        & sel_live[:, :, None] & (ci_all < C)
    sel, n_ok = compact_indices(okf.reshape(-1),
                                min(pair_budget, M * BB * CB))
    live, mi, rem = _budget_slots(sel, M * BB * CB, BB * CB)
    s_idx = torch.div(rem, CB, rounding_mode="floor")
    w = rem % CB
    ci = torch.where(live, topbin[mi, s_idx] * CB + w, 0)
    dc = d2[mi, s_idx, w]
    return mi, ci, dc, live, n_ok, n_bin


def _fused_map_bd(q_pos, min_count, base_min, q_len, q_seeds, usable,
                  membership, bin_mem, t_seeds, t_pos, *, k: int,
                  pair_budget: int, top_k: int = 4, hashed: bool = False,
                  hashed1: bool = False, lean: bool = False, NB: int,
                  CB: int, BB: int, C: int):
    """``_fused_map_d`` with the two-level binned gate: buckets derived on
    the device, in the bin matrix's hash space too when it differs.
    Returns ``(head, packed16, n_ok, n_bin)``."""
    H = membership.shape[0]
    H1 = bin_mem.shape[0]
    q_rb, q_db = _derive_buckets(q_seeds, usable, H, hashed)
    if H1 == H and hashed1 == hashed:
        rb1, db1 = q_rb, q_db
    else:
        rb1, db1 = _derive_buckets(q_seeds, usable, H1, hashed1)
    mi, ci, dc, live, n_ok, n_bin = _binned_gate(
        membership, bin_mem, q_rb, q_db, rb1, db1, min_count, base_min,
        NB=NB, CB=CB, BB=BB, C=C, pair_budget=pair_budget, aligned_db=True)
    return _chain_pack_tail(mi, ci, dc, live, q_seeds, q_pos, base_min,
                            q_len, t_seeds, t_pos, k=k, top_k=top_k,
                            lean=lean) + (n_ok, n_bin)


def _fused_map_bc(q_pos, q_rb, q_db, min_count, base_min, q_len, q_seeds,
                  membership, bin_mem, t_seeds, t_pos, *, k: int,
                  pair_budget: int, top_k: int = 4, lean: bool = False,
                  NB: int, CB: int, BB: int, C: int):
    """``_fused_map_c`` (buckets shipped from the host) with the two-level
    binned gate.  The shipped buckets live in the membership's hash space,
    so level 1 uses the H-space bin matrix.  Returns ``(head, packed16,
    n_ok, n_bin)``."""
    mi, ci, dc, live, n_ok, n_bin = _binned_gate(
        membership, bin_mem, q_rb, q_db, q_rb, q_db, min_count, base_min,
        NB=NB, CB=CB, BB=BB, C=C, pair_budget=pair_budget,
        aligned_db=False)
    return _chain_pack_tail(mi, ci, dc, live, q_seeds, q_pos, base_min,
                            q_len, t_seeds, t_pos, k=k, top_k=top_k,
                            lean=lean) + (n_ok, n_bin)


def _walk_back(start, bp, qi, tj, chain_len: int):
    """The JAX engine's best-chain walk: step i of row r is the i-th
    predecessor of anchor ``start[r]`` through the backpointers ``bp``
    (-1 ends a chain; a start of -1 is an empty walk), and gives that
    anchor's ``qi`` and ``tj``, -1 past the chain's start.  Computed by
    pointer doubling (the 2^k-th predecessor table, squared k times), in
    a few dozen kernels, instead of ``chain_len`` sequential steps of
    several each, which would fill the card's launch queue and make the
    dispatch wait for the device.  Returns ``(cq, ct)`` ``[P, chain_len]``
    int32."""
    P, A = bp.shape
    dev = bp.device
    # index A is a sink that a finished walk stays in
    sink = torch.full((P, 1), A, dtype=torch.int64, device=dev)
    jump = torch.cat([torch.where(bp >= 0, bp.long(), A), sink], dim=1)
    steps = torch.arange(chain_len, device=dev)
    pos = torch.where(start >= 0, start, A).long()[:, None].expand(
        P, chain_len)
    bit = 0
    while (1 << bit) < chain_len:
        hop = ((steps >> bit) & 1).bool()[None, :]
        pos = torch.where(hop, torch.gather(jump, 1, pos), pos)
        bit += 1
        if (1 << bit) < chain_len:
            jump = torch.gather(jump, 1, jump)
    end = torch.full((P, 1), -1, dtype=qi.dtype, device=dev)
    return (torch.gather(torch.cat([qi, end], dim=1), 1, pos),
            torch.gather(torch.cat([tj, end.to(tj.dtype)], dim=1), 1, pos))


def _overlap_from_counts(counts, dcounts, q_seeds, q_pos, min_count,
                         base_min, t_seeds, t_pos, *, k: int,
                         pair_budget: int, variant: str = "aligner",
                         chain_len: int = 128):
    """Gate + forward chain DP + best-chain walk from retrieval counts,
    over the first ``pair_budget`` passing pairs.

    For every gate-passing (query row, chunk) pair, in query-major /
    chunk-ascending order, the best chain ends at the first anchor of
    maximal forward score (``jnp.argmax``'s tie-break); its anchors are
    walked back through the backpointers for ``chain_len`` steps.  Rows
    whose best chain reaches ``max(1, base_min)`` are kept, compacted to
    the front in order.  Returns ``(head [B, 4] int32 (query row, chunk,
    best chain length, distinct count; -1 rows past the kept ones), cq
    [B, chain_len] int8, ct [B, chain_len] int16 (chain query / target
    seed indices, end -> start, -1 padded), n_ok, n_keep, mx)``: the
    passing and kept counts and the longest kept min(length, chain_len)
    as 0-d device tensors, which collect reads to re-run above the budget
    and to slice the rows it fetches."""
    M, C = counts.shape
    dev = counts.device
    ok = (counts >= min_count[:, None]) & (dcounts >= base_min[:, None]) \
        & (min_count[:, None] > 0)
    B = min(pair_budget, M * C)
    sel, n_ok = compact_indices(ok.reshape(-1), B)
    live, mi, ci = _budget_slots(sel, M * C, C)
    anchors = _build_anchors(mi, ci, live, q_seeds, q_pos, t_seeds, t_pos)
    out = dp_forward_lean(anchors, k, variant)
    f, bp = out["f"], out["bp"]
    qi_a, tj_a = out["qi"], out["tj"]
    best_len = torch.where(live, f.amax(dim=1), 0)
    best_a = torch.argmax(f, dim=1)          # first maximum, as jnp.argmax
    # qi < nq <= 128 and tj < nt <= 4096: the JAX engine's int8 / int16
    # fetch types
    cq, ct = _walk_back(torch.where(best_len > 0, best_a, -1), bp, qi_a,
                        tj_a, chain_len)
    cq, ct = cq.to(torch.int8), ct.to(torch.int16)
    head = torch.stack([torch.where(live, mi, -1).to(torch.int32),
                        ci.to(torch.int32), best_len.to(torch.int32),
                        dcounts[mi, ci].to(torch.int32)], dim=1)
    # the kept rows (best chain at least the row's static minimum)
    # compacted to the front, in order
    keep = live & (best_len >= base_min[mi].clamp(min=1))
    sel2, n_keep = compact_indices(keep, B)
    s2 = sel2.clamp(max=B - 1)
    head = torch.where((sel2 >= B)[:, None], -1, head[s2])
    mx = torch.where(keep, best_len.clamp(max=chain_len), 0).amax()
    return head, cq[s2], ct[s2], n_ok, n_keep, mx


def _fused_overlap(q_seeds, q_pos, q_rb, q_db, min_count, base_min,
                   membership, t_seeds, t_pos, *, k: int, pair_budget: int,
                   variant: str = "aligner", chain_len: int = 128):
    """Retrieval + gate + chain DP + best-chain walk with the run/distinct
    bucket arrays shipped from the host (queries whose seeds overflow the
    shipped width); see ``_overlap_from_counts``."""
    counts = _count_rows(membership, q_rb)
    dcounts = _count_rows(membership, q_db)
    return _overlap_from_counts(counts, dcounts, q_seeds, q_pos, min_count,
                                base_min, t_seeds, t_pos, k=k,
                                pair_budget=pair_budget, variant=variant,
                                chain_len=chain_len)


def _fused_overlap_d(q_pos, min_count, base_min, q_seeds, usable,
                     membership, t_seeds, t_pos, *, k: int, pair_budget: int,
                     variant: str = "aligner",
                     chain_len: int = 128, hashed: bool = False):
    """``_fused_overlap`` with the buckets derived on the device from the
    seed ids (``_derive_buckets``): the standard overlap path."""
    q_rb, q_db = _derive_buckets(q_seeds, usable, membership.shape[0],
                                 hashed)
    counts, dcounts = _count_rows_pair(membership, q_rb, q_db)
    return _overlap_from_counts(counts, dcounts, q_seeds, q_pos, min_count,
                                base_min, t_seeds, t_pos, k=k,
                                pair_budget=pair_budget, variant=variant,
                                chain_len=chain_len)


def map_budget(rows: int, collisions: bool) -> int:
    """The JAX engine's default pair budget of a map dispatch over
    ``rows`` query rows (~0.3 passing pairs a row are observed; this
    allows 1, 2 for small batches), doubled under heavy hash-bucket
    collisions (more than 2 seeds a bucket), which inflate gate passes."""
    b = max(512, 2 * rows) if rows <= 512 else max(4096, rows)
    return 2 * b if collisions else b


def overlap_budget(rows: int) -> int:
    """The JAX engine's default pair budget of an overlap dispatch: 16
    pairs a query (all-vs-all retrieves ~coverage candidates a query) on
    a 4096 grid."""
    return max(4096, ((16 * rows + 4095) // 4096) * 4096)


def _per_block(budget: int, D: int) -> int:
    """A batch's pair budget split evenly over its ``D`` data blocks, as
    the JAX engine's one budget covers the whole batch on its mesh."""
    return -(-budget // D)


def _tight(n: int) -> int:
    """The map budget sized from a collected count ``n``: a quarter more,
    on a 256 grid."""
    return max(256, ((n + n // 4 + 255) // 256) * 256)


def _grown(n: int) -> int:
    """The 4096 grid of ``n`` plus an eighth: the overlap budget that the
    JAX engine escalates to and the JAX overlapper plans after seeing
    ``n`` passing pairs."""
    return ((n + n // 8 + 4095) // 4096) * 4096


def _map_fetch(res) -> HostCopy:
    """Host copy of a map block: its counts ``(n_ok[, n_bin])``, head and
    packed rows."""
    return HostCopy([torch.stack(res[2:]), res[0], res[1]])


def _overlap_fetch(res) -> HostCopy:
    """Host copy of an overlap block's counts ``(n_ok, n_keep, mx)``; its
    rows are fetched at collect, sliced to the kept ones."""
    return HostCopy([torch.stack(res[3:6])])


class MapEngine:
    """Resident device index + one-dispatch query pipelines for the mapper
    (flat or binned gate) and the overlapper.  ``routes`` counts the
    dispatches per fused path, ``bins`` the binned dispatches per
    ``(n_bin, BB)`` at the width their collect ended on, ``reruns`` the
    re-runs at collect by cause (``pair_budget``, ``BB``, both)."""

    STATE_KEYS = ("membership", "t_seeds", "t_pos", "usable_dev",
                  "chunk_off", "chunk_inset", "chunk_len")
    BINNED_STATE_KEYS = ("bin_mem1", "bin_mem2")
    # the resident tensors a data shard holds a replica of
    DEVICE_KEYS = ("membership", "t_seeds", "t_pos", "usable_dev",
                   "bin_mem1", "bin_mem2")

    def __init__(self, index, k: int, nq: int = 64, nt: int = 320,
                 mesh=None, hit_fraction: float = 0.25,
                 lean: bool = False, binned: bool = False, device=None):
        # batches run on the grid's data shards; without a grid, on a
        # 1 x 1 grid of ``device``
        self.mesh = mesh
        self._grid = (mesh if mesh is not None
                      else DeviceGrid.single(resolve_device(device)))
        self.device = self._grid.home
        self.seed_sharded = (mesh is not None
                             and "seed" in mesh.axis_names
                             and mesh.shape["seed"] > 1)
        self.index = index
        self.k = k
        # lean: pack only the mapper-walk summary columns (1 + 7K)
        self.lean = lean
        self.nq = nq
        self.nt = nt
        self.hit_fraction = hit_fraction
        self.routes = Counter()
        self.bins = Counter()
        self.reruns = Counter()
        # (route, rows) -> the largest block count of the last collected
        # map dispatch of that route and size (``_map_budget``)
        self._seen = {}
        S = index.num_seeds
        self.H = match_ops.choose_hash_size(S)
        self.num_seeds = S
        C = index.num_sequences
        self.C = C
        # the JAX engine's chunk-axis padding, kept so that the resident
        # state (and chunk ids) equal the reference engine's
        _grid = 128 if C <= 2048 else (1024 if C <= 16384 else 4096)
        CP = max(128, ((C + _grid - 1) // _grid) * _grid)
        # two-level binned retrieval at genome scale: chunks permuted into
        # genome-position order so that bins are contiguous ranges of the
        # engine's chunk axis
        self._binned = (bool(binned) and C >= _BINNED_MIN_C
                        and not self.seed_sharded)
        self._perm = None
        if self._binned:
            self._CB = _BINNED_CB
            self._NB = CP // self._CB          # CP is a multiple of CB
            self._BB = min(8, self._NB)
            # stable: equal offsets keep their reference walk order
            order = np.argsort(
                np.fromiter((s.offset for s in index.sequences), np.int64,
                            C), kind="stable").astype(np.int32)
            self._perm = order         # engine position -> index chunk id
            self._pos_of = np.empty(C, np.int32)
            self._pos_of[order] = np.arange(C, dtype=np.int32)
        derive_mem = (not self.seed_sharded
                      and max((s.num_seeds for s in index.sequences),
                              default=0) <= nt)
        mem = None if derive_mem else np.zeros((self.H, CP), dtype=np.int8)
        t_seeds = np.full((CP, nt), -1, np.int32)
        t_pos = np.zeros((CP, nt), np.int32)
        # chunk geometry for the vectorized candidate walk
        self.chunk_off = np.zeros(CP, np.int64)
        self.chunk_inset = np.zeros(CP, np.int64)
        self.chunk_len = np.zeros(CP, np.int64)
        for ci_, s in enumerate(index.sequences):
            # device tables in engine (permuted) order, chunk geometry in
            # the index's order: collectors translate ids back
            p = int(self._pos_of[ci_]) if self._binned else ci_
            if mem is not None and s.seeds.size:
                mem[match_ops.hash_ids(np.unique(s.seeds), S, self.H),
                    p] = 1
            m = min(s.num_seeds, nt)
            t_seeds[p, :m] = s.seeds[:m]
            t_pos[p, :m] = s.seed_positions(k)[:m]
            self.chunk_off[ci_] = s.offset
            self.chunk_inset[ci_] = s.inset
            self.chunk_len[ci_] = s.length
        dev = self.device
        self.t_seeds = torch.from_numpy(t_seeds).to(dev)
        self.t_pos = torch.from_numpy(t_pos).to(dev)
        self._hashed = S > self.H
        if self.seed_sharded:
            # hash-bucket rows padded to a multiple of n_seed with zero
            # rows; the row blocks go to the (data, seed) devices
            ns = mesh.shape["seed"]
            HP = ((self.H + ns - 1) // ns) * ns
            if HP != self.H:
                mem = np.concatenate(
                    [mem, np.zeros((HP - self.H, mem.shape[1]), mem.dtype)])
            self.membership = None
            self._mem_shape = mem.shape
        elif derive_mem:
            # every chunk's full seed list is resident: scatter on device
            self.membership = _derive_membership(self.t_seeds, self.H,
                                                 self._hashed)
        else:
            # truncated chunk(s): ship the exact matrix bit-packed
            packed = torch.from_numpy(np.packbits(mem, axis=1)).to(dev)
            self.membership = _unpack_membership(packed, mem.shape[1])
        if self._binned:
            NB, CB = self._NB, self._CB
            if derive_mem:
                # complete chunk tables: the level-1 matrix in its own,
                # wider hash space H1
                self.H1 = match_ops.choose_hash_size(S, max_h=1 << 20)
                self._hashed1 = S > self.H1
                self.bin_mem1 = _derive_bin_mem_direct(
                    self.t_seeds, self.H1, NB, CB, self._hashed1)
                self.bin_mem2 = (
                    self.bin_mem1
                    if self.H1 == self.H and self._hashed1 == self._hashed
                    else _derive_bin_mem(self.membership, NB, CB))
            else:
                # truncated chunk(s): bins from the exact membership
                self.H1 = self.H
                self._hashed1 = self._hashed
                self.bin_mem1 = self.bin_mem2 = _derive_bin_mem(
                    self.membership, NB, CB)
        # "usable" per Matches: seeds present in every chunk carry no info
        if index._seed_counts is None:
            index.index_sequences()
        self.usable = np.asarray(index._seed_counts) < max(1, C)
        UL = (self.H if S <= self.H
              else ((S + 4095) // 4096) * 4096)
        up = np.zeros(UL, np.int8)
        up[:S] = self.usable
        self.usable_dev = torch.from_numpy(up).to(dev)
        self._place(mem if self.seed_sharded else None)

    def _place(self, mem=None):
        """The data shards' resident tables (a grid only): replicas of the
        home tensors on each data device this process owns and, when
        seed-sharded, row block s of the padded host membership ``mem`` on
        device (d, s), one copy per distinct (device, block)."""
        self._shards = None
        g = self.mesh
        if g is None:
            return
        S = g.shape["seed"]
        blocks = {}
        self._shards = {}
        for d in range(g.shape["data"]):
            if not g.owns(d):
                continue
            dev = g.data_device(d)
            tabs = {key: (None if getattr(self, key, None) is None
                          else getattr(self, key).to(dev))
                    for key in self.DEVICE_KEYS}
            tabs["device"] = dev
            if self.seed_sharded:
                HL = mem.shape[0] // S
                for s in range(S):
                    key = (str(g.devices[d, s]), s)
                    if key not in blocks:
                        blocks[key] = torch.from_numpy(np.ascontiguousarray(
                            mem[s * HL:(s + 1) * HL])).to(g.devices[d, s])
                tabs["mem_blocks"] = [blocks[(str(g.devices[d, s]), s)]
                                      for s in range(S)]
            self._shards[d] = tabs

    def _tables(self, d: int) -> dict:
        """Data shard ``d``'s resident tensors and device."""
        if self._shards is not None:
            return self._shards[d]
        tabs = {key: getattr(self, key, None) for key in self.DEVICE_KEYS}
        tabs["device"] = self.device
        return tabs

    def shard_tensors(self) -> dict:
        """Per data shard this process owns, its resident tensors by name
        (``membership`` row blocks as ``mem_block<s>``)."""
        out = {}
        for d in (self._shards or {0: None}):
            tabs = dict(self._tables(d))
            tabs.pop("device")
            for s, blk in enumerate(tabs.pop("mem_blocks", [])):
                tabs[f"mem_block{s}"] = blk
            out[d] = {k: v for k, v in tabs.items() if v is not None}
        return out

    def load_state(self, arrays: dict):
        """Install resident state taken from a JAX ``downpore_tpu``
        MapEngine (``np.asarray`` of each ``STATE_KEYS`` field, and of each
        ``BINNED_STATE_KEYS`` field in binned mode) on this engine's
        device.  Shapes must match the ones this engine built from its
        index."""
        keys = self.STATE_KEYS + (self.BINNED_STATE_KEYS if self._binned
                                  else ())
        mem = None
        for key in keys:
            if key not in arrays:
                raise KeyError(f"load_state: missing {key!r}")
            new = np.asarray(arrays[key])
            if key == "membership" and self.seed_sharded:
                # the JAX engine's padded [HP, CP] rows, placed in blocks
                if tuple(new.shape) != tuple(self._mem_shape):
                    raise ValueError(f"load_state: membership has shape "
                                     f"{new.shape}, engine has "
                                     f"{tuple(self._mem_shape)}")
                mem = new.astype(np.int8)
                continue
            cur = getattr(self, key)
            if tuple(new.shape) != tuple(cur.shape):
                raise ValueError(f"load_state: {key} has shape "
                                 f"{new.shape}, engine has {tuple(cur.shape)}")
            if torch.is_tensor(cur):
                setattr(self, key, torch.tensor(new, dtype=cur.dtype,
                                                device=self.device))
            else:
                setattr(self, key, new.astype(cur.dtype))
        self.usable = np.asarray(arrays["usable_dev"])[:self.num_seeds] > 0
        self._nat_tables = None
        self._place(mem)

    # -- batch-vectorized window packing (host) --------------------------
    _NQS = 192  # seed-scan width: run-collapse is exact for windows with
    # up to this many seeds; beyond it num_sets undercounts, which only
    # lowers min_count (recall-safe, the chain DP is the filter)

    def _pack_windows_native(self, windows: List, lens_b: np.ndarray):
        """One-pass native packer (native/seqscan.cpp pack_windows): same
        outputs as the numpy pipeline of ``pack_query_windows``.  None
        when the toolchain is absent."""
        from .. import native
        if native.load() is None or not len(windows):
            return None
        tabs = getattr(self, "_nat_tables", None)
        if tabs is None:
            tabs = (np.ascontiguousarray(self.index.kmer_table, np.uint8),
                    np.ascontiguousarray(self.index.kmer_map, np.int32),
                    np.ascontiguousarray(self.usable, np.uint8))
            self._nat_tables = tabs
        kt, km, us = tabs
        off = np.zeros(len(windows), np.int64)
        np.cumsum(lens_b[:-1], out=off[1:])
        codes = np.empty(int(lens_b.sum()), np.uint8)
        for i, w in enumerate(windows):
            codes[off[i] : off[i] + lens_b[i]] = w.codes
        return native.pack_windows(codes, off, lens_b, self.k, self.nq,
                                   self._NQS, kt, km, us, self.num_seeds,
                                   self.H)

    def pack_query_windows(self, windows: List) -> tuple:
        """Seed features of plain sequence windows, forward and reverse
        complement rows interleaved ([2i] = fw of window i, [2i+1] = rc).
        Returns ``(q_seeds, q_pos, q_rb, q_db, num_sets, q_len,
        num_seeds)``: the query features plus the exact per-row
        extracted-seed counts (ref: mapping/mapping.go:497-505)."""
        index = self.index
        k = self.k
        nq = self.nq
        M = len(windows)
        lens_b = np.array([len(w) for w in windows], np.int64)

        native_out = self._pack_windows_native(windows, lens_b)
        if native_out is not None:
            q_seeds, q_pos, q_rb, q_db, num_sets, num_seeds = native_out
            q_len = np.repeat(lens_b, 2).astype(np.int32)
            return (q_seeds, q_pos, q_rb, q_db, num_sets, q_len,
                    num_seeds)

        L = max(int(lens_b.max()) if M else k, k)
        W = L - k + 1
        # forward and RC code rows interleaved, so one rolling-kmer pass
        # covers both orientations (complement of a 2-bit code = ^3)
        codes = np.zeros((2 * M, L), np.uint8)
        for i, w in enumerate(windows):
            n = lens_b[i]
            codes[2 * i, :n] = w.codes
            codes[2 * i + 1, :n] = w.codes[::-1]
            codes[2 * i + 1, :n] ^= 3
        lens_k = np.maximum(0, lens_b - k + 1)
        km2 = np.zeros((2 * M, W), np.int32)
        for j in range(k):
            km2 <<= 2
            km2 |= codes[:, j : j + W]
        cols = np.arange(W)[None, :]
        lens2 = np.repeat(lens_k, 2)
        q_len = np.repeat(lens_b, 2).astype(np.int32)
        valid = cols < lens2[:, None]
        flag = valid & index.kmer_table[km2]
        num_seeds = flag.sum(1).astype(np.int64)

        # compact the first _NQS flagged positions per row (order kept)
        NQS = self._NQS
        dest = np.cumsum(flag, axis=1, dtype=np.int32) - 1
        rows, colsnz = np.nonzero(flag & (dest < NQS))
        d = dest[rows, colsnz]
        pos_c = np.zeros((2 * M, NQS), np.int32)
        km_c = np.zeros((2 * M, NQS), np.int32)
        pos_c[rows, d] = colsnz
        km_c[rows, d] = km2[rows, colsnz]
        live_c = np.arange(NQS)[None, :] < np.minimum(num_seeds,
                                                      NQS)[:, None]
        seeds_c = np.where(live_c, index.kmer_map[km_c], -1)

        q_seeds = seeds_c[:, :nq].astype(np.int32)
        q_pos = np.where(live_c[:, :nq], pos_c[:, :nq], 0).astype(np.int32)

        # run-collapse over usable seeds (SeedIndex.matches semantics,
        # ref: seeds/seeds.go:335-353); num_sets = exact run count
        us = live_c & self.usable[np.clip(seeds_c, 0, None)] & \
            (seeds_c >= 0)
        slot = np.arange(NQS)[None, :]
        idxs = np.where(us, slot, -1)
        pa = np.maximum.accumulate(idxs, axis=1)
        prev = np.empty_like(pa)
        prev[:, 0] = -1
        prev[:, 1:] = pa[:, :-1]
        pv = np.take_along_axis(seeds_c, np.clip(prev, 0, None), 1)
        pv = np.where(prev >= 0, pv, -2)
        run_start = us & (pv != seeds_c)
        num_sets = run_start.sum(1).astype(np.int32)

        rdest = np.cumsum(run_start, axis=1) - 1
        rrows, rcols = np.nonzero(run_start & (rdest < nq))
        rd = rdest[rrows, rcols]
        run_seeds = np.full((2 * M, nq), -1, np.int64)
        run_seeds[rrows, rd] = seeds_c[rrows, rcols]
        rb_live = run_seeds >= 0
        q_rb = np.where(
            rb_live,
            match_ops.hash_ids(np.clip(run_seeds, 0, None),
                               self.num_seeds, self.H), -1).astype(np.int32)
        # distinct buckets: row-sorted unique (-1 marks dead slots)
        BIG = 1 << 30
        srt = np.sort(np.where(q_rb >= 0, q_rb, BIG), axis=1)
        first = np.empty_like(srt, dtype=bool)
        first[:, 0] = True
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
        q_db = np.where(first & (srt < BIG), srt, -1).astype(np.int32)
        return q_seeds, q_pos, q_rb, q_db, num_sets, q_len, num_seeds

    # -- dispatch / collect ---------------------------------------------
    def dispatch_packed(self, packed: tuple, base_min: np.ndarray,
                        pair_budget: int = 0, top_k: int = 4,
                        min_sets: int = 5):
        """Enqueue the fused pipeline on a prepacked query-feature tuple
        (``pack_query_windows``), one block of rows per data shard, and
        return without reading anything back: ``(M, [Pending, ...],
        (route, M))``, or ``(0, None, None)`` for an empty batch or index.
        Each block runs at ``pair_budget`` passing pairs (0:
        ``_map_budget``) and, binned, at the selection width ``BB`` the
        JAX engine starts from; ``collect_arrays_many`` re-runs a block
        that exceeded either."""
        q_seeds, q_pos, q_rb, q_db, num_sets, q_len = packed[:6]
        M = q_seeds.shape[0]
        if M == 0 or self.C == 0:
            return (0, None, None)
        # right-size the seed axis: halve it when every row's live seeds
        # fit half the width (anchors = 2 * nq_eff per pair)
        nq_full = self.nq
        max_live = int((q_seeds >= 0).sum(axis=1).max(initial=1))
        nq_eff = nq_full if max_live > nq_full // 2 else nq_full // 2
        if nq_eff < nq_full:
            q_seeds = q_seeds[:, :nq_eff]
            q_pos = q_pos[:, :nq_eff]
            q_rb = q_rb[:, :nq_eff]
            q_db = q_db[:, :nq_eff]
        # min_count per Matches: round(hit_fraction * num_sets); queries
        # with too few usable seeds get no candidates (min_count = 0
        # never passes the > 0 check)
        min_count = (self.hit_fraction * num_sets.astype(np.int64)
                     + 0.5).astype(np.int64)
        min_count[num_sets < min_sets] = 0
        base_min = np.minimum(np.asarray(base_min), 1 << 14)
        # buckets are a pure function of (q_seeds, usable) whenever every
        # extracted seed of every row fits the shipped width (never
        # derived when seed-sharded, as in the JAX engine)
        num_seeds_arr = packed[6] if len(packed) > 6 else None
        nq = q_seeds.shape[1]
        derive = (not self.seed_sharded and num_seeds_arr is not None
                  and int(np.max(num_seeds_arr, initial=0)) <= nq)
        if self.seed_sharded:
            route = "_map_from_counts"
        else:
            route = ("_fused_map_b" if self._binned else "_fused_map_") \
                + ("d" if derive else "c")
        # the bucket's and a data split's padding rows (min_count 0) never
        # pass the gate
        rows = dict(q_pos=(q_pos, 0), min_count=(min_count, 0),
                    base_min=(base_min, 1 << 14), q_len=(q_len, 0),
                    q_seeds=(q_seeds, -1))
        if not derive:
            rows.update(q_rb=(q_rb, -1), q_db=(q_db, -1))
        MB = captured.padded_rows(M, self._grid.shape["data"])
        budget = pair_budget or self._map_budget(route, MB)
        keep = []
        blocks = []
        for d, lo, parts in self._grid.split_rows(
                [captured.pad_rows(np.asarray(a, np.int32), MB, f)
                 for a, f in rows.values()],
                [f for _, f in rows.values()], keep):
            q = dict(zip(rows, parts))
            tabs = self._tables(d)
            self.routes[route] += 1
            blocks.append(Pending(
                lo, tabs["device"],
                functools.partial(self._dispatch_block, q, tabs, route,
                                  top_k),
                (budget, self._BB if self._binned else 0), keep,
                _map_fetch))
        return (M, blocks, (route, MB))

    def _map_budget(self, route: str, MB: int) -> int:
        """The pair budget of each block of a map dispatch of ``MB``
        (bucketed) rows on ``route``: the JAX engine's (``map_budget``,
        split over the blocks) or, once a dispatch of that route and size
        has been collected, ``_tight`` of the largest block count
        collected there when smaller.  Any budget gives the same rows
        (collect re-runs an overflow); a tight one spares the device the
        padding slots' anchors, and one that follows the running maximum
        settles, so the dispatches of a route and size replay one
        captured graph."""
        budget = _per_block(map_budget(MB, self.num_seeds > 2 * self.H),
                            self._grid.shape["data"])
        seen = self._seen.get((route, MB))
        return budget if seen is None else min(budget, _tight(seen))

    def _dispatch_block(self, q: dict, tabs: dict, route: str, top_k: int,
                        budget: int, BB: int):
        """One data shard's fused map pipeline on its device, at ``budget``
        pairs (and width ``BB``, binned): ``(head, packed16, n_ok[,
        n_bin])`` on the device, through ``captured.run`` (seed-sharded:
        each shard's counts, then the tail from the summed counts)."""
        inputs = {n: q[n] for n in ("q_pos", "min_count", "base_min",
                                    "q_len", "q_seeds")}
        tables = dict(t_seeds=tabs["t_seeds"], t_pos=tabs["t_pos"])
        statics = dict(k=self.k, pair_budget=budget, top_k=top_k,
                       lean=self.lean)
        if route == "_map_from_counts":
            dev = tabs["device"]
            inputs.update(
                counts=sharded_counts(tabs["mem_blocks"], q["q_rb"], dev),
                dcounts=sharded_counts(tabs["mem_blocks"], q["q_db"], dev))
            return captured.run(_map_from_counts, inputs, tables, **statics)
        tables["membership"] = tabs["membership"]
        if route in ("_fused_map_d", "_fused_map_bd"):
            tables["usable"] = tabs["usable_dev"]
            statics["hashed"] = self._hashed
        else:
            inputs.update(q_rb=q["q_rb"], q_db=q["q_db"])
        if route == "_fused_map_bd":
            tables["bin_mem"] = tabs["bin_mem1"]
            statics["hashed1"] = self._hashed1
        elif route == "_fused_map_bc":
            tables["bin_mem"] = tabs["bin_mem2"]
        if self._binned:
            statics.update(NB=self._NB, CB=self._CB, BB=BB, C=self.C)
        fn = {"_fused_map_d": _fused_map_d, "_fused_map_c": _fused_map_c,
              "_fused_map_bd": _fused_map_bd,
              "_fused_map_bc": _fused_map_bc}[route]
        return captured.run(fn, inputs, tables, **statics)

    def _collect_block(self, p: Pending):
        """A map block's host rows, exact: while its passing count exceeds
        the budget or (binned) its most passing bins exceed ``BB``, re-run
        it with the budget grown 4x until it holds the count and ``BB`` at
        ``_bb_final``, the width the JAX engine's doubling ends on (the
        passing bins do not depend on ``BB``).  Returns ``(head, packed)``
        of the live rows and the passing count."""
        cnt, head, packed = p.host.wait()
        n_ok = int(cnt[0])
        n_bin = int(cnt[1]) if self._binned else 0
        budget, BB = p.args
        while n_ok > budget or n_bin > BB:
            cause = [c for c, over in (("pair_budget", n_ok > budget),
                                       ("BB", n_bin > BB)) if over]
            self.reruns["+".join(cause)] += 1
            BB = _bb_final(n_bin, BB, self._NB) if self._binned else 0
            while n_ok > budget:
                budget *= 4
            cnt, head, packed = p.rerun(budget, BB)
            n_ok = int(cnt[0])
        if self._binned:
            self.bins[(n_bin, BB)] += 1
        live = head[:, 0] >= 0
        return head[live], packed[live].astype(np.int32), n_ok

    def collect_arrays_many(self, futs_list):
        """Host arrays of several dispatches: per dispatch ``(head [N, 3]
        int32 (query row, chunk, distinct count), summary [N, W] int32)``
        ordered query-major / chunk-ascending (the reference's candidate
        walk order), or None for an empty dispatch.  Each block is made
        exact first (``_collect_block``); its query rows are offset by its
        first row; binned engines' chunk ids are translated from engine to
        index order and the rows sorted again."""
        out = []
        for _, blocks, shape in futs_list:
            if blocks is None:
                out.append(None)
                continue
            parts, counts = {}, []
            for p in blocks:
                head, packed, n_ok = self._collect_block(p)
                counts.append(n_ok)
                head[:, 0] += p.lo
                if self._perm is not None:
                    head[:, 1] = self._perm[head[:, 1]]
                    order = np.lexsort((head[:, 1], head[:, 0]))
                    head, packed = head[order], packed[order]
                parts[p.lo] = (head, packed)
            self._seen[shape] = max(self._seen.get(shape, 0), *counts)
            parts = self._grid.gather(parts)
            out.append(parts[0] if len(parts) == 1 else tuple(
                np.concatenate([p[i] for p in parts]) for i in range(2)))
        return out

    # -- host-side seed-query packing (overlapper) -----------------------
    def pack_queries(self, seed_queries: List,
                     need_buckets: bool = True) -> tuple:
        """Seed sequences -> fixed-shape query arrays ``(q_seeds, q_pos,
        q_rb, q_db, num_sets, q_len)``.  Run-collapse and the usable mask
        follow ``SeedIndex.matches`` (ref: seeds/seeds.go:335-353);
        ``num_sets`` is the exact run count.  With ``need_buckets`` False
        the bucket arrays stay -1."""
        M = len(seed_queries)
        nq = self.nq
        q_seeds = np.full((M, nq), -1, np.int32)
        q_pos = np.zeros((M, nq), np.int32)
        q_rb = np.full((M, nq), -1, np.int32)
        q_db = np.full((M, nq), -1, np.int32)
        num_sets = np.zeros(M, np.int32)
        q_len = np.zeros(M, np.int32)
        for i, sq in enumerate(seed_queries):
            s = sq.seeds
            m = min(s.shape[0], nq)
            q_seeds[i, :m] = s[:m]
            q_pos[i, :m] = sq.seed_positions(self.k)[:m]
            q_len[i] = sq.length
            f = s[self.usable[s]]
            if f.size:
                runs = f[np.concatenate([[True], f[1:] != f[:-1]])]
                num_sets[i] = runs.shape[0]
                if not need_buckets:
                    continue
                rb = match_ops.hash_ids(runs, self.num_seeds, self.H)
                r = min(rb.shape[0], nq)
                q_rb[i, :r] = rb[:r]
                db = np.unique(rb)
                d = min(db.shape[0], nq)
                q_db[i, :d] = db[:d]
        return q_seeds, q_pos, q_rb, q_db, num_sets, q_len

    # -- overlap dispatch / collect --------------------------------------
    def query_chains(self, seed_queries: List, base_min: np.ndarray,
                     pair_budget: int = 0, chain_len: int = 128,
                     variant: str = "aligner", min_sets: int = 5,
                     _defer: bool = False, shape_plan: dict = None):
        """Fused retrieval + gate + chain + best-chain extraction.

        Returns per query a list of (chunk idx, distinct count, best chain
        length, query-anchor indices, target-anchor indices) in chunk
        order: the overlapper's per-candidate best alignments.  Target
        indices address the chunk's own seed list (truncated at
        ``self.nt`` seeds).  Each data block runs at ``pair_budget``
        passing pairs (0: ``overlap_budget`` of the batch's rows split
        over the blocks, raised to the job's ``shape_plan["budget"]``,
        which collect keeps at ``_grown`` of the largest block count it
        has seen).  The rows are padded to the job's ``shape_plan["mb"]``,
        the largest row bucket its batches have had (the JAX overlapper's
        shape half of the plan), so that a round's short last batch and
        every later round replay the graphs of its full batches."""
        M = len(seed_queries)
        if M == 0 or self.C == 0:
            return []
        plan = shape_plan if shape_plan is not None else {}
        # the DP scans 2 * nq_eff anchors and the walk chain_len steps:
        # sized to the batch's real max seed count on a 64 grid
        max_ns = max((len(q.seeds) for q in seed_queries), default=1)
        nq_eff = min(self.nq,
                     max(32, ((min(max_ns, self.nq) + 63) // 64) * 64))
        # buckets derive on the device when every query's seeds fit (never
        # when seed-sharded, as in the JAX engine)
        derive = not self.seed_sharded and max_ns <= nq_eff
        q_seeds, q_pos, q_rb, q_db, num_sets, _ = self.pack_queries(
            seed_queries, need_buckets=not derive)
        q_seeds = q_seeds[:, :nq_eff]
        q_pos = q_pos[:, :nq_eff]
        chain_len = min(chain_len, nq_eff)
        min_count = (self.hit_fraction * num_sets + 0.5).astype(np.int64)
        min_count[num_sets < min_sets] = 0
        MB = max(captured.row_bucket(M), plan.get("mb", 0))
        plan["mb"] = MB
        MB = captured.padded_rows(MB, self._grid.shape["data"])
        # the bucket's and a data split's padding rows (min_count 0) never
        # pass the gate
        rows = dict(q_pos=(q_pos, 0), min_count=(min_count, 0),
                    q_seeds=(q_seeds, -1))
        if derive:
            rows["base_min"] = (np.minimum(np.asarray(base_min), 1 << 14),
                                1 << 14)
        else:
            rows.update(base_min=(base_min, 1 << 20), q_rb=(q_rb, -1),
                        q_db=(q_db, -1))
        route = ("_overlap_from_counts" if self.seed_sharded
                 else "_fused_overlap_d" if derive else "_fused_overlap")
        budget = pair_budget or max(
            _per_block(overlap_budget(M), self._grid.shape["data"]),
            plan.get("budget", 0))
        keep = []
        blocks = []
        for d, lo, parts in self._grid.split_rows(
                [captured.pad_rows(np.asarray(a, np.int32), MB, f)
                 for a, f in rows.values()],
                [f for _, f in rows.values()], keep):
            q = dict(zip(rows, parts))
            tabs = self._tables(d)
            statics = dict(k=self.k, variant=variant, chain_len=chain_len)
            self.routes[route] += 1
            blocks.append(Pending(
                lo, tabs["device"],
                functools.partial(self._overlap_block, q, tabs, route,
                                  statics),
                (budget,), keep, _overlap_fetch))
        futs = (M, blocks, plan)
        return futs if _defer else self.collect_chains(futs)

    def _overlap_block(self, q: dict, tabs: dict, route: str, statics: dict,
                       budget: int):
        """One data shard's fused overlap pipeline on its device, at
        ``budget`` pairs: ``(head, cq, ct, n_ok, n_keep, mx)`` on the
        device, through ``captured.run`` (seed-sharded: each shard's
        counts, then the tail from the summed counts)."""
        inputs = {n: q[n] for n in ("q_pos", "min_count", "q_seeds",
                                    "base_min")}
        tables = dict(t_seeds=tabs["t_seeds"], t_pos=tabs["t_pos"])
        statics = dict(statics, pair_budget=budget)
        if route == "_overlap_from_counts":
            dev = tabs["device"]
            inputs.update(
                counts=sharded_counts(tabs["mem_blocks"], q["q_rb"], dev),
                dcounts=sharded_counts(tabs["mem_blocks"], q["q_db"], dev))
            return captured.run(_overlap_from_counts, inputs, tables,
                                **statics)
        tables["membership"] = tabs["membership"]
        if route == "_fused_overlap_d":
            tables["usable"] = tabs["usable_dev"]
            return captured.run(_fused_overlap_d, inputs, tables,
                                hashed=self._hashed, **statics)
        inputs.update(q_rb=q["q_rb"], q_db=q["q_db"])
        return captured.run(_fused_overlap, inputs, tables, **statics)

    def dispatch_chains(self, seed_queries: List, base_min: np.ndarray,
                        pair_budget: int = 0, chain_len: int = 128,
                        variant: str = "aligner", min_sets: int = 5,
                        shape_plan: dict = None):
        """First half of ``query_chains``: enqueue the fused pipeline and
        return, reading nothing back, its pending blocks for
        ``collect_chains``."""
        return self.query_chains(seed_queries, base_min, pair_budget,
                                 chain_len, variant, min_sets, _defer=True,
                                 shape_plan=shape_plan)

    def collect_chains_raw(self, futs):
        """Host arrays of a ``dispatch_chains`` result: ``(M, head, cq,
        ct)`` with head columns (query row, chunk, best chain length,
        distinct count) over the kept rows, in query-major /
        chunk-ascending order, and the chains sliced to the longest kept
        one (-1 past each row's own chain).  A block whose passing count
        exceeds its budget re-runs at ``max(2 x budget, _grown(count))``
        until it holds it, as the JAX collect does; every count raises the
        job plan's budget to ``_grown`` of it.  The rows are sliced on the
        device to the kept ones and the real length before they are
        fetched."""
        if isinstance(futs, list):       # empty-input fast path
            return 0, np.zeros((0, 4), np.int32), None, None
        M, blocks, plan = futs
        parts = {}
        for p in blocks:
            (cnt,) = p.host.wait()
            n = int(cnt[0])
            while n > p.args[0]:
                self.reruns["pair_budget"] += 1
                (cnt,) = p.rerun(max(p.args[0] * 2, _grown(n)))
                n = int(cnt[0])
            plan["budget"] = max(plan.get("budget", 0), _grown(n))
            nk, Lb = int(cnt[1]), max(1, int(cnt[2]))
            head, cq, ct = p.result[:3]
            head, cq, ct = HostCopy([head[:nk], cq[:nk, :Lb],
                                     ct[:nk, :Lb]]).wait()
            head[:, 0] += p.lo
            parts[p.lo] = (head, cq, ct)
        parts = self._grid.gather(parts)
        if len(parts) == 1:
            return (M,) + parts[0]
        L = max(p[1].shape[1] for p in parts)
        pad = lambda a: np.pad(a, ((0, 0), (0, L - a.shape[1])),
                               constant_values=-1)
        return (M, np.concatenate([p[0] for p in parts]),
                np.concatenate([pad(p[1]) for p in parts]),
                np.concatenate([pad(p[2]) for p in parts]))

    def collect_chains(self, futs):
        """Per-query candidate lists of a ``dispatch_chains`` result (see
        ``query_chains``)."""
        if isinstance(futs, list):       # empty-input fast path
            return futs
        M, head, cq, ct = self.collect_chains_raw(futs)
        out = [[] for _ in range(M)]
        live = np.flatnonzero((head[:, 0] >= 0) & (head[:, 0] < M)
                              & (head[:, 2] > 0))
        hl = head[live].tolist()
        for i, b in enumerate(live.tolist()):
            mi, ci, blen, dc = hl[i]
            ma = cq[b, blen - 1::-1].tolist()
            mb = ct[b, blen - 1::-1].tolist()
            out[mi].append((ci, dc, blen, ma, mb))
        return out
