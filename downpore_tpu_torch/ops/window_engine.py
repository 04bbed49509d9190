"""Device-resident window matching engine for the trimmer (torch port of
``downpore_tpu/ops/window_engine.py``).

Resident state on the engine's device, built as the JAX engine builds it:

* ``_front_km`` / ``_back_km [4^k, AP] int8`` — k-mer -> adapter
  membership (AP is the adapter count rounded up to a multiple of 128),
* ``front`` / ``back`` — the adapter seed tables in k-mer space: seeds
  ``[AP, nq]`` int32 (pad -1), positions ``[AP, nq]`` int16, lengths
  ``[AP]`` int32,
* ``_front_bc`` / ``_back_bc [AP] int32`` — barcode flags.

A batch of windows goes to the device once, as 2-bit packed codes
(``upload``); ``_unpack_kmers`` rebuilds the rolling k-mers there.  The
gate sums the membership rows of each window's k-mers (``_gate_counts``:
counts per *position*, so a k-mer repeated in a window counts each time),
keeps the top-``top_t`` adapters of each window (``_gate_topk_pairs``, ties
to the lower adapter index), and the chain DP (``chain.dp_from_anchors`` ->
``cuda_chain.chain_scan_fb``) runs on the pairs that pass.  The edge verdict
(the findMatches walk), DetermineAdapters' per-adapter coverage and the
middle pass's detection rows are computed on the device; only they come
back to the host.

Each ``*_dispatch`` uploads its batch without waiting (pinned staging,
``transfer.upload``), enqueues the verdict and the host copy of its
result, and returns ``transfer.Pending`` blocks; nothing is read back
until ``*_collect``.  As in the JAX engine, the chain DP runs over a fixed
pair budget of gate-passing pairs (``_passing``: ascending pair order,
dead slots after them, with no anchor), and the middle pass keeps at most
``det_budget`` detection rows a block; collect reads the counts, re-runs
a block over its pair budget over every passing pair, and one over its
detection budget so at 4x that budget, whose first rows it keeps.  So above
``4 * det_budget`` detections in one block the middle pass drops the
rest, exactly as the JAX package does.

The dispatches pad a batch's rows to the JAX engine's shape bucket
(``captured.row_bucket``, rounded to the grid's data axis; padding rows
have no k-mers) and run each block through ``captured.run``: on a card
one CUDA graph per (verdict, bucket, budgets, table shapes), captured at
its first dispatch and replayed after, the counterpart of the JAX
engine's ``jax.jit`` per shape.  A re-run at collect takes a budget that
covers every passing pair and settles (``_rerun_budget``), so the
re-runs of a run replay one graph.

Dropped from the JAX engine because no output depends on them: the
rotating host staging buffers (a pinned staging tensor per upload, kept
by the dispatch's blocks), the resident copy of the thresholds, the
``lax.map`` segments and the one-hot picks.  So is
the paired edge route (``_fused_edge_pair``, ``edge_pair_dispatch`` /
``edge_pair_collect`` and the front/back tables stacked for them):
stacking bought the JAX engine one XLA call for both sides, but here each
side's block is already one graph replay, and a paired block saves no
host time and ends later, since both sides are packed before its device
work starts, where the front's device work runs beside the back's
packing; so each side takes ``edge_verdict_dispatch``.  Pairs that fail
the gate chain nowhere: they
report the empty summary the JAX engine gives them.  Only
``_fused_match``, which returns every pair's summary row, chains them
all.  ``chain`` and ``_chain_from_windows`` have no caller and are not
ported.

With a device grid (``mesh``) the tables replicate to each data shard's
device and every window batch splits into the grid's data shards
(contiguous, equal row blocks; padding rows have no k-mers, so they pass
no gate); each block is enqueued on its shard's device without waiting,
so the blocks run at the same time on distinct cards, and the collects
put the blocks' rows back in order (per-adapter totals summed, coverages
maximized).
"""
from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import DeviceGrid
from . import captured
from .chain import anchors_of_slots, compact_indices, dp_from_anchors, \
    make_anchors_topk, summarize_dp, summarize_scalars, unpack_summary
from .map_engine import _tight
from .transfer import HostCopy, Pending, upload

_BIGM = 1 << 20  # impossible min-match for gate-failing pairs
# bound on the [m, W, A] int8 block one gate gather materializes
_GATHER_ELEMS = 1 << 28
# pairs per anchor-build step: bounds the [chunk, NQ, W] equality tensor
_ANCHOR_CHUNK = 4096


def _unpack_kmers(packed, k: int, W: int):
    """2-bit packed window codes ``[n, (W + k - 1) / 4] uint8`` (4 bases a
    byte, first base in the high bits) -> ``[n, W]`` int32 rolling
    k-mers."""
    n = packed.shape[0]
    # (6, 4, 2, 0), made on the device: a tensor built from a host list
    # would be a copy that waits for the device's queue
    shifts = torch.arange(6, -1, -2, dtype=torch.int32, device=packed.device)
    codes = ((packed.to(torch.int32)[:, :, None] >> shifts) & 3).reshape(
        n, -1)
    acc = torch.zeros((n, W), dtype=torch.int32, device=packed.device)
    for j in range(k):
        acc |= codes[:, j:j + W] << (2 * (k - 1 - j))
    return acc


def _gate_counts(kmers, lens, km_table):
    """``[n, W]`` k-mers (+ per-row k-mer counts) -> ``[n, A]`` int32
    hit counts: the sum of the int8 table rows of each row's live
    k-mers, gathered in blocks of at most ``_GATHER_ELEMS``."""
    n, W = kmers.shape
    A = km_table.shape[1]
    km = kmers.clamp(min=0).long()
    valid = torch.arange(W, device=kmers.device)[None, :] < lens[:, None]
    out = torch.empty((n, A), dtype=torch.int32, device=kmers.device)
    step = max(1, _GATHER_ELEMS // max(1, W * A))
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        rows = torch.where(valid[sl, :, None], km_table[km[sl]], 0)
        out[sl] = rows.sum(dim=1, dtype=torch.int32)
    return out


def _gate_topk_pairs(kmers, lens, km_table, gate_min, chain_min,
                     top_t: int):
    """Gate counts + per-window top-``top_t`` adapter selection, flattened
    to (window idx, adapter idx, min-match) pair vectors of length
    ``n * top_t`` (gate-failing pairs get the impossible min-match).  Ties
    go to the lower adapter index, as ``jax.lax.top_k`` orders them: a
    stable descending sort, never ``torch.topk``."""
    counts = _gate_counts(kmers, lens, km_table)
    srt = torch.sort(counts, dim=1, descending=True, stable=True)
    cvals, cai = srt.values[:, :top_t], srt.indices[:, :top_t]
    ok = cvals >= gate_min[cai]
    n = kmers.shape[0]
    ei = torch.arange(n, device=kmers.device).repeat_interleave(top_t)
    ai = cai.reshape(-1)
    mm = torch.where(ok.reshape(-1), chain_min[ai], _BIGM)
    return ei, ai, mm


def _anchors_chunked(kmers, lens, a_seeds, a_pos, ei, ai, live=None,
                     chunk: int = _ANCHOR_CHUNK):
    """Anchors of the (window ``ei``, adapter ``ai``) pairs, built
    ``chunk`` pairs at a time.  The adapter tables are in k-mer space, so
    window k-mers compare with them directly; positions past a window's
    k-mer count are -1, and so is every position of a dead budget slot
    (``live`` False), which therefore has no anchor
    (``chain.anchors_of_slots``)."""
    W = kmers.shape[1]
    pos = torch.arange(W, dtype=torch.int32, device=kmers.device)

    def build(rows):
        e_all, a_all, on = (ei, ai, live) if rows is None \
            else (ei[rows], ai[rows], live[rows])
        parts = []
        for lo in range(0, max(1, e_all.shape[0]), chunk):
            e, a = e_all[lo:lo + chunk], a_all[lo:lo + chunk]
            n_e = lens[e] if on is None else torch.where(
                on[lo:lo + chunk], lens[e], 0)
            ts = torch.where(pos[None, :] < n_e[:, None], kmers[e], -1)
            parts.append(make_anchors_topk(
                a_seeds[a].to(torch.int32), a_pos[a].to(torch.int32), ts,
                pos.expand(e.shape[0], W), per_seed=2))
        return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
    return build(None) if live is None else anchors_of_slots(live, build)


def _passing(ei, ai, mm, pair_budget: int):
    """The gate-passing pairs compacted, in ascending pair order, to
    ``pair_budget`` slots (every pair's slot when 0 or not below the pair
    count: the unbudgeted form).  Returns ``(sel, live, ei, ai, mm,
    n_ok)``: each slot's pair index (the pair count for a dead slot), its
    liveness, the slots' pairs (dead ones at window and adapter 0 with the
    impossible min-match) and the passing count, a 0-d device tensor."""
    P = ei.shape[0]
    B = pair_budget if 0 < pair_budget < P else P
    sel, n_ok = compact_indices(mm < _BIGM, B)
    live = sel < P
    cl = sel.clamp(max=max(0, P - 1))
    return (sel, live, torch.where(live, ei[cl], 0),
            torch.where(live, ai[cl], 0), torch.where(live, mm[cl], _BIGM),
            n_ok)


def _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei, ai, mm, live,
                 k: int):
    """Anchors, chain DP and scalar summaries of the budget slots'
    pairs (ei, ai); dead slots have no anchor."""
    out = dp_from_anchors(
        _anchors_chunked(kmers, lens, a_seeds, a_pos, ei, ai, live), k)
    return out, summarize_scalars(out, mm, a_len[ai], k)


def _fused_match(packed, lens, km_table, gate_min, chain_min,
                 a_seeds, a_pos, a_len, k: int, W: int, top_t: int = 4,
                 top_k: int = 4):
    """Gate + adapter selection + chain + summary: ``[n, top_t, M+1]``
    int16 rows of (adapter idx, packed summary) for every (window,
    top-``top_t`` adapter) pair, gate-failing pairs chained with the
    impossible min-match.  Values are clamped to int16 as the JAX
    engine's rows are."""
    kmers = _unpack_kmers(packed, k, W)
    n = kmers.shape[0]
    ei, ai, mm = _gate_topk_pairs(kmers, lens, km_table, gate_min,
                                  chain_min, top_t)
    out = dp_from_anchors(
        _anchors_chunked(kmers, lens, a_seeds, a_pos, ei, ai), k)
    rows = torch.cat([ai[:, None].to(torch.int32),
                      summarize_dp(out, mm, a_len[ai], k, top_k)], dim=1)
    return rows.clamp(-32768, 32767).to(torch.int16).reshape(n, top_t, -1)


def _fused_edge_verdict(packed, lens, km_table, gate_min, chain_min,
                        a_seeds, a_pos, a_len, is_barcode, k: int, W: int,
                        top_t: int = 8, pair_budget: int = 0):
    """Edge pass: gate + chain + the per-edge adapter walk of the
    reference's findMatches (ref: trim/trim.go:354-428), the chain DP over
    the first ``pair_budget`` gate-passing pairs (``_passing``).

    Returns (verdict ``[n, 4]`` int32 of (found, best_match, earliest,
    latest), per-adapter chain-count totals ``[AP]`` int32, gate-passing
    pair count); collect re-runs over every passing pair when the count
    exceeds the budget."""
    kmers = _unpack_kmers(packed, k, W)
    n = kmers.shape[0]
    ei, ai, mm = _gate_topk_pairs(kmers, lens, km_table, gate_min,
                                  chain_min, top_t)
    sel, live, ei_s, ai_s, mm_s, n_ok = _passing(ei, ai, mm, pair_budget)
    _, s = _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei_s, ai_s,
                        mm_s, live, k)

    def grid(v):
        """Back onto the (window, top-t) grid; failing pairs hold 0, dead
        slots land in a trailing element that is dropped."""
        g = torch.zeros(n * top_t + 1, dtype=v.dtype, device=v.device)
        g[sel] = v
        return g[:-1].reshape(n, top_t)

    n_chains = grid(s["n_chains"])
    has = n_chains > 0
    ai_t = ai.reshape(n, top_t)
    ident = torch.div(grid(s["ident_cov_q"]) * 100,
                      a_len[ai_t].clamp(min=1), rounding_mode="floor")
    e_t, l_t = grid(s["earliest"]), grid(s["latest"])

    # walk hits in adapter order, as findMatches does: barcode precedence
    # + the +-5 ambiguity rule (jnp.argsort is stable, so is this one)
    order = torch.argsort(torch.where(has, ai_t, 1 << 30), dim=1,
                          stable=True)
    has, ai_t, ident, e_t, l_t = (torch.gather(a, 1, order)
                                  for a in (has, ai_t, ident, e_t, l_t))
    elen = lens + (k - 1)            # bases in each window
    is_bc = is_barcode[ai_t] > 0
    false = torch.zeros(n, dtype=torch.bool, device=kmers.device)
    found, barcoded, ambiguous = false, false, false
    best_i = torch.zeros(n, dtype=torch.int32, device=kmers.device)
    best_a = torch.zeros_like(ai_t[:, 0])
    early, late = elen, torch.zeros_like(elen)
    for t in range(top_t):
        hit, a, idn, bc = has[:, t], ai_t[:, t], ident[:, t], is_bc[:, t]
        case1 = hit & ~barcoded & bc
        case2 = hit & barcoded & bc
        case3 = hit & ~barcoded & ~bc & (idn > best_i)
        delta = idn - best_i
        ambiguous = torch.where(case2, (delta > -5) & (delta < 5), ambiguous)
        upd = case1 | case3 | (case2 & (idn > best_i))
        best_i = torch.where(upd, idn, best_i)
        best_a = torch.where(upd, a, best_a)
        barcoded = barcoded | case1
        early = torch.where(hit, torch.minimum(early, e_t[:, t].clamp(min=0)),
                            early)
        late = torch.where(hit, torch.maximum(late,
                                              torch.minimum(elen, l_t[:, t])),
                           late)
        found = found | hit
    # ambiguous barcodes: trim but report no adapter (trim.go:423-426)
    found = found & ~ambiguous
    best_a = torch.where(ambiguous, 0, best_a)
    verdict = torch.stack([found.to(torch.int32), best_a.to(torch.int32),
                           early.to(torch.int32), late.to(torch.int32)],
                          dim=1)
    # dead slots add no chain (their n_chains is 0)
    counts_a = torch.zeros(km_table.shape[1], dtype=torch.int32,
                           device=kmers.device).index_add_(
        0, ai_s, s["n_chains"])
    return verdict, counts_a, n_ok


def _fused_enable(packed, lens, km_table, gate_min, chain_min,
                  a_seeds, a_pos, a_len, k: int, W: int, top_t: int = 8,
                  pair_budget: int = 0):
    """DetermineAdapters: per-adapter max covered query bases over the
    batch (ref isNewFullMatch, trim/trim.go:326-352), ``[AP]`` int32, and
    the gate-passing pair count (the chain DP runs over the first
    ``pair_budget`` of them; collect re-runs over every one above it)."""
    kmers = _unpack_kmers(packed, k, W)
    ei, ai, mm = _gate_topk_pairs(kmers, lens, km_table, gate_min,
                                  chain_min, top_t)
    _, live, ei_s, ai_s, mm_s, n_ok = _passing(ei, ai, mm, pair_budget)
    _, s = _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei_s, ai_s,
                        mm_s, live, k)
    # dead slots cover nothing (no chain), so they leave the maxima alone
    cov = torch.where(s["n_chains"] > 0, s["ident_cov_q"], 0)
    return torch.zeros(km_table.shape[1], dtype=torch.int32,
                       device=kmers.device).scatter_reduce_(
        0, ai_s, cov, "amax"), n_ok


def _fused_window_verdict(packed, lens, km_table, gate_min, chain_min,
                          a_seeds, a_pos, a_len, mid_threshold: int,
                          k: int, W: int, top_t: int = 8, top_k: int = 4,
                          pair_budget: int = 0, det_budget: int = 4096):
    """Middle pass: gate + chain + the identity-threshold detection filter
    (ref findSplit, trim/trim.go:515-591), the chain DP over the first
    ``pair_budget`` gate-passing pairs (all of them with 0).

    Returns ``[det_budget + 1, 4]`` int32, the JAX layout: rows of (window
    idx, adapter idx, start offset in window, identity) for the first
    ``det_budget`` top-``top_k`` chains (by ``cov_q``, ties to the lower
    anchor) with identity >= ``mid_threshold``, in ascending (pair, chain
    rank) order, then rows of (-1, 0, 0, 0); the last row holds (passing
    pairs (0 unbudgeted), detections, 0, 0), which collect reads to re-run
    an overflowing batch."""
    kmers = _unpack_kmers(packed, k, W)
    ei, ai, mm = _gate_topk_pairs(kmers, lens, km_table, gate_min,
                                  chain_min, top_t)
    _, live, ei, ai, mm, n_ok = _passing(ei, ai, mm, pair_budget)
    out, s = _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei, ai, mm,
                          live, k)
    key = torch.where(s["is_start"], out["cov_q"], -1)
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices
    idx = idx[:, :top_k]
    take = lambda arr: torch.gather(arr, 1, idx)
    identity = torch.div(take(out["cov_q"]) * 100,
                         a_len[ai].clamp(min=1)[:, None],
                         rounding_mode="floor")
    det = (take(key) >= 0) & (identity >= mid_threshold)
    start = take(out["start_tp"]) - take(out["start_qp"])
    n_det = det.sum(dtype=torch.int32)
    flat = det.reshape(-1)
    didx, _ = compact_indices(flat, det_budget)
    dlive = didx < flat.shape[0]
    pi = torch.div(didx, top_k, rounding_mode="floor").clamp(
        max=max(0, det.shape[0] - 1))
    ci = didx % top_k
    rows = torch.stack([torch.where(dlive, ei[pi], -1),
                        torch.where(dlive, ai[pi], 0),
                        torch.where(dlive, start[pi, ci], 0),
                        torch.where(dlive, identity[pi, ci], 0)], dim=1)
    n_ok = n_ok if pair_budget else torch.zeros_like(n_det)
    zero = torch.zeros_like(n_det)
    tail = torch.stack([n_ok, n_det, zero, zero])[None]
    return torch.cat([rows.to(torch.int32), tail])


def _pack_windows(windows, W: int, k: int):
    """A window list as 2-bit packed codes ``[n, CL/4]`` uint8 (CL is
    W + k - 1 rounded up to 4) and k-mer counts ``[n]`` int32.  Pad bytes
    decode as ``A``; the counts mask them."""
    n = len(windows)
    CL = ((W + k - 1 + 3) // 4) * 4
    codes = np.zeros((n, CL), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, w in enumerate(windows):
        m = min(len(w), W + k - 1)
        codes[i, :m] = w.codes[:m]
        lens[i] = max(0, m - k + 1)
    c4 = codes.reshape(n, -1, 4)
    packed = (c4[:, :, 0] << 6) | (c4[:, :, 1] << 4) | (c4[:, :, 2] << 2) \
        | c4[:, :, 3]
    return packed, lens


class WindowChainEngine:
    """Per-Trimmer device state: adapter seed tables, k-mer -> adapter
    membership tables and barcode flags on ``device``."""

    def __init__(self, front_adapters, back_adapters, front_sets, back_sets,
                 kmer_map: np.ndarray, seed_map: List[int], k: int,
                 nq: int = 64, mesh=None, device=None):
        self.k = k
        self.nq = nq
        # re-runs at collect, by verdict and budget
        self.reruns = Counter()
        # the pair budget each verdict's re-runs take (``_rerun_budget``)
        self._rerun_at = {}
        # window batches run on the grid's data shards; without a grid,
        # on a 1 x 1 grid of ``device``
        self.mesh = mesh
        self._grid = (mesh if mesh is not None
                      else DeviceGrid.single(resolve_device(device)))
        self.device = self._grid.home
        size = kmer_map.shape[0]
        sm = np.asarray(seed_map, dtype=np.int64)

        def tables(adapters):
            """Adapter seed tables in k-mer space (seed id -> k-mer is a
            bijection, so window k-mers compare directly), rows padded to
            the membership table's 128-multiple."""
            A = len(adapters)
            AP = 128 * ((max(1, A) + 127) // 128)
            seeds = np.full((AP, nq), -1, np.int32)
            pos = np.zeros((AP, nq), np.int16)
            alen = np.zeros(AP, np.int32)
            for i, ad in enumerate(adapters):
                m = min(ad.num_seeds, nq)
                seeds[i, :m] = sm[np.asarray(ad.seeds[:m], dtype=np.int64)]
                pos[i, :m] = ad.seed_positions(k)[:m]
                alen[i] = ad.length
            return (seeds, pos, alen)

        def km_table(adapter_sets):
            AP = 128 * ((max(1, len(adapter_sets)) + 127) // 128)
            t = np.zeros((size, AP), dtype=np.int8)
            for i, st in enumerate(adapter_sets):
                kms = [seed_map[int(sid)] for sid in st]
                t[kms, i] = 1
            return t

        def bc_table(adapters, AP):
            t = np.zeros(AP, np.int32)
            for i, ad in enumerate(adapters):
                if (ad.get_name() or "").startswith("Barcode"):
                    t[i] = 1
            return t

        fkm = km_table(front_sets)
        bkm = km_table(back_sets)
        ft = tables(front_adapters)
        bt = tables(back_adapters)
        fbc = bc_table(front_adapters, fkm.shape[1])
        bbc = bc_table(back_adapters, bkm.shape[1])
        put = self._put
        self.front = tuple(put(a) for a in ft)
        self.back = tuple(put(a) for a in bt)
        self._front_km, self._back_km = put(fkm), put(bkm)
        self._front_bc, self._back_bc = put(fbc), put(bbc)
        # replicas on the grid's data devices (aliases on the home device)
        self._replicas = {}
        if mesh is not None:
            for d in range(mesh.shape["data"]):
                if mesh.owns(d):
                    dev = mesh.data_device(d)
                    self._replicas[str(dev)] = {
                        side: (km.to(dev), tuple(a.to(dev) for a in tabs),
                               bc.to(dev))
                        for side, km, tabs, bc in (
                            (True, self._front_km, self.front,
                             self._front_bc),
                            (False, self._back_km, self.back,
                             self._back_bc))}

    def _put(self, a: np.ndarray, keep: list = None) -> torch.Tensor:
        """A host array as a new tensor on the engine's device (always a
        copy, so callers may reuse their buffers).  With ``keep`` (a
        dispatch's list of pinned staging tensors) the copy does not wait
        for the device (``transfer.upload``)."""
        if keep is None:
            return torch.tensor(a, device=self.device)
        return upload(a, self.device, keep)

    def _pad_mins(self, table, gate_min, chain_min, keep: list):
        """Thresholds padded to the table's AP columns (padded adapters
        can never pass) on the device, and the real adapter count."""
        A = min(table.shape[1], len(gate_min))
        gm = np.full(table.shape[1], 1 << 20, np.int32)
        gm[:A] = gate_min[:A]
        cm = np.ones(table.shape[1], np.int32)
        cm[:A] = chain_min[:A]
        return self._put(gm, keep), self._put(cm, keep), A

    def _side(self, front: bool, device=None):
        """(k-mer table, (seeds, pos, lengths), barcode flags) of one side,
        on ``device`` (default the engine's)."""
        if device is not None and str(device) in self._replicas:
            return self._replicas[str(device)][front]
        if front:
            return self._front_km, self.front, self._front_bc
        return self._back_km, self.back, self._back_bc

    def _blocks(self, packed_dev, lens_dev):
        """A window batch's data shard blocks: ``[(lo, packed, lens)]``,
        each on its shard's device."""
        return [(lo, p, ln) for _, lo, (p, ln) in
                self._grid.split_rows([packed_dev, lens_dev], [0, 0])]

    def _pending(self, packed_dev, lens_dev, lo: int, fn, front: bool, gm,
                 cm, budgets: dict, keep: list, fetch,
                 barcodes: bool = False, **kw) -> list:
        """One ``Pending`` per data shard block of an uploaded batch:
        ``fn`` (a fused verdict, given the side's barcode flags with
        ``barcodes``) on the block's device and side tables at
        ``budgets`` (its budget keywords, in the order a re-run passes
        them); ``lo`` offsets the blocks' first rows."""
        out = []
        for blo, p, ln in self._blocks(packed_dev, lens_dev):
            tab, (a_seeds, a_pos, a_len), is_bc = self._side(front,
                                                             p.device)
            tables = dict(km_table=tab, a_seeds=a_seeds, a_pos=a_pos,
                          a_len=a_len)
            if barcodes:
                tables["is_barcode"] = is_bc

            def run(*args, p=p, ln=ln, tables=tables):
                inputs = dict(packed=p, lens=ln,
                              gate_min=gm.to(p.device, non_blocking=True),
                              chain_min=cm.to(p.device, non_blocking=True))
                return captured.run(fn, inputs, tables, **kw,
                                    **dict(zip(budgets, args)))
            out.append(Pending(lo + blo, p.device, run,
                               tuple(budgets.values()), keep, fetch))
        return out

    def _rerun_budget(self, kind: str, n_ok: int) -> int:
        """The pair budget of a ``kind`` block's re-run at collect after
        it passed ``n_ok`` pairs: ``_tight`` of the most any re-run of
        the kind has needed.  It covers every passing pair, so the rows
        are the JAX collect's unbudgeted re-run's, and it settles, so the
        re-runs replay one captured graph."""
        b = max(self._rerun_at.get(kind, 0), _tight(n_ok))
        self._rerun_at[kind] = b
        return b

    def _upload_bucketed(self, windows, W: int, keep: list):
        """``upload`` with the rows padded to the batch's shape bucket
        (``captured.padded_rows``): padding rows have no k-mers, so they
        pass no gate."""
        packed, lens = _pack_windows(windows, W, self.k)
        nb = captured.padded_rows(len(windows), self._grid.shape["data"])
        return (self._put(captured.pad_rows(packed, nb, 0), keep),
                self._put(captured.pad_rows(lens, nb, 0), keep),
                len(windows))

    # -- per batch ------------------------------------------------------
    def upload(self, windows, W: int, keep: list = None):
        """Window batch -> (packed codes, k-mer counts) on the device and
        the window count; with ``keep``, copied without waiting (see
        ``_put``)."""
        packed, lens = _pack_windows(windows, W, self.k)
        return self._put(packed, keep), self._put(lens, keep), len(windows)

    def upload_rows(self, packed_rows: np.ndarray, lens: np.ndarray,
                    n: int, keep: list = None):
        """Ship a caller-prepared packed window batch ([n, CL/4] uint8
        rows + k-mer counts)."""
        return self._put(packed_rows, keep), self._put(lens, keep), n

    def gate(self, packed_dev, lens_dev, front: bool, n: int,
             W: int) -> np.ndarray:
        parts = {}
        for lo, p, ln in self._blocks(packed_dev, lens_dev):
            table = self._side(front, p.device)[0]
            parts[lo] = _gate_counts(_unpack_kmers(p, self.k, W), ln,
                                     table).cpu().numpy()
        return np.concatenate(self._grid.gather(parts))[:n]

    def match_dispatch(self, windows, front: bool, gate_min: np.ndarray,
                       chain_min: np.ndarray, W: int, top_t: int = 8,
                       batch: int = 16384):
        """Fused gate + chain (``_fused_match``) per sub-batch of
        ``batch`` windows and data shard; fetch with ``match_collect``."""
        keep = []
        table = self._side(front)[0]
        gm, cm, A = self._pad_mins(table, gate_min, chain_min, keep)
        if A == 0:  # no adapters enabled: no window has matches
            return [(len(windows), None)]
        futures = []
        for lo in range(0, len(windows), batch):
            km_dev, lens_dev, n = self.upload(windows[lo:lo + batch], W, keep)
            blocks = []
            for blo, p, ln in self._blocks(km_dev, lens_dev):
                tab, (a_seeds, a_pos, a_len), _ = self._side(front, p.device)
                blocks.append((blo, _fused_match(
                    p, ln, tab, gm.to(p.device), cm.to(p.device), a_seeds,
                    a_pos, a_len, self.k, W, top_t=top_t)))
            futures.append((n, blocks))
        return futures

    def match_collect(self, futures):
        """Per window, a list of (adapter idx, summary row dict) for its
        top-``top_t`` adapters with a chain."""
        results = []
        for n, blocks in futures:
            if blocks is None:
                results.extend([[] for _ in range(n)])
                continue
            arr = np.concatenate(self._grid.gather(
                {lo: fut.cpu().numpy() for lo, fut in blocks}))[:n]
            T = arr.shape[1]                            # [n, T, M+1]
            flat = unpack_summary(arr[:, :, 1:].reshape(n * T, -1))
            for i in range(n):
                row = []
                for t in range(T):
                    j = i * T + t
                    if flat["n_chains"][j] > 0:
                        row.append((int(arr[i, t, 0]),
                                    {key: v[j] for key, v in flat.items()}))
                results.append(row)
        return results

    def match(self, windows, front: bool, gate_min: np.ndarray,
              chain_min: np.ndarray, W: int, top_t: int = 8,
              batch: int = 16384):
        """``match_collect(match_dispatch(...))``."""
        return self.match_collect(self.match_dispatch(
            windows, front, gate_min, chain_min, W, top_t=top_t,
            batch=batch))

    def edge_verdict_dispatch(self, windows, front: bool,
                              gate_min: np.ndarray, chain_min: np.ndarray,
                              W: int, top_t: int = 8, batch: int = 16384,
                              pair_budget: int = 16384):
        """Upload edge windows and enqueue the edge verdicts of one side,
        per sub-batch of ``batch`` windows and data shard, the chain DP
        over at most ``pair_budget`` gate-passing pairs (0: all); reads
        nothing back.  Fetch with ``edge_verdict_collect``."""
        keep = []
        table = self._side(front)[0]
        gm, cm, A = self._pad_mins(table, gate_min, chain_min, keep)
        if A == 0:
            return [(len(windows), None)]
        futures = []
        for lo in range(0, len(windows), batch):
            km_dev, lens_dev, n = self._upload_bucketed(
                windows[lo:lo + batch], W, keep)
            futures.append((n, self._pending(
                km_dev, lens_dev, 0, _fused_edge_verdict, front, gm, cm,
                dict(pair_budget=pair_budget), keep, _edge_fetch,
                barcodes=True, k=self.k, W=W, top_t=top_t)))
        return futures

    def edge_verdict_collect(self, futures, num_adapters: int):
        """([n, 4] int32 rows of (found, best_match, earliest, latest),
        per-adapter chain-count totals [num_adapters]).  A block whose
        gate-passing count exceeds its pair budget re-runs over every
        passing pair (at ``_rerun_budget``, which holds them all: what the
        JAX collect's unbudgeted re-run chains, without the failing pairs'
        slots)."""
        rows = []
        counts = np.zeros(num_adapters, np.int64)
        for n, blocks in futures:
            if blocks is None:
                rows.append(np.zeros((n, 4), np.int32))
                continue
            parts = {}
            for p in blocks:
                v, c, cnt = p.host.wait()
                budget, n_ok = p.args[0], int(cnt[0])
                if budget and n_ok > budget:
                    self.reruns["edge"] += 1
                    v, c, cnt = p.rerun(self._rerun_budget("edge", n_ok))
                parts[p.lo] = (v, c)
            parts = self._grid.gather(parts)
            rows.append(np.concatenate([v for v, _ in parts])[:n])
            for _, c in parts:
                counts += c[:num_adapters]
        return np.concatenate(rows) if rows else np.zeros((0, 4), np.int32), \
            counts

    def enable_covs(self, windows, front: bool, gate_min: np.ndarray,
                    chain_min: np.ndarray, W: int, top_t: int = 8,
                    batch: int = 16384, pair_budget: int = 16384):
        """DetermineAdapters: per-adapter max covered bases over all
        windows.  Every sub-batch is enqueued before the first is
        collected; one whose gate-passing count exceeds ``pair_budget``
        re-runs over every passing pair."""
        keep = []
        table = self._side(front)[0]
        gm, cm, A = self._pad_mins(table, gate_min, chain_min, keep)
        if A == 0:
            return np.zeros(0, np.int32)
        blocks = []
        for lo in range(0, len(windows), batch):
            km_dev, lens_dev, _ = self._upload_bucketed(
                windows[lo:lo + batch], W, keep)
            blocks += self._pending(
                km_dev, lens_dev, lo, _fused_enable, front, gm, cm,
                dict(pair_budget=pair_budget), keep, _edge_fetch, k=self.k,
                W=W, top_t=top_t)
        out = np.zeros(table.shape[1], np.int64)
        parts = {}
        for p in blocks:
            covs, cnt = p.host.wait()
            n_ok = int(cnt[0])
            if pair_budget and n_ok > pair_budget:
                self.reruns["enable"] += 1
                covs, cnt = p.rerun(self._rerun_budget("enable", n_ok))
            parts[p.lo] = covs
        for covs in self._grid.gather(parts):
            out = np.maximum(out, covs)
        return out[:A]

    def window_verdict_dispatch(self, windows, gate_min: np.ndarray,
                                chain_min: np.ndarray, mid_threshold: int,
                                W: int, top_t: int = 8, batch: int = 16384,
                                pair_budget: int = 0,
                                det_budget: int = 4096):
        """Upload interior windows + enqueue the detection scan against the
        front adapters (the middle pass uses only those)."""
        keep = []
        uploads = [self._upload_bucketed(windows[lo:lo + batch], W, keep)
                   + (lo,) for lo in range(0, len(windows), batch)]
        return self.window_verdict_dispatch_packed(
            uploads, gate_min, chain_min, mid_threshold, W, top_t,
            pair_budget, det_budget, keep)

    def window_verdict_dispatch_packed(self, uploads, gate_min, chain_min,
                                       mid_threshold: int, W: int,
                                       top_t: int = 8, pair_budget: int = 0,
                                       det_budget: int = 4096,
                                       keep: list = None):
        """The detection scan over uploaded batches: ``uploads`` is a list
        of (packed_dev, lens_dev, n, lo), ``lo`` the global index of the
        batch's first window; ``keep`` holds the uploads' pinned staging
        tensors until collect.  The chain DP runs over at most
        ``pair_budget`` gate-passing pairs (0: all) and at most
        ``det_budget`` detections come back a block.  Reads nothing back:
        one ``Pending`` per batch and data shard, its ``lo`` the global
        index of the block's first window."""
        keep = [] if keep is None else keep
        gm, cm, A = self._pad_mins(self._front_km, gate_min, chain_min,
                                   keep)
        if A == 0:
            return []
        futures = []
        for km_dev, lens_dev, _, lo in uploads:
            futures += self._pending(
                km_dev, lens_dev, lo, _fused_window_verdict, True, gm, cm,
                dict(pair_budget=pair_budget, det_budget=det_budget), keep,
                _window_fetch, mid_threshold=mid_threshold, k=self.k, W=W,
                top_t=top_t)
        return futures

    def window_verdict_collect(self, futures):
        """Window detections: [(window idx, adapter idx, start,
        identity)] int32 rows, window indices global across batches.  As
        the JAX collect: a block over its pair budget re-runs over every
        passing pair (at ``_rerun_budget``, which covers every pair the
        JAX unbudgeted re-run chains that can detect anything); one whose
        detections overflow ``det_budget`` re-runs so at ``4 *
        det_budget`` (at a pair budget that holds every passing pair) and
        keeps that run's first rows."""
        parts = {}
        for p in futures:
            pair_budget, det_budget = p.args
            (arr,) = p.host.wait()
            n_ok = int(arr[-1, 0])      # 0 when the block ran unbudgeted
            if pair_budget and n_ok > pair_budget:
                self.reruns["middle_pair_budget"] += 1
                (arr,) = p.rerun(self._rerun_budget("middle", n_ok),
                                 det_budget)
            if int(arr[-1, 1]) > arr.shape[0] - 1:
                self.reruns["middle_det_budget"] += 1
                (arr,) = p.rerun(p.args[0], 4 * det_budget)
            rows = arr[:-1]
            rows = rows[rows[:, 0] >= 0]
            rows[:, 0] += p.lo
            parts[p.lo] = rows
        out = [r for r in self._grid.gather(parts) if r.size]
        return np.concatenate(out) if out else np.zeros((0, 4), np.int32)


def _edge_fetch(res) -> HostCopy:
    """Host copy of an edge verdict ``(verdict, counts, n_ok)`` or a
    DetermineAdapters ``(covs, n_ok)``."""
    return HostCopy(list(res[:-1]) + [res[-1].reshape(1)])


def _window_fetch(res) -> HostCopy:
    """Host copy of a middle-pass detection block."""
    return HostCopy([res])
