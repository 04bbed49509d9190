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

Dropped from the JAX engine because no output depends on them: the pair
and detection budgets and their re-runs (``torch.nonzero`` yields every
passing pair and detection, in the order the unbudgeted run gives),
batch-size buckets, the rotating host staging buffers, the resident copy
of the thresholds, the ``lax.map`` segments and the one-hot picks.  So is
the paired edge route (``_fused_edge_pair``, ``edge_pair_dispatch`` /
``edge_pair_collect`` and the front/back tables stacked for them):
stacking bought the JAX engine one XLA call for both sides, but here it
would be the two per-side verdicts plus stacked copies, so each side takes
``edge_verdict_dispatch``.  Pairs that fail the gate chain nowhere: they
report the empty summary the JAX engine gives them.  Only ``_fused_match``, which returns every pair's
summary row, chains them all.  ``chain`` and ``_chain_from_windows``
have no caller and are not ported.

With a device grid (``mesh``) the tables replicate to each data shard's
device and every window batch splits into the grid's data shards
(contiguous, equal row blocks; padding rows have no k-mers, so they pass
no gate); each block runs on its shard's device and the collects put the
blocks' rows back in order (per-adapter totals summed, coverages
maximized).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import DeviceGrid
from .chain import compact_indices, dp_from_anchors, make_anchors_topk, \
    summarize_dp, summarize_scalars, unpack_summary

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
    shifts = torch.tensor([6, 4, 2, 0], dtype=torch.int32,
                          device=packed.device)
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


def _anchors_chunked(kmers, lens, a_seeds, a_pos, ei, ai,
                     chunk: int = _ANCHOR_CHUNK):
    """Anchors of the (window ``ei``, adapter ``ai``) pairs, built
    ``chunk`` pairs at a time.  The adapter tables are in k-mer space, so
    window k-mers compare with them directly; positions past a window's
    k-mer count are -1."""
    W = kmers.shape[1]
    pos = torch.arange(W, dtype=torch.int32, device=kmers.device)
    parts = []
    for lo in range(0, max(1, ei.shape[0]), chunk):
        e, a = ei[lo:lo + chunk], ai[lo:lo + chunk]
        ts = torch.where(pos[None, :] < lens[e][:, None], kmers[e], -1)
        parts.append(make_anchors_topk(
            a_seeds[a].to(torch.int32), a_pos[a].to(torch.int32), ts,
            pos.expand(e.shape[0], W), per_seed=2))
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _passing(ei, ai, mm):
    """The gate-passing pairs, in ascending pair order."""
    sel, _ = compact_indices(mm < _BIGM)
    return sel, ei[sel], ai[sel], mm[sel]


def _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei, ai, mm, k: int):
    """Anchors, chain DP and scalar summaries of the pairs (ei, ai)."""
    out = dp_from_anchors(
        _anchors_chunked(kmers, lens, a_seeds, a_pos, ei, ai), k)
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
                        top_t: int = 8):
    """Edge pass: gate + chain + the per-edge adapter walk of the
    reference's findMatches (ref: trim/trim.go:354-428).

    Returns (verdict ``[n, 4]`` int32 of (found, best_match, earliest,
    latest), per-adapter chain-count totals ``[AP]`` int32)."""
    kmers = _unpack_kmers(packed, k, W)
    n = kmers.shape[0]
    ei, ai, mm = _gate_topk_pairs(kmers, lens, km_table, gate_min,
                                  chain_min, top_t)
    sel, ei_s, ai_s, mm_s = _passing(ei, ai, mm)
    _, s = _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei_s, ai_s,
                        mm_s, k)

    def grid(v):
        """Back onto the (window, top-t) grid; failing pairs hold 0."""
        g = torch.zeros(n * top_t, dtype=v.dtype, device=v.device)
        g[sel] = v
        return g.reshape(n, top_t)

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
    counts_a = torch.zeros(km_table.shape[1], dtype=torch.int32,
                           device=kmers.device).index_add_(
        0, ai_s, s["n_chains"])
    return verdict, counts_a


def _fused_enable(packed, lens, km_table, gate_min, chain_min,
                  a_seeds, a_pos, a_len, k: int, W: int, top_t: int = 8):
    """DetermineAdapters: per-adapter max covered query bases over the
    batch (ref isNewFullMatch, trim/trim.go:326-352), ``[AP]`` int32."""
    kmers = _unpack_kmers(packed, k, W)
    ei, ai, mm = _gate_topk_pairs(kmers, lens, km_table, gate_min,
                                  chain_min, top_t)
    _, ei_s, ai_s, mm_s = _passing(ei, ai, mm)
    _, s = _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei_s, ai_s,
                        mm_s, k)
    cov = torch.where(s["n_chains"] > 0, s["ident_cov_q"], 0)
    return torch.zeros(km_table.shape[1], dtype=torch.int32,
                       device=kmers.device).scatter_reduce_(
        0, ai_s, cov, "amax")


def _fused_window_verdict(packed, lens, km_table, gate_min, chain_min,
                          a_seeds, a_pos, a_len, mid_threshold: int,
                          k: int, W: int, top_t: int = 8, top_k: int = 4):
    """Middle pass: gate + chain + the identity-threshold detection filter
    (ref findSplit, trim/trim.go:515-591).

    Returns ``[n_det, 4]`` int32 rows of (window idx, adapter idx, start
    offset in window, identity) for every top-``top_k`` chain (by
    ``cov_q``, ties to the lower anchor) with identity >=
    ``mid_threshold``, in ascending (pair, chain rank) order."""
    kmers = _unpack_kmers(packed, k, W)
    ei, ai, mm = _gate_topk_pairs(kmers, lens, km_table, gate_min,
                                  chain_min, top_t)
    _, ei, ai, mm = _passing(ei, ai, mm)
    out, s = _chain_pairs(kmers, lens, a_seeds, a_pos, a_len, ei, ai, mm, k)
    key = torch.where(s["is_start"], out["cov_q"], -1)
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices
    idx = idx[:, :top_k]
    take = lambda arr: torch.gather(arr, 1, idx)
    identity = torch.div(take(out["cov_q"]) * 100,
                         a_len[ai].clamp(min=1)[:, None],
                         rounding_mode="floor")
    det = (take(key) >= 0) & (identity >= mid_threshold)
    start = take(out["start_tp"]) - take(out["start_qp"])
    pi, ci = torch.nonzero(det, as_tuple=True)
    return torch.stack([ei[pi], ai[pi], start[pi, ci], identity[pi, ci]],
                       dim=1).to(torch.int32)


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

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a new tensor on the engine's device (always a
        copy, so callers may reuse their buffers)."""
        return torch.tensor(a, device=self.device)

    def _pad_mins(self, table, gate_min, chain_min):
        """Thresholds padded to the table's AP columns (padded adapters
        can never pass) on the device, and the real adapter count."""
        A = min(table.shape[1], len(gate_min))
        gm = np.full(table.shape[1], 1 << 20, np.int32)
        gm[:A] = gate_min[:A]
        cm = np.ones(table.shape[1], np.int32)
        cm[:A] = chain_min[:A]
        return self._put(gm), self._put(cm), A

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

    # -- per batch ------------------------------------------------------
    def upload(self, windows, W: int):
        """Window batch -> (packed codes, k-mer counts) on the device and
        the window count."""
        packed, lens = _pack_windows(windows, W, self.k)
        return self._put(packed), self._put(lens), len(windows)

    def upload_rows(self, packed_rows: np.ndarray, lens: np.ndarray,
                    n: int):
        """Ship a caller-prepared packed window batch ([n, CL/4] uint8
        rows + k-mer counts)."""
        return self._put(packed_rows), self._put(lens), n

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
        table = self._side(front)[0]
        gm, cm, A = self._pad_mins(table, gate_min, chain_min)
        if A == 0:  # no adapters enabled: no window has matches
            return [(len(windows), None)]
        futures = []
        for lo in range(0, len(windows), batch):
            km_dev, lens_dev, n = self.upload(windows[lo:lo + batch], W)
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
                              W: int, top_t: int = 8, batch: int = 16384):
        """Edge verdicts of one side per sub-batch and data shard; fetch
        with ``edge_verdict_collect``."""
        table = self._side(front)[0]
        gm, cm, A = self._pad_mins(table, gate_min, chain_min)
        if A == 0:
            return [(len(windows), None)]
        futures = []
        for lo in range(0, len(windows), batch):
            km_dev, lens_dev, n = self.upload(windows[lo:lo + batch], W)
            blocks = []
            for blo, p, ln in self._blocks(km_dev, lens_dev):
                tab, (a_seeds, a_pos, a_len), is_bc = self._side(front,
                                                                 p.device)
                blocks.append((blo, _fused_edge_verdict(
                    p, ln, tab, gm.to(p.device), cm.to(p.device), a_seeds,
                    a_pos, a_len, is_bc, self.k, W, top_t=top_t)))
            futures.append((n, blocks))
        return futures

    def edge_verdict_collect(self, futures, num_adapters: int):
        """([n, 4] int32 rows of (found, best_match, earliest, latest),
        per-adapter chain-count totals [num_adapters])."""
        rows = []
        counts = np.zeros(num_adapters, np.int64)
        for n, blocks in futures:
            if blocks is None:
                rows.append(np.zeros((n, 4), np.int32))
                continue
            parts = self._grid.gather(
                {lo: (v.cpu().numpy(), c.cpu().numpy())
                 for lo, (v, c) in blocks})
            rows.append(np.concatenate([v for v, _ in parts])[:n])
            for _, c in parts:
                counts += c[:num_adapters]
        return np.concatenate(rows) if rows else np.zeros((0, 4), np.int32), \
            counts

    def enable_covs(self, windows, front: bool, gate_min: np.ndarray,
                    chain_min: np.ndarray, W: int, top_t: int = 8,
                    batch: int = 16384):
        """DetermineAdapters: per-adapter max covered bases over all
        windows."""
        table = self._side(front)[0]
        gm, cm, A = self._pad_mins(table, gate_min, chain_min)
        if A == 0:
            return np.zeros(0, np.int32)
        out = np.zeros(table.shape[1], np.int64)
        for lo in range(0, len(windows), batch):
            km_dev, lens_dev, _ = self.upload(windows[lo:lo + batch], W)
            parts = {}
            for blo, p, ln in self._blocks(km_dev, lens_dev):
                tab, (a_seeds, a_pos, a_len), _ = self._side(front, p.device)
                parts[blo] = _fused_enable(
                    p, ln, tab, gm.to(p.device), cm.to(p.device), a_seeds,
                    a_pos, a_len, self.k, W, top_t=top_t).cpu().numpy()
            for covs in self._grid.gather(parts):
                out = np.maximum(out, covs)
        return out[:A]

    def window_verdict_dispatch(self, windows, gate_min: np.ndarray,
                                chain_min: np.ndarray, mid_threshold: int,
                                W: int, top_t: int = 8, batch: int = 16384):
        """Upload interior windows + run the detection scan against the
        front adapters (the middle pass uses only those)."""
        uploads = [self.upload(windows[lo:lo + batch], W) + (lo,)
                   for lo in range(0, len(windows), batch)]
        return self.window_verdict_dispatch_packed(
            uploads, gate_min, chain_min, mid_threshold, W, top_t)

    def window_verdict_dispatch_packed(self, uploads, gate_min, chain_min,
                                       mid_threshold: int, W: int,
                                       top_t: int = 8):
        """The detection scan over uploaded batches: ``uploads`` is a list
        of (packed_dev, lens_dev, n, lo), ``lo`` the global index of the
        batch's first window.  One result per batch and data shard,
        with the global index of the block's first window."""
        table = self._front_km
        gm, cm, A = self._pad_mins(table, gate_min, chain_min)
        if A == 0:
            return [(0, None)]
        futures = []
        for km_dev, lens_dev, _, lo in uploads:
            for blo, p, ln in self._blocks(km_dev, lens_dev):
                tab, (a_seeds, a_pos, a_len), _ = self._side(True, p.device)
                futures.append((lo + blo, _fused_window_verdict(
                    p, ln, tab, gm.to(p.device), cm.to(p.device), a_seeds,
                    a_pos, a_len, mid_threshold, self.k, W, top_t=top_t)))
        return futures

    def window_verdict_collect(self, futures):
        """Window detections: [(window idx, adapter idx, start,
        identity)] int32 rows, window indices global across batches."""
        parts = {}
        for lo, fut in futures:
            if fut is None:
                continue
            rows = fut.cpu().numpy()
            rows[:, 0] += lo
            parts[lo] = rows
        out = [r for r in self._grid.gather(parts) if r.size]
        return np.concatenate(out) if out else np.zeros((0, 4), np.int32)
