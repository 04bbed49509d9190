"""Batched in-order seed chaining as an anchor DP (torch port of
``downpore_tpu/ops/chain.py``).

Anchors are (i, j) pairs with ``query_seed[i] == target_seed[j]``,
batched as ``[P, A]`` arrays over many (query, target) pairs.  A forward
and a backward scan (``cuda_chain.chain_scan_fb``, one launch of the Hopper
kernel) give,
for every anchor, the best chain through it, its covered bases and the
chain's start/end coordinates; ``summarize_dp`` packs the per-pair
quantities the mapper walks.  ``dp_forward_lean`` is the overlap path's
forward-only DP (scores and backpointers).

Beside the engines' functions, the module's library surface (the seed-
query pipeline's chain half: ``make_anchors``, ``chain_batch``,
``chain_batch_summary``, ``chain_summary_indexed``,
``DeviceAdapterTables``, ``run_chain_batch``, ``run_chain_summary``) and
its numpy helpers and oracle (``extract_best_chain``,
``good_chain_stats``, ``chain_pair_np``).  Every DP goes through the
chain kernel, one ``chain_scan_fb`` launch per ``dp_from_anchors`` call.
The JAX host wrappers padded pair batches to ``_bucket`` sizes and sliced
them at ``max_pairs`` for its compiled shapes; pairs are independent rows,
so the port runs the whole batch at its own size (a data shard's block
with a ``mesh``).  The JAX module's int16 ``small`` scan is not ported:
the port computes in int32, which gives the same results wherever the
engine would have taken it (positions < 16000).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import cuda_anchors
from .cuda_chain import chain_scan_fb, chain_scan_lean
# the gap windows live beside the plain scan that uses them; re-exported
# under the JAX module's name
from .cuda_chain import window_ok as _window_ok  # noqa: F401

# bound on the [ch, NQ, NT] bool equality (and its int32 rank) that one
# make_anchors step materializes
_ANCHOR_ELEMS = 1 << 26


def _device_int32(arrays, device=None):
    """Numpy arrays or tensors as int32 tensors on one device: that of the
    first tensor among them, else ``resolve_device(device)``."""
    dev = next((a.device for a in arrays if torch.is_tensor(a)), None)
    dev = dev if dev is not None else resolve_device(device)
    return [(a if torch.is_tensor(a)
             else torch.from_numpy(np.ascontiguousarray(a))).to(
                 dev, torch.int32) for a in arrays]


def make_anchors(qseeds, qpos, tseeds, tpos, max_anchors: int):
    """Enumerate matching (i, j) seed pairs in row-major order.

    All args are ``[P, N]`` int32 tensors, padded with seed id -1.
    Returns a dict of ``[P, max_anchors]`` int32 arrays ``qi, tj, qp, tp``
    and bool ``valid``, plus the per-pair ``overflow`` count of matches
    beyond ``max_anchors``, which are dropped.  An empty slot has ``qi``
    and ``tj`` -1 and zero positions (``jnp.nonzero(size=, fill_value=-1)``
    of the JAX function).  The order is the DP's tie order, so it is
    exact: each match's rank is a running count over the flattened
    ``[NQ * NT]`` equality, and the matches ranked below ``max_anchors``
    land in their slots; pairs go in chunks that bound the equality."""
    P, NQ = qseeds.shape
    NT = tseeds.shape[1]
    dev = qseeds.device
    flat_idx = torch.full((P, max_anchors), -1, dtype=torch.int64,
                          device=dev)
    n_eq = torch.zeros(P, dtype=torch.int64, device=dev)
    ch = max(1, _ANCHOR_ELEMS // max(1, NQ * NT))
    for lo in range(0, P, ch):
        qs, ts = qseeds[lo:lo + ch], tseeds[lo:lo + ch]
        eq = ((qs[:, :, None] == ts[:, None, :]) & (qs[:, :, None] >= 0)
              & (ts[:, None, :] >= 0)).reshape(qs.shape[0], NQ * NT)
        rank = torch.cumsum(eq, dim=1, dtype=torch.int32)
        n_eq[lo:lo + ch] = rank[:, -1] if NQ * NT else 0
        r, c = (eq & (rank <= max_anchors)).nonzero(as_tuple=True)
        flat_idx[lo + r, (rank[r, c] - 1).long()] = c
    valid = flat_idx >= 0
    qi = torch.where(valid, torch.div(flat_idx, NT, rounding_mode="floor"),
                     -1)
    tj = torch.where(valid, flat_idx % max(1, NT), -1)
    qp = torch.where(valid, torch.gather(qpos, 1, qi.clamp(min=0)), 0)
    tp = torch.where(valid, torch.gather(tpos, 1, tj.clamp(min=0)), 0)
    return {"qi": qi.to(torch.int32), "tj": tj.to(torch.int32),
            "qp": qp.to(torch.int32), "tp": tp.to(torch.int32),
            "valid": valid,
            "overflow": (n_eq - valid.sum(dim=1)).to(torch.int32)}


def make_anchors_topk(qseeds, qpos, tseeds, tpos, per_seed: int = 2):
    """Anchors capped at ``per_seed`` target occurrences per query seed.

    All args are ``[P, N]`` int32, seed ids padded with -1.  Returns a dict
    of ``[P, NQ * per_seed]`` arrays ``qi, tj, qp, tp, valid`` in (i, j)
    row-major order, plus the per-pair ``overflow`` count of dropped
    matches.  A missing occurrence has ``qi = -1``, ``tj = 0`` and zero
    positions, as ``jnp.argmax`` over an all-false row gives.  CPU tensors
    run the plain version, CUDA tensors one launch of the anchor kernel
    (``cuda_anchors.anchors_topk``); ``per_seed`` must be 2, the engines'
    cap, which is all the kernel keeps."""
    return cuda_anchors.as_dict(cuda_anchors.anchors_topk(
        qseeds, qpos, tseeds, tpos, per_seed))


def anchors_of_slots(live, build):
    """Anchors (``make_anchors_topk``'s layout) of an engine's pair-budget
    slots: ``build(rows)`` makes those of the slots ``rows`` (None: every
    slot).  A dead slot (``live`` False) has no query seed, so its anchors
    are empty (``qi`` -1, the rest 0, invalid).  On a card every slot is
    built: finding the live ones would wait for the device.  On the CPU,
    where that read waits for nothing, only the live ones are, and the
    dead ones get the empty anchors."""
    if live.device.type != "cpu" or bool(live.all()):
        return build(None)
    rows = live.nonzero().flatten()
    out = {}
    for key, v in build(rows).items():
        full = torch.full((live.shape[0],) + tuple(v.shape[1:]),
                          -1 if key == "qi" else 0, dtype=v.dtype)
        full[rows] = v
        out[key] = full
    return out


def dp_from_anchors(anchors, k: int, variant: str = "extend"):
    """Forward + backward chain DP over a prepared anchor batch: one
    ``chain_scan_fb`` launch, whose backward warps read each row reversed
    and negated and write back in the row's own order.

    Returns a dict of ``[P, A]`` arrays (see ``downpore_tpu.ops.chain.
    dp_from_anchors``): qi, tj, qp, tp, valid, overflow, f, b, through,
    cov_q, cov_t, start_qp/tp, end_qp/tp, bp."""
    qi, tj, qp, tp, valid = (anchors["qi"], anchors["tj"], anchors["qp"],
                             anchors["tp"], anchors["valid"])
    (f, cov_qf, cov_tf, s_qp, s_tp, bp, b, cov_qb, cov_tb, e_qp,
     e_tp) = chain_scan_fb(qi.contiguous(), tj.contiguous(), qp.contiguous(),
                           tp.contiguous(),
                           valid.to(torch.int32).contiguous(), k, variant)
    through = torch.where(valid, f + b - 1, 0)
    return {
        "qi": qi, "tj": tj, "qp": qp, "tp": tp, "valid": valid,
        "overflow": anchors["overflow"],
        "f": f, "b": b, "through": through,
        "cov_q": cov_qf + cov_qb - k, "cov_t": cov_tf + cov_tb - k,
        "start_qp": s_qp, "start_tp": s_tp,
        "end_qp": e_qp, "end_tp": e_tp,
        "bp": bp,
    }


def dp_forward_lean(anchors, k: int, variant: str = "extend"):
    """Forward-only chain DP: a dict with ``qi, tj, f, bp``, exactly what
    the overlap best-chain walk consumes (``_chain_scan_lean``), from the
    kernel's lean mode, which keeps only score and backpointers."""
    qi, tj, qp, tp, valid = (anchors["qi"], anchors["tj"], anchors["qp"],
                             anchors["tp"], anchors["valid"])
    f, bp = chain_scan_lean(
        qi.contiguous(), tj.contiguous(), qp.contiguous(), tp.contiguous(),
        valid.to(torch.int32).contiguous(), k, variant)
    return {"qi": qi, "tj": tj, "f": f, "bp": bp}


def summarize_scalars(out, min_match, alen, k: int):
    """Per-pair scalar aggregates of a DP output dict (``best``,
    ``ident_cov_q``, ``earliest``, ``latest``, ``n_chains``) plus the
    ``good`` and ``is_start`` masks.  "Good" means a chain within 2/3 of
    the best and >= ``min_match`` long (ref: seeds/sequence.go:434-465)."""
    through = out["through"]
    valid = out["valid"]
    big = 1 << 30
    best = torch.where(valid, through, 0).amax(dim=1)
    mmc = min_match[:, None]
    thr = torch.maximum(mmc, torch.div(best[:, None] * 2, 3,
                                       rounding_mode="floor"))
    good = valid & (through >= thr) & (through >= mmc)
    ident_cov_q = torch.where(good, out["cov_q"], 0).amax(dim=1)
    starts_sum = out["start_qp"] + out["start_tp"]
    earliest = torch.where(good, starts_sum, big).amin(dim=1)
    ends = out["end_tp"] + (alen[:, None] - out["end_qp"] - k)
    latest = torch.where(good, ends, -big).amax(dim=1)
    is_start = good & (out["f"] == 1)
    n_chains = is_start.sum(dim=1, dtype=torch.int32)
    return {"best": best, "ident_cov_q": ident_cov_q, "earliest": earliest,
            "latest": latest, "n_chains": n_chains, "good": good,
            "is_start": is_start}


def summarize_dp(out, min_match, alen, k: int, top_k: int = 4,
                 lean: bool = False):
    """Pack a DP output dict into the ``[P, W]`` int32 summary rows.

    Top-K chain starts are ranked by ``cov_q`` with ties to the lower
    anchor index, as ``jax.lax.top_k`` orders them: a stable descending
    sort, since ``torch.topk`` promises no order among ties.  ``lean``
    packs only the mapper-walk columns (1 + 7K instead of 5 + 8K)."""
    s = summarize_scalars(out, min_match, alen, k)
    key = torch.where(s["is_start"], out["cov_q"], -1)
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices
    idx = idx[:, :top_k]
    take = lambda arr: torch.gather(arr, 1, idx).to(torch.int32)
    tops = [(take(key) >= 0).to(torch.int32),
            take(out["start_qp"]), take(out["start_tp"]),
            take(out["end_qp"]), take(out["end_tp"])]
    if lean:
        cols = [s["best"][:, None]] + tops \
            + [take(out["cov_t"]), take(out["through"])]
    else:
        cols = [s[n][:, None] for n in SUMMARY_SCALARS] + tops \
            + [take(out["cov_q"]), take(out["cov_t"]), take(out["through"])]
    return torch.cat([c.to(torch.int32) for c in cols], dim=1)


def compact_indices(mask_flat, size: int, skip=None):
    """First ``size`` indices of the set entries of ``mask_flat``,
    ascending (``torch.nonzero``'s order), padded with ``len(mask_flat)``
    past the count, and the total count as a 0-d int32 tensor on the
    mask's device: ``downpore_tpu.ops.chain.compact_indices``.  Nothing is
    read back to the host.  Slot j holds the first index whose running
    count of set entries reaches j + 1: a binary search over the int32
    inclusive prefix sum, which is ``len(mask_flat)`` once j passes the
    count.  ``skip`` (a 0-d int32 tensor) passes over that many set
    entries first: slot j holds the one whose count reaches skip + j + 1,
    so consecutive skips of ``size`` cut the whole list into pieces."""
    rank = torch.cumsum(mask_flat.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, size + 1, dtype=torch.int32,
                        device=mask_flat.device)
    if skip is not None:
        want = want + skip
    sel = torch.searchsorted(rank, want)
    n = rank[-1] if rank.numel() else torch.zeros(
        (), dtype=torch.int32, device=mask_flat.device)
    return sel, n


SUMMARY_SCALARS = ["best", "ident_cov_q", "earliest", "latest", "n_chains"]
SUMMARY_TOPS = ["top_valid", "top_sqp", "top_stp", "top_eqp", "top_etp",
                "top_cov_q", "top_cov_t", "top_len"]
LEAN_SCALARS = ["best"]
LEAN_TOPS = ["top_valid", "top_sqp", "top_stp", "top_eqp", "top_etp",
             "top_cov_t", "top_len"]


def summary_columns(top_k: int = 4, lean: bool = False) -> dict:
    """Each field's first column in the packed summary rows: a scalar's
    column, a top field's first of ``top_k``."""
    scalars = LEAN_SCALARS if lean else SUMMARY_SCALARS
    tops = LEAN_TOPS if lean else SUMMARY_TOPS
    cols = {name: c for c, name in enumerate(scalars)}
    cols.update((name, len(scalars) + i * top_k)
                for i, name in enumerate(tops))
    return cols


def unpack_summary(packed: np.ndarray, top_k: int = 4,
                   lean: bool = False) -> dict:
    """Split the packed summary array back into the named dict."""
    scalars = LEAN_SCALARS if lean else SUMMARY_SCALARS
    out = {name: packed[:, c] if name in scalars
           else packed[:, c : c + top_k]
           for name, c in summary_columns(top_k, lean).items()}
    out["top_valid"] = out["top_valid"].astype(bool)
    return out


# ---------------------------------------------------------------------
# library surface: the chain half of the seed-query pipeline
# ---------------------------------------------------------------------

def chain_batch(qseeds, qpos, tseeds, tpos, k: int, max_anchors: int,
                variant: str = "extend", device=None):
    """make_anchors + dp_from_anchors (see dp_from_anchors).  Numpy inputs
    go to ``resolve_device(device)``; tensors stay where they are."""
    qseeds, qpos, tseeds, tpos = _device_int32((qseeds, qpos, tseeds, tpos),
                                               device)
    anchors = make_anchors(qseeds, qpos, tseeds, tpos, max_anchors)
    return dp_from_anchors(anchors, k, variant)


def chain_batch_summary(qseeds, qpos, tseeds, tpos, min_match, alen,
                        k: int, max_anchors: int, variant: str = "extend",
                        top_k: int = 4, device=None):
    """Chain DP + aggregation on the device into the packed summary rows
    (``summarize_dp``): per pair the best chain length, the identity
    coverage, the earliest start and latest end over good chains, the
    number of good chains and the top-K good chain starts, ordered by
    coverage.  ``min_match`` [P] and ``alen`` [P] are per-pair inputs;
    "good" means a chain within 2/3 of the best and >= min_match long
    (ref: seeds/sequence.go:434-465)."""
    qseeds, qpos, tseeds, tpos, min_match, alen = _device_int32(
        (qseeds, qpos, tseeds, tpos, min_match, alen), device)
    out = chain_batch(qseeds, qpos, tseeds, tpos, k=k,
                      max_anchors=max_anchors, variant=variant)
    return summarize_dp(out, min_match, alen, k, top_k)


def chain_summary_indexed(a_seeds, a_pos, a_len, aidx, mm, ts, tp,
                          k: int, max_anchors: int,
                          variant: str = "extend", top_k: int = 4):
    """``chain_batch_summary`` with the query side resident on the device:
    ``a_seeds``/``a_pos`` are per-adapter tables ``[A, nq]`` (int16) that
    stay there across calls; each pair ships only its adapter index, its
    min-match threshold and an int16 target list."""
    aidx, mm, ts, tp = _device_int32((aidx, mm, ts, tp), a_seeds.device)
    rows = aidx.long()
    return chain_batch_summary(
        a_seeds[rows].to(torch.int32), a_pos[rows].to(torch.int32), ts, tp,
        mm, a_len[rows], k=k, max_anchors=max_anchors, variant=variant,
        top_k=top_k)


def _pack(lists, width: int, fill: int, dtype=np.int32) -> np.ndarray:
    """Ragged list of arrays -> padded ``[len(lists), width]``, each cut
    to ``width``, without a per-row python loop."""
    n = len(lists)
    out = np.full((n, width), fill, dtype)
    chunk = [np.asarray(lists[i][:width]) for i in range(n)]
    lens = np.fromiter((c.shape[0] for c in chunk), np.int64, n)
    if lens.sum() == 0:
        return out
    flat = np.concatenate(chunk)
    rows = np.repeat(np.arange(n), lens)
    ends = np.cumsum(lens)
    cols = np.arange(lens.sum()) - np.repeat(ends - lens, lens)
    out[rows, cols] = flat
    return out


class DeviceAdapterTables:
    """Device-resident padded adapter seed/position tables for
    ``chain_summary_indexed``."""

    def __init__(self, adapters, k: int, nq: int, seed_dtype=np.int16,
                 device=None):
        A = len(adapters)
        seeds = np.full((A, nq), -1, seed_dtype)
        pos = np.zeros((A, nq), np.int16)
        alen = np.zeros(A, np.int32)
        for i, ad in enumerate(adapters):
            m = min(ad.num_seeds, nq)
            seeds[i, :m] = ad.seeds[:m]
            pos[i, :m] = ad.seed_positions(k)[:m]
            alen[i] = ad.length
        dev = resolve_device(device)
        self.a_seeds = torch.from_numpy(seeds).to(dev)
        self.a_pos = torch.from_numpy(pos).to(dev)
        self.a_len = torch.from_numpy(alen).to(dev)
        self.k = k
        self.nq = nq

    def run(self, aidx_list, mm_list, tseeds_list, tpos_list, nt: int,
            max_anchors: int, variant: str = "extend", top_k: int = 4):
        """Indexed summary over (adapter index, target list) pairs: the
        targets packed to ``nt`` columns of int16, as the JAX method ships
        them.  The rows unpack with ``unpack_summary``'s default top-K of
        4, as there."""
        P = len(aidx_list)
        if P == 0:
            return None
        out = chain_summary_indexed(
            self.a_seeds, self.a_pos, self.a_len,
            np.asarray(aidx_list, np.int32), np.asarray(mm_list, np.int32),
            _pack(tseeds_list, nt, -1, np.int16),
            _pack(tpos_list, nt, 0, np.int16), k=self.k,
            max_anchors=max_anchors, variant=variant, top_k=top_k)
        return unpack_summary(out.cpu().numpy())


def _run_pairs(arrays, fills, fn, mesh, device):
    """``fn`` over packed pair arrays on one device, or with ``mesh`` (a
    ``DeviceGrid``) over its data shards' row blocks, the blocks' host
    results concatenated back in row order and cut to the pair count."""
    P = arrays[0].shape[0]
    if mesh is None:
        return fn(*_device_int32(arrays, device))
    parts = {lo: fn(*blocks) for _, lo, blocks in
             mesh.split_rows(arrays, fills)}
    parts = mesh.gather(parts)
    return {key: np.concatenate([p[key] for p in parts])[:P]
            for key in parts[0]}


def run_chain_summary(qseeds_list, qpos_list, tseeds_list, tpos_list,
                      min_match_list, alen_list, k: int, nq: int, nt: int,
                      max_anchors: int, variant: str = "extend",
                      top_k: int = 4, mesh=None, device=None):
    """Host wrapper for ``chain_batch_summary``: pads the pairs' query and
    target lists to ``nq``/``nt`` columns and returns the unpacked summary
    dict of numpy arrays.  With ``mesh``, the pairs split over its data
    shards."""
    P = len(qseeds_list)
    if P == 0:
        return None

    def one(qs, qp, ts, tp, mm, al):
        out = chain_batch_summary(qs, qp, ts, tp, mm, al, k=k,
                                  max_anchors=max_anchors, variant=variant,
                                  top_k=top_k)
        return unpack_summary(out.cpu().numpy(), top_k)

    arrays = [_pack(qseeds_list, nq, -1), _pack(qpos_list, nq, 0),
              _pack(tseeds_list, nt, -1), _pack(tpos_list, nt, 0),
              np.asarray(min_match_list, np.int32).reshape(P),
              np.asarray(alen_list, np.int32).reshape(P)]
    return _run_pairs(arrays, [-1, 0, -1, 0, 1, 0], one, mesh, device)


def extract_best_chain(out, pair_idx: int):
    """Recover the best chain's (query_seed_idx, target_seed_idx) lists by
    walking forward-pass backpointers from the best-scoring anchor."""
    f = out["f"][pair_idx]
    if int(f.max(initial=0)) == 0:
        return [], []
    a = int(np.argmax(f))
    bp = out["bp"][pair_idx]
    qi = out["qi"][pair_idx]
    tj = out["tj"][pair_idx]
    ma, mb = [], []
    while a >= 0:
        ma.append(int(qi[a]))
        mb.append(int(tj[a]))
        a = int(bp[a])
    return ma[::-1], mb[::-1]


def _bucket(n: int) -> int:
    """The JAX module's batch bucket off the TPU: the power of two from 8
    up that holds ``n``.  The engines pad their rows to the accelerator
    ladder instead (``captured.row_bucket``), the library wrappers to
    nothing."""
    b = 8
    while b < n:
        b *= 2
    return b


def run_chain_batch(qseeds_list, qpos_list, tseeds_list, tpos_list, k: int,
                    nq: int, nt: int, max_anchors: int,
                    variant: str = "extend", keys=None, mesh=None,
                    device=None):
    """Host wrapper: pad a list of (query, target) seed/position vectors to
    ``[P, nq]`` / ``[P, nt]``, run ``chain_batch`` and return its outputs
    as numpy arrays (only ``keys`` when given).  Queries and targets
    longer than nq/nt are cut (``overflow`` counts the anchors that did
    not fit).  With ``mesh``, the pairs split over its data shards."""
    P = len(qseeds_list)
    if P == 0:
        return None

    def one(qs, qp, ts, tp):
        out = chain_batch(qs, qp, ts, tp, k=k, max_anchors=max_anchors,
                          variant=variant)
        if keys is not None:
            out = {key: out[key] for key in keys}
        return {key: v.cpu().numpy() for key, v in out.items()}

    arrays = [_pack(qseeds_list, nq, -1), _pack(qpos_list, nq, 0),
              _pack(tseeds_list, nt, -1), _pack(tpos_list, nt, 0)]
    return _run_pairs(arrays, [-1, 0, -1, 0], one, mesh, device)


def good_chain_stats(out, pair_idx: int, min_match: int):
    """Aggregate one pair's DP arrays the way the reference walks its chain
    list: anchors on chains within 2/3 of the best and >= min_match long
    are 'good' (ref: seeds/sequence.go:434-465).

    Returns (best_len, thr, good_mask) where good_mask selects good
    anchors."""
    through = out["through"][pair_idx]
    valid = out["valid"][pair_idx]
    best = int(through.max(initial=0))
    if best < min_match:
        return best, min_match, np.zeros_like(valid)
    thr = max(min_match, (best * 2) // 3)
    return best, thr, valid & (through >= thr)


# ---------------------------------------------------------------------
# numpy oracle (same DP, scalar loops) for parity tests
# ---------------------------------------------------------------------

def _window_ok_np(gap_q: int, gap_t: int, k: int) -> bool:
    if gap_q < 0:
        return -k <= gap_t <= 0
    return (gap_q * 2) // 3 - k <= gap_t <= (gap_q * 3) // 2 + k


def chain_pair_np(qseeds, qpos, tseeds, tpos, k: int):
    """Scalar twin of the forward pass of ``chain_batch`` for one pair.
    Returns (anchors, f, cov_q, cov_t) with anchors as (qi, tj) tuples."""
    anchors = [(i, j) for i in range(len(qseeds)) for j in range(len(tseeds))
               if qseeds[i] >= 0 and qseeds[i] == tseeds[j]]
    n = len(anchors)
    f = [0] * n
    cov_q = [0] * n
    cov_t = [0] * n
    for t in range(n):
        it, jt = anchors[t]
        best, best_score = -1, 0
        for bi in range(t):
            ib, jb = anchors[bi]
            if ib >= it or jb >= jt:
                continue
            gq = qpos[it] - qpos[ib] - k
            gt = tpos[jt] - tpos[jb] - k
            if not _window_ok_np(gq, gt, k):
                continue
            if f[bi] > best_score:
                best_score = f[bi]
                best = bi
        if best >= 0:
            f[t] = best_score + 1
            gq = qpos[it] - qpos[anchors[best][0]] - k
            gt = tpos[jt] - tpos[anchors[best][1]] - k
            cov_q[t] = cov_q[best] + k + min(0, gq)
            cov_t[t] = cov_t[best] + k + min(0, gt)
        else:
            f[t] = 1
            cov_q[t] = k
            cov_t[t] = k
    return anchors, f, cov_q, cov_t
