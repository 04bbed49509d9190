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

Ported are the functions of the map path.  The JAX module's int16
``small`` scan is not: the port computes in int32, which gives the same
results wherever the engine would have taken it (positions < 16000).
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda_chain import chain_scan_fb, chain_scan_lean
# the gap windows live beside the plain scan that uses them; re-exported
# under the JAX module's name
from .cuda_chain import window_ok as _window_ok  # noqa: F401


def make_anchors_topk(qseeds, qpos, tseeds, tpos, per_seed: int = 2):
    """Anchors capped at ``per_seed`` target occurrences per query seed.

    All args are ``[P, N]`` int32, seed ids padded with -1.  Returns a dict
    of ``[P, NQ * per_seed]`` arrays ``qi, tj, qp, tp, valid`` in (i, j)
    row-major order, plus the per-pair ``overflow`` count of dropped
    matches.  A missing occurrence has ``qi = -1``, ``tj = 0`` and zero
    positions, as ``jnp.argmax`` over an all-false row gives."""
    P, NQ = qseeds.shape
    NT = tseeds.shape[1]
    dev = qseeds.device
    eq = (qseeds[:, :, None] == tseeds[:, None, :]) \
        & (qseeds[:, :, None] >= 0) & (tseeds[:, None, :] >= 0)
    iota_dt = torch.int16 if NT < (1 << 15) else torch.int32
    iota = torch.arange(NT, dtype=iota_dt, device=dev)
    cur = eq
    js, hits = [], []
    for _ in range(per_seed):
        first = torch.where(cur, iota, NT).amin(dim=2).long()    # [P, NQ]
        hit = first < NT
        j = torch.where(hit, first, 0)
        js.append(j)
        hits.append(hit)
        if len(js) < per_seed:
            cur = cur & (iota != j[:, :, None])
    A = NQ * per_seed
    tj = torch.stack(js, dim=2).reshape(P, A)
    valid = torch.stack(hits, dim=2).reshape(P, A)
    qi = torch.arange(NQ, device=dev).repeat_interleave(per_seed)
    qi = torch.where(valid, qi[None, :], -1).to(torch.int32)
    qp = torch.where(valid, qpos.repeat_interleave(per_seed, dim=1), 0)
    tp = torch.where(valid, torch.gather(tpos, 1, tj), 0)
    overflow = eq.sum(dim=(1, 2)) - valid.sum(dim=1)
    return {"qi": qi, "tj": tj.to(torch.int32), "qp": qp.to(torch.int32),
            "tp": tp.to(torch.int32), "valid": valid,
            "overflow": overflow.to(torch.int32)}


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


def compact_indices(mask_flat):
    """Ascending int64 indices of the set entries of ``mask_flat`` and
    their count: ``downpore_tpu.ops.chain.compact_indices`` without its
    fixed output size (every set index is returned)."""
    idx = torch.nonzero(mask_flat).flatten()
    return idx, idx.numel()


SUMMARY_SCALARS = ["best", "ident_cov_q", "earliest", "latest", "n_chains"]
SUMMARY_TOPS = ["top_valid", "top_sqp", "top_stp", "top_eqp", "top_etp",
                "top_cov_q", "top_cov_t", "top_len"]
LEAN_SCALARS = ["best"]
LEAN_TOPS = ["top_valid", "top_sqp", "top_stp", "top_eqp", "top_etp",
             "top_cov_t", "top_len"]


def unpack_summary(packed: np.ndarray, top_k: int = 4,
                   lean: bool = False) -> dict:
    """Split the packed summary array back into the named dict."""
    scalars = LEAN_SCALARS if lean else SUMMARY_SCALARS
    tops = LEAN_TOPS if lean else SUMMARY_TOPS
    out = {}
    c = 0
    for name in scalars:
        out[name] = packed[:, c]
        c += 1
    for name in tops:
        out[name] = packed[:, c : c + top_k]
        c += top_k
    out["top_valid"] = out["top_valid"].astype(bool)
    return out
