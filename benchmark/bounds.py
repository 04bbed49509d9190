"""The table of peaks and the work each path kernel needs on given inputs.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``chain_bound``,
``anchor_work``, ``anchors_bound`` and ``counts_bound``: each counts the
int32 operations and the bytes that its function needs on the inputs of
one launch, whatever implements it, and the bound is the larger of the
operations over the card's int32 rate and the bytes over its memory rate.
A launch's roofline share is its bound over its measured time.
"""
from __future__ import annotations

import torch

# one H100 SXM: 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock
# (NVIDIA's Hopper architecture white paper), and 3.35 TB/s of HBM3 (the
# data sheet).  The path kernels use no tensor core.
INT32_OPS_S = 132 * 64 * 1.98e9
HBM_BYTES_S = 3.35e12
# a check of candidate p at step t: 2 index compares, 3 window compares,
# the branch select, the key select and the max
CHAIN_OPS_PER_CHECK = 8
# int32 output arrays of a chain launch by mode
CHAIN_OUTPUTS = {"forward": 6, "fb": 11, "lean": 2}
# a lookup in the anchor build's table: the hash (a multiply and a shift),
# the key compare and the select; an insert likewise
ANCHOR_OPS_PER_LOOKUP = 4


def bound(ops: float, nbytes: float):
    """(bound in ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / INT32_OPS_S, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def chain_bound(valid, mode: str):
    """A check of each valid anchor t against each valid p < t, n (n - 1)
    / 2 for a row of n valid anchors, per direction (``fb`` scans twice);
    the five inputs read once and the outputs written once."""
    P, A = valid.shape
    n = valid.ne(0).sum(dim=1).long()
    checks = int((n * (n - 1) // 2).sum())
    dirs = 2 if mode == "fb" else 1
    nbytes = (5 + CHAIN_OUTPUTS[mode]) * P * A * 4
    return bound(checks * dirs * CHAIN_OPS_PER_CHECK, nbytes)


def _anchor_rows(args):
    """The query and target seed rows an anchor launch reads, as rows."""
    qs, _, ts, _ = args[:4]
    if len(args) > 4 and args[4] is not None:
        mi, ci, live = args[4:7]
        return torch.where(live[:, None], qs[mi], -1), ts[ci]
    return qs, ts


def _rows_read(idx) -> int:
    """Distinct rows among ``idx``: each input row is read once."""
    return int(torch.unique(idx).numel()) if idx.numel() else 0


def anchor_work(q, t) -> dict:
    """A lookup of each live target seed of each pair that has a live
    query seed, an insert of each live query seed; and the brute-force
    compares, for reference."""
    nq = q.ge(0).sum(dim=1).long()
    nt = t.ge(0).sum(dim=1).long()
    return {"lookups": int(nt[nq.gt(0)].sum()), "inserts": int(nq.sum()),
            "compares": int((nq * nt).sum())}


def anchors_bound(args, outs):
    """``anchor_work``'s lookups and inserts at ``ANCHOR_OPS_PER_LOOKUP``
    operations each, against the distinct rows the busy pairs read, the
    hits' target positions and the slot arrays read once and the outputs
    (17 bytes a slot) written once.  ``args`` are the launch's
    ``(qs, qpos, ts, tpos[, mi, ci, live])``, ``outs`` its six outputs."""
    q, t = _anchor_rows(args)
    work = anchor_work(q, t)
    P, A = outs[0].shape
    busy = q.ge(0).any(dim=1)
    if len(args) > 4 and args[4] is not None:
        q_rows = _rows_read(args[4][busy])
        t_rows = _rows_read(args[5][busy])
        slots = P * 17
    else:
        q_rows = t_rows = int(busy.sum())
        slots = 0
    nbytes = q_rows * q.shape[1] * 8 + t_rows * t.shape[1] * 4 \
        + int(outs[4].sum()) * 4 + P * A * 17 + P * 4 + slots
    return bound((work["lookups"] + work["inserts"]) * ANCHOR_OPS_PER_LOOKUP,
                 nbytes)


def counts_bound(args):
    """An add per byte of every live slot's gathered row (each of its
    ``BB`` bins' in the binned form; one more per byte of a ``first``
    slot), against the distinct membership rows the live slots name, the
    buckets, mask and bins read once and the int32 outputs written once.
    ``args`` are the launch's ``(mem, b, first, topbin, NB)``."""
    mem, b, first, topbin, NB = args
    M, R = b.shape
    W = mem.shape[1]
    BB = 1 if topbin is None else topbin.shape[1]
    live = b.ge(0)
    adds = int(live.sum()) * BB * W
    if topbin is None:
        rows = b[live].long().clamp(max=mem.shape[0] - 1)
    else:
        rows = (b.clamp(min=0).long()[:, :, None] * NB
                + topbin[:, None, :])[live]
    nbytes = _rows_read(rows) * W + M * R * 4 + M * BB * W * 4
    if first is not None:
        adds += int((first & live).sum()) * BB * W
        nbytes += M * R + M * BB * W * 4
    if topbin is not None:
        nbytes += M * BB * 8
    return bound(adds, nbytes)
