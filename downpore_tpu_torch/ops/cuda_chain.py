"""Forward anchor chain DP: the hand-written Hopper kernel and its plain
torch version.

Counterpart of ``downpore_tpu/ops/pallas_chain.py`` (``_kernel`` /
``pallas_chain_scan``), which computes exactly ``ops/chain.py:_chain_scan``
vmapped over pairs.  ``chain_scan`` takes ``[P, A]`` int32 anchors (qi, tj,
qp, tp, valid as 0/1) and returns the six ``[P, A]`` int32 arrays
``(score, cov_q, cov_t, s_qp, s_tp, bp)``.

A tensor on the CPU goes to ``chain_scan_plain``, a per-step transcription
of ``_chain_scan`` vectorised over pairs.  A CUDA tensor launches the
kernel in ``csrc/chain_scan.cu`` or raises; there is no fallback.

The scan is latency-bound: A serial steps per pair over a few KB of state,
so neither HBM bandwidth nor arithmetic limits it.  In eager torch each
step is ~25 small launches (~10k per dispatch at A = 384, twice for the
backward pass); the kernel instead keeps each pair's inputs and state in
shared memory for the whole scan, one warp per pair, and spreads the
predecessor search of each step across the warp's lanes (see the source
note in ``chain_scan.cu``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

NEG = -(10 ** 9)
VARIANTS = {"extend": 0, "aligner": 1}

_count_lock = threading.Lock()


def window_ok(gap_q: torch.Tensor, gap_t: torch.Tensor, k: int,
              variant: str = "extend") -> torch.Tensor:
    """Gap compatibility windows of ``ops/chain.py:_window_ok``, with JAX's
    flooring integer division (``torch.div(..., rounding_mode="floor")``):
    ``gap_t`` is negative for overlapping seeds in the aligner variant,
    where floor and truncation differ."""
    fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")
    if variant == "extend":
        neg = (gap_t >= -k) & (gap_t <= 0)
        pos = (gap_t >= fdiv(gap_q * 2, 3) - k) \
            & (gap_t <= fdiv(gap_q * 3, 2) + k)
        return torch.where(gap_q < 0, neg, pos)
    if variant != "aligner":
        raise ValueError(f"unknown chain variant {variant!r}")
    g = gap_t
    min_gap = fdiv(g * 2, 3) - k
    max_gap = fdiv(g * 3, 2) + k + 1
    neg_min = min_gap < 0
    small = max_gap < 20
    min_gap = torch.where(neg_min, -k,
                          torch.where(small, 0, min_gap))
    max_gap = torch.where(neg_min, max_gap.clamp(min=0),
                          torch.where(small, 20, max_gap))
    return (gap_q >= min_gap) & (gap_q <= max_gap)


def chain_scan_plain(qi, tj, qp, tp, valid, k: int,
                     variant: str = "extend"):
    """Plain torch forward scan on any device: the recurrence of
    ``_chain_scan`` step by step, vectorised over the ``P`` pairs.  Step t
    reads only the already-final prefix ``[:, :t]`` of the state."""
    P, A = qi.shape
    dev = qi.device
    i32 = torch.int32
    score = torch.zeros((P, A), dtype=i32, device=dev)
    cov_q = torch.zeros_like(score)
    cov_t = torch.zeros_like(score)
    s_qp = torch.zeros_like(score)
    s_tp = torch.zeros_like(score)
    bp = torch.full((P, A), -1, dtype=i32, device=dev)
    vb = valid != 0
    rows = torch.arange(P, device=dev)
    for t in range(A):
        qp_t, tp_t = qp[:, t], tp[:, t]
        if t == 0:
            has_prev = torch.zeros(P, dtype=torch.bool, device=dev)
            best = torch.zeros(P, dtype=torch.int64, device=dev)
            best_s = torch.zeros(P, dtype=i32, device=dev)
        else:
            gap_q = qp_t[:, None] - qp[:, :t] - k
            gap_t = tp_t[:, None] - tp[:, :t] - k
            prev = score[:, :t]
            ok = vb[:, :t] & (qi[:, :t] < qi[:, t:t + 1]) \
                & (tj[:, :t] < tj[:, t:t + 1]) \
                & window_ok(gap_q, gap_t, k, variant) & (prev > 0)
            cand = torch.where(ok, prev, NEG)
            best_s = cand.amax(dim=1)
            # first index of the maximum (jnp.argmax's tie-break)
            iota = torch.arange(t, device=dev)
            best = torch.where(cand == best_s[:, None], iota, t).amin(dim=1)
            has_prev = best_s > 0
        gq_b = qp_t - qp[rows, best] - k
        gt_b = tp_t - tp[rows, best] - k
        v = vb[:, t]
        zero = torch.zeros((), dtype=i32, device=dev)
        kk = torch.full((), k, dtype=i32, device=dev)
        upd = lambda new, empty: torch.where(v, new, empty).to(i32)
        n_score = torch.where(has_prev, best_s + 1, 1)
        n_cov_q = torch.where(has_prev, cov_q[rows, best] + k
                              + torch.minimum(zero, gq_b), kk)
        n_cov_t = torch.where(has_prev, cov_t[rows, best] + k
                              + torch.minimum(zero, gt_b), kk)
        n_s_qp = torch.where(has_prev, s_qp[rows, best], qp_t)
        n_s_tp = torch.where(has_prev, s_tp[rows, best], tp_t)
        n_bp = torch.where(has_prev, best.to(i32), -1)
        score[:, t] = upd(n_score, 0)
        cov_q[:, t] = upd(n_cov_q, 0)
        cov_t[:, t] = upd(n_cov_t, 0)
        s_qp[:, t] = upd(n_s_qp, 0)
        s_tp[:, t] = upd(n_s_tp, 0)
        bp[:, t] = upd(n_bp, -1)
    return score, cov_q, cov_t, s_qp, s_tp, bp


def _check(arrays, device):
    shape = arrays[0].shape
    if len(shape) != 2:
        raise ValueError(f"chain_scan takes [P, A] arrays, got {tuple(shape)}")
    for a in arrays:
        if a.device != device:
            raise ValueError("chain_scan inputs must share one device")
        if a.dtype != torch.int32:
            raise TypeError(f"chain_scan takes int32, got {a.dtype}")
        if a.shape != shape:
            raise ValueError("chain_scan inputs must share one [P, A] shape")
        if not a.is_contiguous():
            raise ValueError("chain_scan inputs must be contiguous")


def _launch(qi, tj, qp, tp, valid, k: int, variant: str):
    P, A = qi.shape
    if P == 0 or A == 0:
        # nothing to scan: no launch, and the count stays as it is
        return tuple(torch.empty((P, A), dtype=torch.int32, device=qi.device)
                     for _ in range(6))
    lib = _build.load("chain_scan")
    fn = lib.chain_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.chain_scan_error_string.argtypes = [ctypes.c_int]
        lib.chain_scan_error_string.restype = ctypes.c_char_p
    outs = [torch.empty((P, A), dtype=torch.int32, device=qi.device)
            for _ in range(6)]
    with torch.cuda.device(qi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() for a in (qi, tj, qp, tp, valid)),
                 *(o.data_ptr() for o in outs), P, A, k,
                 VARIANTS[variant], stream)
    if err != 0:
        msg = lib.chain_scan_error_string(err).decode()
        raise RuntimeError(f"chain_scan kernel launch failed: {msg} ({err})")
    with _count_lock:
        chain_scan.launches += 1
    return tuple(outs)


def chain_scan(qi, tj, qp, tp, valid, k: int, variant: str = "extend"):
    """Forward chain DP over ``[P, A]`` int32 anchors; see the module
    docstring.  CPU tensors run ``chain_scan_plain``; CUDA tensors launch
    the kernel (``chain_scan.launches`` counts those launches)."""
    arrays = (qi, tj, qp, tp, valid)
    device = qi.device
    _check(arrays, device)
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    if device.type == "cpu":
        return chain_scan_plain(qi, tj, qp, tp, valid, k, variant)
    if device.type != "cuda":
        raise ValueError(f"chain_scan has no kernel for {device.type!r}")
    return _launch(qi, tj, qp, tp, valid, k, variant)


chain_scan.launches = 0
