"""Anchor chain DP: the hand-written Hopper kernel and its plain torch
versions.

Counterpart of ``downpore_tpu/ops/pallas_chain.py`` (``_kernel`` /
``pallas_chain_scan``), which computes exactly ``ops/chain.py:_chain_scan``
vmapped over pairs.  Three entry points on ``[P, A]`` int32 anchors (qi,
tj, qp, tp, valid as 0/1), each one launch of ``csrc/chain_scan.cu``:

* ``chain_scan``: the forward scan, six arrays ``(score, cov_q, cov_t,
  s_qp, s_tp, bp)``;
* ``chain_scan_fb``: forward and backward (the JAX module's reversed,
  negated second scan, already un-reversed): eleven arrays, the forward
  six then ``(b, cov_qb, cov_tb, e_qp, e_tp)``;
* ``chain_scan_lean``: ``(score, bp)`` only (``_chain_scan_lean``).

A tensor on the CPU goes to ``chain_scan_plain``, a per-step transcription
of ``_chain_scan`` vectorised over pairs.  A CUDA tensor launches the
kernel or raises; there is no fallback.  ``chain_scan.launches`` counts
the kernel's launches in every mode, ``MODE_LAUNCHES`` by mode; a launch
captured into a CUDA graph (``captured.run``) counts at each replay of the
graph, where the kernel runs, and not at its capture
(``captured.each_run``).

The kernel is bound by the integer issue rate: A serial steps per pair,
step t checking every p < t.  It keeps a pair's anchors in registers, one
warp per pair and direction, takes each step's argmax with one
``redux.sync`` over a packed (score, -p) key, and tests the gap windows
without division, as compares of precomputed forms (``window_ok_linear``);
see the source note in ``chain_scan.cu``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, captured

NEG = -(10 ** 9)
VARIANTS = {"extend": 0, "aligner": 1}

MODES = {"forward": 0, "fb": 1, "lean": 2}
N_OUT = {"forward": 6, "fb": 11, "lean": 2}
# the kernel's packed argmax key (score << 16) | (0xFFFF - p) is exact
# while every score and anchor index is below 2^15
MAX_A = (1 << 15) - 1
MODE_LAUNCHES = {m: 0 for m in MODES}

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


def window_ok_linear(qp_p, tp_p, qp_t, tp_t, k: int,
                     variant: str = "extend") -> torch.Tensor:
    """``window_ok`` as the kernel tests it (``window_linear`` in
    ``chain_scan.cu``, with the proof): without division, since
    ``x >= floor(y / 3)`` iff ``3x >= y - 2`` and ``x <= floor(y / 2)`` iff
    ``2x <= y`` for every sign, and with the gaps written out in the anchor
    positions (``gap_q = qp_t - qp_p - k``), so that each inequality
    compares a form of anchor p with a threshold of step t."""
    if variant == "extend":
        pos = (3 * tp_p - 2 * qp_p <= 3 * tp_t - 2 * qp_t + 2 * k + 2) \
            & (2 * tp_p - 3 * qp_p >= 2 * tp_t - 3 * qp_t - k)
        neg = (tp_p <= tp_t) & (tp_p >= tp_t - k)
        return torch.where(qp_p > qp_t - k, neg, pos)
    if variant != "aligner":
        raise ValueError(f"unknown chain variant {variant!r}")
    m_ok = 2 * qp_p - 3 * tp_p >= 2 * qp_t - 3 * tp_t - k - 2
    neg_min = (qp_p <= qp_t) & ((qp_p >= qp_t - k) | m_ok)
    small = (qp_p <= qp_t - k) & (qp_p >= qp_t - k - 20)
    ratio = (3 * qp_p - 2 * tp_p <= 3 * qp_t - 2 * tp_t + 2 * k + 2) & m_ok
    return torch.where(2 * tp_p > 2 * tp_t - 5 * k, neg_min,
                       torch.where(3 * tp_p > 3 * tp_t - k - 38, small,
                                   ratio))


def _forward_plain(qi, tj, qp, tp, valid, k: int, variant: str):
    """Plain torch forward scan on any device: the recurrence of
    ``_chain_scan`` step by step, vectorised over the ``P`` pairs.  Step t
    reads only the already-final prefix ``[:, :t]`` of the state.  A row
    without a valid anchor (an engine's unused budget slot) keeps the
    state it starts in, so the scan runs over the other rows only."""
    P, A = qi.shape
    dev = qi.device
    i32 = torch.int32
    score = torch.zeros((P, A), dtype=i32, device=dev)
    cov_q = torch.zeros_like(score)
    cov_t = torch.zeros_like(score)
    s_qp = torch.zeros_like(score)
    s_tp = torch.zeros_like(score)
    bp = torch.full((P, A), -1, dtype=i32, device=dev)
    live = (valid != 0).any(dim=1)
    if P and not bool(live.all()):
        rows = live.nonzero().flatten()
        out = (score, cov_q, cov_t, s_qp, s_tp, bp)
        for o, sub in zip(out, _forward_plain(
                *(a[rows] for a in (qi, tj, qp, tp, valid)), k, variant)):
            o[rows] = sub
        return out
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


def chain_scan_plain(qi, tj, qp, tp, valid, k: int,
                     variant: str = "extend", mode: str = "forward"):
    """Plain torch version of every mode of the kernel (see the module
    docstring for the outputs).  The backward scan is the JAX module's:
    the forward recurrence over the reversed, negated row, its outputs
    reversed back and its start positions negated back."""
    fwd = _forward_plain(qi, tj, qp, tp, valid, k, variant)
    if mode == "lean":
        return fwd[0], fwd[5]
    if mode == "forward":
        return fwd
    if mode != "fb":
        raise ValueError(f"unknown chain_scan mode {mode!r}")
    rev = lambda x: torch.flip(x, dims=(1,))
    b, cov_qb, cov_tb, e_qp, e_tp, _ = _forward_plain(
        rev(-qi), rev(-tj), rev(-qp), rev(-tp), rev(valid), k, variant)
    return fwd + (rev(b), rev(cov_qb), rev(cov_tb), -rev(e_qp), -rev(e_tp))


def _check(arrays, device):
    shape = arrays[0].shape
    if len(shape) != 2:
        raise ValueError(f"chain_scan takes [P, A] arrays, got {tuple(shape)}")
    if shape[1] > MAX_A:
        raise ValueError(f"chain_scan takes A <= {MAX_A} anchors a pair (the "
                         f"kernel's argmax key would overflow), got "
                         f"{shape[1]}")
    for a in arrays:
        if a.device != device:
            raise ValueError("chain_scan inputs must share one device")
        if a.dtype != torch.int32:
            raise TypeError(f"chain_scan takes int32, got {a.dtype}")
        if a.shape != shape:
            raise ValueError("chain_scan inputs must share one [P, A] shape")
        if not a.is_contiguous():
            raise ValueError("chain_scan inputs must be contiguous")


def _lib():
    lib = _build.load("chain_scan")
    fn = lib.chain_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.chain_scan_error_string.argtypes = [ctypes.c_int]
        lib.chain_scan_error_string.restype = ctypes.c_char_p
        lib.chain_scan_max_register_a.restype = ctypes.c_int
    return lib


def _launch(qi, tj, qp, tp, valid, k: int, variant: str,
            mode: str = "forward"):
    P, A = qi.shape
    n_out = N_OUT[mode]
    if P == 0 or A == 0:
        # nothing to scan: no launch, and the count stays as it is
        return tuple(torch.empty((P, A), dtype=torch.int32, device=qi.device)
                     for _ in range(n_out))
    lib = _lib()
    # one allocation for every output; each [P, A] view is contiguous
    outs = torch.empty((n_out, P, A), dtype=torch.int32,
                       device=qi.device).unbind(0)
    # the kernel's output slots: lean writes score (0) and bp (5)
    slots = [o.data_ptr() for o in outs] if mode != "lean" else \
        [outs[0].data_ptr()] + [None] * 4 + [outs[1].data_ptr()]
    slots += [None] * (11 - len(slots))
    ins = (ctypes.c_void_p * 5)(*(a.data_ptr()
                                  for a in (qi, tj, qp, tp, valid)))
    out_arr = (ctypes.c_void_p * 11)(*slots)
    with torch.cuda.device(qi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.chain_scan_launch(ins, out_arr, P, A, k, VARIANTS[variant],
                                    MODES[mode], stream)
    if err != 0:
        msg = lib.chain_scan_error_string(err).decode()
        raise RuntimeError(f"chain_scan kernel launch failed ({mode}, "
                           f"A = {A}): {msg} ({err})")
    def count():
        with _count_lock:
            chain_scan.launches += 1
            MODE_LAUNCHES[mode] += 1
    captured.each_run(count)
    return tuple(outs)


def _scan(qi, tj, qp, tp, valid, k: int, variant: str, mode: str):
    arrays = (qi, tj, qp, tp, valid)
    device = qi.device
    _check(arrays, device)
    if variant not in VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}")
    if device.type == "cpu":
        return chain_scan_plain(qi, tj, qp, tp, valid, k, variant, mode)
    if device.type != "cuda":
        raise ValueError(f"chain_scan has no kernel for {device.type!r}")
    return _launch(qi, tj, qp, tp, valid, k, variant, mode)


def chain_scan(qi, tj, qp, tp, valid, k: int, variant: str = "extend"):
    """Forward chain DP over ``[P, A]`` int32 anchors: ``(score, cov_q,
    cov_t, s_qp, s_tp, bp)``.  CPU tensors run ``chain_scan_plain``; CUDA
    tensors launch the kernel (``chain_scan.launches`` counts launches of
    every mode)."""
    return _scan(qi, tj, qp, tp, valid, k, variant, "forward")


def chain_scan_fb(qi, tj, qp, tp, valid, k: int, variant: str = "extend"):
    """Forward and backward chain DP in one launch: the six forward arrays,
    then the backward scan's ``(b, cov_qb, cov_tb, e_qp, e_tp)`` in the
    row's own anchor order and coordinates."""
    return _scan(qi, tj, qp, tp, valid, k, variant, "fb")


def chain_scan_lean(qi, tj, qp, tp, valid, k: int, variant: str = "extend"):
    """Forward chain DP keeping only ``(score, bp)``."""
    return _scan(qi, tj, qp, tp, valid, k, variant, "lean")


chain_scan.launches = 0
