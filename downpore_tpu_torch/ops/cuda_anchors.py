"""Anchor build, two target hits per query seed: the hand-written Hopper
kernel and its plain torch version.

Counterpart of ``downpore_tpu/ops/chain.py:57`` ``make_anchors_topk`` at
``per_seed = 2``, which the JAX engines leave to XLA inside their ``jit``
(the map and overlap engines' ``_build_anchors``, the trimmer's
``_anchors_chunked``).  For pair p and query seed i with ``qs[p, i] >= 0``
it takes the first two target indices j, ascending, with ``ts[p, j] ==
qs[p, i]``; outputs are ``(qi, tj, qp, tp, valid, overflow)``: ``[P, 2 NQ]``
int32 (``valid`` bool) in (i, slot) row-major order, a miss with ``qi`` -1
and ``tj``, ``qp``, ``tp`` 0, and ``overflow [P]`` int32, the pair's matches
minus its valid anchors.

Two entries, each one launch of ``csrc/anchors_topk.cu`` on a card:

* ``anchors_topk(qs, qpos, ts, tpos)``: row p of each ``[P, N]`` array;
* ``anchors_topk_indexed(mi, ci, live, q_seeds, q_pos, t_seeds, t_pos)``:
  an engine's pair-budget slots, the query row ``q_seeds[mi[p]]`` and the
  target row ``t_seeds[ci[p]]`` read by index inside the kernel, a slot
  with ``live`` False having every query seed -1; no gathered row copies.

A tensor on the CPU goes to the plain version (``anchors_topk_plain``:
the ``[P, NQ, NT]`` equality of ``make_anchors_topk``, the indexed entry in
steps of ``_anchor_chunk`` pairs to bound it).  A CUDA tensor launches the
kernel or raises; there is no fallback.  ``anchors_topk.launches`` counts
the launches; one captured into a CUDA graph counts at each replay
(``captured.each_run``).  The kernel looks each target seed up in a hash
table of the pair's query seeds in shared memory, so it takes at most
``MAX_NQ`` query seeds a row; it is bound by the bytes of the rows it reads
and the outputs it writes; see the source note in ``anchors_topk.cu``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, captured

PER_SEED = 2
MAX_NQ = 1024     # query seeds a row the kernel's table holds
KEYS = ("qi", "tj", "qp", "tp", "valid", "overflow")

_count_lock = threading.Lock()


def _anchor_chunk(nq: int, nt: int) -> int:
    """Pairs per step of the plain indexed build: its ``[CH, nq, nt]``
    equality tensor stays near 512 MB."""
    return max(128, min(8192, (1 << 29) // max(1, nq * nt)))


def _topk_rows(qseeds, qpos, tseeds, tpos, per_seed: int = PER_SEED):
    """The plain function on rows: first ``per_seed`` target occurrences
    of each query seed from the ``[P, NQ, NT]`` equality (the JAX
    function's ``argmax`` over an all-false row gives a miss ``tj`` of
    0)."""
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
    return (qi, tj.to(torch.int32), qp.to(torch.int32), tp.to(torch.int32),
            valid, overflow.to(torch.int32))


def anchors_topk_plain(qs, qpos, ts, tpos, mi=None, ci=None, live=None):
    """Plain torch version of both entries (the kernel's arguments): rows
    ``(qs, qpos, ts, tpos)`` with ``mi`` None, else the indexed slots
    ``(mi, ci, live)`` over those tables, ``_anchor_chunk`` slots a
    step."""
    if mi is None:
        return _topk_rows(qs, qpos, ts, tpos)
    chunk = _anchor_chunk(qs.shape[1], ts.shape[1])
    parts = []
    for lo in range(0, max(1, mi.shape[0]), chunk):
        m, c = mi[lo:lo + chunk], ci[lo:lo + chunk]
        q = torch.where(live[lo:lo + chunk, None], qs[m], -1)
        parts.append(_topk_rows(q, qpos[m], ts[c], tpos[c]))
    return tuple(torch.cat(p) for p in zip(*parts))


def _check_rows(name, arrays, device):
    for a in arrays:
        if a.device != device:
            raise ValueError(f"{name} inputs must share one device")
        if a.dtype != torch.int32:
            raise TypeError(f"{name} takes int32 seeds and positions, got "
                            f"{a.dtype}")
        if a.dim() != 2:
            raise ValueError(f"{name} takes [rows, N] arrays, got "
                             f"{tuple(a.shape)}")
        if a.shape[1] > 1 and a.stride(1) != 1:
            raise ValueError(f"{name} takes rows contiguous in memory")


def _bind(lib):
    """``lib`` with the C entry points' argument types set."""
    fn = lib.anchors_topk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 \
            + [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.anchors_topk_error_string.argtypes = [ctypes.c_int]
        lib.anchors_topk_error_string.restype = ctypes.c_char_p
        lib.anchors_topk_first_slot.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.anchors_topk_first_slot.restype = ctypes.c_int
    return lib


def _lib():
    return _bind(_build.load("anchors_topk"))


def _outputs(P: int, NQ: int, device):
    """The kernel's outputs, allocated: four int32 ``[P, 2 NQ]`` views of
    one block, ``valid`` and ``overflow``."""
    A = PER_SEED * NQ
    ints = torch.empty((4, P, A), dtype=torch.int32, device=device)
    return (*ints.unbind(0), torch.empty((P, A), dtype=torch.bool,
                                         device=device),
            torch.empty((P,), dtype=torch.int32, device=device))


def _call(lib, outs, qs, qpos, ts, tpos, mi=None, ci=None, live=None,
          stream=None) -> int:
    """One call of the C entry point into ``outs``; its error code."""
    P = (qs if mi is None else mi).shape[0]
    ptr = lambda t: None if t is None else t.data_ptr()
    return lib.anchors_topk_launch(
        qs.data_ptr(), qpos.data_ptr(), ts.data_ptr(), tpos.data_ptr(),
        qs.stride(0), qpos.stride(0), ts.stride(0), tpos.stride(0),
        ptr(mi), ptr(ci), ptr(live), *(o.data_ptr() for o in outs), P,
        qs.shape[1], ts.shape[1], stream)


def _launch(qs, qpos, ts, tpos, mi=None, ci=None, live=None):
    P = (qs if mi is None else mi).shape[0]
    NQ, NT = qs.shape[1], ts.shape[1]
    outs = _outputs(P, NQ, qs.device)
    if P == 0 or NQ == 0:
        # nothing to build: no launch, and the count stays as it is
        outs[5].zero_()
        return outs
    lib = _lib()
    with torch.cuda.device(qs.device):
        err = _call(lib, outs, qs, qpos, ts, tpos, mi, ci, live,
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.anchors_topk_error_string(err).decode()
        raise RuntimeError(f"anchors_topk kernel launch failed (P = {P}, "
                           f"NQ = {NQ}, NT = {NT}): {msg} ({err})")

    def count():
        with _count_lock:
            anchors_topk.launches += 1
    captured.each_run(count)
    return outs


def _run(args, device):
    if device.type == "cpu":
        return anchors_topk_plain(*args)
    if device.type != "cuda":
        raise ValueError(f"anchors_topk has no kernel for {device.type!r}")
    if args[0].shape[1] > MAX_NQ:
        raise ValueError(f"the anchors_topk kernel takes at most {MAX_NQ} "
                         f"query seeds a row, got {args[0].shape[1]}")
    return _launch(*args)


def anchors_topk(qs, qpos, ts, tpos, per_seed: int = PER_SEED):
    """Anchors of row p of ``qs, qpos [P, NQ]`` against row p of ``ts, tpos
    [P, NT]`` (int32, seeds -1 padded): ``(qi, tj, qp, tp, valid,
    overflow)``.  Only ``per_seed = 2`` is taken, the engines' cap."""
    if per_seed != PER_SEED:
        raise ValueError(f"anchors_topk keeps {PER_SEED} target hits a "
                         f"query seed, not {per_seed}")
    _check_rows("anchors_topk", (qs, qpos, ts, tpos), qs.device)
    P, NQ = qs.shape
    if qpos.shape != (P, NQ) or tuple(ts.shape) != tuple(tpos.shape) \
            or ts.shape[0] != P:
        raise ValueError("anchors_topk takes qs, qpos [P, NQ] and ts, tpos "
                         "[P, NT]")
    return _run((qs, qpos, ts, tpos), qs.device)


def anchors_topk_indexed(mi, ci, live, q_seeds, q_pos, t_seeds, t_pos):
    """Anchors of an engine's pair-budget slots: slot p pairs query row
    ``mi[p]`` of ``q_seeds, q_pos [M, NQ]`` with target row ``ci[p]`` of
    ``t_seeds, t_pos [C, NT]`` (int32), and a slot with ``live[p]`` False
    has no query seed.  ``mi`` and ``ci`` are int64 ``[P]``, ``live`` bool
    ``[P]``; returns ``anchors_topk``'s arrays over the ``P`` slots."""
    dev = q_seeds.device
    _check_rows("anchors_topk_indexed", (q_seeds, q_pos, t_seeds, t_pos),
                dev)
    if q_pos.shape != q_seeds.shape or t_pos.shape != t_seeds.shape:
        raise ValueError("anchors_topk_indexed takes q_seeds, q_pos [M, NQ] "
                         "and t_seeds, t_pos [C, NT]")
    for a, dt in ((mi, torch.int64), (ci, torch.int64), (live, torch.bool)):
        if a.device != dev:
            raise ValueError("anchors_topk_indexed inputs must share one "
                             "device")
        if a.dtype != dt:
            raise TypeError(f"anchors_topk_indexed takes int64 slot rows "
                            f"and a bool live mask, got {a.dtype}")
        if a.dim() != 1 or a.shape != mi.shape:
            raise ValueError("anchors_topk_indexed takes [P] slot arrays")
        if not a.is_contiguous():
            raise ValueError("anchors_topk_indexed takes contiguous slot "
                             "arrays")
    return _run((q_seeds, q_pos, t_seeds, t_pos, mi, ci, live), dev)


def as_dict(outs) -> dict:
    """``make_anchors_topk``'s dict of the kernel's outputs."""
    return dict(zip(KEYS, outs))


anchors_topk.launches = 0
