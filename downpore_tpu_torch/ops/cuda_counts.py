"""Retrieval counts as a gather-reduce: the hand-written Hopper kernel and
its plain torch versions.

Counterpart of ``downpore_tpu/ops/map_engine.py``'s ``_count_rows`` (:107),
``_count_rows_pair`` (:142) and ``_binned_counts_pair`` (:518), which the
JAX engines leave to XLA inside their ``jit``: for each query row, the
int32 sum of the int8 membership rows its live buckets name.

``retrieval_count(mem, b, first=None, topbin=None, NB=1)``, one launch of
``csrc/retrieval_count.cu`` on a card, which never writes the gathered
``[M, R, W]`` block:

* flat: ``mem [H, W]`` int8, ``b [M, R]`` int32 buckets (-1 padded) ->
  ``(c,)`` ``[M, W]`` int32, ``c[m] = sum over r with b[m, r] >= 0 of
  mem[b[m, r]]``, or ``(c, d)`` with a bool ``first [M, R]``, ``d`` the
  same sum over the slots with ``first[m, r]`` set: one read of each row
  serves both;
* binned (the binned gate's level 2): with int64 ``topbin [M, BB]`` the
  row of slot r in selected bin ``topbin[m, bb]`` is ``b[m, r] NB +
  topbin[m, bb]`` of ``mem = flat [H NB, CB]``; ``[M, BB, CB]`` outputs.  A tensor on the CPU goes to the
plain version (``retrieval_count_plain``: the gather and sum, in row
chunks that keep each gathered block under ``_GATHER_ELEMS`` elements, as
the JAX engine's ``lax.map`` does).  A CUDA tensor launches the kernel or
raises; there is no fallback.  ``retrieval_count.launches`` counts the
launches; one captured into a CUDA graph counts at each replay
(``captured.each_run``).  The kernel is bound by the bytes of the distinct
membership rows it reads, its repeats served from L2 (column tiles sized
from the launch's shape); see the source note in ``retrieval_count.cu``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, captured

# bound on the [m, R, W] int8 block one plain gather materializes
_GATHER_ELEMS = 1 << 28

_count_lock = threading.Lock()


def _row_chunks(M: int, R: int, C: int):
    """Row slices that keep each gathered ``[m, R, C]`` block under
    ``_GATHER_ELEMS`` elements (the JAX engine's ``lax.map`` chunking)."""
    if M * R * C <= _GATHER_ELEMS:
        return [slice(0, M)]
    mc = max(1, _GATHER_ELEMS // max(1, R * C))
    mc = max(8, (mc // 8) * 8)
    return [slice(lo, min(M, lo + mc)) for lo in range(0, M, mc)]


def retrieval_count_plain(mem, b, first=None, topbin=None, NB: int = 1):
    """Plain torch version of the kernel (its arguments): ``(c,)``, or
    ``(c, d)`` with ``first``; flat ``[M, W]`` without ``topbin``, else
    binned ``[M, BB, W]``."""
    M, R = b.shape
    W = mem.shape[1]
    BB = 1 if topbin is None else topbin.shape[1]
    shape = (M, W) if topbin is None else (M, BB, W)
    c = torch.empty(shape, dtype=torch.int32, device=mem.device)
    d = None if first is None else torch.empty_like(c)
    for sl in _row_chunks(M, R, BB * W):
        bs = b[sl]
        if topbin is None:
            idx = bs.clamp(min=0).long()                          # [m, R]
            live = (bs >= 0)[:, :, None]
        else:
            idx = bs.clamp(min=0).long()[:, :, None] * NB \
                + topbin[sl][:, None, :]                          # [m, R, BB]
            live = (bs >= 0)[:, :, None, None]
        rows = torch.where(live, mem[idx], 0)
        c[sl] = rows.sum(dim=1, dtype=torch.int32)
        if d is not None:
            fm = first[sl].reshape(first[sl].shape + (1,) * (rows.dim() - 2))
            d[sl] = torch.where(fm, rows, 0).sum(dim=1, dtype=torch.int32)
    return (c,) if d is None else (c, d)


def _check(mem, b, first, topbin, NB):
    dev = mem.device
    arrays = [(mem, torch.int8, 2), (b, torch.int32, 2)]
    if first is not None:
        arrays.append((first, torch.bool, 2))
    if topbin is not None:
        arrays.append((topbin, torch.int64, 2))
    for a, dt, nd in arrays:
        if a.device != dev:
            raise ValueError("retrieval_count inputs must share one device")
        if a.dtype != dt:
            raise TypeError(f"retrieval_count takes int8 membership, int32 "
                            f"buckets, a bool first mask and int64 bins; got "
                            f"{a.dtype} where {dt} goes")
        if a.dim() != nd:
            raise ValueError(f"retrieval_count takes 2-d arrays, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError("retrieval_count takes contiguous arrays")
    if first is not None and first.shape != b.shape:
        raise ValueError("retrieval_count's first mask must match the "
                         "buckets' [M, R]")
    if topbin is not None and (topbin.shape[0] != b.shape[0] or NB < 1):
        raise ValueError("retrieval_count's bins must be [M, BB], NB >= 1")
    if not 0 < mem.shape[0] < (1 << 30):
        raise ValueError(f"retrieval_count takes 1 to 2^30 - 1 membership "
                         f"rows, got {mem.shape[0]}")


def _bind(lib):
    """``lib`` with the C entry points' argument types set."""
    fn = lib.retrieval_count_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.retrieval_count_error_string.argtypes = [ctypes.c_int]
        lib.retrieval_count_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    return _bind(_build.load("retrieval_count"))


def _outputs(mem, b, first, topbin):
    """The kernel's outputs, allocated: ``(c,)`` or ``(c, d)``."""
    M, W = b.shape[0], mem.shape[1]
    shape = (M, W) if topbin is None else (M, topbin.shape[1], W)
    return torch.empty((1 if first is None else 2,) + shape,
                       dtype=torch.int32, device=mem.device).unbind(0)


def _call(lib, outs, mem, b, first=None, topbin=None, NB: int = 1,
          stream=None) -> int:
    """One call of the C entry point into ``outs``; its error code."""
    ptr = lambda t: None if t is None else t.data_ptr()
    BB = 1 if topbin is None else topbin.shape[1]
    return lib.retrieval_count_launch(
        mem.data_ptr(), b.data_ptr(), ptr(first), ptr(topbin),
        outs[0].data_ptr(), outs[1].data_ptr() if len(outs) > 1 else None,
        b.shape[0], mem.shape[0], b.shape[1], BB, NB, mem.shape[1], stream)


def _launch(mem, b, first=None, topbin=None, NB: int = 1):
    outs = _outputs(mem, b, first, topbin)
    if not outs[0].numel():
        # nothing to count: no launch, and the count stays as it is
        return outs
    lib = _lib()
    with torch.cuda.device(mem.device):
        err = _call(lib, outs, mem, b, first, topbin, NB,
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.retrieval_count_error_string(err).decode()
        raise RuntimeError(f"retrieval_count kernel launch failed (shape "
                           f"{tuple(outs[0].shape)}, R = {b.shape[1]}): "
                           f"{msg} ({err})")

    def count():
        with _count_lock:
            retrieval_count.launches += 1
    captured.each_run(count)
    return outs


def retrieval_count(mem, b, first=None, topbin=None, NB: int = 1):
    """The kernel's entry (both forms): ``(c,)`` or ``(c, d)``.  CPU
    tensors run ``retrieval_count_plain``; CUDA tensors launch the kernel
    (``retrieval_count.launches`` counts the launches)."""
    _check(mem, b, first, topbin, NB)
    dev = mem.device
    if dev.type == "cpu":
        return retrieval_count_plain(mem, b, first, topbin, NB)
    if dev.type != "cuda":
        raise ValueError(f"retrieval_count has no kernel for {dev.type!r}")
    return _launch(mem, b, first, topbin, NB)


retrieval_count.launches = 0
