"""Batched DTW band update: the hand-written Hopper kernel and its plain
torch version.

Counterpart of ``downpore_tpu/ops/pallas_band.py`` (``_band_kernel`` /
``pallas_update_bands``): ``update_bands(ds, poffs, threshold)`` takes
``[B, W]`` int32 distances and previous bands and returns ``(out [B, W]
int32, min [B] int32)``, every add saturating at ``BAND_FULL = 0xFFFF``
(the recurrence of ``align/band.py``).

A tensor on the CPU goes to ``update_bands_plain``.  A CUDA tensor launches
the kernel in ``csrc/band_update.cu`` (one warp per band, W <= 32) or
raises; there is no fallback.  The same warp step (``csrc/band.cuh``) is
the inner loop of the beam-consensus kernel (``cuda_beam``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

BAND_FULL = 0xFFFF

_count_lock = threading.Lock()


def update_bands_plain(ds, poffs, threshold: int, full: int = BAND_FULL):
    """Plain torch band update over ``[..., W]`` (``ds`` and ``poffs``
    broadcast against each other), saturating at ``full``:

        raw[i] = min(p[i], p[i+1], p[i-1] + d[i-1],
                     p[i-2] + d[i-2] + d[i-1]) + d[i]
        out[i] = max(raw[i] - min(raw), 0), then ``full`` at or above
        ``threshold``

    with out-of-range neighbours ``full``.  Returns ``(out, min)``."""
    shape = torch.broadcast_shapes(ds.shape, poffs.shape)
    ds = ds.to(torch.int32).expand(shape)
    poffs = poffs.to(torch.int32).expand(shape)
    sat = lambda x: torch.clamp(x, max=full)
    pad = torch.full(shape[:-1] + (1,), full, dtype=torch.int32,
                     device=ds.device)
    stay = torch.cat([poffs[..., 1:], pad], dim=-1)
    pd = sat(poffs + ds)
    skip1 = torch.cat([pad, pd[..., :-1]], dim=-1)
    two = sat(pd[..., :-1] + ds[..., 1:])
    skip2 = torch.cat([pad, pad, two[..., :-1]], dim=-1)[..., :shape[-1]]
    best = torch.minimum(torch.minimum(poffs, stay),
                         torch.minimum(skip1, skip2))
    raw = sat(best + ds)
    m = raw.amin(dim=-1)
    out = torch.clamp(raw - m[..., None], min=0)
    out = torch.where(out >= threshold, full, out)
    return out, m


def _check(ds, poffs):
    if ds.dim() != 2 or ds.shape != poffs.shape:
        raise ValueError(f"update_bands takes two [B, W] arrays, got "
                         f"{tuple(ds.shape)} and {tuple(poffs.shape)}")
    if ds.device != poffs.device:
        raise ValueError("update_bands inputs must share one device")
    for a in (ds, poffs):
        if a.dtype != torch.int32:
            raise TypeError(f"update_bands takes int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError("update_bands inputs must be contiguous")


def _launch(ds, poffs, threshold: int):
    B, W = ds.shape
    out = torch.empty((B, W), dtype=torch.int32, device=ds.device)
    m = torch.empty((B,), dtype=torch.int32, device=ds.device)
    if B == 0:
        return out, m
    if not 1 <= W <= 32:
        raise ValueError(f"the band kernel takes 1 <= W <= 32, got W={W}")
    lib = _build.load("band_update")
    fn = lib.band_update_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.band_update_error_string.argtypes = [ctypes.c_int]
        lib.band_update_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(ds.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ds.data_ptr(), poffs.data_ptr(), out.data_ptr(),
                 m.data_ptr(), B, W, threshold, stream)
    if err != 0:
        msg = lib.band_update_error_string(err).decode()
        raise RuntimeError(f"band_update kernel launch failed: {msg} ({err})")
    with _count_lock:
        update_bands.launches += 1
    return out, m


def update_bands(ds, poffs, threshold: int):
    """Batched band update over ``[B, W]`` int32 (see the module
    docstring).  CPU tensors run ``update_bands_plain``; CUDA tensors
    launch the kernel (``update_bands.launches`` counts those launches)."""
    _check(ds, poffs)
    if ds.device.type == "cpu":
        return update_bands_plain(ds, poffs, threshold)
    if ds.device.type != "cuda":
        raise ValueError(f"update_bands has no kernel for {ds.device.type!r}")
    return _launch(ds, poffs, threshold)


update_bands.launches = 0
