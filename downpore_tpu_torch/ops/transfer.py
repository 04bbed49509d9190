"""Host <-> device copies that do not wait for the card.

A dispatch only enqueues work; these two helpers keep its copies from
bringing the wait back:

* ``upload`` puts a host array on a device.  A copy from pageable numpy
  memory returns only once it has happened, after the work already queued
  on the stream, so on a CUDA device the array is first staged in a pinned
  host tensor and copied with ``non_blocking=True``.  The pinned tensor
  goes into the caller's ``keep`` list, which the dispatch's future holds
  until collect.  The result is always a copy (on the CPU too), so a
  caller may reuse its buffer, and a re-run at collect reads the inputs
  the dispatch saw.
* ``HostCopy`` starts device tensors on their way to the host: on a CUDA
  device into pinned tensors with ``non_blocking=True`` and an event
  recorded behind the copies; ``wait()`` waits on that event alone (not
  on work enqueued later) and returns numpy arrays.  On the CPU the
  tensors are already on the host.

``Pending`` is one block of a dispatch in flight, enqueued on its device
under ``on_device``: its device result, the host copy started behind it,
and what a re-run at collect needs.

Counters (always on, named for ``utils.metrics.counters``):
``upload.bytes`` counts the bytes ``upload`` puts on a device and
``HostCopy.bytes`` those a ``HostCopy`` brings to the host (on the CPU the
same sizes, though nothing crosses a bus).  Spans: ``map.upload`` around
an upload, ``map.wait`` around a ``HostCopy``'s wait for its event.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Sequence

import numpy as np
import torch

from ..utils import metrics
from ..utils.metrics import span

_count_lock = threading.Lock()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def upload(a, device: torch.device, keep: list) -> torch.Tensor:
    """``a`` (a numpy array or a CPU tensor) as a new tensor on
    ``device``, copied without waiting for the device's queue."""
    with span("map.upload"):
        t = a if torch.is_tensor(a) else torch.from_numpy(
            np.ascontiguousarray(a))
        with _count_lock:
            upload.bytes += _nbytes(t)
        if device.type != "cuda":
            return t.to(device, copy=True)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        keep.append(host)
        return host.to(device, non_blocking=True)


upload.bytes = 0


class HostCopy:
    """Device tensors of one device, copied to the host behind the work
    that computes them."""

    bytes = 0

    def __init__(self, tensors: Sequence[torch.Tensor]):
        with _count_lock:
            HostCopy.bytes += sum(_nbytes(t) for t in tensors)
        self.event = None
        dev = tensors[0].device
        if dev.type != "cuda":
            self.host = list(tensors)
            return
        with torch.cuda.device(dev):
            self.host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            with span("map.wait"):
                self.event.synchronize()
        return [h.numpy() for h in self.host]


metrics.counter("upload.bytes", lambda: upload.bytes)
metrics.counter("host_copy.bytes", lambda: HostCopy.bytes)


def on_device(dev: torch.device):
    """The context that makes ``dev`` the current CUDA device (nothing on
    the CPU): a data shard's block is enqueued under it, on its card's
    current stream."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class Pending:
    """One block of a dispatch in flight.  ``run(*args)`` enqueues the
    block's work on ``device`` and returns the device result;
    ``fetch(result)`` starts its host copy (a ``HostCopy``).  ``lo`` is the
    global index of the block's first row.  ``run``, ``args`` (the budgets
    it ran at) and ``keep`` (its pinned uploads) stay with it for a re-run
    at collect."""

    def __init__(self, lo: int, device: torch.device, run, args: tuple,
                 keep: list, fetch):
        self.lo, self.device, self.run = lo, device, run
        self.keep, self.fetch = keep, fetch
        self._start(args)

    def _start(self, args: tuple):
        self.args = args
        with on_device(self.device):
            self.result = self.run(*args)
            self.host = self.fetch(self.result)

    def rerun(self, *args) -> List[np.ndarray]:
        """Run the block again at ``args`` and wait for its host copy."""
        self._start(args)
        return self.host.wait()
