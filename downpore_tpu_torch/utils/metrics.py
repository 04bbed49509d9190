"""Stage timing and the ``-profile DIR`` trace of the port's commands.

``StageTimer`` accumulates wall seconds and item counts per named stage
and reports them on stderr.  ``start_profiler`` / ``stop_profiler``
capture a ``torch.profiler`` trace: a Chrome trace, ``DIR/trace.json``, with device activity when the
command computes on a CUDA card."""
from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates (wall seconds, item count) per named stage."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: Dict[str, list] = {}

    @contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.time()
        try:
            yield self
        finally:
            dt = time.time() - t0
            acc = self.stages.setdefault(name, [0.0, 0])
            acc[0] += dt
            acc[1] += items

    def add_items(self, name: str, items: int):
        acc = self.stages.setdefault(name, [0.0, 0])
        acc[1] += items

    def report(self, out=None):
        if out is None:
            out = sys.stderr  # resolved at call time (testable)
        if not self.enabled or not self.stages:
            return
        for name, (secs, items) in self.stages.items():
            rate = f"  ({items / secs:.1f}/s)" if items and secs > 0 else ""
            count = f"  {items} items" if items else ""
            print(f"[stage] {name}: {secs:.2f}s{count}{rate}", file=out)


_active: Optional[tuple] = None   # (profiler, trace dir)


def start_profiler(trace_dir: str, device: torch.device):
    """Begin a ``torch.profiler`` capture of the host and ``device``."""
    global _active
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _active = (prof, trace_dir)


def stop_profiler():
    """End the capture and write ``trace.json`` into its directory."""
    global _active
    if _active is None:
        return
    prof, trace_dir = _active
    _active = None
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    print(f"[profile] trace written to {trace_dir}", file=sys.stderr)


__all__ = ["StageTimer", "start_profiler", "stop_profiler"]
