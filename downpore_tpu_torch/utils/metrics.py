"""Stage timing and the ``-profile DIR`` trace of the port's commands.

``StageTimer`` is ``downpore_tpu.utils.metrics``'s (JAX-free host code).
``start_profiler`` / ``stop_profiler`` keep that module's names and
messages, with ``torch.profiler`` in place of ``jax.profiler``: the trace
is a Chrome trace, ``DIR/trace.json``, with device activity when the
command computes on a CUDA card."""
from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from downpore_tpu.utils.metrics import StageTimer

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
