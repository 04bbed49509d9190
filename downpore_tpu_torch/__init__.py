"""downpore_tpu_torch — the PyTorch/CUDA port of ``downpore_tpu``.

The JAX package stays the reference: every module here mirrors the layout
and names of its ``downpore_tpu`` counterpart, runs plain torch on tensors
that live on an explicit ``device``, and replaces each Pallas kernel with
a hand-written CUDA kernel for Hopper (``csrc/``).  The package stands
alone: it imports neither ``jax`` nor anything of ``downpore_tpu``.  Its
host modules (core, io, seeds, align, overlap, consensus, data, utils,
cli, native with its own ``native/seqscan.cpp``) are its own copies; the
tests hold them and the torch engine against the JAX package on the same
inputs.

Ported: the ``trim``, ``map`` (flat and binned retrieval gates),
``overlap`` and ``correct`` commands, and the host commands ``subseq``,
``consensus``, ``align``, ``kmers`` and ``version``; their multi-device
paths run on a (data, seed) grid of torch devices (``parallel``).  Beside
them: the seed-query library (``ops.match`` retrieval counts,
``ops.chain.chain_batch`` and its wrappers, ``parallel``'s sharded
pipeline step), the read simulator (``sim``) and the benchmark suite
(``python -m downpore_tpu_torch.bench``).
"""
from __future__ import annotations

# glibc malloc tuning: in some environments, returning big buffers
# to the OS makes every fresh multi-hundred-MB numpy allocation re-fault
# its pages at ~90 us/page (measured: a 0.5 GB astype cost 12 s; the
# identical op on recycled pages 0.17 s).  Keeping large allocations on
# the heap and never trimming lets the allocator recycle mapped pages.
# Opt out with DOWNPORE_NO_MALLOPT=1.
import os as _os

if not _os.environ.get("DOWNPORE_NO_MALLOPT"):
    try:
        import ctypes as _ctypes
        _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
        _libc.mallopt(-4, 0)          # M_MMAP_MAX = 0
        _libc.mallopt(-1, 1 << 30)    # M_TRIM_THRESHOLD = never
    except Exception:
        pass


def _prefault_arena():
    """Populate a scratch arena once so batch pipelines never pay
    first-touch faults mid-run.

    User-space first-touch in such environments costs ~180 ms/MB
    (measured: 45 s for 256 MB), but the kernel populate path is ~500x
    faster: ``mlock`` faults the pages in-kernel in ~0.1 s/256 MB.  With
    the trim threshold above, the pages stay in the heap after free, so
    later large numpy buffers land on resident memory.  Size via
    DOWNPORE_PREFAULT_MB (default 768; 0 disables)."""
    try:
        mb = int(_os.environ.get("DOWNPORE_PREFAULT_MB", "768"))
    except ValueError:
        mb = 768
    if mb <= 0:
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.malloc.restype = ctypes.c_void_p
        n = mb << 20
        p = libc.malloc(n)
        if p:
            if libc.mlock(ctypes.c_void_p(p), n) == 0:
                libc.munlock(ctypes.c_void_p(p), n)
            else:  # mlock refused (rlimit): fall back to touching
                ctypes.memset(p, 0, n)
            libc.free(ctypes.c_void_p(p))
    except Exception:
        pass


_prefault_arena()

import os  # noqa: E402

import torch  # noqa: E402

__version__ = "0.1.0"

DEVICE_ENV = "DOWNPORE_TORCH_DEVICE"


def resolve_device(device=None) -> torch.device:
    """The torch device the port computes on.

    ``device`` wins when given; otherwise ``$DOWNPORE_TORCH_DEVICE``,
    default ``cuda``.  Asking for CUDA on a host without a usable card
    raises: the port never falls back to the CPU silently (set the
    variable to ``cpu`` to run the plain torch versions)."""
    if device is None:
        device = os.environ.get(DEVICE_ENV, "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; set {DEVICE_ENV}=cpu to run on the CPU")
    return dev
