"""downpore_tpu_torch — the PyTorch/CUDA port of ``downpore_tpu``.

The JAX package stays the reference: every module here mirrors the layout
and names of its ``downpore_tpu`` counterpart, runs plain torch on tensors
that live on an explicit ``device``, and replaces each Pallas kernel of
the ported path with a hand-written CUDA kernel for Hopper (``csrc/``).
The JAX-free host modules of ``downpore_tpu`` (core, io, seeds, native,
sim, align, cli.framework, utils.kmers, mapping.mapper, overlap,
consensus) are imported as they are; nothing in this package imports
``jax``.

Ported so far: the ``map`` command (flat and binned retrieval gates), the
``overlap`` command, and the ``correct`` command (overlap rounds and beam
consensus).
"""
from __future__ import annotations

import os

import torch

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
