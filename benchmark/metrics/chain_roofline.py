"""The chain scan (``ops/cuda_chain.py``) kernel's share of its
roofline in the traced window: the sum of the bounds of the window's
launches of it (``benchmark/bounds.py`` on each unit's launches,
``trace.Work``) over the device time of its kernels in the window's trace,
in percent."""
from benchmark import read as r

HOOKS = []


def read(ctx):
    return r.roofline_pct(ctx, "chain")
