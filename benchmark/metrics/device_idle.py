"""The device's idle share of the traced window: 1 - (union of its kernels,
copies and sets) / window, in percent."""
from benchmark import read as r

HOOKS = []


def read(ctx):
    return r.idle_pct(ctx)
