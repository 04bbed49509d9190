"""Re-runs at collect a unit: the growth of the driver's ``reruns``
counter (the engine's own, all causes) over the window."""
from benchmark import read as r

HOOKS = []


def read(ctx):
    return r.counter_per_unit(ctx, "reruns")
