"""Megabytes a batch copied between host and device: the growth of the
program's counters ``upload.bytes`` (``transfer.upload``) and
``host_copy.bytes`` (``transfer.HostCopy``) over the window's batches."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    b = p.counter_growth(ctx, ("upload.bytes", "host_copy.bytes"))
    return None if b is None or not ctx.units else b / 1e6 / ctx.units
