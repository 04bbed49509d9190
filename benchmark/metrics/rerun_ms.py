"""Host milliseconds a batch in the map engine's re-runs at collect: the
program's ``map.rerun`` spans (``MapEngine._collect_block`` running a
block again at a grown pair budget or bin width), summed over threads.  0
where the window ran none."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    return p.ms_per_unit(ctx, "map.rerun")
