"""Rounds a batch of the mapper's chimera split search: the growth of the
program's counter ``map.split.rounds`` (``Mapper._split_stage``: one
pack, dispatch and collect of the windows of the reads still searching)
over the window's batches, shard threads summed.  None where the program
does not count them."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    n = p.counter_growth(ctx, ("map.split.rounds",))
    return None if n is None or not ctx.units else n / ctx.units
