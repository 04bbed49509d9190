"""Windows a batch that the mapper's later stages map: the growth of the
program's counters ``map.next.windows`` (``Mapper._map_next_stage``'s two
rounds) and ``map.split.windows`` (``Mapper._split_stage``'s rounds) over
the window's batches.  None where the program does not count them."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    n = p.counter_growth(ctx, ("map.next.windows", "map.split.windows"))
    return None if n is None or not ctx.units else n / ctx.units
