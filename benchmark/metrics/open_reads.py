"""Long reads a batch that the ends phase hands on open to the later
stages: the growth of the program's counter ``map.ends.open_reads``
(``Mapper._pair_ends_native``) over the window's batches."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    n = p.counter_growth(ctx, ("map.ends.open_reads",))
    return None if n is None or not ctx.units else n / ctx.units
