"""CUDA graph captures a batch in the window: the growth of the program's
counter ``graph.captures`` (``captured.GRAPHS.captures``) over the
window's batches.  Each capture synchronises the card and empties the
allocator's cache; once the warm pass has captured every shape it reads
0."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    n = p.counter_growth(ctx, ("graph.captures",))
    return None if n is None or not ctx.units else n / ctx.units
