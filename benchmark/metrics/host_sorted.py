"""Host-ordered pairs a read: the growth of the program's counter
``map.collect.host_sorted`` (``MapEngine.host_sorted``: the pairs of the
query rows that a binned map block's piece boundaries split, which its
collect orders on the host; the card orders the rest) over the window's
batches, over the reads of the window's units.  None where the program
does not count them."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    n = p.counter_growth(ctx, ("map.collect.host_sorted",))
    if n is None or not ctx.units:
        return None
    return n / (ctx.units * ctx.traffic["batch_reads"])
