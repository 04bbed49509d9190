"""Gate pairs a read: the growth of the program's counter
``map.gate.pairs`` (``MapEngine.gate_pairs``: the passing count each map
block's collect ends on, after its re-runs) over the window's batches,
over the reads of the window's units.  None where the program does not
count them."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    n = p.counter_growth(ctx, ("map.gate.pairs",))
    if n is None or not ctx.units:
        return None
    return n / (ctx.units * ctx.traffic["batch_reads"])
