"""Host milliseconds a batch blocked on the card: the program's
``map.wait`` spans (``transfer.HostCopy.wait`` waiting for its copy's
event, inside the engine's collect), summed over threads.  0 where the
window ran no such wait (the CPU, whose tensors are already on the
host)."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    return p.ms_per_unit(ctx, "map.wait")
