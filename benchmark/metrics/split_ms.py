"""Host milliseconds a batch in the mapper's chimera split search: the
program's ``map.split`` spans (``Mapper._split_stage``, a binary search
for a split point on each read still open after mapNext), summed over the
shard threads."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    return p.ms_per_unit(ctx, "map.split")
