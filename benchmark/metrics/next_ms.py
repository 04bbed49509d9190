"""Host milliseconds a batch in the mapper's mapNext stage: the program's
``map.next`` spans (``Mapper._map_next_stage``, two rounds of windows
stepped inward on the reads the ends phase left open), summed over the
shard threads."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    return p.ms_per_unit(ctx, "map.next")
