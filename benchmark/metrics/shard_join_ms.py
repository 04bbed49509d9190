"""Host milliseconds a batch the mapper's first shard thread waits for the
second: the program's ``map.join`` spans (the ``fut.result()`` of
``Mapper.map_batch``), the imbalance between the two shards.  0 where no
batch was split (fewer reads than ``Mapper._SHARD_MIN``)."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    return p.ms_per_unit(ctx, "map.join")
