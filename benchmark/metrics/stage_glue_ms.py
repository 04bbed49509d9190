"""Host milliseconds a batch in the mapper's stage chain between device
stages: over the program's ``map.shard`` spans (one a shard thread,
``Mapper._map_batch_one``), the shard's time less its ``map.stage`` spans
(``Mapper.perform_mapping_batch``), summed over threads.  This is the
Python bookkeeping of the phases (sub-sequences, dominated mappings,
pairing, the split search's loop)."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    sh = p.shards(ctx)
    if sh is None:
        return None
    ns = sum((s.end - s.start) - sum(st.end - st.start for st in stages)
             for s, stages in sh)
    return ns / 1e6 / ctx.units
