"""Host milliseconds a batch in the mapper's query packing
(``MapEngine.pack_query_windows``), summed over the map's threads."""
from benchmark import read as r

HOOKS = [
    ("downpore_tpu_torch.ops.map_engine:MapEngine.pack_query_windows",
     "map.pack"),
]


def read(ctx):
    return r.span_ms_per_unit(ctx, "map.pack")
