"""Host milliseconds a batch in the mapper's candidate walk
(``Mapper._walk_candidates``), summed over the map's threads."""
from benchmark import read as r

HOOKS = [
    ("downpore_tpu_torch.mapping.mapper:Mapper._walk_candidates",
     "map.walk"),
]


def read(ctx):
    return r.span_ms_per_unit(ctx, "map.walk")
