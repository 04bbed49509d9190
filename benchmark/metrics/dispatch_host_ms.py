"""Mean host milliseconds of one call of the map engine's dispatch
(``MapEngine.dispatch_packed``: uploads and the graph replay).  Another
engine's dispatch is read by a file of its own,
``dispatch_host_ms.<kind>.py``."""
from benchmark import read as r

HOOKS = [
    ("downpore_tpu_torch.ops.map_engine:MapEngine.dispatch_packed",
     "map.dispatch"),
]


def read(ctx):
    return r.span_ms_per_call(ctx, "map.dispatch")
