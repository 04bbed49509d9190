"""Milliseconds a batch the mapper's shard threads are off the CPU: over
the program's ``map.shard`` spans, wall time less the thread's CPU time,
summed over threads (waits for the interpreter lock, the graph cache's
lock, events and copies)."""
from benchmark import program as p

HOOKS = []
p.trace()


def read(ctx):
    sh = p.shards(ctx)
    if sh is None or any(s.cpu_ns is None for s, _ in sh):
        return None
    return sum((s.end - s.start) - s.cpu_ns for s, _ in sh) / 1e6 \
        / ctx.units
