"""The metrics read from the program's own spans and counters
(``benchmark/program.py``), on the CPU at test size: a traced run reports
all six, and the hooked metrics that time the same calls as the program's
``map.pack``, ``map.walk`` and ``map.dispatch`` spans read what those
spans read, with the program's tracer on."""
import pytest

from benchmark import program, run

from .conftest import SMALL, small

CELLS = sorted(SMALL)
MAN = run.manifest()
PROGRAM = ["stage_glue_ms.map", "collect_wait_ms.map", "shard_join_ms.map",
           "shard_offcpu_ms.map", "copy_mb.map", "graph_captures.map"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_programs_spans(monkeypatch, name):
    seen = []
    window = program.window

    def keep(ctx):
        seen.append(ctx)
        return window(ctx)
    monkeypatch.setattr(program, "window", keep)
    cfg, trf = small(name)
    res = run.run_cell(name, 2**31 + 29, 0.05, True, "cpu", config=cfg,
                       traffic=trf, man=MAN)
    assert res["correct"]
    got = {n: v["value"] for n, v in res["metrics"].items()}
    _, layer = run.metrics_of(MAN, name)
    host = {m["name"] for m in layer if m["source"] != "device_trace"}
    assert set(PROGRAM) <= host <= set(got)
    assert got["stage_glue_ms.map"] > 0 and got["shard_offcpu_ms.map"] > -1
    assert got["copy_mb.map"] > 0
    # the CPU: no graph, no wait for a copy; batches below the shard size
    assert got["graph_captures.map"] == 0
    assert got["collect_wait_ms.map"] == 0
    assert got["shard_join_ms.map"] == 0
    ctx = seen[0]
    assert all(c is ctx for c in seen) and ctx.program
    spans = ctx.program
    assert sum(s.name == "map.batch" for s in spans) == ctx.units
    # a hook wraps the method that opens the span: it reads a little more
    for metric, span, per_call in (("pack_ms.map", "map.pack", False),
                                   ("walk_ms.map", "map.walk", False),
                                   ("dispatch_host_ms.map", "map.dispatch",
                                    True)):
        ms = [(s.end - s.start) / 1e6 for s in spans if s.name == span]
        own = sum(ms) / (len(ms) if per_call else ctx.units)
        assert own <= got[metric] <= own * 1.05 + 0.05, metric


def test_without_a_tracer_every_reader_is_silent(monkeypatch):
    monkeypatch.setattr(program, "_tracer", lambda: None)
    program.trace()

    class Ctx:
        window, units = (0.0, 1.0), 3
    for m in PROGRAM:
        assert run.reader(m).read(Ctx()) is None
