"""The port's tracer (``downpore_tpu_torch.utils.metrics``) on the CPU.

Off, a span reads no clock and opens no profiler range, and nothing is
kept.  On, spans nest by thread and take an explicit parent across the
map's shard thread; a ``Mapper.map_batch`` of two shards gives the span
tree the mapper, engine and copies define; the copy counters count the
bytes of the tensors copied; ``StageTimer`` keeps its report; and the map
command's ``-profile DIR`` writes a Chrome trace holding the spans of both
shard threads.
"""
import io
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

from downpore_tpu_torch.cli.main import main as torch_main
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.ops import captured, transfer
from downpore_tpu_torch.utils import kmer_occurrences, metrics, \
    score_seed_values

torch.set_num_threads(2)

K = 11
# parent of each span of a map batch (the card adds graph.replay and
# graph.capture under map.dispatch or map.rerun, and map.wait under
# map.collect or map.rerun)
PARENTS = {
    "map.batch": (None,),
    "map.shard": ("map.batch",),
    "map.join": ("map.batch",),
    "map.short": ("map.shard",),
    "map.ends": ("map.shard",),
    "map.next": ("map.shard",),
    "map.split": ("map.shard",),
    "map.pair": ("map.ends",),
    "map.stage": ("map.short", "map.ends", "map.next", "map.split"),
    "map.pack": ("map.stage",),
    "map.dispatch": ("map.stage",),
    "map.collect": ("map.stage",),
    "map.walk": ("map.stage",),
    "map.upload": ("map.dispatch",),
    "map.rerun": ("map.collect",),
}


@pytest.fixture
def tracing():
    metrics.enable()
    try:
        yield
    finally:
        metrics.disable()


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(42)
    return Sequence(rng.integers(0, 4, 60000).astype(np.uint8), id=0,
                    name="chr")


@pytest.fixture(scope="module")
def mapper(genome):
    values = score_seed_values(kmer_occurrences([genome], K), K)
    return Mapper(genome, False, K, values, 40, 1000, 10000, device="cpu")


def batch_reads(genome, n=8):
    """``n`` reads of 1.5-6 kb at 8% substitutions, every second one
    reverse-complemented, and a chimera: short reads, both ends, mapNext
    and the split search all get work."""
    rng = np.random.default_rng(77)
    g = genome.codes
    reads = []
    for i in range(n):
        start = int(rng.integers(0, 53000))
        codes = g[start:start + int(rng.integers(1500, 6000))].copy()
        hit = rng.random(len(codes)) < 0.08
        codes[hit] = (codes[hit] + rng.integers(1, 4, hit.sum())) % 4
        read = Sequence(codes, id=i, name=f"r{i}")
        if i % 2:
            read = read.reverse_complement()
            read.offset = read.inset = 0
        reads.append(read)
    reads.append(Sequence(np.concatenate([g[2000:6000], g[40000:44000]]),
                          id=n, name="chimera"))
    return reads


def fail(*a, **kw):
    raise AssertionError("called with tracing off")


@pytest.mark.parametrize("shards", [1, 2])
def test_off_reads_no_clock_and_opens_no_range(monkeypatch, mapper, genome,
                                               shards):
    reads = batch_reads(genome)
    if shards == 2:
        monkeypatch.setattr(Mapper, "_SHARD_MIN", 4)
    ref = [[mapper.as_string(m) for m in ms]
           for ms in mapper.map_batch(reads)]
    metrics.enable()
    metrics.disable()
    for name in ("perf_counter_ns", "thread_time_ns"):
        monkeypatch.setattr(time, name, fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fail)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [[mapper.as_string(m) for m in ms]
               for ms in mapper.map_batch(reads)]
    assert got == ref
    assert metrics.spans() == {}


def test_spans_nest_and_take_parents_across_threads(tracing):
    metrics.counter("test.calls", lambda: 7)
    with metrics.span("a", counts=True) as a:
        with metrics.span("b") as b:
            pass
        box = {}

        def worker():
            with metrics.span("w", parent=a, cpu=True) as w:
                with metrics.span("x") as x:
                    box.update(w=w, x=x)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    w, x = box["w"], box["x"]
    assert a.parent == 0 and b.parent == a.id
    assert w.parent == a.id and x.parent == w.id
    assert w.tid != a.tid == b.tid and x.tid == w.tid
    assert a.start <= b.start <= b.end <= a.end
    assert w.cpu_ns is not None and 0 <= w.cpu_ns
    assert a.cpu_ns is None and b.counts is None
    assert a.counts[0]["test.calls"] == a.counts[1]["test.calls"] == 7
    by_thread = metrics.spans()
    assert [s.name for s in by_thread[a.tid]] == ["b", "a"]
    assert [s.name for s in by_thread[w.tid]] == ["x", "w"]


def _tree(by_thread):
    """(spans by id, children names by parent id)."""
    every = {s.id: s for ss in by_thread.values() for s in ss}
    kids = {}
    for s in every.values():
        kids.setdefault(s.parent, []).append(s.name)
    return every, kids


@pytest.mark.parametrize("budget", [0, 2])
def test_map_batch_span_tree(monkeypatch, mapper, genome, budget, tracing):
    """Two shards (``_SHARD_MIN`` lowered); ``budget`` 2 forces every
    block's re-run at collect."""
    monkeypatch.setattr(Mapper, "_SHARD_MIN", 4)
    if budget:
        monkeypatch.setattr(mapper.engine, "_map_budget",
                            lambda route, MB: budget)
    mapper.map_batch(batch_reads(genome))
    every, kids = _tree(metrics.spans())
    names = [s.name for s in every.values()]
    assert set(names) <= set(PARENTS)
    for s in every.values():
        parent = every[s.parent].name if s.parent else None
        assert parent in PARENTS[s.name], (s.name, parent)
        if parent is not None:
            p = every[s.parent]
            assert p.start <= s.start <= s.end <= p.end or p.tid != s.tid
    (batch,) = [s for s in every.values() if s.name == "map.batch"]
    assert sorted(kids[batch.id]) == ["map.join", "map.shard", "map.shard"]
    shards = [s for s in every.values() if s.name == "map.shard"]
    assert len({s.tid for s in shards}) == 2
    for s in shards:
        assert sorted(kids[s.id]) == ["map.ends", "map.next", "map.short",
                                      "map.split"]
        assert s.cpu_ns is not None
    for name in ("map.stage", "map.pack", "map.dispatch", "map.collect",
                 "map.walk", "map.upload"):
        assert names.count(name) >= 2, name
    assert ("map.rerun" in names) == bool(budget)
    # every span of the batch lies under the batch span
    for s in every.values():
        top = s
        while top.parent:
            top = every[top.parent]
        assert top is batch


@pytest.mark.parametrize("arrays", [
    [np.arange(12, dtype=np.int32).reshape(3, 4)],
    [np.zeros((5, 7), np.int64), np.ones(9, np.int16), np.ones(3, bool)],
])
def test_copy_counters_count_the_bytes_copied(arrays, tracing):
    up0, back0 = transfer.upload.bytes, transfer.HostCopy.bytes
    with metrics.span("copies", counts=True) as s:
        keep = []
        dev = [transfer.upload(a, torch.device("cpu"), keep)
               for a in arrays]
        transfer.HostCopy(dev).wait()
    size = sum(a.nbytes for a in arrays)
    assert transfer.upload.bytes - up0 == size
    assert transfer.HostCopy.bytes - back0 == size
    c0, c1 = s.counts
    assert c1["upload.bytes"] - c0["upload.bytes"] == size
    assert c1["host_copy.bytes"] - c0["host_copy.bytes"] == size
    assert c1["graph.captures"] == c0["graph.captures"] \
        == captured.GRAPHS.captures


@pytest.mark.parametrize("on", [False, True])
def test_stage_timer_report_keeps_its_format(on):
    metrics.enable()    # a new, empty recording
    if not on:
        metrics.disable()
    try:
        timer = metrics.StageTimer()
        with timer.stage("trim", items=3):
            time.sleep(0.01)
        with timer.stage("write"):
            pass
        timer.add_items("trim:edges", 5)
    finally:
        metrics.disable()
    out = io.StringIO()
    timer.report(out)
    lines = out.getvalue().splitlines()
    assert re.fullmatch(r"\[stage\] trim: \d+\.\d\ds  3 items  "
                        r"\(\d+\.\d/s\)", lines[0])
    assert re.fullmatch(r"\[stage\] write: \d+\.\d\ds", lines[1])
    assert lines[2] == "[stage] trim:edges: 0.00s  5 items"
    assert timer.stages["trim"][0] >= 0.01
    kept = [s.name for ss in metrics.spans().values() for s in ss]
    assert kept == (["trim", "write"] if on else [])
    silent = io.StringIO()
    metrics.StageTimer(enabled=False).report(silent)
    assert silent.getvalue() == ""


def test_map_command_profile_writes_its_spans(monkeypatch, tmp_path,
                                              genome, capsys):
    monkeypatch.setenv("DOWNPORE_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(Mapper, "_SHARD_MIN", 4)
    gpath, rpath = tmp_path / "genome.fasta", tmp_path / "reads.fasta"
    gpath.write_text(f">chr\n{genome}\n")
    rpath.write_text("".join(f">{r.get_name()}\n{r}\n"
                             for r in batch_reads(genome)))
    argv = ["map", "-input", str(rpath), "-reference", str(gpath),
            "-circular", "false"]
    torch_main(argv)
    ref = capsys.readouterr()
    torch_main(argv + ["-profile", str(tmp_path / "prof")])
    got = capsys.readouterr()
    assert got.out == ref.out and got.out.count("\n") >= 8
    assert "[profile] trace written to" in got.err
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {}
    for e in events["traceEvents"]:
        if e.get("cat") in ("cpu_op", "program_span"):
            names.setdefault(e["name"], []).append(e)
    for name in ("map.batch", "map.shard", "map.stage", "map.parse_wait",
                 "map.write"):
        assert name in names, name
    # the second shard's thread is not the profiler's: its spans are
    # added to the file, beside the first shard's ranges
    assert sorted(e["cat"] for e in names["map.shard"]) == \
        ["cpu_op", "program_span"]
    (batch,) = names["map.batch"]
    for e in names["map.shard"]:
        assert batch["ts"] <= e["ts"] + 1e3
        assert e["ts"] + e["dur"] <= batch["ts"] + batch["dur"] + 1e3
    assert metrics.spans() and not metrics._on


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# the card's spans, beside PARENTS: a graph's capture or replay in a
# dispatch or a re-run, the wait for a host copy in a collect or a re-run
CARD = {"graph.capture": ("map.dispatch", "map.rerun"),
        "graph.replay": ("map.dispatch", "map.rerun"),
        "map.wait": ("map.collect", "map.rerun")}


@pytest.mark.cuda
def test_card_map_batch_spans(monkeypatch, genome, cuda_device, tracing):
    """The first batch captures each shape (``graph.capture``, counted by
    ``GRAPHS.captures``), the second replays them (``graph.replay``); both
    wait for their host copies (``map.wait``)."""
    monkeypatch.setattr(Mapper, "_SHARD_MIN", 4)
    values = score_seed_values(kmer_occurrences([genome], K), K)
    m = Mapper(genome, False, K, values, 40, 1000, 10000,
               device=cuda_device)
    reads = batch_reads(genome)
    names = []
    for _ in range(2):
        c0 = captured.GRAPHS.captures
        metrics.disable()
        metrics.enable()
        m.map_batch(reads)
        every, _ = _tree(metrics.spans())
        for s in every.values():
            parent = every[s.parent].name if s.parent else None
            assert parent in {**PARENTS, **CARD}[s.name], (s.name, parent)
        names.append([s.name for s in every.values()])
        assert names[-1].count("graph.capture") \
            == captured.GRAPHS.captures - c0
    assert names[0].count("graph.capture") > 0
    assert "graph.capture" not in names[1] and "graph.replay" in names[1]
    assert all(n.count("map.wait") >= 2 for n in names)


@pytest.mark.cuda
def test_card_profile_holds_spans_and_kernels(tmp_path, genome, cuda_device):
    values = score_seed_values(kmer_occurrences([genome], K), K)
    m = Mapper(genome, False, K, values, 40, 1000, 10000,
               device=cuda_device)
    reads = batch_reads(genome)
    m.map_batch(reads)
    metrics.start_profiler(str(tmp_path), cuda_device)
    try:
        m.map_batch(reads)
        torch.cuda.synchronize()
    finally:
        metrics.stop_profiler()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {}
    for e in events:
        cats.setdefault(e.get("cat"), set()).add(e.get("name"))
    assert {"map.batch", "map.shard", "map.stage", "map.dispatch",
            "graph.replay", "map.wait"} <= cats["cpu_op"]
    assert cats.get("kernel")
