"""Nanopore-shaped reads (``benchmark/ont.py``: a spread of lengths,
insertions and deletions, chimeras, random and junk reads) mapped on the
CPU at small sizes against a genome carrying the repeat families:
``Mapper.map_batch`` against the JAX package's ``Mapper``, byte for byte,
on the native route and the route without the library, on one and two
shard threads; and the counters of the short path and the later stages
(``map.short.reads``, ``map.next.windows``, ``map.split.rounds``,
``map.split.windows``) against what those stages did, with no update
lost across threads."""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from benchmark import generate, mixed, ont, run
from downpore_tpu.core import Sequence as JaxSequence
from downpore_tpu.mapping import Mapper as JaxMapper
from downpore_tpu_torch import native
from downpore_tpu_torch.core.sequence import Sequence
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.mapping.mapper import _StageCounts
from downpore_tpu_torch.utils import (kmer_occurrences, metrics,
                                      score_seed_values)

torch.set_num_threads(2)

CELL = "ont_repeats_64m_k13.map_ont"
SEED = 2**31 + 41
ES = 1000
COUNTERS = ("map.short.reads", "map.next.windows", "map.split.rounds",
            "map.split.windows")


def _config():
    """The cell's configuration at test size: a 300 kb genome, reads of a
    shorter spread (mean 4 kb) so that a batch of 40 holds every path, and
    more chimeras, random and junk reads than a batch of 40 would draw."""
    _, _, cfg, _ = run.cell_parts(run.manifest(), CELL)
    cfg = json.loads(json.dumps(cfg))
    cfg["genome_bases"] = 300_000
    cfg["reads"].update(length_mean=4000, length_sd=3500, chimera_share=0.1,
                        random_share=0.05, junk_share=0.05)
    return cfg


@pytest.fixture(scope="module")
def planted():
    """The genome, the port's mapper, the JAX package's on the same seed
    values, the reads drawn and the JAX package's lines for them."""
    cfg = _config()
    m = cfg["map"]
    g = mixed.genome(SEED, cfg)
    ref = Sequence.from_string(g.tobytes().decode(), id=0, name="g")
    values = score_seed_values(kmer_occurrences([ref], m["k"]), m["k"])
    args = (False, m["k"], values, m["seed_rate"], m["query_size"],
            m["chunk_size"])
    tm = Mapper(ref, *args, device="cpu")
    jm = JaxMapper(JaxSequence.from_string(g.tobytes().decode(), id=0,
                                           name="g"), *args)
    reads = ont.sample(generate.rng_for(SEED, "reads0"), g, 40,
                       cfg["reads"])
    texts = [s.tobytes().decode() for s in reads.seqs]
    jq = [JaxSequence.from_string(t, id=i, name=f"r{i}")
          for i, t in enumerate(texts)]
    want = [[jm.as_string(x) for x in ms] for ms in jm.map_batch(jq)]
    return tm, reads, texts, want


def _port_lines(tm, texts):
    tq = [Sequence.from_string(t, id=i, name=f"r{i}")
          for i, t in enumerate(texts)]
    return [[tm.as_string(x) for x in ms] for ms in tm.map_batch(tq)]


def test_reads_take_every_path(planted):
    _, reads, _, want = planted
    kinds = np.bincount(reads.kind, minlength=4)
    assert kinds[ont.CHIMERA] == 4 and kinds[ont.RANDOM] == 2 \
        and kinds[ont.JUNK] == 2
    assert (reads.length <= 2 * ES).sum() >= 3
    assert ((reads.length > 3 * ES) & (reads.length < 4 * ES)).sum() >= 2
    assert (reads.length > 6 * ES).sum() >= 3
    assert sum(bool(x) for x in want) >= 25


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("route", ["native", "python"])
def test_map_batch_matches_jax(planted, monkeypatch, route, shards):
    tm, _, texts, want = planted
    if route == "native" and native.load() is None:
        pytest.skip("no native toolchain")
    if route == "python":
        monkeypatch.setattr(native, "load", lambda: None)
    if shards == 2:
        monkeypatch.setattr(Mapper, "_SHARD_MIN", 8)
    assert _port_lines(tm, texts) == want


def test_stage_counters_count_what_the_stages_did(planted, monkeypatch):
    """On two shard threads, each counter grows by what the stages mapped:
    the short reads, mapNext's windows (``_map_cuts``' cuts), and the
    split search's rounds and windows (its ``_map_windows`` calls)."""
    tm, reads, texts, _ = planted
    monkeypatch.setattr(Mapper, "_SHARD_MIN", 8)
    lock = threading.Lock()
    done = dict.fromkeys(COUNTERS, 0)
    threads = set()
    local = threading.local()

    def tally(name, n):
        with lock:
            done[name] += n
            threads.add(threading.get_ident())

    cuts, windows, split = Mapper._map_cuts, Mapper._map_windows, \
        Mapper._split_stage

    def map_cuts(self, rds, cs):
        tally("map.next.windows", len(cs))
        return cuts(self, rds, cs)

    def map_windows(self, rds, starts, ends):
        if getattr(local, "split", False):
            tally("map.split.rounds", 1)
            tally("map.split.windows", len(rds))
        return windows(self, rds, starts, ends)

    def split_stage(self, *a):
        local.split = True
        try:
            return split(self, *a)
        finally:
            local.split = False
    monkeypatch.setattr(Mapper, "_map_cuts", map_cuts)
    monkeypatch.setattr(Mapper, "_map_windows", map_windows)
    monkeypatch.setattr(Mapper, "_split_stage", split_stage)
    before = metrics.counters()
    _port_lines(tm, texts)
    after = metrics.counters()
    grown = {n: after[n] - before[n] for n in COUNTERS}
    done["map.short.reads"] = int((reads.length <= 2 * ES).sum())
    assert grown == done
    assert all(v > 0 for v in grown.values()) and len(threads) == 2


def test_stage_counts_lose_no_update_across_threads():
    counts = _StageCounts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                counts.add("split_rounds", 1)
                counts.add("split_windows", 3)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert (counts.split_rounds, counts.split_windows) == (32000, 96000)
    assert counts.short_reads == counts.next_windows == 0
