"""Each cell driven on the CPU at test size: the port judged by its plain
reference (``correct`` true), the last line's keys, and ``correct`` false
under the control and under each fault the cell can have."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import faults, run

from .conftest import SMALL, small

CELLS = sorted(SMALL)
MAN = run.manifest()


def _run(name, trace=False, seed=2**31 + 11):
    cfg, trf = small(name)
    return run.run_cell(name, seed, 0.05, trace, "cpu", config=cfg,
                        traffic=trf, man=MAN)


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    line = run.result_line(res, "cpu", 1)
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e, _ = run.metrics_of(MAN, name)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_its_host_metrics(name):
    res = _run(name, trace=True)
    assert res["correct"]
    _, layer = run.metrics_of(MAN, name)
    spans = [m["name"] for m in layer if m["source"] == "program_span"]
    assert spans and set(spans) <= set(res["metrics"])
    # device metrics are left out where no device was traced
    assert not any("roofline" in n or "idle" in n for n in res["metrics"])


@pytest.mark.parametrize("plant", ["forward_strand_only", "half_query_seeds",
                                   "half_left_out", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_are_not_correct(name, plant):
    with faults.plant(plant):
        res = _run(name)
    assert not res["correct"], (plant, res["checks"])


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "random_4m6_k11.map", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_cell_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "no.such",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "random_4m6_k11.map", "--seed", str(2**31 + 3), "--seconds", "2",
         "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def test_without_the_program_no_result(tmp_path):
    import shutil
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "random_4m6_k11.map", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_reference_judges_each_rule():
    from benchmark.reference import map as ref
    fw = "r\t8000\t10\t7990\t+\tg\t100000\t5010\t12990\t40\t7980\t255"
    rc = "r\t8000\t10\t7990\t-\tg\t100000\t5010\t12990\t40\t7980\t255"
    assert ref.judge_line(fw, "r", 8000, 5000, False, "g", 100000)
    assert ref.judge_line(rc, "r", 8000, 5000, True, "g", 100000)
    bad = [fw.replace("5010", "5011"), fw.replace("+", "-"),
           fw.replace("7980", "7981"), fw.replace("\t255", "\t60"),
           fw.replace("\t40\t", "\t0\t"), fw.replace("r\t", "s\t", 1),
           fw.replace("100000", "99999"), fw + "\textra"]
    for line in bad:
        assert not ref.judge_line(line, "r", 8000, 5000, False, "g",
                                  100000), line
    assert not ref.judge_line(rc, "r", 8000, 5001, True, "g", 100000)
    assert ref.judge([[fw], [], [fw, rc]], ["r"] * 3, [8000] * 3,
                     [5000] * 3, [False] * 3, "g", 100000) == 2


@pytest.mark.parametrize("name", CELLS)
def test_reference_seeds_are_the_programs(name):
    """The reference works the seed set out again from the genome alone;
    at test size it is the program's, k-mer for k-mer."""
    from downpore_tpu_torch.core.sequence import Sequence
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    from benchmark import generate
    from benchmark.reference import map as ref
    cfg, _ = small(name)
    m = cfg["map"]
    g = generate.genome(2**31 + 5, cfg["genome_bases"])
    seq = Sequence.from_string(g.tobytes().decode(), id=0, name="g")
    values = score_seed_values(kmer_occurrences([seq], m["k"]), m["k"])
    mapper = Mapper(seq, m["circular"], m["k"], values, m["seed_rate"],
                    m["query_size"], m["chunk_size"], device="cpu")
    seeds = ref.Seeds(g, m["k"], m["seed_rate"], m["chunk_size"],
                      m["query_size"], m["circular"])
    assert (seeds.table == mapper.index.kmer_table).all()
    spans = {(s.offset, cfg["genome_bases"] - s.inset)
             for s in mapper.index.sequences}
    want = {tuple(x) for x in seeds.spans.tolist()}
    # the program adds one more chunk on a circular genome: its two ends
    assert want <= spans
    assert len(spans) - len(want) == int(m["circular"])
