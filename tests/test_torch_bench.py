"""The port's benchmark suite (``python -m downpore_tpu_torch.bench``) on
the CPU at toy sizes.

One subprocess, with ``jax`` and ``downpore_tpu`` blocked from import and
``DOWNPORE_TORCH_DEVICE=cpu``, runs all seven sections with the size
constants lowered: it must print the nine metric lines, each with
``"device": "cpu"``, and exit 0.  The ``map_gb`` and ``overlap_gb`` checks
get the JAX package's own results on the same toy inputs (its map
command's "Uniquely mapped" count, its overlap command's round lines and
PAF line count), so they pass only where the port's commands equal the
JAX ones.  In-process cases pin the exit codes: 2 for an unknown section,
non-zero when a section raises (the rest still run) or when ``map_gb`` or
``overlap_gb`` is given a wrong expected count, and a raise at start
without a card unless the caller asks for the CPU.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import downpore_tpu_torch.bench as bench
from downpore_tpu.cli.main import main as jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

METRICS = ["trim_reads_per_s", "map_bases_per_s", "map_1mb_bases_per_s",
           "map_chr20_bases_per_s", "overlap_bases_per_s",
           "consensus_bases_per_s", "trim_gb_scale_mb_per_s",
           "map_gb_mb_per_s", "overlap_gb_mb_per_s"]

TOY = dict(
    N_READS=48, READ_LEN=500, BATCH=48,
    MAP_CASES=tuple(c[:2] + toy + c[5:] for c, toy in zip(
        bench.MAP_CASES, [(50_000, 11, 12), (30_000, 11, 8),
                          (60_000, 13, 8)])),
    MAP_READ_LEN=(2000, 3000),
    OVERLAP_GENOME=25_000, OVERLAP_READS=30, OVERLAP_READ_LEN=(2000, 3000),
    CONSENSUS_JOBS=6, CONSENSUS_MEMBERS=4, CONSENSUS_CORE=50,
    CONSENSUS_ORACLE_JOBS=1, BAND_ROWS=64, BAND_REPS=10,
    TRIM_GB_READS=96, TRIM_GB_WARM=48, TRIM_GB_BATCH=48,
    MAP_GB_GENOME=50_000, MAP_GB_READS=30, MAP_GB_READ_LEN=3000,
    OV_GB_GENOME=20_000, OV_GB_READS=60, OV_GB_READ_LEN=2000)


def _jax_run(argv):
    """The JAX package's CLI on ``argv``: (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        jax_main(argv)
    return out.getvalue(), err.getvalue()


def _jax_expectations(tmp):
    """The JAX commands' results on the toy ``map_gb`` and ``overlap_gb``
    inputs, written by the bench's own generators into ``tmp`` (the bench
    reuses them): (uniquely mapped, overlap round lines, PAF lines)."""
    B = bench.BASES
    genome = B[np.random.default_rng(bench.SEED + 40).integers(
        0, 4, TOY["MAP_GB_GENOME"])]
    gpath, rpath = tmp / "g.fasta", str(tmp / "bench_map_gb_reads.fasta")
    gpath.write_text(">ref\n" + genome.tobytes().decode() + "\n")
    bench._make_genome_reads(rpath, genome, TOY["MAP_GB_READS"],
                             TOY["MAP_GB_READ_LEN"], 0.08, bench.SEED + 41)
    _, err = _jax_run(["map", "-input", rpath, "-reference", str(gpath),
                       "-circular", "false"])
    unique = [int(ln.split(":")[1]) for ln in err.splitlines()
              if ln.startswith("Uniquely mapped:")]
    genome = B[np.random.default_rng(bench.SEED + 50).integers(
        0, 4, TOY["OV_GB_GENOME"])]
    rpath = str(tmp / "bench_ov_gb_reads.fasta")
    bench._make_genome_reads(rpath, genome, TOY["OV_GB_READS"],
                             TOY["OV_GB_READ_LEN"], 0.05, bench.SEED + 51)
    out, err = _jax_run(["overlap", "-input", rpath])
    rounds = [ln for ln in err.splitlines()
              if ln.startswith(("Using query set", "Total "))]
    return unique[0], rounds, out.count("\n")


def test_bench_every_section_without_jax(tmp_path):
    unique, rounds, paf = _jax_expectations(tmp_path)
    assert unique == TOY["MAP_GB_READS"] and rounds and paf > 0
    consts = dict(TOY, MAP_GB_UNIQUE=unique, OV_GB_STDERR=rounds,
                  OV_GB_PAF_LINES=paf)
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['downpore_tpu'] = None; "
            "import torch; torch.set_num_threads(2); "
            "import downpore_tpu_torch.bench as b; "
            + "".join(f"b.{k} = {v!r}; " for k, v in consts.items())
            + "rc = b.main(); "
            "assert not any(m.split('.')[0] in ('jax', 'downpore_tpu') "
            "for m, v in sys.modules.items() if v is not None); "
            "sys.exit(rc)")
    running = tmp_path / "running.jsonl"
    env = dict(os.environ, DOWNPORE_TORCH_DEVICE="cpu", TMPDIR=str(tmp_path),
               BENCH_RUNNING_JSON=str(running),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    assert [r["metric"] for r in rows] == METRICS
    assert all(r["device"] == "cpu" and r["value"] > 0
               and r["vs_baseline"] >= 0 for r in rows)
    assert [json.loads(ln) for ln in running.read_text().splitlines()] \
        == rows
    err = proc.stderr
    for line in ("# device=cpu", "# overlap round kernel: dev+dispatch=",
                 f"Uniquely mapped: {unique}", "# suite total"):
        assert line in err, line
    assert "FAILED" not in err


def test_bench_unknown_section_exits_2(tmp_path):
    env = dict(os.environ, DOWNPORE_TORCH_DEVICE="cpu", TMPDIR=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "downpore_tpu_torch.bench", "trim", "mapp"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 2
    assert "unknown section(s) ['mapp']" in proc.stderr
    assert proc.stdout == ""


@pytest.fixture
def toy(monkeypatch, tmp_path):
    monkeypatch.setenv("DOWNPORE_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(bench.tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(bench, "RUNNING_JSON", str(tmp_path / "run.jsonl"))
    for k, v in TOY.items():
        monkeypatch.setattr(bench, k, v)


def test_bench_failing_section_exits_nonzero(toy, monkeypatch, capsys):
    """A raising section is noted, the next ones run, and the suite exits
    non-zero; so do wrong expected counts in map_gb and overlap_gb."""
    ran = []

    def boom(dev, label):
        raise ValueError("planted")

    monkeypatch.setattr(bench, "SECTIONS", [
        ("trim", boom), ("map", lambda dev, label: ran.append(label))])
    assert bench.main([]) == 1
    assert ran == ["cpu"]
    err = capsys.readouterr().err
    assert "# trim FAILED: ValueError: planted" in err
    assert "FAILED sections: ['trim']" in err
    monkeypatch.setattr(bench, "SECTIONS", [
        ("map_gb", bench.bench_map_gb), ("overlap_gb", bench.bench_overlap_gb)])
    monkeypatch.setattr(bench, "MAP_GB_UNIQUE", TOY["MAP_GB_READS"] + 1)
    monkeypatch.setattr(bench, "OV_GB_PAF_LINES", -1)
    monkeypatch.setattr(bench, "OV_GB_STDERR", [])
    assert bench.main(["map_gb", "overlap_gb"]) == 1
    out = capsys.readouterr()
    assert "map_gb FAILED: RuntimeError: map_gb: stderr lacks" in out.err
    assert "overlap_gb FAILED: RuntimeError: overlap_gb:" in out.err
    assert out.out == ""


def test_bench_needs_a_card_or_the_cpu(monkeypatch):
    """No card and no request for the CPU: the suite raises at start."""
    monkeypatch.delenv("DOWNPORE_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="DOWNPORE_TORCH_DEVICE=cpu"):
        bench.main(["trim"])
