"""End-to-end parity of the torch port's ``correct`` command with the JAX
package, on the CPU: stdout (the corrected fasta) and stderr must be
byte-identical on test_cli_golden.py's 48-read overlap fixture, with the
beam-consensus engine (the default), the host engine, and a model table
measure (tolerance 0).
"""
import numpy as np
import pytest
import torch

import downpore_tpu_torch
from downpore_tpu.cli.main import main as jax_main
from downpore_tpu.core import Sequence
from downpore_tpu_torch.cli.main import main as torch_main
from downpore_tpu_torch.ops import cuda_beam
from test_torch_parallel import eight_cpus  # noqa: F401  (fixture)

torch.set_num_threads(2)

BASES = "ACGT"


def _mutate(rng, s, rate):
    """test_cli_golden.py's error model: half deletions, a quarter
    mismatches, a quarter insertions."""
    out = []
    for c in s:
        r = rng.random()
        if r < rate * 0.5:
            continue
        if r < rate * 0.75:
            out.append(BASES[rng.integers(0, 4)])
        elif r < rate:
            out.append(c)
            out.append(BASES[rng.integers(0, 4)])
        else:
            out.append(c)
    return "".join(out)


def overlap_records():
    """The overlap fixture of test_cli_golden.py:109-126: 48 reads of
    2.5-5 kb from a 40 kb genome at ~2% error, as (name, bases)."""
    rng = np.random.default_rng(22)
    G = 40000
    genome = "".join(BASES[i] for i in rng.integers(0, 4, G))
    out = []
    for i in range(48):
        L = int(rng.integers(2500, 5000))
        pos = int(rng.integers(0, G - L))
        out.append((f"cr{i}.{pos}.{pos + L}",
                    _mutate(rng, genome[pos:pos + L], 0.02)))
    return out


def overlap_sequences():
    return [Sequence.from_string(s, id=i, name=n)
            for i, (n, s) in enumerate(overlap_records())]


@pytest.fixture(scope="module")
def reads_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_correct") / "reads.fasta"
    with open(p, "w") as f:
        for name, s in overlap_records():
            f.write(f">{name}\n{s}\n")
    return str(p)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """A k = 5 current-level model file with seeded random levels."""
    rng = np.random.default_rng(8)
    p = tmp_path_factory.mktemp("torch_model") / "model.txt"
    with open(p, "w") as f:
        for v in range(4 ** 5):
            km = "".join(BASES[(v >> (2 * (4 - i))) & 3] for i in range(5))
            f.write(f"{km}\t{rng.uniform(60.0, 120.0):.3f}\n")
    return str(p)


@pytest.mark.parametrize("extra", [[], ["-device_consensus", "false"],
                                   ["-model", "MODEL"]],
                         ids=["device", "host", "model"])
def test_correct_cli_matches_jax(capsys, monkeypatch, reads_path,
                                 model_path, extra):
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    argv = ["correct", "-input", reads_path] + [
        model_path if a == "MODEL" else a for a in extra]
    jax_main(argv)
    ref = capsys.readouterr()
    torch_main(argv)
    got = capsys.readouterr()
    assert got.out == ref.out
    assert got.err == ref.err
    assert got.out.count(">") >= 3


def test_correct_device_failure_falls_back_like_jax(capsys, monkeypatch,
                                                   reads_path):
    """A device consensus that raises: both CLIs print the JAX command's
    fallback line, rerun the host landmark engine and give the same
    stdout, stderr and exit code."""
    import downpore_tpu.consensus as jax_consensus
    import downpore_tpu_torch.consensus as torch_consensus

    def fail(*a, **kw):
        raise RuntimeError("device lost")
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    monkeypatch.setattr(jax_consensus, "build_consensus_bulk", fail)
    monkeypatch.setattr(torch_consensus, "build_consensus_bulk", fail)
    argv = ["correct", "-input", reads_path]
    ref_rc = jax_main(argv)
    ref = capsys.readouterr()
    got_rc = torch_main(argv)
    got = capsys.readouterr()
    line = ("Device consensus failed (device lost); falling back to the "
            "host engine.")
    assert line in ref.err.splitlines()
    assert (got.out, got.err, got_rc) == (ref.out, ref.err, ref_rc)
    # the fallback's output is the host engine's
    torch_main(argv + ["-device_consensus", "false"])
    assert capsys.readouterr().out == got.out and got.out.count(">") >= 3


def test_correct_plain_path_launches_no_kernel(capsys, monkeypatch,
                                               reads_path):
    """On the CPU the beam scan is the plain version: no kernel launch."""
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    before = cuda_beam.beam_consensus.launches
    calls = []
    orig = cuda_beam.beam_consensus_plain
    monkeypatch.setattr(cuda_beam, "beam_consensus_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    torch_main(["correct", "-input", reads_path])
    assert capsys.readouterr().out.count(">") >= 3
    assert calls and cuda_beam.beam_consensus.launches == before


def test_help_correct_matches_jax(capsys):
    jax_main(["help", "correct"])
    ref = capsys.readouterr().out
    torch_main(["help", "correct"])
    assert capsys.readouterr().out == ref
    assert "-device_consensus" in ref


def test_correct_cli_data_parallel_matches_jax(capsys, monkeypatch,
                                               reads_path, eight_cpus):
    """``-data_parallel true`` on an 8-way data grid (8 CPU entries): the
    k-mer counts and the overlap rounds run on the grid, the consensus
    unsharded; stdout and stderr equal the JAX CLI's."""
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    argv = ["correct", "-input", reads_path, "-data_parallel", "true"]
    jax_main(argv)
    ref = capsys.readouterr()
    torch_main(argv)
    got = capsys.readouterr()
    assert got.out == ref.out and got.err == ref.err
    assert got.out.count(">") >= 3
