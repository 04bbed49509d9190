"""Parity of the port's ``overlap`` command with the JAX package's, on the
CPU, on test_cli_golden.py's 48-read overlap fixture: stdout (PAF) and
stderr must be byte-identical in one round and in several rounds, with the
native and the Python final checks; a ``-checkpoint`` resume must give the
full run's stdout; ``collect_find_arrays``, which the native final check
reads, must agree with ``collect_find`` on the port's engine and with the
JAX overlapper's arrays (tolerance 0).
"""
import numpy as np
import pytest
import torch

import downpore_tpu_torch
from downpore_tpu.cli.main import main as jax_main
from downpore_tpu_torch.io import seqio as seqio_mod
from downpore_tpu.overlap import Overlapper as JaxOverlapper
from downpore_tpu_torch.cli.main import main as torch_main
from downpore_tpu_torch.overlap import Overlapper as TorchOverlapper
from test_torch_correct import overlap_records
from test_torch_overlap import round_setup
from test_torch_parallel import eight_cpus  # noqa: F401  (fixture)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reads_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_overlap_cli") / "reads.fasta"
    with open(p, "w") as f:
        for name, s in overlap_records():
            f.write(f">{name}\n{s}\n")
    return str(p)


@pytest.mark.parametrize("extra,final", [
    ([], "native"), (["-query_batch_size", "12"], "native"),
    (["-query_batch_size", "12"], "python")],
    ids=["one-round", "rounds", "rounds-python-final"])
def test_overlap_cli_matches_jax(capsys, monkeypatch, reads_path, extra,
                                 final):
    """Several rounds (``-query_batch_size 12``) also hold the port's
    engine, which sizes every round afresh, to the JAX command's
    cross-round shape plan."""
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    if final == "python":
        monkeypatch.setenv("DOWNPORE_TPU_PY_FINAL", "1")
    argv = ["overlap", "-input", reads_path] + extra
    jax_main(argv)
    ref = capsys.readouterr()
    torch_main(argv)
    got = capsys.readouterr()
    assert got.out == ref.out
    assert got.err == ref.err
    assert got.out.count("\n") >= 20
    rounds = got.err.count("Using query set")
    assert rounds >= (3 if extra else 1)


def test_overlap_checkpoint_resume(capsys, monkeypatch, reads_path,
                                   tmp_path):
    """test_cli_golden.py's interrupted run on the port: die after the
    first round's checkpoint save, resume, and get the full stdout."""
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    argv = ["overlap", "-input", reads_path, "-query_batch_size", "12"]
    torch_main(argv)
    full = capsys.readouterr().out
    ck = str(tmp_path / "ck.json")
    orig_save = seqio_mod.SequenceSet.save_state
    calls = {"n": 0}

    def save_then_die(self, path_, extra=None):
        orig_save(self, path_, extra)
        calls["n"] += 1
        if calls["n"] == 1:
            raise KeyboardInterrupt

    monkeypatch.setattr(seqio_mod.SequenceSet, "save_state", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        torch_main(argv + ["-checkpoint", ck])
    part1 = capsys.readouterr().out
    monkeypatch.setattr(seqio_mod.SequenceSet, "save_state", orig_save)
    torch_main(argv + ["-checkpoint", ck])
    resumed = capsys.readouterr()
    assert "Resuming from round 1" in resumed.err
    assert part1 and part1 + resumed.out == full


def test_help_overlap_matches_jax(capsys):
    jax_main(["help", "overlap"])
    ref = capsys.readouterr().out
    torch_main(["help", "overlap"])
    assert capsys.readouterr().out == ref
    assert "-checkpoint" in ref


def test_command_list_matches_jax_order(capsys):
    from downpore_tpu.cli.main import get_commands as jax_commands
    from downpore_tpu_torch.cli.main import get_commands
    ported = [c.name for c in get_commands()]
    assert ported == [c.name for c in jax_commands() if c.name in ported]
    assert "overlap" in ported


@pytest.mark.parametrize("flag", [["-data_parallel", "true"],
                                  ["-seed_shards", "2"]])
def test_overlap_cli_multi_device_matches_jax(capsys, monkeypatch,
                                              reads_path, eight_cpus, flag):
    """An 8 x 1 data grid and a 4 x 2 seed-sharded grid (8 CPU entries),
    several rounds: stdout and stderr equal the JAX CLI's."""
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    argv = ["overlap", "-input", reads_path, "-query_batch_size", "24"] \
        + flag
    jax_main(argv)
    ref = capsys.readouterr()
    torch_main(argv)
    got = capsys.readouterr()
    assert got.out == ref.out and got.err == ref.err
    assert got.out.count("\n") >= 20 and got.err.count("Using query set") >= 2


@pytest.fixture(scope="module")
def found():
    """One overlap round on each engine, dispatched and left uncollected:
    ``(overlapper, queries, futs)`` for the port and for the JAX package."""
    from test_torch_correct import overlap_sequences
    reads = overlap_sequences()
    tov, tq = round_setup(reads, TorchOverlapper, device="cpu")
    jov, jq = round_setup(reads, JaxOverlapper)
    return (tov, tq, tov.dispatch_find(tq)), (jov, jq, jov.dispatch_find(jq))


def test_collect_find_arrays_matches_collect_find(found):
    (ov, queries, futs), _ = found
    matches = ov.collect_find(queries, futs)
    qids, rcq, ia, ib, ma, mb, m_off = ov.collect_find_arrays(queries, futs)
    assert len(matches) == len(qids) >= 20
    seqs = ov.seq_objects(queries)
    for r, m in enumerate(matches):
        assert (qids[r], bool(rcq[r])) == (m.query_id, m.rc_query)
        assert seqs[ia[r]] is m.seq_a
        assert seqs[len(queries) + ib[r]] is m.seq_b
        assert ma[m_off[r]:m_off[r + 1]].tolist() == m.match_a
        assert mb[m_off[r]:m_off[r + 1]].tolist() == m.match_b


def test_collect_find_arrays_matches_jax(found):
    (ov, queries, futs), (jov, jq, jfuts) = found
    got = ov.collect_find_arrays(queries, futs)
    ref = jov.collect_find_arrays(jq, jfuts)
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
