"""End-to-end parity of the torch port's trim path with the JAX package, on
the CPU: the ``Trimmer`` (edge trim, middle split, mutated adapters, no
false positives, require_pairs, DetermineAdapters, the bundled set), the
golden digest of test_trim_golden.py, a checkpoint resume, a middle pass
with several window dispatches pending, the ``trim`` CLI (stdout, every
demultiplexed file, stderr) and ``correct -trim 1``.  Outputs must be
byte-identical (tolerance 0).  Also: the CLI's command list, ``help`` of
all nine commands and ``version`` equal the JAX CLI's.
"""
import hashlib
import io
import os

import numpy as np
import pytest
import torch

import downpore_tpu_torch
from downpore_tpu.cli.main import main as jax_main
from downpore_tpu.core import Sequence
from downpore_tpu.data import BACK_ADAPTERS, FRONT_ADAPTERS
from downpore_tpu.io import SequenceSet
from downpore_tpu.trim import trimmer as jtrim
from downpore_tpu_torch.cli.main import main as torch_main
from downpore_tpu_torch.trim import trimmer as ttrim
from test_torch_map import without_profile_flag
from test_torch_parallel import eight_cpus  # noqa: F401  (fixture)

torch.set_num_threads(2)

BASES = "ACGT"
FRONT_AD = ("SQK-NSK007-Y", "AATGTACTTCGTTCAGTTACGTATTGCT")
BACK_AD = ("SQK-NSK007-Y", "GCAATACGTAACTGAACGAAGT")
# test_trim_golden.py's recorded digest of the JAX package's output
GOLDEN_DIGEST = \
    "b7ef415758ba165151d66f047f59093b027d5e2299db656ac5ad23266ca27399"
COMMANDS = ["trim", "map", "overlap", "subseq", "consensus", "align",
            "correct", "kmers", "version"]


def rand_bases(n, rng):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def mutate(s, rate, rng):
    """test_trim.py's substitution model (always a different base)."""
    lut = {"A": "CGT", "C": "AGT", "G": "ACT", "T": "ACG"}
    return "".join(lut[c][rng.integers(0, 3)] if rng.random() < rate else c
                   for c in s)


def write_reads(path, records, fastq=False):
    with open(path, "w") as f:
        for name, s in records:
            if fastq:
                f.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
            else:
                f.write(f">{name}\n{s}\n")
    return str(path)


def as_seqs(records):
    return [Sequence.from_string(s, id=i, name=n)
            for i, (n, s) in enumerate(records)]


# -- test_trim.py's cases ---------------------------------------------------
def case_reads(name, rng):
    """(records, adapters (front, back), trim params, determine args)."""
    single = ([FRONT_AD], [BACK_AD])
    params = (85, 5, 50, 1000, True, False, False)
    if name == "edge_and_split":
        left, right = rand_bases(1200, rng), rand_bases(1300, rng)
        recs = [FRONT_AD[1] + rand_bases(800, rng) + BACK_AD[1],
                rand_bases(900, rng), left + FRONT_AD[1] + right,
                FRONT_AD[1] + rand_bases(700, rng)]
        return list(enumerate(recs)), single, params, None
    if name == "mutated":
        recs = [mutate(FRONT_AD[1], 0.1, rng) + rand_bases(600, rng)
                for _ in range(20)]
        return list(enumerate(recs)), single, params, None
    if name == "clean":
        return [(i, rand_bases(800, rng)) for i in range(20)], single, \
            params, None
    if name == "require_pairs":
        return [(0, FRONT_AD[1] + rand_bases(700, rng))], single, \
            (85, 5, 50, 1000, True, True, True), None
    if name == "determine":
        recs = [FRONT_AD[1] + rand_bases(600, rng) for _ in range(30)]
        return list(enumerate(recs)), (FRONT_ADAPTERS[:20],
                                       BACK_ADAPTERS[:20]), params, (30, 90)
    # the bundled set, no determine step: barcode precedence and ties
    recs = []
    for i in range(24):
        _, f = FRONT_ADAPTERS[10 + (i % 6) * 3]
        _, b = BACK_ADAPTERS[10 + (i % 6) * 3]
        recs.append(mutate(f, 0.03, rng) + rand_bases(900, rng)
                    + mutate(b, 0.03, rng))
    recs.append(rand_bases(1400, rng) + FRONT_ADAPTERS[20][1]
                + rand_bases(1300, rng))
    return list(enumerate(recs)), (FRONT_ADAPTERS, BACK_ADAPTERS), \
        (85, 5, 50, 1000, True, True, False), None


def run_trimmer(mod, path, adapters, params, determine, **kw):
    """Trim ``path`` with ``mod``'s Trimmer; returns the written reads and
    the adapter tallies."""
    extra = {"device": "cpu"} if mod is ttrim else {}
    t = mod.Trimmer(as_seqs(adapters[0]), as_seqs(adapters[1]), k=6,
                    verbosity=0, **extra)
    ss = SequenceSet(path, min_length=50)
    if determine:
        t.determine_adapters(ss, *determine)
    t.set_trim_params(*params)
    t.trim(ss, **kw)
    out = io.StringIO()
    ss.write(out, True)
    return out.getvalue(), (t.front_counts, t.back_counts, t.no_count,
                            t.seen_count)


@pytest.mark.parametrize("case", ["edge_and_split", "mutated", "clean",
                                  "require_pairs", "determine", "bundled"])
def test_trimmer_matches_jax(tmp_path, case):
    recs, adapters, params, determine = case_reads(
        case, np.random.default_rng(123))
    path = write_reads(tmp_path / "reads.fasta",
                       [(f"read{i}", s) for i, s in recs])
    ref = run_trimmer(jtrim, path, adapters, params, determine)
    got = run_trimmer(ttrim, path, adapters, params, determine)
    assert got == ref
    if case == "edge_and_split":
        assert "read2_(left)" in got[0] and "read2_(right)" in got[0]
    if case == "bundled":
        assert got[0].count("Barcode") >= 20 and "_(left)" in got[0]


# -- the golden fixture -----------------------------------------------------
def golden_records():
    """test_trim_golden.py's fixture (rng 9, recipe at :16-42)."""
    rng = np.random.default_rng(9)
    front, back = FRONT_AD[1], BACK_AD[1]

    def rb(n):
        return "".join(BASES[i] for i in rng.integers(0, 4, n))

    def mut(s, r=0.08):
        return "".join(BASES[rng.integers(0, 4)] if rng.random() < r else c
                       for c in s)

    recs = []
    for i in range(30):
        core = rb(int(rng.integers(600, 1200)))
        recs.append((f"read{i}", mut(front) + core + mut(back)))
    recs.append(("chimera", rb(1500) + front + rb(1600)))
    recs.append(("clean", rb(900)))
    return recs


@pytest.fixture(scope="module")
def golden_path(tmp_path_factory):
    return write_reads(tmp_path_factory.mktemp("golden") / "reads.fastq",
                       golden_records(), fastq=True)


def test_golden_digest(golden_path):
    trimmer = ttrim.load_trimmer("", "", 6, verbosity=0, device="cpu")
    seq_set = SequenceSet(golden_path, min_length=50)
    trimmer.determine_adapters(seq_set, 10000, 90)
    trimmer.set_trim_params(85, 5, 50, 1000, True, True, False)
    trimmer.trim(seq_set)
    out = io.StringIO()
    seq_set.write(out, True)
    assert hashlib.sha256(out.getvalue().encode()).hexdigest() \
        == GOLDEN_DIGEST


def test_middle_stream_small_batches_match(golden_path):
    """Windows dispatched 8 at a time (several dispatches pending) give
    the middle pass of the default batch, and the JAX package's."""
    params = (85, 5, 50, 1000, True, True, False)

    def run(mod, window_batch):
        extra = {"device": "cpu"} if mod is ttrim else {}
        t = mod.load_trimmer("", "", 6, verbosity=0, **extra)
        ss = SequenceSet(golden_path, min_length=50)
        t.set_trim_params(*params)
        t._middle_pass(ss, window_batch)
        out = io.StringIO()
        ss.write(out, True)
        return out.getvalue()

    small = run(ttrim, 8)
    assert small == run(ttrim, None) == run(jtrim, None)
    assert "chimera_(left)" in small


def test_checkpoint_resume_matches(tmp_path):
    """test_seqio.py's resume pattern: the middle pass dies once after the
    edge pass; a fresh trimmer resumes from the snapshot."""
    rng = np.random.default_rng(4)
    path = write_reads(tmp_path / "reads.fastq",
                       [(f"read{i}", FRONT_AD[1] + rand_bases(700, rng))
                        for i in range(12)], fastq=True)

    def run(mod, checkpoint=None, interrupt=False):
        extra = {"device": "cpu"} if mod is ttrim else {}
        t = mod.load_trimmer("", "", 6, verbosity=0, **extra)
        ss = SequenceSet(path, min_length=50)
        if interrupt:
            orig = type(t)._middle_pass

            def boom(self, seqs, **kw):
                raise KeyboardInterrupt
            type(t)._middle_pass = boom
            try:
                with pytest.raises(KeyboardInterrupt):
                    t.trim(ss, batch_size=4, checkpoint=checkpoint)
            finally:
                type(t)._middle_pass = orig
            return None
        t.trim(ss, batch_size=4, checkpoint=checkpoint)
        out = io.StringIO()
        ss.write(out, True)
        return out.getvalue()

    expected = run(ttrim)
    ck = str(tmp_path / "trim.json")
    run(ttrim, checkpoint=ck, interrupt=True)
    assert os.path.exists(ck)
    assert run(ttrim, checkpoint=ck) == expected == run(jtrim)


# -- the CLI ---------------------------------------------------------------
@pytest.fixture(scope="module")
def cli_reads(tmp_path_factory):
    """Barcoded reads (three bundled barcodes, front and back), the golden
    fixture's adapter reads, a chimera and a clean read, as fastq."""
    rng = np.random.default_rng(31)
    recs = []
    for i in range(18):
        j = 10 + (i % 3) * 4
        recs.append((f"bc{i}", mutate(FRONT_ADAPTERS[j][1], 0.02, rng)
                     + rand_bases(int(rng.integers(700, 1100)), rng)
                     + mutate(BACK_ADAPTERS[j][1], 0.02, rng)))
    recs += golden_records()
    return write_reads(tmp_path_factory.mktemp("cli") / "reads.fastq",
                       recs, fastq=True)


def strip_stage(err):
    return "".join(ln for ln in err.splitlines(True)
                   if not ln.startswith("[stage]"))


@pytest.mark.parametrize("flags", [
    [], ["-determine_adapters", "false", "-verbosity", "0"],
    ["-tag_adapters", "false"], ["-discard_middle", "true"],
    ["-demultiplex", "DIR"]],
    ids=["default", "no_determine", "untagged", "discard_middle",
         "demultiplex"])
def test_trim_cli_matches_jax(capsys, monkeypatch, tmp_path, cli_reads,
                              flags):
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    outs = []
    for main, tag in ((jax_main, "jax"), (torch_main, "torch")):
        d = tmp_path / tag
        d.mkdir()
        main(["trim", "-input", cli_reads]
             + [str(d) if f == "DIR" else f for f in flags])
        cap = capsys.readouterr()
        files = {p: (d / p).read_text() for p in sorted(os.listdir(d))}
        outs.append((cap.out, cap.err, files))
    (out, err, files), (t_out, t_err, t_files) = outs
    assert t_out == out and t_files == files
    if "-verbosity" in flags:
        assert t_err == err and "[stage]" not in err
    else:
        assert strip_stage(t_err) == strip_stage(err)
        assert "[stage] trim" in t_err
    if "-demultiplex" in flags:
        assert len(t_files) == 3 and not t_out
        assert all(v.count("\n@") >= 4 for v in t_files.values())
    else:
        assert t_out.count("\n+\n") >= 40


def test_trim_cli_profile_writes_a_trace(capsys, monkeypatch, tmp_path,
                                         golden_path):
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    d = tmp_path / "trace"
    torch_main(["trim", "-input", golden_path, "-profile", str(d),
                "-verbosity", "0"])
    err = capsys.readouterr().err
    assert f"[profile] trace written to {d}\n" in err
    assert os.path.getsize(d / "trace.json") > 0


def test_trim_cli_data_parallel_matches_jax(capsys, monkeypatch,
                                            golden_path, eight_cpus):
    """``-data_parallel true`` on an 8-way data grid (8 CPU entries) over
    the golden fixture: stdout and stderr equal the JAX CLI's."""
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    argv = ["trim", "-input", golden_path, "-data_parallel", "true"]
    jax_main(argv)
    ref = capsys.readouterr()
    torch_main(argv)
    got = capsys.readouterr()
    assert got.out == ref.out
    assert strip_stage(got.err) == strip_stage(ref.err)
    assert "chimera_(left)" in got.out


def test_correct_trim_matches_jax(capsys, monkeypatch, tmp_path):
    """``correct -trim 1`` (bundled adapters at k = 5) on
    test_torch_correct.py's 48-read fixture with the first bundled front
    and back adapters at the ends of each read: the trim cuts them, and the
    trimmed reads yield consensus on both sides."""
    from test_torch_correct import overlap_records
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    path = write_reads(tmp_path / "reads.fasta",
                       [(n, FRONT_ADAPTERS[0][1] + s + BACK_ADAPTERS[0][1])
                        for n, s in overlap_records()])
    argv = ["correct", "-input", path, "-trim", "1"]
    jax_main(argv)
    ref = capsys.readouterr()
    torch_main(argv)
    got = capsys.readouterr()
    assert got.out == ref.out and got.err == ref.err
    assert "Trimming ends" in got.err and "Front adapter: " in got.err
    assert "% with no adapters found.\nQuery ids are" in got.err
    assert got.out.count(">") >= 1 and "_corrected\n" in got.out


def test_command_list_matches_jax(capsys):
    jax_main([])
    ref = capsys.readouterr().out
    torch_main([])
    assert capsys.readouterr().out == ref
    assert ref.split()[-9:] == COMMANDS


@pytest.mark.parametrize("command", COMMANDS)
def test_help_matches_jax(capsys, command):
    jax_main(["help", command])
    ref = capsys.readouterr().out
    torch_main(["help", command])
    got = capsys.readouterr().out
    if command == "map":
        got = without_profile_flag(got)
    assert got == ref
    assert command == "version" or ref.startswith("-")


def test_version_matches_jax(capsys):
    jax_main(["version"])
    ref = capsys.readouterr().out
    torch_main(["version"])
    assert capsys.readouterr().out == ref
    assert ref.startswith("downpore-tpu version ")
