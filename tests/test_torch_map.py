"""End-to-end parity of the torch port's ``map`` slice with the JAX
package, on the CPU: ``Mapper.map_batch`` on test_mapping.py's read cases,
and the ``map`` CLI on test_cli_golden.py's fixture.  Mappings must have
identical fields and the CLI's stdout must be byte-identical (tolerance 0).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from downpore_tpu.cli.main import main as jax_main
from downpore_tpu.core import Sequence
from downpore_tpu.mapping import Mapper as JaxMapper
from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values
import downpore_tpu_torch
from downpore_tpu_torch.cli.main import main as torch_main
from downpore_tpu_torch.mapping import Mapper as TorchMapper
from test_torch_parallel import eight_cpus  # noqa: F401  (fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = "ACGT"
K = 11


def rand_bases(n, rng):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def mutate_codes(codes, rate, rng):
    codes = codes.copy()
    mask = rng.random(len(codes)) < rate
    codes[mask] = (codes[mask] + rng.integers(1, 4, mask.sum())) % 4
    return codes


@pytest.fixture(scope="module")
def mappers():
    rng = np.random.default_rng(42)
    genome = Sequence.from_string(rand_bases(60000, rng), id=0, name="chr")
    values = score_seed_values(kmer_occurrences([genome], K), K)
    args = (genome, False, K, values, 40, 1000, 10000)
    return genome, JaxMapper(*args), TorchMapper(*args, device="cpu")


def make_read(case, genome):
    """The read cases of test_mapping.py:42-133."""
    rng = np.random.default_rng(7)
    g = genome.codes
    if case == "exact":
        return Sequence(g[20000:24000].copy(), id=1, name="r")
    if case == "noisy":
        return Sequence(mutate_codes(g[5000:9000], 0.08, rng), id=2,
                        name="noisy")
    if case == "rc":
        read = Sequence(g[30000:34000].copy(), id=3,
                        name="rcread").reverse_complement()
        read.offset = read.inset = 0
        return read
    if case == "short":
        return Sequence(g[10000:11500].copy(), id=4, name="short")
    if case == "chimeric":
        return Sequence(np.concatenate([g[2000:6000], g[40000:44000]]),
                        id=5, name="chimera")
    assert case == "unmappable"
    return Sequence.from_string(rand_bases(3000, np.random.default_rng(99)),
                                id=6, name="junk")


def fields(maps):
    return [(m.start, m.end, m.query_offset, m.query_inset, m.rc, m.ids)
            for m in maps]


@pytest.mark.parametrize("case", ["exact", "noisy", "rc", "short",
                                  "chimeric", "unmappable"])
def test_map_batch_matches_jax(mappers, case):
    genome, jm, tm = mappers
    read = make_read(case, genome)
    ref = jm.map_batch([read])[0]
    got = tm.map_batch([read])[0]
    assert fields(got) == fields(ref)
    assert [jm.as_string(m) for m in ref] == [tm.as_string(m) for m in got]
    if case == "unmappable":
        assert got == []
    else:
        assert got


def test_map_batch_many_reads_matches_jax(mappers):
    genome, jm, tm = mappers
    rng = np.random.default_rng(77)
    reads = []
    for i in range(16):
        start = int(rng.integers(0, 55000))
        ln = int(rng.integers(1500, 5000))
        codes = mutate_codes(genome.codes[start:start + ln], 0.08, rng)
        read = Sequence(codes, id=i, name=f"m{i}")
        if i % 2:
            read = read.reverse_complement()
            read.offset = read.inset = 0
        reads.append(read)
    ref = [fields(ms) for ms in jm.map_batch(reads)]
    got = [fields(ms) for ms in tm.map_batch(reads)]
    assert got == ref
    assert sum(1 for ms in got if ms) >= 14


_RC = str.maketrans("ACGT", "TGCA")


def _cli_mutate(rng, s, rate):
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


@pytest.fixture(scope="module")
def cli_fixture(tmp_path_factory):
    """The map fixture of test_cli_golden.py:49-91."""
    d = tmp_path_factory.mktemp("torch_cli")
    genome = rand_bases(30000, np.random.default_rng(11))
    gpath = d / "genome.fasta"
    gpath.write_text(f">genome\n{genome}\n")
    rng = np.random.default_rng(12)
    rpath = d / "reads.fasta"
    with open(rpath, "w") as f:
        for i in range(24):
            pos = int(rng.integers(0, len(genome) - 2000))
            s = _cli_mutate(rng, genome[pos:pos + 2000], 0.03)
            if i % 3 == 2:
                s = s.translate(_RC)[::-1]
            f.write(f">r{i}\n{s}\n")
    return ["map", "-input", str(rpath), "-reference", str(gpath),
            "-circular", "false"]


def test_map_cli_matches_jax(capsys, monkeypatch, cli_fixture):
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    jax_main(cli_fixture)
    ref = capsys.readouterr()
    torch_main(cli_fixture)
    got = capsys.readouterr()
    assert got.out == ref.out
    assert got.err == ref.err
    assert len(got.out.splitlines()) >= 24


def test_help_map_matches_jax(capsys):
    jax_main(["help", "map"])
    ref = capsys.readouterr().out
    torch_main(["help", "map"])
    assert without_profile_flag(capsys.readouterr().out) == ref
    assert "-data_parallel" in ref


def without_profile_flag(help_map: str) -> str:
    """The port's ``help map`` without its last line, the ``-profile DIR``
    flag the port's map command adds to the JAX command's (trim's flag,
    with trim's help text); that line is checked here."""
    head, last = help_map.rstrip("\n").rsplit("\n", 1)
    assert last.split()[:2] == ["-profile", "-p"]
    assert last.split()[2:] == ("Directory to write a JAX profiler trace "
                                "to (default:)").split()
    return head + "\n"


def _host_command_inputs(tmp, genome_path):
    """Small inputs of the host commands: reads of the map fixture's
    genome with their SAM alignment (``kmers``, k = 4, test_cli_golden.py's
    recipe), 8 mutated copies of a 300-base template (``consensus`` and
    ``align``) and two named sequences with ``subseq`` queries on stdin.
    Returns (argv lists, stdin text)."""
    genome = genome_path.read_text().split("\n")[1]
    rng = np.random.default_rng(15)
    reads, sam = tmp / "kreads.fastq", tmp / "kreads.sam"
    with open(reads, "w") as fr, open(sam, "w") as fs:
        fs.write("@HD\tVN:1.6\n")
        for i in range(20):
            pos = int(rng.integers(0, len(genome) - 600))
            s = genome[pos:pos + 600]
            fr.write(f"@kr{i}\n{s}\n+\n{'F' * len(s)}\n")
            fs.write(f"kr{i}\t0\tgenome\t{pos + 1}\t60\t600M\t*\t0\t0"
                     f"\t{s}\t{'F' * len(s)}\n")
    template = rand_bases(300, rng)
    copies = tmp / "copies.fasta"
    copies.write_text("".join(f">c{i}\n{_cli_mutate(rng, template, 0.03)}\n"
                              for i in range(8)))
    subs = tmp / "subs.fasta"
    subs.write_text(f">alpha one\n{rand_bases(500, rng)}\n"
                    f">beta\n{rand_bases(400, rng)}\n")
    stdin = ("10 20 false alpha\n10 20 true alpha\n390 10 false alpha\n"
             "0 5 false beta\n0 5 false gamma\n")
    return ([["help", "trim"], ["version"],
             ["kmers", "-input", str(reads), "-alignment", str(sam),
              "-reference", str(genome_path), "-k", "4"],
             ["subseq", "-input", str(subs)],
             ["consensus", "-input", str(copies), "-k", "5"],
             ["align", "-input", str(copies), "-k", "5"]], stdin)


def test_map_without_jax_subprocess(capsys, monkeypatch, cli_fixture,
                                   tmp_path):
    """The port runs with jax and the JAX package blocked from import:
    sys.modules["jax"] = sys.modules["downpore_tpu"] = None makes any
    ``import jax`` or ``import downpore_tpu...`` raise.  One process runs
    all nine commands: ``map``, ``map -data_parallel true`` (a 1 x 1 grid
    in the port), then ``overlap`` and ``correct`` (on the
    first 24 reads of test_torch_correct.py's overlap fixture), ``trim``
    (on test_trim_golden.py's fixture), ``help``, ``version``, ``kmers``,
    ``subseq`` (queries on stdin), ``consensus`` and ``align``.  Its
    stdout, and the seed values ``kmers`` writes, must be byte-identical
    to the JAX CLI's on the same inputs."""
    import io
    from test_torch_correct import overlap_records
    from test_torch_trim import golden_records, write_reads
    reads = tmp_path / "correct.fasta"
    reads.write_text("".join(f">{n}\n{s}\n"
                             for n, s in overlap_records()[:24]))
    trim = ["trim", "-input", write_reads(tmp_path / "trim.fastq",
                                          golden_records(), fastq=True)]
    runs = [cli_fixture, cli_fixture + ["-data_parallel", "true"],
            ["overlap", "-input", str(reads)],
            ["correct", "-input", str(reads)], trim]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    genome = type(tmp_path)(cli_fixture[4])
    host_jax, stdin = _host_command_inputs(jax_dir, genome)
    host_port, _ = _host_command_inputs(port_dir, genome)
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    for argv in runs + host_jax:
        jax_main(argv)
    expect = capsys.readouterr().out
    assert expect.count("_corrected") >= 1
    assert expect.count("\t255\n") > 24
    assert "\n@chimera_(left)\n" in expect
    assert "gamma not found in" in expect
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['downpore_tpu'] = None; "
            "import torch; torch.set_num_threads(2); "
            "from downpore_tpu_torch.cli.main import main; "
            f"[main(a) for a in {runs + host_port!r}]; "
            "assert not any(m.split('.')[0] in ('jax', 'downpore_tpu') "
            "for m, v in sys.modules.items() if v is not None)")
    env = dict(os.environ, DOWNPORE_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300,
                          input=stdin)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == expect.replace(str(jax_dir), str(port_dir))
    kmer_values = "kreads.sam_kmers_4.txt"
    assert (port_dir / kmer_values).read_text() \
        == (jax_dir / kmer_values).read_text()


@pytest.mark.parametrize("flag", [["-data_parallel", "true"],
                                  ["-seed_shards", "2"]])
def test_map_cli_multi_device_matches_jax(capsys, monkeypatch, cli_fixture,
                                          eight_cpus, flag):
    """An 8 x 1 data grid and a 4 x 2 seed-sharded grid (8 CPU entries, the
    JAX meshes' shapes): stdout and stderr equal the JAX CLI's."""
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    jax_main(cli_fixture + flag)
    ref = capsys.readouterr()
    torch_main(cli_fixture + flag)
    got = capsys.readouterr()
    assert got.out == ref.out
    assert got.err == ref.err
    assert len(got.out.splitlines()) >= 24


def test_map_cli_seed_shards_on_one_device_raises_like_jax(monkeypatch,
                                                         cli_fixture):
    """On one device ``-seed_shards 2`` raises the JAX mesh's ValueError."""
    import re
    import jax
    from downpore_tpu.parallel.mesh import make_mesh
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    with pytest.raises(ValueError) as ref:
        make_mesh(n_seed=2, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        torch_main(cli_fixture + ["-seed_shards", "2"])


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        downpore_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        downpore_tpu_torch.resolve_device("cuda:0")
    monkeypatch.setenv(downpore_tpu_torch.DEVICE_ENV, "cpu")
    assert downpore_tpu_torch.resolve_device().type == "cpu"
    monkeypatch.delenv(downpore_tpu_torch.DEVICE_ENV)
    with pytest.raises(RuntimeError):
        downpore_tpu_torch.resolve_device()


def _load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_imports_only_the_port():
    """The smoke script reaches the host helpers through the port, never
    through the JAX package or jax itself, and the port's host helpers
    are its own copies, not the JAX package's objects."""
    from downpore_tpu_torch.core import Sequence as PortSequence
    from downpore_tpu_torch.utils import kmer_occurrences as port_occ
    names = _load_chip_smoke().own_imports()
    assert "downpore_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "downpore_tpu"}
    assert PortSequence is not Sequence and port_occ is not kmer_occurrences
    assert PortSequence.__module__ == "downpore_tpu_torch.core.sequence"
    assert port_occ.__module__ == "downpore_tpu_torch.utils.kmers"


_A = np.arange(6, dtype=np.int32).reshape(2, 3)


@pytest.mark.parametrize("a,b,same", [
    ((_A, [1, None]), (_A.copy(), [1, None]), True),
    ({"v": _A, "n": 3}, {"v": _A.copy(), "n": 3}, True),
    (_A, _A.astype(np.int64), False),            # dtype
    (_A, _A.reshape(3, 2), False),               # shape
    (_A, np.where(_A == 5, -3, _A), False),      # one value
    ((_A,), [_A], False),                        # tuple against list
    ({"v": _A}, {"w": _A}, False),               # keys
    ([_A, _A], [_A], False),                     # length
], ids=["nested", "dict", "dtype", "shape", "value", "container", "keys",
        "length"])
def test_chip_smoke_same_tells_outputs_apart(a, b, same):
    """``phase_graphs`` holds replayed outputs to eager ones with
    ``chip_smoke._same``: equal only where every array's dtype, shape and
    values, and every container's type, length and keys agree."""
    smoke = _load_chip_smoke()
    assert smoke._same(a, b) is same and smoke._same(b, a) is same


def test_chip_smoke_without_a_card_fails_without_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs one CUDA card" in proc.stderr
