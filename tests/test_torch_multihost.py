"""Two processes on one device grid (the port's counterpart of
test_multihost.py:83-133): two CPU processes joined by a ``gloo``
``torch.distributed`` group, each listing two CPU entries, so that
``make_mesh()`` spans 4 devices in rank order.  A real ``map_batch`` runs
data-parallel across them (each process dispatches the data shards on its
own entries, the collect all-gathers the rows) and must give, in both
processes, the PAF of the single-process run and of the JAX package's
mapper.  The k-mer histogram on that grid must equal the host bincount.
The workers run with ``jax`` and ``downpore_tpu`` blocked from import."""
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASE = r"""
import numpy as np
rng = np.random.default_rng(5)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
genome = BASES[rng.integers(0, 4, 30000)].tobytes().decode()
k = 8
reads = []
for i in range(16):
    p = int(rng.integers(0, len(genome) - 2500))
    arr = np.frombuffer(genome[p:p + 2400].encode(), np.uint8).copy()
    m = rng.random(len(arr)) < 0.03
    arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    reads.append(arr.tobytes().decode())
"""

WORKER = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["downpore_tpu"] = None
import torch
torch.set_num_threads(1)
import torch.distributed as dist
pid, port, expect_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=pid)
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.parallel import mesh as mesh_mod
from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values
CPU = torch.device("cpu")
mesh_mod.local_devices = lambda: [CPU, CPU]
CASE
ref = Sequence.from_string(genome, id=0, name="ref")
values = score_seed_values(kmer_occurrences([ref], k), k)
seqs = [Sequence.from_string(s, id=i, name=f"r{i}")
        for i, s in enumerate(reads)]

def paf(mapper):
    return [[mapper.as_string(m) for m in (maps or [])]
            for maps in mapper.map_batch(seqs)]

base = Mapper(ref, False, k, values, seed_rate=40, edge_size=1000,
              chunk_size=10000, device=CPU)
grid = mesh_mod.make_mesh()
assert dict(grid.shape) == {"data": 4, "seed": 1}, grid
assert grid.ranks.ravel().tolist() == [0, 0, 1, 1]
mp = Mapper(ref, False, k, values, seed_rate=40, edge_size=1000,
            chunk_size=10000, mesh=grid)
out = paf(mp)
assert sorted(mp.engine._shards) == [2 * pid, 2 * pid + 1]
assert out == paf(base), "multi-process output diverged"
assert out == json.load(open(expect_path)), "differs from the JAX mapper"
assert sum(len(x) for x in out) > 0, "no mappings produced"
hist = kmer_occurrences([ref] + seqs, 6, mesh=grid)
assert (hist == kmer_occurrences([ref] + seqs, 6)).all()
assert not any(m.split(".")[0] in ("jax", "downpore_tpu")
               for m, v in sys.modules.items() if v is not None)
dist.destroy_process_group()
print(f"proc {pid} OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_paf(path):
    """The JAX package's single-process PAF on the workers' case."""
    from downpore_tpu.core import Sequence
    from downpore_tpu.mapping import Mapper
    from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values
    scope = {}
    exec(CASE, scope)
    genome, k, reads = scope["genome"], scope["k"], scope["reads"]
    ref = Sequence.from_string(genome, id=0, name="ref")
    values = score_seed_values(kmer_occurrences([ref], k), k)
    mapper = Mapper(ref, False, k, values, seed_rate=40, edge_size=1000,
                    chunk_size=10000)
    seqs = [Sequence.from_string(s, id=i, name=f"r{i}")
            for i, s in enumerate(reads)]
    out = [[mapper.as_string(m) for m in (maps or [])]
           for maps in mapper.map_batch(seqs)]
    with open(path, "w") as f:
        json.dump(out, f)


def test_two_process_map_batch(tmp_path):
    expect = tmp_path / "expect.json"
    _jax_paf(expect)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("CASE", CASE))
    env = dict(os.environ, DOWNPORE_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(i), port,
                               str(expect)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True,
                              cwd=REPO)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
    assert np.all([len(o) for o in outs])
