"""Map passes of two trees of the port in turns on one card.

    mkdir -p _chipcopy/a && git archive <commit> | tar -x -C _chipcopy/a
    mkdir -p _chipcopy/b && git archive HEAD | tar -x -C _chipcopy/b
    python3 scripts/ab_map.py _chipcopy/a _chipcopy/b [--turns 6]

Each turn is one process in one tree (turns a, b, b, a, a, b, ...): the
tree's ``chip_smoke.make_case`` map case (8192 reads of 6-10 kb against a
4.6 Mb genome), two warm-up ``Mapper.map_batch`` passes (a tree with CUDA
graphs captures its dispatches' graphs there, at the JAX budgets and then
at the budgets the counts settled), then 8 timed ``map_batch`` passes
(two threads) and 4 ``_map_batch_one`` passes (one thread), each ended by
a device synchronize.  Prints one JSON line a turn (the pass seconds, and
for a tree with ``ops/captured.py`` the graphs captured during the timed
passes) and the median of each tree's turn medians.
"""
import argparse
import json
import statistics
import subprocess
import sys

CODE = r'''
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from downpore_tpu_torch.core import Sequence
from downpore_tpu_torch.mapping import Mapper
from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values
dev = torch.device("cuda")
genome, reads, truth = cs.make_case(cs.N_READS, cs.GENOME)
ref = Sequence.from_string(genome, id=0, name="ref")
values = score_seed_values(kmer_occurrences([ref], cs.K), cs.K)
m = Mapper(ref, False, cs.K, values, seed_rate=40, edge_size=1000,
           chunk_size=10000, device=dev)
try:
    from downpore_tpu_torch.ops import captured
    keys = lambda: len(captured.GRAPHS.entries)
except ImportError:
    keys = lambda: 0
for _ in range(2):
    m.map_batch(reads)
    torch.cuda.synchronize()
k0 = keys()
two, one = [], []
for _ in range(8):
    t = time.perf_counter()
    m.map_batch(reads)
    torch.cuda.synchronize()
    two.append(time.perf_counter() - t)
for _ in range(4):
    t = time.perf_counter()
    m._map_batch_one(reads)
    torch.cuda.synchronize()
    one.append(time.perf_counter() - t)
print(json.dumps({"two_threads_s": two, "one_thread_s": one,
                  "captures_in_timed": keys() - k0}))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--turns", type=int, default=6)
    args = ap.parse_args()
    trees = {"a": args.tree_a, "b": args.tree_b}
    order = ("abba" * args.turns)[:args.turns]
    medians = {"a": [], "b": []}
    for i, t in enumerate(order):
        p = subprocess.run([sys.executable, "-c", CODE], cwd=trees[t],
                           capture_output=True, text=True, timeout=600)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode or not lines:
            print(p.stderr[-2000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1])
        medians[t].append(statistics.median(res["two_threads_s"]))
        print(json.dumps({"turn": i, "tree": t, **res}), flush=True)
    for t, ms in medians.items():
        print(f"{t}: turn medians of map_batch {ms}, median "
              f"{statistics.median(ms):.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
