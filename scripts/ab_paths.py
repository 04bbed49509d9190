"""Run two trees of the port in turns on one card and compare them: the
map, overlap and trim paths end to end, and the chain DP through each
tree's own entry points.

    mkdir -p _chipcopy/a && git archive <commit> | tar -x -C _chipcopy/a
    python3 scripts/ab_paths.py _chipcopy/a _chipcopy/b [--rounds 3]

Each turn is one process that imports one tree (its
``downpore_tpu_torch`` and its ``chip_smoke.py``) and runs on the card:

* the chain DP on the inputs of this script's ``chip_smoke.CHAIN_SHAPES``
  (the same recipe and seed for both trees) through the tree's own entry
  points: ``ops.cuda_chain.chain_scan`` (forward), ``ops.chain.
  dp_from_anchors`` (fb: forward and backward, with whatever launches and
  copies the tree makes for it) and ``ops.chain.dp_forward_lean`` (lean).
  A time is that of the whole call on the card (CUDA events over 20 calls,
  the smaller of two), so a call whose host time exceeds its device time
  shows it; a digest of the scores holds the trees' outputs equal;
* the tree's ``phase_slice`` (map, 4.6 Mb), ``phase_overlap`` and
  ``phase_trim``, whose own checks must pass and whose logs give the
  end-to-end numbers (map bases/s, overlap and trim wall seconds).

The turns go a, b, b, a, a, b, ... (``--rounds`` turns of each tree), so
neither tree always runs first.  Each turn's log goes to
``chiprun_out/ab_paths/``; the summary (every turn's value and, per tree,
the range) is printed and written to ``chiprun_out/ab_paths/summary.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join("chiprun_out", "ab_paths")
K = 10
METRICS = (
    # (key, regex over a turn's log, group)
    ("map_bases_per_s",
     r"^map_batch, \d+ passes: .*?median [\d.]+ s = .*?, (\d+) bases/s", 1),
    ("map_median_s", r"^map_batch, \d+ passes: .*?median ([\d.]+) s", 1),
    ("overlap_wall_s", r"^overlap on the card: wall ([\d.]+) s", 1),
    ("trim_wall_s", r"^trim on the card: wall ([\d.]+) s", 1),
    ("trim_mb_per_s", r"^trim on the card: wall [\d.]+ s = ([\d.]+) MB/s", 1),
)


def _recipe():
    """This script's own chip_smoke.py (its shapes, anchor recipe and
    timer), loaded under another name than the tree's."""
    spec = importlib.util.spec_from_file_location(
        "ab_recipe", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chain_times(recipe) -> dict:
    import numpy as np
    import torch
    from downpore_tpu_torch.ops import chain, cuda_chain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}
    for name, P, A, variant, mode in recipe.CHAIN_SHAPES:
        qi, tj, qp, tp, valid = (torch.from_numpy(a).to(dev) for a in
                                 recipe.anchor_batch(
                                     rng, P, A, span=3 * A,
                                     levels=not name.startswith("P4096")))
        anchors = {"qi": qi, "tj": tj, "qp": qp, "tp": tp,
                   "valid": valid.bool(),
                   "overflow": torch.zeros(P, dtype=torch.int32, device=dev)}
        if mode == "forward":
            def fn():
                return cuda_chain.chain_scan(qi, tj, qp, tp, valid, K,
                                             variant)[0]
        elif mode == "fb":
            def fn():
                return chain.dp_from_anchors(anchors, K, variant)["f"]
        else:
            def fn():
                return chain.dp_forward_lean(anchors, K, variant)["f"]
        digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()
        ms = min(recipe.cuda_ms(fn, 20), recipe.cuda_ms(fn, 20))
        out[name] = {"ms": ms, "score_sha256": digest[:16]}
        print(f"AB chain {name}: {ms:.4f} ms (scores {digest[:16]})",
              flush=True)
    return out


def turn(tree: str) -> int:
    """One turn: the chain DP and the three phases of ``tree``."""
    import torch
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    recipe = _recipe()
    import chip_smoke as smoke
    if not smoke.__file__.startswith(tree):
        raise SystemExit(f"imported {smoke.__file__}, not {tree}'s")
    dev = torch.device("cuda")
    print(f"AB tree {tree}: {smoke.nvidia_smi()}", flush=True)
    result = {"chain": chain_times(recipe), "phase_s": {}}
    for name in ("phase_slice", "phase_overlap", "phase_trim"):
        t0 = time.perf_counter()
        got = getattr(smoke, name)(dev)
        del got
        result["phase_s"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("AB_RESULT " + json.dumps(result), flush=True)
    return 0


def run_turn(tree: str, label: str, i: int) -> dict:
    log_path = os.path.join(OUT_DIR, f"turn{i:02d}_{label}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--turn", tree], stdout=log,
                            stderr=subprocess.STDOUT).returncode
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise SystemExit(f"turn {i} ({label}, {tree}) failed with {rc}; "
                         f"see {log_path}:\n{text[-3000:]}")
    rec = {"turn": i, "tree": label, "seconds": time.perf_counter() - t0}
    for key, pat, g in METRICS:
        m = re.search(pat, text, re.M)
        if m is None:
            raise SystemExit(f"turn {i} ({label}): no {key} in {log_path}")
        rec[key] = float(m.group(g))
    res = json.loads(re.search(r"^AB_RESULT (.*)$", text, re.M).group(1))
    rec["chain"] = res["chain"]
    rec["phase_s"] = res["phase_s"]
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="tree a, tree b")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        return turn(args.turn)
    if len(args.trees) != 2:
        ap.error("give two trees")
    import torch
    if not torch.cuda.is_available():
        print("ab_paths: needs one CUDA card", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    trees = {"a": args.trees[0], "b": args.trees[1]}
    order = [("a", "b", "b", "a")[j % 4] for j in range(2 * args.rounds)]
    recs = []
    for i, label in enumerate(order):
        rec = run_turn(trees[label], label, i)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"trees": trees, "turns": recs, "range": {}}
    for key, _, _ in METRICS:
        for label in trees:
            vals = [r[key] for r in recs if r["tree"] == label]
            summary["range"][f"{key} {label}"] = [min(vals), max(vals)]
    names = list(recs[0]["chain"])
    for name in names:
        digests = {r["chain"][name]["score_sha256"] for r in recs}
        if len(digests) != 1:
            raise SystemExit(f"the trees' chain scores differ at {name}")
        for label in trees:
            vals = [r["chain"][name]["ms"] for r in recs
                    if r["tree"] == label]
            summary["range"][f"chain {name} {label}"] = [min(vals),
                                                         max(vals)]
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for key, (lo, hi) in summary["range"].items():
        print(f"{key}: {lo:.6g} .. {hi:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
