"""Run two trees of the port in turns on one card and compare them, on one
of two case sets.

    mkdir -p _chipcopy/a && git archive <commit> | tar -x -C _chipcopy/a
    python3 scripts/ab_paths.py _chipcopy/a _chipcopy/b [--rounds 3]
    python3 scripts/ab_paths.py _chipcopy/a _chipcopy/b --cases overlap_trim
    python3 scripts/ab_paths.py _chipcopy/a _chipcopy/b --cases overlap_cli \
        [--rounds 5]
    python3 scripts/ab_paths.py _chipcopy/a _chipcopy/b --cases beam \\
        [--rounds 2] [--jobs PKL] [--clocks]
    python3 scripts/ab_paths.py _chipcopy/a _chipcopy/b \\
        --cases anchor_counts [--rounds 2] [--args DIR]

Each turn is one process that imports one tree (its
``downpore_tpu_torch``, and for ``paths`` its ``chip_smoke.py``) and runs
on the card.

``--cases paths`` (the default): the map, overlap and trim paths end to
end, and the chain DP through each tree's own entry points:

* the chain DP on the inputs of this script's ``chip_smoke.CHAIN_SHAPES``
  (the same recipe and seed for both trees) through the tree's own entry
  points: ``ops.cuda_chain.chain_scan`` (forward), ``ops.chain.
  dp_from_anchors`` (fb: forward and backward, with whatever launches and
  copies the tree makes for it) and ``ops.chain.dp_forward_lean`` (lean).
  A time is that of the whole call on the card (CUDA events over 20 calls,
  the smaller of two), so a call whose host time exceeds its device time
  shows it; a digest of the scores holds the trees' outputs equal;
* the tree's ``phase_slice`` (map, 4.6 Mb) and ``phase_profile`` (one
  profiled pass: device busy time and idle share, host waits in
  ``cudaStreamSynchronize``), one map dispatch of the 4.6 Mb case timed
  the same way for both trees (``map_dispatch``: its host wall time
  beside the device span of the work it enqueued), the tree's
  ``map_dispatch_case`` of that case (its ``phase_dispatch`` and
  ``phase_graphs`` lines), and the tree's
  ``phase_chromosome`` (map, 64 Mb, with its profiled pass),
  ``phase_overlap`` (round 2 profiled) and ``phase_trim`` (an edge and a
  middle batch profiled), whose own checks must pass and whose logs give
  the end-to-end numbers (map bases/s and medians, overlap and trim wall
  seconds, idle shares) and, from each ``phase_graphs`` line, a replayed
  dispatch's device busy ms and its largest graph's nodes.

``--cases overlap_trim``: the tree's ``phase_overlap`` and ``phase_trim``
alone (their wall seconds, idle shares, and one overlap sub-batch's and
one trim edge batch's dispatch host ms from their ``phase_dispatch`` and
``phase_graphs`` lines).

``--cases overlap_cli``: the tree's ``overlap`` command alone, as a user
runs it (no phase wrappers, recordings or profiler), on the overlap case's
input (``chip_smoke.write_overlap_reads``, written once before the turns
into the temporary directory): its wall seconds to the last PAF line, its
per-round stderr and PAF line count held to the recorded run.

``--cases beam``: the beam-consensus kernel.  First this script's own tree
runs ``correct`` on the card on ``chip_smoke.correct_case()`` (2048 reads
of 5-10 kb from a 1 Mb genome) with ``consensus_kmers_bulk`` wrapped to
keep its arguments (``chiprun_out/ab_beam/jobs.pkl``; ``--jobs`` reuses an
earlier file).  Then each turn:

* per (N, L) bucket of those jobs (the JAX package's bucketing: members
  rounded up to 4, length up to 128; both trees pad a job so), runs the
  tree's ``cuda_beam.beam_consensus`` on the bucket's ``[J, N, L]``: the
  kernel's device time under ``torch.profiler`` (the mean of its events,
  5 calls, the smaller of two), the steps its longest job takes (the
  largest n_valid) and the time a step;
* the same at ``chip_smoke.consensus_jobs`` ``[1024, 8, 512]``, simple-k;
* the tree's ``dtw.consensus_kmers_bulk`` on all the kept jobs: host clock
  to a synchronised end (the smaller of 3 calls), the tree's beam launches
  in one call and their device time in all.

A digest of the chains must be the same in every turn.  With ``--clocks``
a last process builds tree b's kernel with ``-DBEAM_CLOCKS`` and prints,
per case, block 0's cycles a step in phase A, at the first barrier, in the
selection and at the last barrier (warp 0's view; the kernel's
``beam_consensus_clocks``).

``--cases anchor_counts``: the anchor-build and retrieval-count kernels
at the paths' shapes.  First this script's own ``chip_smoke.py`` runs
whole with ``--keep-kernel-args`` (its log ``smoke.log`` beside the
turns'): the largest anchor and count launch of each kind in each
``phase_dispatch`` case is saved with its outputs into a directory of the
temporary directory (``--args`` reuses an earlier one; the files are
large, the overlap membership alone 1.6 GB, so they are not written beside
the logs).  Then each turn builds the tree's two kernels and runs
each saved launch through the tree's C entry point (``chip_smoke.
anchors_raw`` / ``counts_raw``, whose ``_call`` both trees share): its
outputs must equal the saved ones, and its time is that of the kernel
alone (CUDA events over 10 launches, the smaller of two), printed beside
the bound the smoke run computed.

The turns go a, b, b, a, a, b, ... (``--rounds`` turns of each tree), so
neither tree always runs first.  Each turn's log goes to
``chiprun_out/ab_<cases>/``; the summary (every turn's value and, per
tree, the range) is printed and written to ``summary.json`` there.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 10
_PROFILED = (r"^profiled unsharded pass: wall ([\d.]+) ms; device busy "
             r"([\d.]+) ms \(\d+ device events\), idle share ([\d.]+); "
             r"\d+ cudaLaunchKernel; host waits in cudaStreamSynchronize "
             r"([\d.]+) ms")
METRICS = (
    # (key, regex over a turn's log, group, which match: phase_profile runs
    # for map 4.6 Mb first, then inside phase_chromosome for 64 Mb)
    ("map_bases_per_s",
     r"^map_batch, \d+ passes: .*?median [\d.]+ s = .*?, (\d+) bases/s", 1,
     0),
    ("map_median_s", r"^map_batch, \d+ passes: .*?median ([\d.]+) s", 1, 0),
    ("map_profiled_wall_ms", _PROFILED, 1, 0),
    ("map_device_busy_ms", _PROFILED, 2, 0),
    ("map_idle_share", _PROFILED, 3, 0),
    ("map_stream_sync_ms", _PROFILED, 4, 0),
    ("map_dispatch_ms", r"^AB map dispatch: host ([\d.]+) ms", 1, 0),
    ("map_dispatch_span_ms",
     r"^AB map dispatch: host [\d.]+ ms, device span ([\d.]+) ms", 1, 0),
    ("chr_median_s", r"^chromosome map_batch, \d+ passes: .*?median "
     r"([\d.]+) s", 1, 0),
    ("chr_profiled_wall_ms", _PROFILED, 1, 1),
    ("chr_device_busy_ms", _PROFILED, 2, 1),
    ("chr_idle_share", _PROFILED, 3, 1),
    ("chr_stream_sync_ms", _PROFILED, 4, 1),
    ("overlap_wall_s", r"^overlap on the card: wall ([\d.]+) s", 1, 0),
    ("overlap_round2_idle_share",
     r"^overlap round 2 .*?under torch\.profiler: .*?idle share ([\d.]+)",
     1, 0),
    ("trim_wall_s", r"^trim on the card: wall ([\d.]+) s", 1, 0),
    ("trim_mb_per_s", r"^trim on the card: wall [\d.]+ s = ([\d.]+) MB/s",
     1, 0),
    ("trim_edge_idle_share",
     r"^trim edge batch under torch\.profiler: .*?idle share ([\d.]+)", 1,
     0),
    ("trim_middle_idle_share",
     r"^trim middle batch under torch\.profiler: .*?idle share ([\d.]+)",
     1, 0),
    # one dispatch's host ms, as phase_dispatch and phase_graphs print it
    ("overlap_dispatch_ms",
     r"^phase_dispatch overlap round .*?; dispatch ([\d.]+) ms on the host",
     1, 0),
    ("overlap_dispatch_replayed_ms",
     r"^phase_graphs overlap round .*?host ms a dispatch ([\d.]+) replayed",
     1, 0),
    ("trim_edge_dispatch_ms",
     r"^phase_dispatch trim edge batch .*?; dispatch ([\d.]+) ms on the host",
     1, 0),
    ("trim_edge_dispatch_replayed_ms",
     r"^phase_graphs trim edge batch .*?host ms a dispatch ([\d.]+) "
     r"replayed", 1, 0),
)
# per phase_graphs path: the device busy ms of a replayed dispatch +
# collect and the nodes of its largest graph
GRAPH_PATHS = (("map", r"map 4\.6 Mb:"), ("chr", r"map 64 Mb"),
               ("overlap", r"overlap round"), ("trim_edge", r"trim edge batch"),
               ("trim_middle", r"trim middle batch"))
METRICS += tuple(
    m for key, name in GRAPH_PATHS for m in (
        (f"{key}_graph_busy_ms", rf"^phase_graphs {name}.*?device busy "
         r"\(profiler\) ([\d.]+) vs", 1, 0),
        (f"{key}_graph_nodes", rf"^phase_graphs {name}.*?nodes a graph "
         r"\[(?:\d+, )*(\d+)\]", 1, 0)))
# the metrics of the overlap_trim case set
OVERLAP_TRIM = tuple(m for m in METRICS
                     if m[0].startswith(("overlap_", "trim_")))
BEAM_KERNEL = "beam_consensus_kernel"
TURN_TIMEOUT = 1200    # seconds a turn may take


def out_dir(cases: str) -> str:
    return os.path.join(HERE, "chiprun_out", f"ab_{cases}")


JOBS = os.path.join(out_dir("beam"), "jobs.pkl")


def _recipe():
    """This script's own chip_smoke.py (its shapes, recipes and timer),
    loaded under another name than the tree's."""
    spec = importlib.util.spec_from_file_location(
        "ab_recipe", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _enter(tree: str) -> str:
    """Put ``tree`` first on the import path and make it the cwd."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import downpore_tpu_torch
    if not downpore_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {downpore_tpu_torch.__file__}, not "
                         f"{tree}'s")
    return tree


# ---- the paths case set ----

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


def map_dispatch(mapper, reads) -> None:
    """One dispatch of the map case's first 4,096 end windows through the
    tree's ``dispatch_packed``: its host wall time and the device span from
    a CUDA event before it to one after it (the smaller of three), then
    its collect.  A dispatch that waits on the card takes about its whole
    span; one that only enqueues takes its launches."""
    import numpy as np
    import torch
    from downpore_tpu_torch.ops import map_engine
    eng = mapper.engine
    es = mapper.edge_size
    ends = [r for r in reads[:2048] for _ in (0, 1)]
    starts = [(len(r) - es) * (i % 2) for i, r in enumerate(ends)]
    if hasattr(map_engine.WindowRows, "cut"):
        wins = map_engine.WindowRows.cut(ends, starts, np.add(starts, es))
    else:   # a tree whose pack takes a list of subsequences
        wins = [r.subsequence(s, s + es) for r, s in zip(ends, starts)]
    packed = eng.pack_query_windows(wins)
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    eng.collect_arrays_many([eng.dispatch_packed(packed, base_min)])
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        futs = eng.dispatch_packed(packed, base_min)
        host = (time.perf_counter() - t0) * 1e3
        e1.record()
        e1.synchronize()
        eng.collect_arrays_many([futs])
        if best is None or host < best[0]:
            best = (host, e0.elapsed_time(e1))
    print(f"AB map dispatch: host {best[0]:.3f} ms, device span "
          f"{best[1]:.3f} ms", flush=True)


def paths_turn(tree: str, recipe) -> dict:
    """The chain DP and the map, chromosome, overlap and trim phases of
    ``tree``."""
    import torch
    import chip_smoke as smoke
    if not smoke.__file__.startswith(tree):
        raise SystemExit(f"imported {smoke.__file__}, not {tree}'s")
    dev = torch.device("cuda")
    result = {"chain": chain_times(recipe), "phase_s": {}}
    t0 = time.perf_counter()
    mapper, reads, _ = smoke.phase_slice(dev)
    smoke.phase_profile(mapper, reads)
    map_dispatch(mapper, reads)
    smoke.map_dispatch_case("map 4.6 Mb", mapper, reads)
    del mapper, reads
    result["phase_s"]["phase_slice"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for name in ("phase_chromosome", "phase_overlap", "phase_trim"):
        t0 = time.perf_counter()
        got = getattr(smoke, name)(dev)
        del got
        result["phase_s"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return result


def overlap_trim_turn(tree: str, recipe) -> dict:
    """The overlap and trim phases of ``tree`` alone."""
    import torch
    import chip_smoke as smoke
    if not smoke.__file__.startswith(tree):
        raise SystemExit(f"imported {smoke.__file__}, not {tree}'s")
    dev = torch.device("cuda")
    result = {"phase_s": {}}
    for name in ("phase_overlap", "phase_trim"):
        t0 = time.perf_counter()
        got = getattr(smoke, name)(dev)
        del got
        result["phase_s"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return result


def ov_cli_input() -> str:
    import tempfile
    return os.path.join(tempfile.gettempdir(), "ab_overlap_reads.fasta")


def overlap_cli_turn(tree: str, recipe) -> dict:
    """The tree's ``overlap`` CLI on ``ov_cli_input()``, uninstrumented."""
    import contextlib
    import io
    import tempfile
    import torch
    from downpore_tpu_torch.cli.main import main as cli_main
    err = io.StringIO()
    out_path = os.path.join(tempfile.gettempdir(),
                            f"ab_overlap_{os.getpid()}.paf")
    try:
        t0 = time.perf_counter()
        with open(out_path, "w", buffering=1 << 22) as out, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            cli_main(["overlap", "-input", ov_cli_input()])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out_path, "rb") as f:
            n_paf = sum(chunk.count(b"\n") for chunk in iter(
                lambda: f.read(1 << 24), b""))
    finally:
        if os.path.exists(out_path):
            os.remove(out_path)
    rounds = [ln for ln in err.getvalue().splitlines()
              if ln.startswith(("Using query set", "Total "))]
    if rounds != recipe.OV_STDERR or n_paf != recipe.OV_PAF_LINES:
        raise SystemExit(f"overlap's stderr or its {n_paf} PAF lines differ "
                         f"from the recorded run")
    print(f"AB overlap CLI: wall {wall:.3f} s", flush=True)
    return {}


def metric_ranges(recs, trees, summary, metrics) -> None:
    for key, *_ in metrics:
        for label in trees:
            vals = [r[key] for r in recs if r["tree"] == label]
            summary["range"][f"{key} {label}"] = [min(vals), max(vals)]


def paths_summary(recs, trees, summary) -> None:
    metric_ranges(recs, trees, summary, METRICS)
    for name in recs[0]["chain"]:
        digests = {r["chain"][name]["score_sha256"] for r in recs}
        if len(digests) != 1:
            raise SystemExit(f"the trees' chain scores differ at {name}")
        for label in trees:
            vals = [r["chain"][name]["ms"] for r in recs
                    if r["tree"] == label]
            summary["range"][f"chain {name} {label}"] = [min(vals),
                                                         max(vals)]


# ---- the beam case set ----

def capture() -> None:
    """``correct`` on the correct case with ``consensus_kmers_bulk``'s
    arguments kept in JOBS."""
    sys.path.insert(0, HERE)
    from downpore_tpu_torch.consensus import consensus as cons
    recipe = _recipe()
    _, records = recipe.correct_case()
    kept = []
    orig = cons.consensus_kmers_bulk

    def keep(jobs, table, k, **kw):
        kept.append((jobs, table, k, {n: v for n, v in kw.items()
                                      if n != "device"}))
        return orig(jobs, table, k, **kw)
    cons.consensus_kmers_bulk = keep
    try:
        recipe.run_correct(records, "cuda")
    finally:
        cons.consensus_kmers_bulk = orig
    with open(JOBS, "wb") as f:
        pickle.dump(kept, f)
    print(f"AB kept {len(kept)} consensus_kmers_bulk calls, "
          f"{sum(len(j) for j, *_ in kept)} jobs", flush=True)


def kernel_ms(fn, reps: int = 5) -> float:
    """Device time of the beam kernel's launches in one call of ``fn``,
    the mean of ``reps`` calls under torch.profiler (after one warm
    call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and BEAM_KERNEL in e.name]
    if not evts:
        raise SystemExit("the profiler saw no beam kernel on the device")
    return sum(e.time_range.elapsed_us() for e in evts) / reps / 1e3


def buckets(jobs):
    """The jobs' (N, L) buckets, as the JAX package forms them."""
    out = {}
    for job in jobs:
        job = [s for s in job if len(s)]
        if not job:
            continue
        N = ((len(job) + 3) // 4) * 4
        L = ((max(len(s) for s in job) + 127) // 128) * 128
        out.setdefault((N, L), []).append(job)
    return sorted(out.items())


def beam_cases(kept, recipe, dev):
    """(name, beam_consensus's arguments) of every kept bucket and of the
    bench bucket."""
    import numpy as np
    import torch
    from downpore_tpu_torch.ops import dtw
    specs = []
    for jobs, table, k, kw in kept:
        tab = dtw._device_table(table, kw.get("simple_k", 0), dev)
        for (N, L), bjobs in buckets(jobs):
            specs.append((f"correct [{len(bjobs)}, {N}, {L}]", bjobs, N, L,
                          tab, k, kw))
    bench = recipe.consensus_jobs(np.random.default_rng(recipe.SEED + 30),
                                  1024)
    specs.append(("bench [1024, 8, 512] simple-k", bench, 8, 512, None, 5,
                  {"threshold": 200, "gap_cost": 5, "simple_k": 5}))
    cases = []
    for name, bjobs, N, L, tab, k, kw in specs:
        arrs = [np.stack(a) for a in zip(*(dtw._pad_job(j, N, L)
                                           for j in bjobs))]
        seqs, lens, firsts = (torch.from_numpy(np.ascontiguousarray(
            a, np.int32)).to(dev) for a in arrs)
        cases.append((name, (seqs, lens, firsts, tab, k, 4, dtw._t_max(L),
                             kw["threshold"], kw["gap_cost"],
                             kw["simple_k"])))
    return cases


def beam_turn(tree: str, recipe) -> dict:
    """``tree``'s beam kernel at the kept buckets and the bench bucket, and
    its ``consensus_kmers_bulk``."""
    import numpy as np
    import torch
    from downpore_tpu_torch.ops import cuda_beam, dtw
    dev = torch.device("cuda")
    with open(JOBS, "rb") as f:
        kept = pickle.load(f)
    digest = hashlib.sha256()
    result = {"shapes": {}, "bulk": []}
    for name, args in beam_cases(kept, recipe, dev):
        chains, ns = cuda_beam.beam_consensus(*args)
        digest.update(chains.cpu().numpy().tobytes())
        ms = min(kernel_ms(lambda: cuda_beam.beam_consensus(*args)),
                 kernel_ms(lambda: cuda_beam.beam_consensus(*args)))
        steps = int(ns.max())
        result["shapes"][name] = {"ms": ms, "steps": steps,
                                  "us_per_step": ms * 1e3 / steps}
        print(f"AB {name}: kernel {ms:.4f} ms, {steps} steps, "
              f"{ms * 1e3 / steps:.3f} us a step", flush=True)
    for jobs, table, k, kw in kept:
        def bulk():
            return dtw.consensus_kmers_bulk(jobs, table, k, device=dev, **kw)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bulk()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        before = cuda_beam.beam_consensus.launches
        out = bulk()
        launches = cuda_beam.beam_consensus.launches - before
        for a in out:
            digest.update(np.asarray(a, np.int32).tobytes())
        dev_ms = kernel_ms(bulk, 3)
        result["bulk"].append({"wall_ms": min(walls) * 1e3,
                               "launches": launches, "kernel_ms": dev_ms})
        print(f"AB consensus_kmers_bulk ({len(jobs)} jobs): wall "
              f"{min(walls) * 1e3:.3f} ms, {launches} beam launches, "
              f"{dev_ms:.4f} ms of beam kernel time", flush=True)
    result["sha256"] = digest.hexdigest()[:16]
    return result


def beam_summary(recs, trees, summary) -> None:
    if len({r["sha256"] for r in recs}) != 1:
        raise SystemExit("the trees' consensus chains differ")
    for name in recs[0]["shapes"]:
        for label in trees:
            for key in ("ms", "us_per_step"):
                vals = [r["shapes"][name][key] for r in recs
                        if r["tree"] == label]
                summary["range"][f"{name} {key} {label}"] = [min(vals),
                                                             max(vals)]
    for label in trees:
        for key in ("wall_ms", "launches", "kernel_ms"):
            vals = [b[key] for r in recs if r["tree"] == label
                    for b in r["bulk"]]
            summary["range"][f"consensus_kmers_bulk {key} {label}"] = [
                min(vals), max(vals)]


def clocks(tree: str) -> int:
    """``tree``'s beam kernel built with -DBEAM_CLOCKS: block 0's cycles a
    step by phase, per beam case."""
    import ctypes
    import tempfile
    import torch
    _enter(tree)
    recipe = _recipe()
    from downpore_tpu_torch.ops import _build, cuda_beam
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "beam_clocks.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DBEAM_CLOCKS",
                        "-o", so, os.path.join(_build.CSRC,
                                               "beam_consensus.cu")],
                       check=True)
        lib = ctypes.CDLL(so)
        _build._LIBS["beam_consensus"] = lib
        cuda_beam._lib()
        lib.beam_consensus_clocks.argtypes = [ctypes.c_void_p]
        with open(JOBS, "rb") as f:
            kept = pickle.load(f)
        for name, args in beam_cases(kept, recipe, dev):
            cuda_beam.beam_consensus(*args)
            torch.cuda.synchronize()
            out = (ctypes.c_longlong * 5)()
            if lib.beam_consensus_clocks(out):
                raise SystemExit("beam_consensus_clocks failed")
            steps = max(out[4], 1)
            print(f"AB clocks {name}: {out[4]} steps; cycles a step: phase A "
                  f"{out[0] / steps:.0f}, barrier 1 {out[1] / steps:.0f}, "
                  f"selection {out[2] / steps:.0f}, barrier 2 "
                  f"{out[3] / steps:.0f}", flush=True)
    return 0


# ---- the anchor_counts case set ----

def kernel_args_dir() -> str:
    import tempfile
    return os.path.join(tempfile.gettempdir(), "ab_anchor_counts_args")


def capture_kernel_args(dest: str) -> None:
    """This script's ``chip_smoke.py``, whole, saving the anchor and count
    launches it times at the path shapes into ``dest``."""
    shutil.rmtree(dest, ignore_errors=True)
    log_path = os.path.join(out_dir("anchor_counts"), "smoke.log")
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, os.path.join(HERE,
                                                          "chip_smoke.py"),
                             "--keep-kernel-args", dest], cwd=HERE,
                            stdout=log, stderr=subprocess.STDOUT,
                            timeout=TURN_TIMEOUT).returncode
    if rc != 0:
        raise SystemExit(f"chip_smoke.py failed with {rc}; see {log_path}")
    print(f"AB kept {len(os.listdir(dest))} anchor and count launches",
          flush=True)


def anchor_counts_turn(tree: str, recipe) -> dict:
    """``tree``'s anchor and count kernels on every kept launch."""
    import torch
    dev = torch.device("cuda")
    result = {}
    for fname in sorted(os.listdir(ARGS_DIR)):
        kept = torch.load(os.path.join(ARGS_DIR, fname))
        row = kept["row"]
        args = [a.to(dev) if torch.is_tensor(a) else a for a in kept["args"]]
        raw = (recipe.anchors_raw if row["name"] == "anchors_topk"
               else recipe.counts_raw)(args)
        raw()
        torch.cuda.synchronize()
        for got, want in zip(raw.outs, kept["outs"]):
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"{row['name']} at {row['path']} differs "
                                 f"from the kept outputs")
        ms = min(recipe.cuda_ms(raw, 10), recipe.cuda_ms(raw, 10))
        key = f"{row['path']} | {row['name']} {row['kind']} [{row['shape']}]"
        result[key] = {"ms": ms, "bound_ms": row["bound_ms"],
                       "bound_by": row["bound_by"]}
        print(f"AB {key}: kernel {ms:.4f} ms; bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}), share {row['bound_ms'] / ms:.3f}",
              flush=True)
        del args, raw, kept
        torch.cuda.empty_cache()
    return result


def anchor_counts_summary(recs, trees, summary) -> None:
    for key in recs[0]:
        if key in ("turn", "tree", "seconds"):
            continue
        for label in trees:
            vals = [r[key]["ms"] for r in recs if r["tree"] == label]
            summary["range"][f"{key} ms {label}"] = [min(vals), max(vals)]
        bound_ms = recs[0][key]["bound_ms"]
        summary["range"][f"{key} bound ms"] = [bound_ms, bound_ms]


ARGS_DIR = kernel_args_dir()   # the kept launches (--args)
OVERLAP_CLI = (("overlap_cli_wall_s", r"^AB overlap CLI: wall ([\d.]+) s",
                1, 0),)
CASES = {"paths": (paths_turn, paths_summary),
         "overlap_trim": (overlap_trim_turn, functools.partial(
             metric_ranges, metrics=OVERLAP_TRIM)),
         "overlap_cli": (overlap_cli_turn, functools.partial(
             metric_ranges, metrics=OVERLAP_CLI)),
         "beam": (beam_turn, beam_summary),
         "anchor_counts": (anchor_counts_turn, anchor_counts_summary)}
# the log metrics each case set reads
CASE_METRICS = {"paths": METRICS, "overlap_trim": OVERLAP_TRIM,
                "overlap_cli": OVERLAP_CLI, "beam": (), "anchor_counts": ()}


def turn(tree: str, cases: str, args_dir=None) -> int:
    """One turn of ``cases`` on ``tree``."""
    global ARGS_DIR
    ARGS_DIR = args_dir or ARGS_DIR
    tree = _enter(tree)
    recipe = _recipe()
    print(f"AB tree {tree}: {recipe.nvidia_smi()}", flush=True)
    result = CASES[cases][0](tree, recipe)
    print("AB_RESULT " + json.dumps(result), flush=True)
    return 0


def run_turn(tree: str, label: str, i: int, cases: str) -> dict:
    log_path = os.path.join(out_dir(cases), f"turn{i:02d}_{label}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--cases", cases, "--turn", tree,
                             "--args", ARGS_DIR], stdout=log,
                            stderr=subprocess.STDOUT,
                            timeout=TURN_TIMEOUT).returncode
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise SystemExit(f"turn {i} ({label}, {tree}) failed with {rc}; "
                         f"see {log_path}:\n{text[-3000:]}")
    rec = {"turn": i, "tree": label, "seconds": time.perf_counter() - t0}
    for key, pat, g, which in CASE_METRICS[cases]:
        found = list(re.finditer(pat, text, re.M))
        if len(found) <= which:
            raise SystemExit(f"turn {i} ({label}): no {key} in "
                             f"{log_path}")
        rec[key] = float(found[which].group(g))
    rec.update(json.loads(re.search(r"^AB_RESULT (.*)$", text,
                                    re.M).group(1)))
    return rec


def main() -> int:
    global ARGS_DIR
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="tree a, tree b")
    ap.add_argument("--cases", choices=sorted(CASES), default="paths")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--jobs", help="beam: a jobs.pkl of an earlier run, "
                    "instead of a capture")
    ap.add_argument("--clocks", action="store_true",
                    help="beam: also print tree b's cycles a step by phase")
    ap.add_argument("--args", help="anchor_counts: a directory of kept "
                    "launches of an earlier run, instead of a capture")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--clocks-turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        return turn(args.turn, args.cases, args.args)
    if args.clocks_turn:
        return clocks(args.clocks_turn)
    if len(args.trees) != 2:
        ap.error("give two trees")
    if args.cases != "beam" and (args.jobs or args.clocks):
        ap.error("--jobs and --clocks belong to --cases beam")
    if args.cases != "anchor_counts" and args.args:
        ap.error("--args belongs to --cases anchor_counts")
    import torch
    if not torch.cuda.is_available():
        print("ab_paths: needs one CUDA card", file=sys.stderr)
        return 2
    os.makedirs(out_dir(args.cases), exist_ok=True)
    if args.cases == "beam":
        if not args.jobs:
            capture()
        elif os.path.abspath(args.jobs) != JOBS:
            shutil.copyfile(args.jobs, JOBS)
    if args.cases == "overlap_cli":
        _recipe().write_overlap_reads(ov_cli_input())
    if args.cases == "anchor_counts":
        if args.args:
            ARGS_DIR = os.path.abspath(args.args)
        else:
            capture_kernel_args(ARGS_DIR)
    trees = {"a": args.trees[0], "b": args.trees[1]}
    order = [("a", "b", "b", "a")[j % 4] for j in range(2 * args.rounds)]
    recs = []
    for i, label in enumerate(order):
        rec = run_turn(trees[label], label, i, args.cases)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"trees": trees, "turns": recs, "range": {}}
    CASES[args.cases][1](recs, trees, summary)
    with open(os.path.join(out_dir(args.cases), "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for key, (lo, hi) in summary["range"].items():
        print(f"{key}: {lo:.6g} .. {hi:.6g}")
    if args.clocks:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--clocks-turn", trees["b"]], check=True,
                       timeout=TURN_TIMEOUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
