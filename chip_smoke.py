"""Smoke run of the torch port's map path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. device: the card's name and power limit (nvidia-smi), CUDA version,
   and the chain kernel's build from ``downpore_tpu_torch/csrc``;
2. kernel vs plain: ``cuda_chain.chain_scan`` on the card must equal
   ``chain_scan_plain`` on the same card tensors exactly, P = 4096 pairs at
   A in {64, 128, 384}, both gap-window variants, plus the backward pass's
   negated coordinates; both are timed at P = 4096, A = 128;
3. the slice at E. coli scale: a synthetic 4.6 Mb genome (k = 11, seed
   rate 40, 10 kb chunks, 1 kb edges), 8192 reads of 6-10 kb at 8%
   substitutions, half reverse-complemented; ``Mapper.map_batch`` on the
   card, timed over three passes after one warm-up pass, with the chain
   kernel's launch count over those passes, the fused route taken, and the
   recall of planted positions (>= 0.90);
   then one unsharded pass under ``torch.profiler`` with the stages
   ranged (``phase_profile``: wall, device busy time and idle share,
   per-stage host and device times; tables in
   ``chiprun_out/profile_map.txt``);
4. card vs CPU: the first 256 reads mapped on the card and on the CPU
   (plain torch versions) give byte-identical PAF lines.

It prints the kernel table as one JSON line, the nvidia-smi line, and as
its last line ``{"ok": true, "device": {...}}``.  Without a usable CUDA
card it exits non-zero and prints no result.  It imports nothing of JAX
or of the JAX package itself (checked on its own source at start), and
fails if the port pulled ``jax`` in.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
GENOME = 4_600_000
N_READS = 8192
ERR = 0.08
K = 11
P_KERNEL = 4096
RECALL_MIN = 0.90
TIMED_PASSES = 3
BASES = np.frombuffer(b"ACGT", np.uint8)


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def anchor_batch(rng, P: int, A: int):
    """Random anchors in the recipe of the JAX package's Pallas parity
    test: sorted positions, rank indices with swapped neighbours, 85%
    valid."""
    qp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    tp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    qi = np.argsort(np.argsort(qp, axis=1), axis=1).astype(np.int32)
    tj = np.argsort(np.argsort(tp, axis=1), axis=1).astype(np.int32)
    rows = np.repeat(np.arange(P), 20)
    sw = rng.integers(0, A - 1, P * 20)
    for r, s in zip(rows, sw):
        tj[r, s], tj[r, s + 1] = tj[r, s + 1], tj[r, s]
    valid = (rng.random((P, A)) < 0.85).astype(np.int32)
    return qi, tj, qp, tp, valid


def phase_kernel(dev):
    from downpore_tpu_torch.ops import cuda_chain
    rng = np.random.default_rng(0)
    k = 10
    max_err = 0
    timing = None
    for A in (64, 128, 384):
        arrs = anchor_batch(rng, P_KERNEL, A)
        cases = [("fwd", [torch.from_numpy(a).to(dev) for a in arrs])]
        if A == 128:
            # the backward pass's input: reversed, negated coordinates
            qi, tj, qp, tp, valid = arrs
            neg = [np.ascontiguousarray(-a[:, ::-1]) for a in (qi, tj, qp, tp)]
            neg.append(np.ascontiguousarray(valid[:, ::-1]))
            cases.append(("neg", [torch.from_numpy(a).to(dev) for a in neg]))
        for tag, ts in cases:
            for variant in ("extend", "aligner"):
                got = cuda_chain.chain_scan(*ts, k, variant)
                ref = cuda_chain.chain_scan_plain(*ts, k, variant)
                torch.cuda.synchronize()
                err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
                log(f"chain_scan P={P_KERNEL} A={A} {tag} {variant}: "
                    f"max_abs_err={err}")
                if err != 0:
                    raise SystemExit(f"chain_scan differs from its plain "
                                     f"version (A={A}, {tag}, {variant})")
                max_err = max(max_err, err)
        if A == 128:
            ts = cases[0][1]
            ms = cuda_ms(lambda: cuda_chain.chain_scan(*ts, k, "extend"), 50)
            plain_ms = cuda_ms(
                lambda: cuda_chain.chain_scan_plain(*ts, k, "extend"), 3)
            timing = (ms, plain_ms)
            log(f"chain_scan P={P_KERNEL} A=128 extend: kernel {ms:.4f} ms, "
                f"plain torch {plain_ms:.2f} ms")
    return max_err, timing


def make_case(n_reads: int, genome_len: int):
    """Genome and reads as the JAX package's map benchmark makes them:
    reads of 6-10 kb at random positions, substitutions at ``ERR``, odd
    reads reverse-complemented.  Returns (genome str, reads, truth)."""
    from downpore_tpu_torch.core import Sequence
    rng = np.random.default_rng(SEED + 10)
    genome = BASES[rng.integers(0, 4, genome_len)].tobytes().decode()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads, truth = [], []
    for i in range(n_reads):
        p = int(rng.integers(0, genome_len - 10_000))
        L = int(rng.integers(6000, 10_000))
        arr = np.frombuffer(genome[p:p + L].encode(), np.uint8).copy()
        m = rng.random(L) < ERR
        arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
        s = arr.tobytes()
        if i % 2:
            s = s.translate(comp)[::-1]
        reads.append(Sequence.from_string(s.decode(), id=i, name=f"r{i}"))
        truth.append((p, bool(i % 2)))
    return genome, reads, truth


def recall(results, truth) -> float:
    hit = sum(1 for maps, (p, rc) in zip(results, truth)
              if any(m.rc == rc and abs(m.start - p) <= 500 for m in maps))
    return hit / len(truth)


def phase_slice(dev, genome_len: int = GENOME, n_reads: int = N_READS):
    from downpore_tpu_torch.core import Sequence
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.ops import cuda_chain
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    t0 = time.perf_counter()
    genome, reads, truth = make_case(n_reads, genome_len)
    ref = Sequence.from_string(genome, id=0, name="ref")
    log(f"case: {genome_len} b genome, {len(reads)} reads "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    t0 = time.perf_counter()
    values = score_seed_values(kmer_occurrences([ref], K), K)
    mapper = Mapper(ref, False, K, values, seed_rate=40, edge_size=1000,
                    chunk_size=10000, device=dev)
    eng = mapper.engine
    state = sum(t.numel() * t.element_size() for t in
                (eng.membership, eng.t_seeds, eng.t_pos, eng.usable_dev))
    log(f"index: {eng.C} chunks, H={eng.H}, nq={eng.nq}, nt={eng.nt}, "
        f"resident index state {state} bytes, built in "
        f"{time.perf_counter() - t0:.1f} s")
    bases = sum(len(r) for r in reads)
    t0 = time.perf_counter()
    mapper.map_batch(reads)                       # warm-up
    sync(dev)
    log(f"warm-up pass {time.perf_counter() - t0:.3f} s")

    eng.routes.clear()
    cuda_chain.chain_scan.launches = 0
    walls = []
    for _ in range(TIMED_PASSES):
        t0 = time.perf_counter()
        results = mapper.map_batch(reads)
        sync(dev)
        walls.append(time.perf_counter() - t0)
    launches = cuda_chain.chain_scan.launches
    routes = dict(eng.routes)
    wall = float(np.median(walls))
    log(f"map_batch, {TIMED_PASSES} passes: wall "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; median {wall:.4f} s = "
        f"{len(reads) / wall:.1f} reads/s, {bases / wall:.0f} bases/s "
        f"({bases} bases); chain_scan launches {launches}; routes {routes}")
    if launches <= 0:
        raise SystemExit("the map path launched no chain_scan kernel")
    if routes.get("_fused_map_d", 0) <= 0:
        raise SystemExit(f"the map path never took _fused_map_d: {routes}")
    rec = recall(results, truth)
    n_mapped = sum(1 for r in results if r)
    log(f"recall: {rec:.4f} of reads mapped on the planted strand within "
        f"500 b of the planted start; {n_mapped} reads with a mapping")
    if rec < RECALL_MIN:
        raise SystemExit(f"recall {rec:.4f} < {RECALL_MIN}")
    return mapper, reads, launches


PROFILE_OUT = "chiprun_out/profile_map.txt"
PROFILE_RANGES = (
    # (module, attribute, range name); each is wrapped in a
    # torch.profiler.record_function range for the profiled pass only
    ("downpore_tpu_torch.ops.map_engine", "_derive_buckets",
     "dev:derive_buckets"),
    ("downpore_tpu_torch.ops.map_engine", "_count_rows_pair",
     "dev:count_rows_pair"),
    ("downpore_tpu_torch.ops.map_engine", "compact_indices",
     "dev:gate_compact"),
    ("downpore_tpu_torch.ops.map_engine", "make_anchors_topk",
     "dev:make_anchors_topk"),
    ("downpore_tpu_torch.ops.map_engine", "dp_from_anchors",
     "dev:dp_from_anchors"),
    ("downpore_tpu_torch.ops.map_engine", "summarize_dp",
     "dev:summarize_dp"),
    ("downpore_tpu_torch.ops.map_engine:MapEngine", "pack_query_windows",
     "host:pack_query_windows"),
    ("downpore_tpu_torch.ops.map_engine:MapEngine", "dispatch_packed",
     "host:dispatch_packed"),
    ("downpore_tpu_torch.ops.map_engine:MapEngine", "collect_arrays_many",
     "host:collect_arrays_many"),
    ("downpore_tpu_torch.mapping.mapper:Mapper", "_walk_candidates",
     "host:walk_candidates"),
)


def _ranged(fn, name):
    def wrapper(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapper


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def phase_profile(mapper, reads, out_path=PROFILE_OUT):
    """One unsharded ``map_batch`` pass under ``torch.profiler`` (CPU +
    CUDA), with the stages of ``PROFILE_RANGES`` ranged.  Unsharded,
    because ``map_batch`` maps 2048 reads or more as two shards on two
    threads, and the profiler records ranges only on the thread that
    started it; the device work is the same.  Prints the pass's wall time,
    the device's busy time (union of kernel, copy and set spans: the user
    ranges' own device spans are left out, since they nest over kernels
    already counted) and idle share, the kernel launch count, and each
    range's host time and device span; writes the profiler tables to
    ``out_path``."""
    import importlib
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    patched = []
    for where, attr, name in PROFILE_RANGES:
        mod, _, cls = where.partition(":")
        owner = importlib.import_module(mod)
        if cls:
            owner = getattr(owner, cls)
        patched.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, _ranged(getattr(owner, attr), name))
    try:
        sync(mapper.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mapper._map_batch_one(reads)
            sync(mapper.device)
            wall = time.perf_counter() - t0
    finally:
        for owner, attr, orig in patched:
            setattr(owner, attr, orig)

    evts = prof.events()
    work = [e for e in evts
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = _busy_us((e.time_range.start, e.time_range.end)
                       for e in work) / 1e3
    busy = (f"device busy {busy_ms:.3f} ms ({len(work)} device events), "
            f"idle share {1 - busy_ms / (wall * 1e3):.4f}" if work else
            "no device work seen: device busy time and idle share not "
            "measured")
    launches = sum(1 for e in evts if e.name == "cudaLaunchKernel")
    sync_ms = sum(e.time_range.elapsed_us() for e in evts
                  if e.name == "cudaStreamSynchronize") / 1e3
    log(f"profiled unsharded pass: wall {wall * 1e3:.3f} ms; {busy}; {launches} "
        f"cudaLaunchKernel; host waits in cudaStreamSynchronize "
        f"{sync_ms:.3f} ms")
    for _, _, name in PROFILE_RANGES:
        host = [e for e in evts if e.name == name
                and e.device_type == DeviceType.CPU]
        dev = [e for e in evts if e.name == name
               and e.device_type == DeviceType.CUDA]
        host_ms = sum(e.time_range.elapsed_us() for e in host) / 1e3
        dev_ms = _busy_us((e.time_range.start, e.time_range.end)
                          for e in dev) / 1e3
        log(f"  {name}: {len(host)} calls, host {host_ms:.3f} ms, "
            f"device span {dev_ms:.3f} ms")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        for key in ("self_cuda_time_total", "cpu_time_total"):
            f.write(prof.key_averages().table(sort_by=key, row_limit=40))
            f.write("\n")
    log(f"profiler tables written to {out_path}")


def phase_card_vs_cpu(mapper, reads):
    cpu = copy.copy(mapper)
    cpu.device = torch.device("cpu")
    cpu._build_device_index()
    sub = reads[:256]
    on_card = [mapper.as_string(m) for ms in mapper.map_batch(sub)
               for m in ms]
    on_cpu = [cpu.as_string(m) for ms in cpu.map_batch(sub) for m in ms]
    same = "\n".join(on_card) == "\n".join(on_cpu)
    log(f"card vs cpu on {len(sub)} reads: {len(on_card)} / {len(on_cpu)} "
        f"PAF lines, byte-identical: {same}")
    if not same or not on_card:
        raise SystemExit("PAF on the card differs from PAF on the CPU")


def own_imports() -> set:
    """Top-level names of the modules this script imports itself."""
    import ast
    with open(__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def main() -> int:
    bad = own_imports() & {"jax", "jaxlib", "downpore_tpu"}
    if bad:
        raise SystemExit(f"chip_smoke imports the JAX side: {sorted(bad)}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 2
    from downpore_tpu_torch.ops import _build
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load("chain_scan")
    nvcc_s = _build.build_seconds.get("chain_scan")
    log(f"chain_scan build: "
        + (f"{nvcc_s:.2f} s nvcc" if nvcc_s is not None else "cached")
        + f", {time.perf_counter() - t0:.2f} s with load")

    max_err, (ms, plain_ms) = phase_kernel(dev)
    mapper, reads, launches = phase_slice(dev)
    phase_profile(mapper, reads)
    phase_card_vs_cpu(mapper, reads)
    if "jax" in sys.modules:
        raise SystemExit("the port's map path imported jax")

    kernels = [{
        "name": "chain_scan", "route": "cuda",
        "source": "downpore_tpu_torch/csrc/chain_scan.cu",
        "replaces": "downpore_tpu/ops/pallas_chain.py:42",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
