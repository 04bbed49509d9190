"""Smoke run of the torch port's paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. device: the card's name and power limit (nvidia-smi), CUDA version,
   the build of the five kernels from ``downpore_tpu_torch/csrc`` (one
   nvcc per source, all started together), and the port's native host
   library (``downpore_tpu_torch/native/seqscan.cpp``), which must load;
2. kernels vs plain versions, on card tensors, each timed against its
   plain version and its bound (the larger of its int32 operations over
   132 SMs x 64 INT32 lanes x 1.98 GHz and its bytes over 3.35 TB/s):
   the chain kernel's three entry points ``cuda_chain.chain_scan``,
   ``chain_scan_fb`` (forward and backward in one launch) and
   ``chain_scan_lean`` must equal ``chain_scan_plain`` exactly at P = 512,
   A in {64, 96, 128, 256, 384} (register forms) and 640 (the
   shared-memory form), both gap-window variants; then the kernel alone
   (its C entry point, preallocated outputs) is timed at the path shapes
   (``CHAIN_SHAPES``: P = 4096, A = 128 for continuity with earlier
   measurements, map, overlap and trim), each beside its bound, and per
   1,000 pairs over a sweep of P (``CHAIN_SWEEP_P``, A = 128);
   ``cuda_band.update_bands`` must equal ``update_bands_plain`` at
   B = 65,536 bands x 32 (test_align.py's recipe), and the kernel alone
   is timed with cold L2 (``BAND_L2_SETS`` input and output sets in
   turn) beside its bytes bound;
   ``cuda_beam.beam_consensus`` must equal ``beam_consensus_plain`` on
   chains and n_valid at bench.py's consensus shape (1024 jobs x 6
   members x 500-base cores at 8% substitutions, k = 5, simple-k
   measure: the [1024, 8, 512] bucket), and again with the table measure
   on a 64-job subset; ``cuda_anchors.anchors_topk`` (rows and indexed
   slots) and ``cuda_counts.retrieval_count`` (flat with and without the
   ``first`` mask, binned) must equal their plain versions at the paths'
   widths (``ANCHOR_SHAPES``, ``COUNT_SHAPES``: ``phase_anchor_counts``),
   on random rows and on hard ones: hash values that collide in the
   anchor kernel's table, values repeated inside one 32-seed step, int8
   membership over its whole range;
3. the map slice at E. coli scale: a synthetic 4.6 Mb genome (k = 11, seed
   rate 40, 10 kb chunks, 1 kb edges), 8192 reads of 6-10 kb at 8%
   substitutions, half reverse-complemented; ``Mapper.map_batch`` on the
   card, timed over three passes after two warm-up passes (the first
   captures the dispatches' graphs, the second those of the budgets its
   counts settled), with the chain kernel's launch count over those
   passes, the fused route taken, and the recall of planted positions
   (>= 0.90);
   then one unsharded pass under ``torch.profiler`` with the stages
   ranged (``phase_profile``: wall, device busy time and idle share,
   per-stage host and device times; tables in
   ``chiprun_out/profile_map.txt``);
4. card vs CPU: the first 256 reads mapped on the card and on the CPU
   (plain torch versions) give byte-identical PAF lines;
5. the correct slice: ``correct`` through the port's CLI on a synthetic
   1 Mb genome with 2048 reads of 5-10 kb at 3% error (~15x coverage):
   wall time split into overlap rounds, consensus and the rest, kernel
   launch counts of the run (the beam kernel's must be > 0), every
   kernel launch of the run held against its plain version on a copy of
   the same card tensors (exact), and the consensus sequences checked
   against the genome (15-mer containment); then two more runs on the
   same reads, one under ``torch.profiler`` (device busy time and idle
   share) and one under ``cProfile`` (host time by function; table in
   ``chiprun_out/profile_correct.txt``);
6. card vs CPU: ``correct`` on test_cli_golden.py's 48-read overlap
   recipe gives byte-identical fasta on the card and on the CPU, with the
   simple-k measure and with a ``-model`` table measure;
7. map at chromosome scale (``phase_chromosome``, bench.py's
   ``_map_case(64_000_000, 13, 2048, "64Mb")``): a synthetic 64 Mb genome
   (k = 13, seed rate 40, 10 kb chunks with 1 kb edges: ~6,465 chunks, so
   the binned gate), 2048 reads of 6-10 kb at 8% substitutions, odd reads
   reverse-complemented: host index-build seconds, resident bytes on the
   card, routes (``_fused_map_bd`` must be taken), the largest ``n_bin``
   and final ``BB``, one warm-up pass whose chain launches are all held
   against the plain version and a second, unrecorded one, three timed
   passes with the chain launch count, recall (>= 0.90), peak device
   memory, one profiled pass
   (``chiprun_out/profile_map_64mb.txt``) and card-vs-CPU PAF identity on
   the first 64 reads;
8. overlap, all-vs-all (``phase_overlap``, bench.py's
   ``bench_overlap_gb`` input: 12,000 reads of 8 kb at 5% substitutions
   from a 2 Mb genome): ``overlap`` through the port's CLI, stdout to a
   file; its per-round stderr and PAF line count must equal the JAX
   package's recorded run (6 rounds, 721,379 lines); wall split into
   k-mer counting, round prep, find and final checks; resident bytes per
   round; the first round's chain launches held against the plain version;
   device busy time and idle share of round 2 under ``torch.profiler``;
9. the multi-device paths on the one card (``phase_grid``), on grids that
   place several shards on it: the k-mer histogram on a 2 x 2 grid against
   the host bincount; ``Mapper(mesh=make_mesh(2, 2, [card] * 4))`` on the
   map slice's genome and reads (PAF equal to the unsharded mapper's, the
   warm-up pass's chain launches held against the plain version, three
   timed passes with the chain launch count, resident bytes per shard);
   the ``map`` CLI with ``-data_parallel true`` (the 1 x 1 grid) against no
   flag, and ``-seed_shards 2`` against the JAX package's error; seed-
   sharded ``overlap`` (2 x 2) on the first GRID_OV_READS reads of the
   overlap case against the unsharded run; ``trim -data_parallel true``
   (1 x 1 and a 2-way data grid) against the golden digest;
10. the seed-query library (``phase_library``): ``ops.match.hit_counts``
   at [4096, 65536] x [65536, 512] int8 against numpy's int32 product,
   timed beside its bound; ``hit_counts_packed`` against it;
   ``chain_batch`` and ``chain_batch_summary`` at P = 4096, NQ = 64,
   NT = 320, max_anchors = 128 against the CPU's plain run;
   ``run_chain_batch`` on a same-card 2 x 2 grid against no grid;
   ``sharded_pipeline_step`` on 1 x 1 and 2 x 2 grids against the
   unsharded functions; the verify skill's library recipe at a 4.6 Mb
   genome (every planted position recovered); every chain launch of the
   phase held against the plain version;
11. the bench (``phase_bench``): ``downpore_tpu_torch.bench``'s trim, map
   (4.6 Mb and 1 Mb), overlap and consensus sections at the bench's own
   sizes; every section must pass and every metric line carry the card's
   name; their chain and beam launches count in the kernel table;
12. the dispatch / collect contract (``phase_dispatch``, run from the
   phases that build each path: ``DISPATCH_CASES``): one full-width
   dispatch of map 4.6 Mb, of the same map on the 2 x 2 grid, of map 64
   Mb (binned), of an overlap sub-batch (round 2's engine) and of a trim
   edge and a middle batch runs under ``torch.cuda.
   set_sync_debug_mode("error")``, so any wait on the card fails the run;
   each prints its host wall time beside the device span of the work it
   enqueued, the re-runs of its collect, and the device time its padding
   slots cost (profiled dispatch + collect at the path's budget against
   the exact budget).  The timed passes of the map, grid, overlap and
   trim phases print their re-runs at collect too.  Two warm dispatches
   come first: they capture the path's CUDA graphs (counted on their
   own), so the dispatch held to the contract replays them; then one
   more dispatch + collect with the blocks run eagerly records every
   anchor and count launch, holds it against its plain version and times
   the largest of each kind alone beside its plain version, its bound and
   (a flat count) ``torch._int_mm`` of the bucket multiplicities, its
   library yardstick (``time_path_kernels``);
13. the capture / replay layer (``phase_graphs``, beside each
   ``phase_dispatch`` case, and a 2 x 1 data grid whose blocks are one
   graph each): per path, the graphs its keys hold (captures, replays,
   nodes a graph, capture ms, the distinct pair budgets), host ms a
   dispatch and device span and busy ms replayed against the same blocks
   run eagerly, and the bytes of the graph pools and of the cache's
   resident-table buffers; every path, the seed-sharded 2 x 2 grid
   included, must replay a graph at each ``captured.run`` call (its
   collect's re-runs included), capture nothing after its warm
   dispatches, and give in every replayed dispatch, taken after the
   graphs' output buffers were filled with -3, the output of every eager
   one.  The overlap
   phase prints the graphs each round captured and the resident tables
   it copied in: the later rounds with the first round's table shapes
   must capture fewer graphs in all than the first.  Every kernel launch
   in a graph counts, and is recorded for the plain-version checks, at
   each replay.

Every launch a phase records is held against its plain version and
timed (not counted) beside its bound: the chain, anchor and count kernels'
launches of the map warm-up pass, the 64 Mb warm-up pass, overlap's first
round, the grid's recorded runs and ``correct``, trim's first of each
stage (chain and anchors), the library's chain launches and ``correct``'s
beam launches.  Each path's launches of the chain, anchor and count
kernels are counted from 0 over its run (``PATH_LAUNCHES``), and a path
that runs a step but launched its kernel no time fails.  It prints the kernel table as one
JSON line, the nvidia-smi line, and as its last line ``{"ok": true,
"device": {...}}``.  Without a usable CUDA card it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package itself
(checked on its own source at start), and fails if, after every phase,
``jax`` or any ``downpore_tpu`` module is loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 1234
GENOME = 4_600_000
N_READS = 8192
ERR = 0.08
K = 11
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


def anchor_batch(rng, P: int, A: int, span: int = 400, levels=False):
    """Random anchors in the recipe of the JAX package's Pallas parity
    test: sorted positions in [0, span), rank indices with 20 swapped
    neighbours a row, 85% valid.  With ``levels``, in
    ``make_anchors_topk``'s layout instead: two anchors a query seed, side
    by side, sharing its index and position."""
    qp = np.sort(rng.integers(0, span, (P, A)), axis=1).astype(np.int32)
    tp = np.sort(rng.integers(0, span, (P, A)), axis=1).astype(np.int32)
    qi = np.argsort(np.argsort(qp, axis=1), axis=1).astype(np.int32)
    if levels:
        qi //= 2
        qp = np.repeat(qp[:, ::2], 2, axis=1)[:, :A]
    tj = np.argsort(np.argsort(tp, axis=1), axis=1).astype(np.int32)
    rows = np.repeat(np.arange(P), 20)
    sw = rng.integers(0, A - 1, P * 20)
    a, b = tj[rows, sw].copy(), tj[rows, sw + 1].copy()
    tj[rows, sw], tj[rows, sw + 1] = b, a
    valid = (rng.random((P, A)) < 0.85).astype(np.int32)
    return qi, tj, qp, tp, valid


# peak rates for the bounds: H100 SXM, 132 SMs x 64 INT32 lanes at the
# 1.98 GHz boost clock (NVIDIA's Hopper architecture white paper), and
# 3.35 TB/s of HBM3 (the data sheet)
INT32_OPS_S = 132 * 64 * 1.98e9
HBM_BYTES_S = 3.35e12
# a check of candidate p at step t (chain_scan.cu's window_linear, its forms
# precomputed): 2 index compares, 3 window compares (the branch and the two
# of the branch taken), the branch select, the key select and the max
CHAIN_OPS_PER_CHECK = 8
# the shapes the paths give the chain kernel: (name, P, A, variant, mode)
CHAIN_SHAPES = (
    ("P4096 A128 extend forward (the earlier measurements' shape)", 4096,
     128, "extend", "forward"),
    ("P4096 A128 extend fb", 4096, 128, "extend", "fb"),
    ("map [2140, 128] extend fb", 2140, 128, "extend", "fb"),
    ("map [2140, 384] extend fb", 2140, 384, "extend", "fb"),
    ("overlap [45000, 256] aligner lean", 45000, 256, "aligner", "lean"),
    ("trim [16384, 64] extend fb", 16384, 64, "extend", "fb"),
    ("trim [16384, 96] extend fb", 16384, 96, "extend", "fb"),
)
CHAIN_SWEEP_P = (264, 528, 1056, 2112, 4224, 8448, 16896, 33792)


def bound(ops: float, nbytes: float):
    """(bound ms, "operations" or "bytes"): the larger of the int32
    operations over the card's int32 rate and the bytes over its memory
    rate."""
    t_ops, t_bytes = ops / INT32_OPS_S, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def chain_bound(valid, mode: str):
    """The chain kernel's bound on these inputs: the function needs a check
    of each valid anchor t against each valid p < t, n (n - 1) / 2 for a
    row of n valid anchors, per direction (``fb`` scans twice); invalid
    anchors need none.  The bytes are each input read once and each
    output written once."""
    from downpore_tpu_torch.ops import cuda_chain
    P, A = valid.shape
    n = valid.ne(0).sum(dim=1).long()
    checks = int((n * (n - 1) // 2).sum())
    dirs = 2 if mode == "fb" else 1
    nbytes = (5 + cuda_chain.N_OUT[mode]) * P * A * 4
    return bound(checks * dirs * CHAIN_OPS_PER_CHECK, nbytes)


def chain_raw(ins, k: int, variant: str, mode: str):
    """One launch of the chain kernel into preallocated outputs, through
    its C entry point: times the kernel, not the wrapper's allocations,
    and is not counted."""
    from downpore_tpu_torch.ops import cuda_chain
    lib = cuda_chain._lib()
    P, A = ins[0].shape
    outs = torch.empty((cuda_chain.N_OUT[mode], P, A), dtype=torch.int32,
                       device=ins[0].device)
    ptrs = [o.data_ptr() for o in outs.unbind(0)]
    slots = ptrs if mode != "lean" else [ptrs[0]] + [None] * 4 + [ptrs[1]]
    c_in = (ctypes.c_void_p * 5)(*(a.data_ptr() for a in ins))
    c_out = (ctypes.c_void_p * 11)(*(slots + [None] * (11 - len(slots))))
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.chain_scan_launch(c_in, c_out, P, A, k,
                                    cuda_chain.VARIANTS[variant],
                                    cuda_chain.MODES[mode], stream)
        if err:
            raise SystemExit(f"chain_scan launch failed: {err}")
    run.outs = outs
    return run


def phase_kernel(dev):
    """The chain kernel's three entry points (forward, forward + backward
    in one launch, lean) against their plain versions on card tensors,
    exactly, at A in {64, 96, 128, 256, 384} (register forms) and 640
    (the shared-memory form), both variants; then its time at each path
    shape beside its bound.  Returns (max abs error, (ms, plain ms,
    bound ms, bound_by) at P = 4096, A = 128 forward, shape rows)."""
    from downpore_tpu_torch.ops import cuda_chain
    rng = np.random.default_rng(0)
    k = 10
    max_err = 0
    entry = {"forward": cuda_chain.chain_scan, "fb": cuda_chain.chain_scan_fb,
             "lean": cuda_chain.chain_scan_lean}
    for A in (64, 96, 128, 256, 384, 640):
        for levels in (False, True):
            ts = [torch.from_numpy(a).to(dev) for a in
                  anchor_batch(rng, 512, A, span=3 * A, levels=levels)]
            for variant in ("extend", "aligner"):
                for mode, fn in entry.items():
                    got = fn(*ts, k, variant)
                    ref = cuda_chain.chain_scan_plain(*ts, k, variant, mode)
                    torch.cuda.synchronize()
                    err = max(int((g - r).abs().max())
                              for g, r in zip(got, ref))
                    max_err = max(max_err, err)
                    if err != 0 or len(got) != len(ref):
                        raise SystemExit(
                            f"chain_scan differs from its plain version "
                            f"(A={A}, levels={levels}, {variant}, {mode})")
        log(f"chain_scan P=512 A={A}: forward, fb and lean, extend and "
            f"aligner, distinct and paired query seeds: max_abs_err=0")
    rows, timing = [], None
    for name, P, A, variant, mode in CHAIN_SHAPES:
        # the paths' layout (two anchors a query seed) but at the P4096
        # shape, whose earlier measurements had distinct query seeds
        ts = [torch.from_numpy(a).to(dev) for a in anchor_batch(
            rng, P, A, span=3 * A, levels=not name.startswith("P4096"))]
        run = chain_raw(ts, k, variant, mode)
        run()
        ref = entry[mode](*ts, k, variant)
        torch.cuda.synchronize()
        if any(not torch.equal(o, r) for o, r in zip(run.outs, ref)):
            raise SystemExit(f"chain_scan's C entry point differs from its "
                             f"wrapper at {name}")
        ms = min(cuda_ms(run, 20), cuda_ms(run, 20))
        b_ms, b_by = chain_bound(ts[4], mode)
        rows.append((name, ms, b_ms, b_by))
        log(f"chain_scan {name}: kernel {ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by}); share of the bound {b_ms / ms:.3f}")
        if timing is None:
            plain_ms = cuda_ms(lambda: cuda_chain.chain_scan_plain(
                *ts, k, variant, mode), 3)
            timing = (ms, plain_ms, b_ms, b_by)
            log(f"chain_scan {name}: plain torch {plain_ms:.2f} ms")
    # the time per pair falls with P while the card is latency-bound and
    # levels off once it is issue-bound
    sweep = []
    for P in CHAIN_SWEEP_P:
        ts = [torch.from_numpy(a).to(dev) for a in anchor_batch(rng, P, 128)]
        ms = cuda_ms(chain_raw(ts, k, "extend", "forward"), 50)
        sweep.append(f"P={P} {ms * 1e6 / P:.2f}")
    log("chain_scan A=128 extend forward, kernel us per 1,000 pairs: "
        + ", ".join(sweep))
    return max_err, timing, rows


# synthetic shapes of the anchor and count kernels' first check, the
# paths' widths (overlap's NQ = 128, NT = 2048 among them): (P, NQ, NT) and
# (M, R, W, H, BB, NB)
ANCHOR_SHAPES = ((2048, 64, 320), (1024, 128, 4096), (2048, 128, 2048),
                 (512, 300, 90), (4096, 16, 120), (4096, 32, 251))
COUNT_SHAPES = ((4096, 64, 512, 1 << 17, 0, 0), (2048, 128, 12288, 1 << 14,
                                                  0, 0),
                (4096, 64, 56, 1 << 17, 0, 0), (4096, 64, 128, 1 << 14, 8,
                                                 56), (512, 300, 13, 4096, 0,
                                                       0))


def table_size(NQ: int) -> int:
    """Entries of the anchor kernel's hash table at width NQ: the power of
    two >= 2 NQ, at least 32 (``csrc/anchors_topk.cu`` table_bits)."""
    return max(32, 1 << (2 * NQ - 1).bit_length())


def colliding_values(first_slot, NQ: int, n: int, start: int) -> list:
    """``n`` seed values >= ``start`` whose first probe in the anchor
    kernel's table at width NQ is its last entry (``first_slot(v, NQ)``,
    the kernel's own hash): their probes collide and wrap to entry 0."""
    top = table_size(NQ) - 1
    out, v = [], start
    while len(out) < n:
        if first_slot(v, NQ) == top:
            out.append(v)
        v += 1
    return out


def hard_anchor_rows(rng, P: int, NQ: int, NT: int, first_slot):
    """Anchor-build rows ``(qs, qpos, ts, tpos)`` (numpy int32, ``[P, NQ]``
    and ``[P, NT]``, P >= 8) that stress the kernel's table and scan: row
    0 query values that all probe the table's last entry first (some twice)
    and a target drawn from them; row 1 one value three times in the query
    and, in the target, five times in the first 32-seed step and again in
    later steps; row 2 values whose first and second hits straddle a step
    (j 31 and 32), a four-step load (127 and 128) and several steps (31
    and 200); row 3 no live query seed; row 4 no live target seed; row 5
    one value in every query slot; the rest from an alphabet of NT / 3
    values with -1 pads at random lengths."""
    alpha = max(4, NT // 3)
    qs = rng.integers(0, alpha, (P, NQ)).astype(np.int64)
    ts = rng.integers(0, alpha, (P, NT)).astype(np.int64)
    qs[np.arange(NQ)[None, :] >= rng.integers(0, NQ + 1, P)[:, None]] = -1
    ts[np.arange(NT)[None, :] >= rng.integers(0, NT + 1, P)[:, None]] = -1
    hot = np.array(colliding_values(first_slot, NQ, min(NQ, 48),
                                    int(rng.integers(alpha, 1 << 30))))
    qs[0] = -1
    qs[0, rng.permutation(NQ)[:len(hot)]] = hot
    if NQ >= len(hot) + 4:
        qs[0, np.flatnonzero(qs[0] < 0)[:4]] = hot[:4]
    ts[0] = np.where(rng.random(NT) < 0.1, -1, rng.choice(hot, NT))
    big = 1 << 30                       # values no other row draws
    qs[1] = -1
    qs[1, :min(3, NQ)] = big
    ts[1] = np.where(ts[1] == big, -1, ts[1])
    for j in (3, 5, 9, 17, 30, 40, 100, 129, NT - 1):
        if 0 <= j < NT:
            ts[1, j] = big
    qs[2] = -1
    ts[2] = -1
    for i, (v, js) in enumerate(((big + 1, (31, 32)), (big + 2, (127, 128)),
                                 (big + 3, (31, 200)))):
        if i < NQ:
            qs[2, i] = v
            for j in js:
                if j < NT:
                    ts[2, j] = v
    qs[3] = -1
    ts[4] = -1
    qs[5] = big + 4
    ts[5, rng.random(NT) < 0.3] = big + 4
    pos = lambda n: np.cumsum(rng.integers(1, 40, (P, n)), axis=1)
    return [a.astype(np.int32) for a in (qs, pos(NQ), ts, pos(NT))]


def hard_count_inputs(rng, H: int, W: int, M: int, R: int, NB: int = 1):
    """Retrieval-count inputs ``(mem, b, first)`` (numpy) over the whole
    int8 range: membership values in [-128, 127] with row 0 all 127 and
    row 1 all -128; ``[M, R]`` buckets below ``H // NB`` with -1 pads at
    random lengths, row 0 naming bucket 0 in every slot (the largest sum a
    16-bit lane can reach, R x 255 before the bias comes off), row 1
    bucket 1 in every slot, row 2 no live slot; ``first`` a random mask
    over the live slots."""
    mem = rng.integers(-128, 128, (H, W)).astype(np.int8)
    mem[0] = 127
    mem[1] = -128
    b = rng.integers(0, H // NB, (M, R)).astype(np.int32)
    b[np.arange(R)[None, :] >= rng.integers(0, R + 1, M)[:, None]] = -1
    b[0] = 0
    b[1] = 1
    b[2] = -1
    first = (b >= 0) & (rng.random((M, R)) < 0.6)
    return mem, b, first


def phase_anchor_counts(dev):
    """The anchor and retrieval-count kernels against their plain
    versions on synthetic card tensors at the paths' widths, before any
    path runs them: rows from a small alphabet (seeds repeated in a
    target, all -1 rows) and the hard rows of ``hard_anchor_rows``
    (colliding hash values, repeats inside one step), both anchor entries
    (the indexed one with dead slots); flat counts with and without the
    ``first`` mask and the binned form, on 0/1 membership and on
    ``hard_count_inputs``' whole int8 range.  Returns the max abs error of
    each."""
    from downpore_tpu_torch.ops import cuda_anchors, cuda_counts
    rng = np.random.default_rng(SEED + 90)
    errs = {"anchors_topk": 0, "retrieval_count": 0}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    first_slot = cuda_anchors._lib().anchors_topk_first_slot
    with uncounted():
        for P, NQ, NT in ANCHOR_SHAPES:
            alpha = max(4, NT // 3)
            qs = rng.integers(-1, alpha, (P, NQ)).astype(np.int32)
            ts = rng.integers(-1, alpha, (P, NT)).astype(np.int32)
            qs[::7] = -1
            pos = lambda n: np.cumsum(rng.integers(1, 40, (P, n)), axis=1)
            random_rows = [t(qs), t(pos(NQ).astype(np.int32)), t(ts),
                           t(pos(NT).astype(np.int32))]
            hard_rows = [t(a) for a in hard_anchor_rows(rng, P, NQ, NT,
                                                        first_slot)]
            live = rng.random(P) < 0.8
            slots = [t(rng.integers(0, P, P)), t(rng.integers(0, P, P)),
                     t(live)]
            for rows in (random_rows, hard_rows):
                for args, got in (
                        (rows, cuda_anchors.anchors_topk(*rows)),
                        (rows + slots,
                         cuda_anchors.anchors_topk_indexed(*slots, *rows))):
                    err = _max_err(got,
                                   cuda_anchors.anchors_topk_plain(*args))
                    errs["anchors_topk"] = max(errs["anchors_topk"], err)
            log(f"anchors_topk P={P} NQ={NQ} NT={NT}, rows and indexed, "
                f"random and hard rows: max_abs_err={errs['anchors_topk']}")
        for M, R, W, H, BB, NB in COUNT_SHAPES:
            NB = max(1, NB)
            zero_one = (rng.integers(0, 50, (H, W), dtype=np.uint8) == 0)
            b = rng.integers(-1, H // NB, (M, R)).astype(np.int32)
            b[::9] = -1
            cases = [(zero_one.astype(np.int8), b,
                      (b >= 0) & (rng.random((M, R)) < 0.7)),
                     hard_count_inputs(rng, H, W, M, R, NB)]
            topbin = None if not BB else t(np.stack(
                [rng.permutation(NB)[:BB] for _ in range(M)]))
            for mem, b, first in cases:
                mem, b, first = t(mem), t(b), t(first)
                for f in (first, None):
                    args = (mem, b, f, topbin, NB)
                    err = _max_err(cuda_counts.retrieval_count(*args),
                                   cuda_counts.retrieval_count_plain(*args))
                    errs["retrieval_count"] = max(errs["retrieval_count"],
                                                  err)
            log(f"retrieval_count M={M} R={R} W={W} H={H} BB={BB}, 0/1 and "
                f"whole-range int8 membership: "
                f"max_abs_err={errs['retrieval_count']}")
    if any(errs.values()):
        raise SystemExit(f"the anchor or count kernel differs from its "
                         f"plain version: {errs}")
    return errs


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
    # two warm-up passes: the first captures each dispatch's graph at the
    # JAX budgets, the second at the budgets its counts settled, so the
    # timed passes replay; the first one's path-kernel launches are
    # recorded and held against their plain versions
    calls = []
    for i in range(2):
        with patched(record_all(calls) if i == 0 else []):
            t0 = time.perf_counter()
            mapper.map_batch(reads)
            sync(dev)
        log(f"warm-up pass {time.perf_counter() - t0:.3f} s")
    log(f"map warm-up pass 1: its {len(calls)} recorded launches against "
        f"the plain versions:")
    check_recorded(calls)
    del calls

    eng.routes.clear()
    zero_launches()
    walls = []
    with counted_reruns() as reruns:
        for _ in range(TIMED_PASSES):
            t0 = time.perf_counter()
            results = mapper.map_batch(reads)
            sync(dev)
            walls.append(time.perf_counter() - t0)
    launches = path_launches("map 4.6 Mb")
    routes = dict(eng.routes)
    wall = float(np.median(walls))
    log(f"map_batch, {TIMED_PASSES} passes: wall "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; median {wall:.4f} s = "
        f"{len(reads) / wall:.1f} reads/s, {bases / wall:.0f} bases/s "
        f"({bases} bases); launches {launches}; routes {routes}; "
        f"re-runs at collect {reruns['reruns']} of "
        f"{sum(routes.values())} dispatches")
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
    ("downpore_tpu_torch.ops.map_engine", "_binned_gate",
     "dev:binned_gate"),
    ("downpore_tpu_torch.ops.map_engine", "_binned_counts_pair",
     "dev:binned_counts_pair"),
    ("downpore_tpu_torch.ops.map_engine", "compact_indices",
     "dev:gate_compact"),
    ("downpore_tpu_torch.ops.map_engine", "_build_anchors",
     "dev:build_anchors"),
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


def device_busy(events, wall_s: float) -> str:
    """The device's busy time (union of its kernel, copy and set spans:
    user ranges' device spans nest over kernels already counted and are
    left out) and idle share over a window of ``wall_s`` seconds of
    profiler ``events``, as a log fragment."""
    from torch.autograd import DeviceType
    work = [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not work:
        return ("no device work seen: device busy time and idle share not "
                "measured")
    busy_ms = _busy_us((e.time_range.start, e.time_range.end)
                       for e in work) / 1e3
    return (f"device busy {busy_ms:.3f} ms ({len(work)} device events), "
            f"idle share {1 - busy_ms / (wall_s * 1e3):.4f}")


def timed(fn, key: str, spent: dict, dev, wait: bool = True):
    """``fn`` that adds its seconds, up to a device synchronize (with
    ``wait``; a dispatch is timed without one, so that the work it enqueues
    still overlaps what its caller does next), to ``spent[key]``."""
    def wrapper(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            if wait:
                sync(dev)
            spent[key] += time.perf_counter() - t
    return wrapper


@contextlib.contextmanager
def counted_reruns():
    """A Counter whose ``reruns`` counts the re-runs at collect
    (``transfer.Pending.rerun``) in the block."""
    from collections import Counter
    from downpore_tpu_torch.ops import transfer
    counts = Counter()
    rerun = transfer.Pending.rerun

    def counting(self, *args):
        counts["reruns"] += 1
        return rerun(self, *args)
    with patched([(transfer.Pending, "rerun", counting)]):
        yield counts


DISPATCH_ROWS = []      # phase_dispatch's results, in the order measured
# the paths phase_dispatch holds to the contract, each from its phase
DISPATCH_CASES = ("map 4.6 Mb", "map 4.6 Mb on the 2 x 2 grid",
                  "map 4.6 Mb on a 2 x 1 data grid", "map 64 Mb",
                  "overlap sub-batch", "trim edge batch",
                  "trim middle batch")


def _profiled_busy_ms(run) -> float:
    """Device busy milliseconds (``device_busy``'s union of device spans)
    of ``run()`` and a synchronize, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return _busy_us((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation) / 1e3


def _graph_replays() -> dict:
    """Replays of each captured key of the process's graph cache."""
    from downpore_tpu_torch.ops import captured
    return {k: e.replays for k, e in captured.GRAPHS.entries.items()}


def phase_dispatch(name: str, dispatch, collect, need):
    """One engine dispatch at full width, held to the dispatch / collect
    contract.  ``dispatch(budget)`` enqueues the work (``budget`` None:
    the path's own budgets) and returns its pending blocks; ``collect``
    makes them exact and fetches them; ``need(futs)``, after collect, is
    the largest passing count of a block.  Two warm dispatches and
    collects first capture the path's graphs (a capture waits for the
    card; they are counted on their own; the second runs at the budgets
    the first one's counts settled); then the dispatch, now replays only,
    runs
    under ``torch.cuda.set_sync_debug_mode("error")`` (any wait on the
    card raises and fails the run), its host wall time is taken beside
    the device span between CUDA events around it, and the re-runs of its
    collect are counted; then the device busy time of dispatch + collect
    under torch.profiler at the path's budget and at the exact budget (the
    largest passing count: no padding slot, no re-run; its graphs
    captured before the profile) gives the device time the padding
    costs."""
    from downpore_tpu_torch.ops import captured
    n_keys = len(captured.GRAPHS.entries)
    for _ in range(2):
        collect(dispatch(None))
    captures = len(captured.GRAPHS.entries) - n_keys
    torch.cuda.synchronize()
    before = _graph_replays()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        futs = dispatch(None)
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    e1.record()
    e1.synchronize()
    span_ms = e0.elapsed_time(e1)
    replays = sum(r - before.get(k, 0) for k, r in _graph_replays().items())
    with counted_reruns() as reruns:
        collect(futs)
    n = need(futs)
    busy = _profiled_busy_ms(lambda: collect(dispatch(None)))
    collect(dispatch(max(1, n)))            # captures the exact budget's
    busy_exact = _profiled_busy_ms(lambda: collect(dispatch(max(1, n))))
    row = {"name": name, "dispatch_ms": host_ms, "device_span_ms": span_ms,
           "device_busy_ms": busy, "exact_budget": n,
           "exact_busy_ms": busy_exact, "padding_ms": busy - busy_exact,
           "reruns": reruns["reruns"], "captures": captures,
           "replays": replays}
    DISPATCH_ROWS.append(row)
    log(f"phase_dispatch {name}: warm dispatches captured {captures} "
        f"graphs; "
        f"dispatch {host_ms:.3f} ms on the host under "
        f"set_sync_debug_mode('error') (no wait; {replays} replays), "
        f"device span of the work it enqueued {span_ms:.3f} ms; device "
        f"busy (dispatch + collect) {busy:.3f} ms at the path's budget, "
        f"{busy_exact:.3f} ms at the exact budget {n}: padding "
        f"{busy - busy_exact:.3f} ms; re-runs at collect {reruns['reruns']}")
    # the path's anchor and count launches at its shapes: one dispatch +
    # collect with the blocks run eagerly (its graphs, captured before,
    # record nothing), each launch held against its plain version, and
    # the largest of each kind timed (``time_path_kernels``)
    calls = []
    with patched(record_all(calls, kernels=("anchors_topk",
                                            "retrieval_count"))
                 + [(captured, "run", _eager_run)]), uncounted():
        collect(dispatch(None))
    log(f"phase_dispatch {name}: the {len(calls)} anchor and count "
        f"launches of one eager dispatch + collect against their plain "
        f"versions:")
    if not any(c[0].__name__ == "anchors_topk_plain" for c in calls):
        raise SystemExit(f"phase_dispatch {name}: no anchor build recorded")
    check_recorded(calls, path=name)
    return row


GRAPH_ROWS = []         # phase_graphs' results, in the order measured
GRAPH_REPS = 5          # dispatches timed a side in phase_graphs


def _eager_run(fn, inputs, tables=None, **statics):
    """``captured.run`` without the graphs: the block called directly."""
    return fn(**inputs, **(tables or {}), **statics)


def _same(a, b) -> bool:
    """Whether two collected outputs (arrays, numbers, None, and tuples,
    lists or dicts of them) are equal, dtypes and shapes included."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and bool(np.array_equal(a, b)))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    return a == b


def _poison_graph_outputs():
    """Fill every captured graph's output buffers with a value no block
    returns in full (-3; True in a mask), so that a replay whose work did
    not run hands back the fill, not an earlier replay's result."""
    from downpore_tpu_torch.ops import captured
    with captured.GRAPHS._lock:
        for e in captured.GRAPHS.entries.values():
            for o in e.outputs:
                o.fill_(True if o.dtype == torch.bool else -3)


def _dispatch_times(dispatch, collect, reps: int, poison: bool) -> dict:
    """``reps`` dispatches, each collected before the next, then one more
    under torch.profiler: the median host ms of a dispatch (``host``), the
    median device span of the work each enqueued (CUDA events around the
    dispatch, read after its collect; ``span``), the median device time of
    dispatch + collect, its re-runs included (CUDA events; ``total``), the
    device busy ms of the profiled one (``busy``), the re-runs at collect
    over all ``reps`` + 1 (``reruns``), the ``captured.run`` calls
    (``runs``) and every collected output (``outs``).  With ``poison`` the
    graphs' output buffers are filled before each dispatch
    (``_poison_graph_outputs``)."""
    from downpore_tpu_torch.ops import captured
    host, span, total, outs = [], [], [], []
    runs = []
    run = captured.run

    def counting(*a, **kw):
        runs.append(1)
        return run(*a, **kw)
    with patched([(captured, "run", counting)]), counted_reruns() as reruns:
        for _ in range(reps):
            if poison:
                _poison_graph_outputs()
            torch.cuda.synchronize()
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
            e0.record()
            t0 = time.perf_counter()
            futs = dispatch(None)
            host.append((time.perf_counter() - t0) * 1e3)
            e1.record()
            outs.append(collect(futs))
            e2.record()
            e2.synchronize()
            span.append(e0.elapsed_time(e1))
            total.append(e0.elapsed_time(e2))
        if poison:
            _poison_graph_outputs()
        busy = _profiled_busy_ms(lambda: outs.append(collect(dispatch(None))))
    return dict(host=float(np.median(host)), span=float(np.median(span)),
                total=float(np.median(total)), busy=busy,
                reruns=reruns["reruns"], runs=len(runs), outs=outs)


def phase_graphs(name: str, dispatch, collect):
    """The capture / replay layer on one full-width path (``dispatch`` and
    ``collect`` as ``phase_dispatch`` takes them): the graphs the path's
    keys hold (captures, replays, nodes a graph, capture ms, replays by
    pair budget), host ms a dispatch and the device span, dispatch +
    collect time (CUDA events) and busy ms (torch.profiler), replays
    against the same blocks run eagerly (``captured.run`` patched to call
    them directly) in the same call, and the bytes of the graph pools and
    of the cache's resident tables.  The path must replay, capture nothing
    after its warm dispatch, replay a graph at every ``captured.run`` call
    of its measured dispatches (re-runs at collect included), and every
    replayed dispatch's output, each taken after the graphs' output
    buffers were poisoned, must equal every eager one's."""
    from downpore_tpu_torch.ops import captured
    G = captured.GRAPHS
    n_keys = len(G.entries)
    collect(dispatch(None))
    captured_now = len(G.entries) - n_keys
    before = _graph_replays()
    rep = _dispatch_times(dispatch, collect, GRAPH_REPS, poison=True)
    after = _graph_replays()
    keys = [k for k, r in after.items() if r > before.get(k, 0)]
    with patched([(captured, "run", _eager_run)]):
        eager = _dispatch_times(dispatch, collect, GRAPH_REPS, poison=False)
    stats = G.stats()
    mine = [stats[k] for k in keys]
    replays = sum(after[k] - before.get(k, 0) for k in keys)
    by_budget = {}
    for k in keys:
        b = stats[k]["statics"].get("pair_budget")
        by_budget[b] = by_budget.get(b, 0) + after[k] - before.get(k, 0)
    ref = eager["outs"][0]
    equal = all(_same(o, ref) for o in rep["outs"] + eager["outs"])
    row = {"name": name, "keys": len(keys), "captures": captured_now,
           "replays": replays, "runs": rep["runs"],
           "replays_by_budget": by_budget,
           "nodes": sorted(s["nodes"] for s in mine),
           "capture_ms": sorted(round(s["capture_ms"], 3) for s in mine),
           "replay": rep, "eager": eager, "equal": equal,
           "pool_bytes": G.pool_bytes(), "table_bytes": G.table_bytes()}
    GRAPH_ROWS.append(row)
    log(f"phase_graphs {name}: {row['keys']} keys replayed "
        f"({captured_now} captured by its warm dispatch), "
        f"{replays} replays for {rep['runs']} captured.run calls in "
        f"{GRAPH_REPS + 1} dispatches (replays by pair budget {by_budget}; "
        f"re-runs at collect {rep['reruns']} replayed, {eager['reruns']} "
        f"eager); nodes a graph {row['nodes']}; capture ms "
        f"{row['capture_ms']}; host ms a dispatch {rep['host']:.3f} "
        f"replayed vs {eager['host']:.3f} eager; device span "
        f"{rep['span']:.3f} vs {eager['span']:.3f} ms; dispatch + collect "
        f"(CUDA events) {rep['total']:.3f} vs {eager['total']:.3f} ms; "
        f"device busy (profiler) {rep['busy']:.3f} vs {eager['busy']:.3f} "
        f"ms; every replayed output equal to the eager ones (graph outputs "
        f"poisoned before each replayed dispatch): {equal}; graph pools "
        f"{row['pool_bytes']} bytes, resident-table buffers "
        f"{row['table_bytes']} bytes (all graphs so far: {len(G.entries)})")
    if not replays or replays != rep["runs"] or len(G.entries) != n_keys \
            + captured_now:
        raise SystemExit(f"phase_graphs {name}: {replays} replays for "
                         f"{rep['runs']} captured.run calls, "
                         f"{len(G.entries) - n_keys - captured_now} "
                         f"captures after the warm dispatch")
    if not equal:
        raise SystemExit(f"phase_graphs {name}: a replayed dispatch's output "
                         f"differs from the eager one's")
    return row


def map_dispatch_case(name: str, mapper, reads):
    """``phase_dispatch`` of one map dispatch: the end windows of the first
    2048 reads (4096 windows, the mapper's dispatch size)."""
    eng = mapper.engine
    es = mapper.edge_size
    wins = []
    for r in reads[:2048]:
        wins += [r.subsequence(0, es), r.subsequence(len(r) - es, len(r))]
    packed = eng.pack_query_windows(wins)
    base_min = np.maximum(5, packed[6] // 5).astype(np.int32)
    dispatch = lambda b: eng.dispatch_packed(packed, base_min,
                                             pair_budget=b or 0)
    collect = lambda f: eng.collect_arrays_many([f])
    row = phase_dispatch(
        name, dispatch, collect,
        lambda f: max(int(p.host.wait()[0][0]) for p in f[1]))
    phase_graphs(name, dispatch, collect)
    return row


@contextlib.contextmanager
def patched(subs):
    """``(owner, attribute, replacement)`` substitutions for the block;
    afterwards each attribute is restored, or unshadowed where the owner
    inherited it."""
    saved = [(owner, n, owner.__dict__.get(n)) for owner, n, _ in subs]
    for owner, n, fn in subs:
        setattr(owner, n, fn)
    try:
        yield
    finally:
        for owner, n, fn in reversed(saved):
            if fn is None:
                delattr(owner, n)
            else:
                setattr(owner, n, fn)


def ranged(ranges):
    """``patched`` wrapping each ``(module[:class], attribute, name)`` of
    ``ranges`` in a ``torch.profiler.record_function`` range."""
    import importlib
    subs = []
    for where, attr, name in ranges:
        mod, _, cls = where.partition(":")
        owner = importlib.import_module(mod)
        if cls:
            owner = getattr(owner, cls)
        subs.append((owner, attr, _ranged(getattr(owner, attr), name)))
    return patched(subs)


def report_ranges(prof, ranges, out_path):
    """Each range's call count, host time and device span in the events of
    ``prof``; the profiler tables go to ``out_path``."""
    from torch.autograd import DeviceType
    evts = prof.events()
    for _, _, name in ranges:
        host = [e for e in evts if e.name == name
                and e.device_type == DeviceType.CPU]
        if not host:
            continue
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


def phase_profile(mapper, reads, out_path=PROFILE_OUT):
    """One unsharded ``map_batch`` pass under ``torch.profiler`` (CPU +
    CUDA), with the stages of ``PROFILE_RANGES`` ranged.  Unsharded,
    because ``map_batch`` maps 2048 reads or more as two shards on two
    threads, and the profiler records ranges only on the thread that
    started it; the device work is the same.  Prints the pass's wall time,
    the device's busy time and idle share (``device_busy``), the kernel
    launch count, and each range's host time and device span; writes the
    profiler tables to ``out_path``."""
    from torch.profiler import ProfilerActivity, profile

    with ranged(PROFILE_RANGES):
        sync(mapper.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mapper._map_batch_one(reads)
            sync(mapper.device)
            wall = time.perf_counter() - t0
    evts = prof.events()
    launches = sum(1 for e in evts if e.name == "cudaLaunchKernel")
    sync_ms = sum(e.time_range.elapsed_us() for e in evts
                  if e.name == "cudaStreamSynchronize") / 1e3
    log(f"profiled unsharded pass: wall {wall * 1e3:.3f} ms; "
        f"{device_busy(evts, wall)}; {launches} cudaLaunchKernel; host waits "
        f"in cudaStreamSynchronize {sync_ms:.3f} ms")
    report_ranges(prof, PROFILE_RANGES, out_path)


def phase_card_vs_cpu(mapper, reads, n: int = 256):
    """The first ``n`` reads mapped on the card and by a CPU engine built
    from the same index: byte-identical PAF."""
    cpu = copy.copy(mapper)
    cpu.device = torch.device("cpu")
    cpu._build_device_index()
    sub = reads[:n]
    on_card = [mapper.as_string(m) for ms in mapper.map_batch(sub)
               for m in ms]
    on_cpu = [cpu.as_string(m) for ms in cpu.map_batch(sub) for m in ms]
    same = "\n".join(on_card) == "\n".join(on_cpu)
    log(f"card vs cpu on {len(sub)} reads: {len(on_card)} / {len(on_cpu)} "
        f"PAF lines, byte-identical: {same}")
    if not same or not on_card:
        raise SystemExit("PAF on the card differs from PAF on the CPU")


B_BAND = 65536
# input and output sets the band kernel's timed launches take in turn:
# 8 x 25.4 MB, four times the H100's 50 MB L2, so every launch reads and
# writes device memory, as the bound assumes
BAND_L2_SETS = 8


def phase_band(dev):
    """Band kernel vs plain at B_BAND x 32 (test_align.py's recipe)."""
    from downpore_tpu_torch.ops import cuda_band
    rng = np.random.default_rng(21)
    ds = rng.integers(0, 40, (B_BAND, 32)).astype(np.int32)
    poffs = rng.integers(0, 500, (B_BAND, 32)).astype(np.int32)
    poffs[rng.random(poffs.shape) < 0.25] = cuda_band.BAND_FULL
    ds, poffs = (torch.from_numpy(a).to(dev) for a in (ds, poffs))
    out, m = cuda_band.update_bands(ds, poffs, 300)
    ref_out, ref_m = cuda_band.update_bands_plain(ds, poffs, 300)
    torch.cuda.synchronize()
    err = max(int((out - ref_out).abs().max()), int((m - ref_m).abs().max()))
    wrapper_ms = cuda_ms(lambda: cuda_band.update_bands(ds, poffs, 300), 50)
    warm = band_raw(ds, poffs, 300)
    cold = band_raw(ds, poffs, 300, BAND_L2_SETS)
    for run in (warm, cold):
        run()
        torch.cuda.synchronize()
        if not (torch.equal(run.outs[0], out)
                and torch.equal(run.outs[1], m)):
            raise SystemExit("update_bands's C entry point differs from its "
                             "wrapper")
    warm_ms = min(cuda_ms(warm, 50), cuda_ms(warm, 50))
    ms = min(cuda_ms(cold, 4 * BAND_L2_SETS), cuda_ms(cold, 4 * BAND_L2_SETS))
    plain_ms = cuda_ms(lambda: cuda_band.update_bands_plain(ds, poffs, 300),
                       10)
    # ~12 int32 operations a band lane (four terms, saturating adds, the
    # minimum, the threshold); bytes: two inputs, the bands and minima out
    b_ms, b_by = bound(12 * B_BAND * 32, (3 * B_BAND * 32 + B_BAND) * 4)
    log(f"update_bands B={B_BAND} W=32: max_abs_err={err}; kernel alone "
        f"{ms:.4f} ms with cold L2 ({BAND_L2_SETS} input and output sets in "
        f"turn), {warm_ms:.4f} ms on one set (warm L2), through the wrapper "
        f"{wrapper_ms:.4f} ms; plain torch {plain_ms:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}), share {b_ms / ms:.3f}")
    if err != 0:
        raise SystemExit("update_bands differs from its plain version")
    return err, ms, plain_ms, b_ms, b_by


def band_raw(ds, poffs, threshold: int, sets: int = 1):
    """One launch of the band kernel through its C entry point into
    preallocated outputs: times the kernel, not the wrapper's allocations,
    and is not counted.  With ``sets`` > 1 each call takes the next of
    ``sets`` copies of the inputs and outputs in turn, so a copy is out
    of L2 when its turn comes; ``run.outs`` are the first set's."""
    from downpore_tpu_torch.ops import _build
    lib = _build.load("band_update")
    lib.band_update_launch.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.band_update_launch.restype = ctypes.c_int
    B, W = ds.shape
    bufs = [(ds, poffs) if i == 0 else (ds.clone(), poffs.clone())
            for i in range(sets)]
    bufs = [(d, p, torch.empty((B, W), dtype=torch.int32, device=ds.device),
             torch.empty((B,), dtype=torch.int32, device=ds.device))
            for d, p in bufs]
    stream = torch.cuda.current_stream().cuda_stream
    turn = [0]

    def run():
        d, p, out, m = bufs[turn[0] % sets]
        turn[0] += 1
        err = lib.band_update_launch(d.data_ptr(), p.data_ptr(),
                                     out.data_ptr(), m.data_ptr(), B, W,
                                     threshold, stream)
        if err:
            raise SystemExit(f"update_bands launch failed: {err}")
    run.outs = bufs[0][2:]
    return run


def consensus_jobs(rng, n_jobs: int, n_members: int = 6,
                   core_len: int = 500, k: int = 5, err: float = 0.08):
    """bench.py's consensus jobs: k-mer arrays of ``n_members`` copies of a
    random core at ``err`` substitutions."""
    jobs = []
    for _ in range(n_jobs):
        core = rng.integers(0, 4, core_len + k - 1)
        members = []
        for _ in range(n_members):
            codes = core.copy()
            m = rng.random(len(codes)) < err
            codes[m] = rng.integers(0, 4, int(m.sum()))
            km = np.zeros(len(codes) - k + 1, np.int64)
            for j in range(k):
                km = (km << 2) | codes[j:j + len(km)]
            members.append(km.astype(np.int32))
        jobs.append(members)
    return jobs


def phase_beam(dev):
    """Beam kernel vs plain on chains and n_valid: the bench bucket with
    the simple-k measure, and a 64-job subset with the table measure."""
    from downpore_tpu_torch.ops import cuda_beam, dtw
    k, beam, thr, gap = 5, 4, 200, 5
    jobs = consensus_jobs(np.random.default_rng(SEED + 30), 1024)
    N, L = 8, 512                     # consensus_kmers_bulk's bucket
    seqs = np.empty((len(jobs), N, L), np.int32)
    lens = np.empty((len(jobs), N), np.int32)
    firsts = np.empty(len(jobs), np.int32)
    for i, job in enumerate(jobs):
        seqs[i], lens[i], firsts[i] = dtw._pad_job(job, N, L)
    t_max = dtw._t_max(L)
    seqs, lens, firsts = (torch.from_numpy(a).to(dev)
                          for a in (seqs, lens, firsts))
    size = 4 ** k
    ar = torch.arange(size, dtype=torch.int32, device=dev)
    table = dtw._simple_distance(ar[:, None], ar[None, :], k).to(
        torch.int16).contiguous()
    max_err = 0
    times = {}
    for name, sl, tab, sk in (("simple", slice(None), None, k),
                              ("table", slice(0, 64), table, 0)):
        args = (seqs[sl].contiguous(), lens[sl].contiguous(),
                firsts[sl].contiguous(), tab, k, beam, t_max, thr, gap, sk)
        got = cuda_beam.beam_consensus(*args)
        ref = cuda_beam.beam_consensus_plain(*args)
        torch.cuda.synchronize()
        err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
        ms = cuda_ms(lambda: cuda_beam.beam_consensus(*args), 5)
        plain_ms = cuda_ms(lambda: cuda_beam.beam_consensus_plain(*args), 1)
        b_ms, b_by = beam_bound(args[0], args[1], got[1], beam, t_max, tab)
        times[name] = (ms, plain_ms, b_ms, b_by)
        J = args[0].shape[0]
        log(f"beam_consensus {name} measure, {J} jobs x {N} members x "
            f"L={L}, t_max={t_max}: max_abs_err={err} (chains, n_valid); "
            f"mean n_valid {got[1].float().mean().item():.1f}; kernel "
            f"{ms:.3f} ms, plain torch {plain_ms:.3f} ms; bound {b_ms:.4f} "
            f"ms ({b_by}), share {b_ms / ms:.3f}")
        if err != 0:
            raise SystemExit(f"beam_consensus ({name}) differs from its "
                             "plain version")
        max_err = max(max_err, err)
        if name == "simple":
            simple = got
    # the table is the simple measure's: both measures agree on the subset
    if not (torch.equal(got[0], simple[0][:64])
            and torch.equal(got[1], simple[1][:64])):
        raise SystemExit("table and simple-k measures disagree")
    return max_err, times["simple"]


def mutate_fast(rng, arr, rate: float):
    """test_cli_golden.py's error model, vectorized: at ``rate``, half
    deletions, a quarter mismatches, a quarter insertions after the
    base."""
    r = rng.random(len(arr))
    dele = r < rate * 0.5
    mis = (r >= rate * 0.5) & (r < rate * 0.75)
    ins = (r >= rate * 0.75) & (r < rate)
    out = arr.copy()
    out[mis] = BASES[rng.integers(0, 4, int(mis.sum()))]
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    res = out[np.repeat(np.arange(len(arr)), reps)]
    first = np.cumsum(reps) - reps
    res[first[ins] + 1] = BASES[rng.integers(0, 4, int(ins.sum()))]
    return res


CORRECT_GENOME = 1_000_000
CORRECT_READS = 2048
CORRECT_ERR = 0.03
CONTAIN_K = 15
CONTAIN_MIN = 0.8


def correct_case():
    """Genome and reads for the correct phase: reads of 5-10 kb at random
    positions with CORRECT_ERR errors, odd reads reverse-complemented."""
    rng = np.random.default_rng(SEED + 40)
    genome = BASES[rng.integers(0, 4, CORRECT_GENOME)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    records = []
    for i in range(CORRECT_READS):
        L = int(rng.integers(5000, 10_000))
        p = int(rng.integers(0, CORRECT_GENOME - L))
        s = mutate_fast(rng, genome[p:p + L], CORRECT_ERR).tobytes()
        if i % 2:
            s = s.translate(comp)[::-1]
        records.append((f"c{i}.{p}", s.decode()))
    return genome, records


def golden_overlap_records():
    """test_cli_golden.py's 48-read overlap fixture (seed 22): reads of
    2.5-5 kb from a 40 kb genome at ~2% error."""
    rng = np.random.default_rng(22)
    letters, rate = "ACGT", 0.02
    genome = "".join(letters[i] for i in rng.integers(0, 4, 40000))
    records = []
    for i in range(48):
        L = int(rng.integers(2500, 5000))
        pos = int(rng.integers(0, 40000 - L))
        out = []
        for c in genome[pos:pos + L]:
            r = rng.random()
            if r < rate * 0.5:
                continue
            if r < rate * 0.75:
                out.append(letters[rng.integers(0, 4)])
            elif r < rate:
                out.append(c)
                out.append(letters[rng.integers(0, 4)])
            else:
                out.append(c)
        records.append((f"cr{i}.{pos}.{pos + L}", "".join(out)))
    return records


def write_model(path: str, k: int = 5):
    """A current-level model file (k-mer, level per line) with seeded
    random levels: the ``-model`` table measure's input."""
    rng = np.random.default_rng(8)
    with open(path, "w") as f:
        for v in range(4 ** k):
            km = "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3]
                         for i in range(k))
            f.write(f"{km}\t{rng.uniform(60.0, 120.0):.3f}\n")


# the start of correct's stderr line when its device consensus raised and
# it reran the host engine (the JAX command's behaviour, which the port
# keeps): a card run that prints it timed the host engine, and fails
FALLBACK_LINE = "Device consensus failed ("


def run_correct(records, device: str, model: bool = False,
                trim: bool = False):
    """``correct -input reads.fa`` through the port's CLI on ``device``
    (with ``-model`` and a ``write_model`` file when ``model``, with
    ``-trim 1`` when ``trim``); returns (stdout, stderr).  On the card it
    fails where the device consensus fell back to the host engine."""
    import io
    import tempfile
    from downpore_tpu_torch.cli.main import main as cli_main
    out, err = io.StringIO(), io.StringIO()
    with tempfile.TemporaryDirectory() as d, device_env(device):
        path = os.path.join(d, "reads.fasta")
        with open(path, "w") as f:
            f.writelines(f">{n}\n{s}\n" for n, s in records)
        argv = ["correct", "-input", path]
        if model:
            argv += ["-model", os.path.join(d, "model.txt")]
            write_model(argv[-1])
        if trim:
            argv += ["-trim", "1"]
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            cli_main(argv)
    if device != "cpu" and FALLBACK_LINE in err.getvalue():
        raise SystemExit("correct on the card fell back to the host engine: "
                         + err.getvalue()[err.getvalue().index(
                             FALLBACK_LINE):].splitlines()[0])
    return out.getvalue(), err.getvalue()


@contextlib.contextmanager
def device_env(device: str):
    """The port's device variable set to ``device`` for the block."""
    from downpore_tpu_torch import DEVICE_ENV
    old = os.environ.get(DEVICE_ENV)
    os.environ[DEVICE_ENV] = device
    try:
        yield
    finally:
        if old is None:
            del os.environ[DEVICE_ENV]
        else:
            os.environ[DEVICE_ENV] = old


def _kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """2-bit packed k-mers of an ASCII ACGT array."""
    codes = np.searchsorted(BASES, seq).astype(np.int64)
    n = len(codes) - k + 1
    km = np.zeros(max(n, 0), np.int64)
    for j in range(k):
        km = (km << 2) | codes[j:j + n]
    return km


def containment(seqs, genome) -> list:
    """Per sequence, the share of its CONTAIN_K-mers found in the genome
    or its reverse complement."""
    rc = BASES[3 - np.searchsorted(BASES, genome)][::-1]
    ref = np.unique(np.concatenate([_kmer_codes(genome, CONTAIN_K),
                                    _kmer_codes(rc, CONTAIN_K)]))
    out = []
    for s in seqs:
        km = _kmer_codes(np.frombuffer(s.encode(), np.uint8), CONTAIN_K)
        out.append(float(np.isin(km, ref).mean()) if len(km) else 0.0)
    return out


def _table_args(plain, a) -> tuple:
    """Positions of the resident tables among a recorded launch's
    arguments: the membership of a retrieval count, the four row tables of
    an indexed anchor build."""
    name = plain.__name__
    if name == "retrieval_count_plain":
        return (0,)
    if name == "anchors_topk_plain" and len(a) > 4 and a[4] is not None:
        return (0, 1, 2, 3)
    return ()


def recording(launch, plain, calls: list, want=None, tables=None):
    """``launch`` (a kernel wrapper's ``_launch``) that also keeps a copy
    of each launch's card inputs and outputs in ``calls``, to be held
    against ``plain`` (and timed) after the run.  A launch captured into a
    CUDA graph (``captured.run``) is recorded at every replay of the graph:
    the capture keeps the launch's buffers in the graph (referenced, so no
    later node reuses them), and each replay copies them once the replay
    is enqueued.  ``want()`` says whether to record a launch now (default:
    while the wrapper is its module's ``_launch``); the first replay it
    refuses releases the buffers.  With a ``tables`` dict, the resident
    tables of the launches (``_table_args``: memberships, chunk seed
    tables) are copied once per content (tensor and version counter; the
    dict holds the tensor, so its memory is not reused while it is
    there), not once per launch."""
    from downpore_tpu_torch.ops import captured

    def active():
        if want is not None:
            return want()
        return getattr(sys.modules[launch.__module__], "_launch",
                       None) is wrapper

    def copy(args):
        once = _table_args(plain, args) if tables is not None else ()
        out = []
        for i, x in enumerate(args):
            if not torch.is_tensor(x):
                out.append(x)
                continue
            if i not in once:
                out.append(x.clone())
                continue
            key = (x.data_ptr(), tuple(x.shape), tuple(x.stride()), x.dtype)
            hit = tables.get(key)
            if hit is None or hit[1] != x._version:
                hit = tables[key] = (x, x._version, x.clone())
            out.append(hit[2])
        return out

    def keep(saved, outs):
        calls.append((plain, copy(saved), [o.clone() for o in outs],
                      launch))

    def wrapper(*a):
        if captured.capturing():
            out = launch(*a)
            if a[0].numel():
                held = [a, out if isinstance(out, tuple) else (out,)]

                def at_replay():
                    if held and active():
                        keep(*held)
                    else:
                        held.clear()
                captured.each_run(at_replay)
            return out
        if not (a[0].numel() and active()):
            return launch(*a)
        saved = copy(a)
        out = launch(*a)
        outs = out if isinstance(out, tuple) else (out,)
        calls.append((plain, saved, [o.clone() for o in outs], launch))
        return out
    return wrapper


# the kernels of the map, overlap and trim paths
PATH_KERNELS = ("chain_scan", "anchors_topk", "retrieval_count")
PATH_LAUNCHES = {}    # path -> each path kernel's launches over its run
RECORDED_ERRS = {}    # kernel -> max abs error of its recorded launches
KERNEL_ROWS = []      # the anchor and count kernels timed at path shapes
# a directory where time_path_kernels also saves each launch it times
# (``--keep-kernel-args``; scripts/ab_paths.py --cases anchor_counts)
KEEP_KERNEL_ARGS = None


def path_modules():
    """(name, module, plain version) of each path kernel."""
    from downpore_tpu_torch.ops import cuda_anchors, cuda_chain, cuda_counts
    return (("chain_scan", cuda_chain, cuda_chain.chain_scan_plain),
            ("anchors_topk", cuda_anchors, cuda_anchors.anchors_topk_plain),
            ("retrieval_count", cuda_counts,
             cuda_counts.retrieval_count_plain))


def zero_launches():
    """Every path kernel's launch count set to 0."""
    for name, mod, _ in path_modules():
        getattr(mod, name).launches = 0


def launch_counts() -> dict:
    return {name: getattr(mod, name).launches
            for name, mod, _ in path_modules()}


def path_launches(path: str, need=PATH_KERNELS) -> dict:
    """The path kernels' launches since ``zero_launches``, kept under
    ``path`` for the kernel table; fails when a kernel of ``need`` (the
    steps the path runs) launched no time."""
    got = launch_counts()
    PATH_LAUNCHES[path] = got
    missing = [k for k in need if got[k] <= 0]
    if missing:
        raise SystemExit(f"the {path} path launched no {', '.join(missing)} "
                         f"kernel: {got}")
    return got


def record_all(calls: list, want=None, kernels=PATH_KERNELS):
    """``patched`` substitutions that record every launch of the path
    kernels (``kernels``) into ``calls``, their resident tables copied
    once (``recording``)."""
    tables = {}
    return [(mod, "_launch", recording(mod._launch, plain, calls, want,
                                       tables))
            for name, mod, plain in path_modules() if name in kernels]


# a lookup in the anchor kernel's table: the hash (a multiply and a
# shift), the key compare and the select of the entry or of the next probe;
# an insert likewise, with a compare-and-swap in place of the compare
ANCHOR_OPS_PER_LOOKUP = 4


def _anchor_rows(args):
    """The query and target seed rows an anchor launch reads, as rows."""
    qs, _, ts, _ = args[:4]
    if len(args) > 4 and args[4] is not None:
        mi, ci, live = args[4:7]
        return torch.where(live[:, None], qs[mi], -1), ts[ci]
    return qs, ts


def _rows_read(idx) -> int:
    """Distinct rows among ``idx``: each input row is read once."""
    return int(torch.unique(idx).numel()) if idx.numel() else 0


def anchor_work(q, t) -> dict:
    """What an anchor launch's rows (``_anchor_rows``) need: a lookup of
    each live target seed of each pair that has a live query seed, an
    insert of each live query seed; and, for reference, the compares of
    every live query seed with every live target seed of its pair (what a
    brute-force build does, and what the bound counted before)."""
    nq = q.ge(0).sum(dim=1).long()
    nt = t.ge(0).sum(dim=1).long()
    return {"lookups": int(nt[nq.gt(0)].sum()), "inserts": int(nq.sum()),
            "compares": int((nq * nt).sum())}


def anchors_bound(args, outs):
    """The anchor kernel's bound on these inputs: ``anchor_work``'s lookups
    and inserts at ``ANCHOR_OPS_PER_LOOKUP`` int32 operations each; the
    bytes are the distinct rows the pairs with a live query seed read
    (seeds and positions of the query, seeds of the target; of the tables,
    with the indexed entry), the hits' target positions and the slot
    arrays, each read once, and the outputs written once."""
    q, t = _anchor_rows(args)
    work = anchor_work(q, t)
    P, A = outs[0].shape
    busy = q.ge(0).any(dim=1)
    if len(args) > 4 and args[4] is not None:
        q_rows = _rows_read(args[4][busy])
        t_rows = _rows_read(args[5][busy])
        slots = P * 17
    else:
        q_rows = t_rows = int(busy.sum())
        slots = 0
    nbytes = q_rows * q.shape[1] * 8 + t_rows * t.shape[1] * 4 \
        + int(outs[4].sum()) * 4 + P * A * 17 + P * 4 + slots
    return bound((work["lookups"] + work["inserts"]) * ANCHOR_OPS_PER_LOOKUP,
                 nbytes)


def counts_bound(args):
    """The retrieval-count kernel's bound on these inputs: an add per byte
    of every live slot's gathered row (each of its ``BB`` bins' in the
    binned form; one more per byte of a ``first`` slot), against the
    bytes of the distinct membership rows the live slots name, the
    buckets, mask and bins, each read once, and the int32 outputs written
    once."""
    mem, b, first, topbin, NB = args
    M, R = b.shape
    W = mem.shape[1]
    BB = 1 if topbin is None else topbin.shape[1]
    live = b.ge(0)
    adds = int(live.sum()) * BB * W
    if topbin is None:
        rows = b[live].long().clamp(max=mem.shape[0] - 1)
    else:
        rows = (b.clamp(min=0).long()[:, :, None] * NB
                + topbin[:, None, :])[live]
    nbytes = _rows_read(rows) * W + M * R * 4 + M * BB * W * 4
    if first is not None:
        adds += int((first & live).sum()) * BB * W
        nbytes += M * R + M * BB * W * 4
    if topbin is not None:
        nbytes += M * BB * 8
    return bound(adds, nbytes)


def anchors_raw(args):
    """One launch of the anchor kernel on a recorded launch's arguments,
    through its C entry point into preallocated outputs: times the kernel,
    not the wrapper, and is not counted."""
    from downpore_tpu_torch.ops import cuda_anchors
    lib = cuda_anchors._lib()
    qs, mi = args[0], (args[4] if len(args) > 4 else None)
    outs = cuda_anchors._outputs((qs if mi is None else mi).shape[0],
                                 qs.shape[1], qs.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = cuda_anchors._call(lib, outs, *args, stream=stream)
        if err:
            raise SystemExit(f"anchors_topk launch failed: {err}")
    run.outs = outs
    return run


def counts_raw(args):
    """One launch of the retrieval-count kernel on a recorded launch's
    arguments, through its C entry point into preallocated outputs."""
    from downpore_tpu_torch.ops import cuda_counts
    lib = cuda_counts._lib()
    outs = cuda_counts._outputs(*args[:4])
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = cuda_counts._call(lib, outs, *args, stream=stream)
        if err:
            raise SystemExit(f"retrieval_count launch failed: {err}")
    run.outs = outs
    return run


def counts_library(args, outs):
    """The library yardstick of a flat retrieval count: one
    ``torch._int_mm`` of the ``[M, H]`` int8 bucket-multiplicity matrix by
    the membership, which gives the run count ``c``.  Returns (ms, equal
    to the kernel's c), or None where no such call exists (the binned
    form, shapes ``_int_mm`` refuses, a multiplicity above int8).  The port
    never calls it."""
    mem, b, first, topbin, _ = args
    M, R = b.shape
    H, W = mem.shape
    if topbin is not None or M <= 16 or H % 8 or W % 8:
        return None
    mult = torch.zeros((M, H), dtype=torch.int32, device=mem.device)
    mult.scatter_add_(1, b.clamp(min=0).long(), b.ge(0).int())
    if int(mult.max()) > 127:
        return None
    a8 = mult.to(torch.int8)
    del mult
    run = lambda: torch._int_mm(a8, mem)
    same = torch.equal(run(), outs[0])
    return min(cuda_ms(run, 3), cuda_ms(run, 3)), same


def time_path_kernels(path: str, calls):
    """The anchor and count kernels of one path's recorded launches, the
    largest launch of each kind (anchors: rows or indexed; counts: flat
    or binned, with or without ``first``): the kernel alone, its plain
    version and (a flat count) the library call on the same inputs,
    beside the bound; a row each in KERNEL_ROWS."""
    largest = {}
    for plain, args, outs, _ in calls:
        name = plain.__name__.removesuffix("_plain")
        if name == "anchors_topk":
            kind = "indexed" if len(args) > 4 and args[4] is not None \
                else "rows"
            size = outs[0].numel()
        elif name == "retrieval_count":
            kind = ("binned" if args[3] is not None else "flat") \
                + (" + first" if args[2] is not None else "")
            size = args[1].numel() * outs[0].numel() // max(1, args[1].shape[0])
        else:
            continue
        if size >= largest.get((name, kind), (-1,))[0]:
            largest[(name, kind)] = (size, plain, args, outs)
    for (name, kind), (_, plain, args, outs) in sorted(largest.items()):
        anchors = name == "anchors_topk"
        run = (anchors_raw if anchors else counts_raw)(args)
        ms = min(cuda_ms(run, 10), cuda_ms(run, 10))
        plain_ms = cuda_ms(lambda: plain(*args), 1)
        b_ms, b_by = anchors_bound(args, outs) if anchors \
            else counts_bound(args)
        lib = None if anchors else counts_library(args, outs)
        lib_ms = None if lib is None or not lib[1] else lib[0]
        extra = ""
        if anchors:
            q, t = _anchor_rows(args)
            shape = f"P={outs[0].shape[0]} NQ={q.shape[1]} NT={t.shape[1]}"
            work = anchor_work(q, t)
            extra = (f" ({work['lookups']} lookups, {work['inserts']} "
                     f"inserts; a brute-force build's {work['compares']} "
                     f"compares, {work['compares'] * 3} operations, would "
                     f"take {work['compares'] * 3 / INT32_OPS_S * 1e3:.4f} "
                     f"ms)")
        else:
            shape = (f"M={args[1].shape[0]} R={args[1].shape[1]} "
                     f"W={args[0].shape[1]} H={args[0].shape[0]}"
                     + (f" BB={args[3].shape[1]} NB={args[4]}"
                        if args[3] is not None else ""))
        row = dict(path=path, name=name, kind=kind, shape=shape, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        KERNEL_ROWS.append(row)
        if KEEP_KERNEL_ARGS is not None:
            keep_kernel_args(row, args, outs)
        log(f"  {name} ({kind}) at {path} [{shape}]: kernel {ms:.4f} ms, "
            f"plain torch {plain_ms:.3f} ms, library "
            + (f"{lib_ms:.4f} ms (torch._int_mm)" if lib_ms is not None
               else ("null" if lib is None else
                     "null (its product differs)"))
            + f"; bound {b_ms:.4f} ms ({b_by}){extra}; share "
            f"{b_ms / ms:.3f}")


def keep_kernel_args(row, args, outs) -> None:
    """One timed launch (its ``KERNEL_ROWS`` row, arguments and outputs,
    on the host) saved as the next numbered file of ``KEEP_KERNEL_ARGS``."""
    os.makedirs(KEEP_KERNEL_ARGS, exist_ok=True)
    host = lambda a: a.cpu() if torch.is_tensor(a) else a
    path = os.path.join(KEEP_KERNEL_ARGS,
                        f"{len(os.listdir(KEEP_KERNEL_ARGS)):03d}.pt")
    torch.save({"row": row, "args": [host(a) for a in args],
                "outs": [host(o) for o in outs]}, path)


BEAM_OPS_PER_CELL = 20   # distance, band terms, saturating adds, min, vote


def beam_bound(seqs, lens, n_valid, beam: int, t_max: int, table=None,
               shapes=None):
    """The beam kernel's bound on these inputs: each job's steps (its
    chain length) x 4 beam candidate evaluations (the 4 next k-mers of
    each of the ``beam`` chains, scored once; the kernel's recentring of
    all 4 beam candidates, not only the kept ones, is not needed by the
    function) x its members with k-mers x 32 band lanes x
    BEAM_OPS_PER_CELL int32 operations; the bytes are the inputs read
    once and the chains ([J, t_max]) and their lengths written once.
    ``seqs`` and ``lens`` are [J, N, L] and [J, N], or flat with
    ``shapes`` one (N, L, T) per job."""
    if shapes is None:
        members = lens.gt(0).sum(dim=1).long()
    else:
        members = torch.stack([r.gt(0).sum() for r in torch.split(
            lens, [n for n, _, _ in shapes])]).long()
    ops = int((n_valid.long() * members).sum()) * 4 * beam * 32 \
        * BEAM_OPS_PER_CELL
    J = n_valid.numel()
    nbytes = (seqs.numel() + lens.numel() + J + J * (t_max + 1)) * 4 \
        + (table.numel() * 2 if table is not None else 0)
    return bound(ops, nbytes)


def beam_raw(args):
    """One launch of the beam kernel over a recorded ``cuda_beam._launch``
    call's inputs (the ragged form), through its C entry point into
    preallocated outputs, with its per-job parameters on the card already:
    times the kernel, not the wrapper's allocations and upload, and is
    not counted."""
    from downpore_tpu_torch.ops import cuda_beam
    seqs, lens, firsts, shapes, table, k, beam, thr, gap, sk = args[:10]
    dev = seqs.device
    lib = cuda_beam._lib()
    J = len(shapes)
    t_top = max(T for _, _, T in shapes)
    meta, n_top, sw_top = cuda_beam.plan(shapes)
    meta = meta.to(dev)
    chains = torch.empty((J, t_top), dtype=torch.int32, device=dev)
    n_valid = torch.empty((J,), dtype=torch.int32, device=dev)
    rec = torch.empty((J, t_top, 4, beam), dtype=torch.int32, device=dev)
    need = lib.beam_consensus_scratch_bytes(n_top, beam, sw_top, t_top)
    scratch = torch.empty((J * need,), dtype=torch.uint8, device=dev) \
        if need > 0 else None
    warps = cuda_beam.beam_warps(
        J, n_top, beam,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.beam_consensus_launch(
            seqs.data_ptr(), lens.data_ptr(), firsts.data_ptr(),
            meta.data_ptr(), None if table is None else table.data_ptr(),
            chains.data_ptr(), n_valid.data_ptr(), rec.data_ptr(),
            None if scratch is None else scratch.data_ptr(), J, n_top,
            t_top, sw_top, k, beam, thr, gap, sk, 1, warps, stream)
        if err:
            raise SystemExit(f"beam_consensus launch failed: {err}")
    run.outs = (chains, n_valid)
    run.warps = warps
    return run


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave the kernels' counts as they were."""
    from downpore_tpu_torch.ops import cuda_anchors, cuda_band, cuda_beam, \
        cuda_chain, cuda_counts
    kerns = (cuda_chain.chain_scan, cuda_band.update_bands,
             cuda_beam.beam_consensus, cuda_anchors.anchors_topk,
             cuda_counts.retrieval_count)
    saved = [kern.launches for kern in kerns]
    modes = dict(cuda_chain.MODE_LAUNCHES)
    try:
        yield
    finally:
        for kern, n in zip(kerns, saved):
            kern.launches = n
        cuda_chain.MODE_LAUNCHES.update(modes)


def _max_err(outs, ref) -> int:
    """Max abs difference of a launch's outputs and its plain version's
    (bool outputs as 0/1); a shape or dtype that differs fails."""
    err = 0
    for g, r in zip(outs, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise SystemExit(f"an output of shape {tuple(g.shape)} "
                             f"{g.dtype} against the plain version's "
                             f"{tuple(r.shape)} {r.dtype}")
        if g.numel():
            err = max(err, int((g.long() - r.long()).abs().max()))
    return err


def check_recorded(calls, times=None, path=None) -> dict:
    """Max abs error per kernel of the recorded launches against their
    plain versions on the same card tensors (fails on any difference),
    and each launch's time (the kernel alone, not counted) beside its
    bound; a beam launch also with the steps its longest job took and the
    time a step.  Each launch's ms is added to ``times[name]`` when
    ``times`` is given; with ``path``, the largest anchor and count
    launches are also timed beside their plain versions
    (``time_path_kernels``)."""
    errs = {}
    for plain, args, outs, launch in calls:
        ref = plain(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if len(ref) != len(outs):
            raise SystemExit(f"{plain.__name__} gave {len(ref)} outputs, "
                             f"the kernel {len(outs)}")
        err = _max_err(outs, ref)
        name = plain.__name__.removesuffix("_plain").removesuffix("_ragged")
        errs[name] = max(errs.get(name, 0), err)
        RECORDED_ERRS[name] = max(RECORDED_ERRS.get(name, 0), err)
        scalars = [a for a in args if not torch.is_tensor(a) and a is not None]
        extra = ""
        if name == "chain_scan":     # the kernel alone, as phase_kernel
            ms = cuda_ms(chain_raw(args[:5], *args[5:]), 5)
            b_ms, b_by = chain_bound(args[4], args[7])
            shape = list(args[0].shape)
        elif name in ("anchors_topk", "retrieval_count"):
            anchors = name == "anchors_topk"
            run = (anchors_raw if anchors else counts_raw)(args)
            run()
            if _max_err(run.outs, outs):
                raise SystemExit(f"{name}'s C entry point differs from its "
                                 f"wrapper on a recorded launch")
            ms = cuda_ms(run, 5)
            b_ms, b_by = anchors_bound(args, outs) if anchors \
                else counts_bound(args)
            shape = [list(a.shape) for a in args if torch.is_tensor(a)]
        else:                        # the ragged beam launch, kernel alone
            run = beam_raw(args)
            run()
            if any(not torch.equal(o, r) for o, r in zip(run.outs, outs)):
                raise SystemExit("beam_consensus's C entry point differs "
                                 "from its wrapper on a recorded launch")
            ms = min(cuda_ms(run, 3), cuda_ms(run, 3))
            shapes = args[3]
            b_ms, b_by = beam_bound(args[0], args[1], outs[1], args[6],
                                    max(T for _, _, T in shapes), args[4],
                                    shapes)
            steps = int(outs[1].max())
            shape = sorted({tuple(s) for s in shapes})
            scalars = [len(shapes), run.warps] + scalars[1:]
            extra = (f"; {steps} steps (longest job), "
                     f"{ms * 1e3 / steps:.3f} us a step")
        if times is not None:
            times[name] = times.get(name, 0.0) + ms
        log(f"  {name} {shape} {scalars}: max_abs_err={err}; "
            f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
            f"{b_ms / ms:.3f}{extra}")
        if err != 0:
            raise SystemExit(f"{name} differs from its plain version at a "
                             f"shape of a main path")
    if path is not None:
        time_path_kernels(path, calls)
    return errs


def phase_correct(dev):
    """The port's correct on the card at CORRECT_READS reads, every kernel
    launch of the run held against its plain version; returns the case's
    records and the kernel launch counts of the run."""
    from downpore_tpu_torch import consensus as cons_mod
    from downpore_tpu_torch.ops import cuda_band, cuda_beam, cuda_chain
    from downpore_tpu_torch.overlap import Overlapper

    t0 = time.perf_counter()
    genome, records = correct_case()
    bases = sum(len(s) for _, s in records)
    log(f"correct case: {CORRECT_GENOME} b genome, {len(records)} reads, "
        f"{bases} bases ({bases / CORRECT_GENOME:.1f}x), generated in "
        f"{time.perf_counter() - t0:.1f} s")
    spent = {"overlap": 0.0, "consensus": 0.0}
    calls = []
    subs = [(owner, n, timed(getattr(owner, n), key, spent, dev))
            for owner, n, key in
            [(Overlapper, n, "overlap") for n in
             ("prepare_queries", "add_sequences", "find_overlaps")]
            + [(cons_mod, "build_consensus_bulk", "consensus")]]
    subs += record_all(calls)
    subs += [(cuda_beam, "_launch", recording(
        cuda_beam._launch, cuda_beam.beam_consensus_ragged_plain, calls))]
    kernels = (cuda_band.update_bands, cuda_beam.beam_consensus)
    with patched(subs):
        for kern in kernels:
            kern.launches = 0
        zero_launches()
        t0 = time.perf_counter()
        out, err = run_correct(records, dev.type)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = {kern.__name__: kern.launches for kern in kernels}
        launches.update(path_launches("correct"))
    lines = out.splitlines()
    names = [ln[1:] for ln in lines if ln.startswith(">")]
    seqs = [ln for ln in lines if ln and not ln.startswith(">")]
    other = wall - spent["overlap"] - spent["consensus"]
    log(f"correct on {dev.type} (first run, imports included): wall "
        f"{wall:.3f} s = overlap rounds {spent['overlap']:.3f} s + "
        f"consensus {spent['consensus']:.3f} s + the rest {other:.3f} s; "
        f"kernel launches {launches}; {len(names)} consensus sequences, "
        f"{sum(len(x) for x in seqs)} bases")
    log("correct stderr: " + " | ".join(err.strip().splitlines()[:8]))
    if launches["beam_consensus"] <= 0:
        raise SystemExit("the correct path launched no beam_consensus "
                         "kernel")
    if not names or len(names) != len(seqs) \
            or any(set(x) - set("ACGT") or len(x) <= 300 for x in seqs):
        raise SystemExit("correct gave no well-formed consensus sequences")
    cont = containment(seqs, genome)
    log(f"consensus {CONTAIN_K}-mers found in the genome: "
        + ", ".join(f"{c:.4f}" for c in cont))
    if min(cont) < CONTAIN_MIN:
        raise SystemExit(f"a consensus sequence shares < {CONTAIN_MIN} of "
                         f"its {CONTAIN_K}-mers with the genome")
    log(f"the run's {len(calls)} kernel launches against their plain "
        f"versions (beam: [(N, L, T) of its jobs], [jobs, warps a job, "
        f"k, beam, threshold, gap, simple_k, records]):")
    kernel_ms = {}
    errs = check_recorded(calls, kernel_ms)
    if set(errs) != {"chain_scan", "beam_consensus", "anchors_topk",
                     "retrieval_count"}:
        raise SystemExit(f"recorded launches of {sorted(errs)} only")
    log(f"correct's beam_consensus: {launches['beam_consensus']} launches, "
        f"{kernel_ms['beam_consensus']:.4f} ms of kernel time in all "
        f"(each launch re-timed alone on its recorded inputs)")
    return records, launches


PROFILE_CORRECT_OUT = "chiprun_out/profile_correct.txt"


def profile_correct(records, dev, out_path=PROFILE_CORRECT_OUT, top=20):
    """Two more (warm) runs of ``correct`` on ``records``: one under
    ``torch.profiler`` for the device's busy time (union of its kernel,
    copy and set spans) and idle share, one under ``cProfile`` for the
    host time by function of both packages, cumulative (a function's time
    includes its callees').  Prints both; writes the cProfile table to
    ``out_path``."""
    import cProfile
    import io
    import pstats
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_correct(records, dev.type)
        sync(dev)
        wall = time.perf_counter() - t0
    log(f"correct under torch.profiler: wall {wall * 1e3:.3f} ms; "
        f"{device_busy(prof.events(), wall)}")

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    run_correct(records, dev.type)
    sync(dev)
    pr.disable()
    wall = time.perf_counter() - t0
    rows = sorted(((ct, f"{file[file.rfind('downpore_tpu'):]}:{line}({fn})")
                   for (file, line, fn), (_, _, _, ct, _)
                   in pstats.Stats(pr).stats.items()
                   if "downpore_tpu" in file), reverse=True)
    log(f"correct under cProfile: wall {wall * 1e3:.3f} ms; cumulative host "
        f"ms of the top {top} functions of the two packages:")
    for ct, where in rows[:top]:
        log(f"  {ct * 1e3:10.3f}  {where}")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(80)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(buf.getvalue())
    log(f"cProfile table written to {out_path}")


def phase_correct_card_vs_cpu():
    """``correct`` on the card and on the CPU, with the simple-k measure
    and with a ``-model`` table measure: byte-identical fasta."""
    from downpore_tpu_torch.ops import cuda_beam
    records = golden_overlap_records()
    for model in (False, True):
        before = cuda_beam.beam_consensus.launches
        on_card, _ = run_correct(records, "cuda", model)
        launched = cuda_beam.beam_consensus.launches - before
        on_cpu, _ = run_correct(records, "cpu", model)
        same = on_card == on_cpu
        log(f"correct{' -model' if model else ''} card vs cpu on the "
            f"{len(records)}-read fixture: {on_card.count('>')} / "
            f"{on_cpu.count('>')} consensus sequences, {launched} beam "
            f"kernel launches, byte-identical: {same}")
        if not same or not on_card.count(">") or launched <= 0:
            raise SystemExit("correct fasta on the card differs from the "
                             "CPU's")
    # -trim 1 (bundled adapters, k = 5) on the same reads with the first
    # bundled front and back adapters at their ends: the trim cuts them
    # and the trimmed reads go on to the overlap rounds and the beam
    from downpore_tpu_torch.ops import cuda_chain
    from downpore_tpu_torch.trim import BACK_ADAPTERS, FRONT_ADAPTERS
    records = adapter_records(records, FRONT_ADAPTERS[0][1],
                              BACK_ADAPTERS[0][1])
    chain0 = cuda_chain.chain_scan.launches
    beam0 = cuda_beam.beam_consensus.launches
    on_card = run_correct(records, "cuda", trim=True)
    chains = cuda_chain.chain_scan.launches - chain0
    beams = cuda_beam.beam_consensus.launches - beam0
    on_cpu = run_correct(records, "cpu", trim=True)
    same = on_card == on_cpu
    log(f"correct -trim 1 card vs cpu on the {len(records)}-read fixture "
        f"with adapters: {on_card[0].count('>')} / {on_cpu[0].count('>')} "
        f"consensus sequences, {chains} chain and {beams} beam kernel "
        f"launches, fasta and stderr byte-identical: {same}; stderr: "
        + " | ".join(ln for ln in on_card[1].splitlines()
                     if not ln.startswith(("Front adapter:",
                                           "Back adapter:"))))
    if not same or "Trimming ends" not in on_card[1]:
        raise SystemExit("correct -trim 1 on the card differs from the "
                         "CPU's")
    if not on_card[0].count(">") or chains <= 0 or beams <= 0:
        raise SystemExit("correct -trim 1 gave no consensus or launched "
                         "no chain_scan or beam_consensus kernel")


def adapter_records(records, front: str, back: str):
    """``records`` with ``front`` before and ``back`` after each read."""
    return [(n, front + s + back) for n, s in records]


CHR_GENOME = 64_000_000
CHR_READS = 2048
CHR_K = 13
CHR_PAF_READS = 64
PROFILE_CHR_OUT = "chiprun_out/profile_map_64mb.txt"


def resident_bytes(eng, names) -> dict:
    """Bytes on the card of each named engine tensor (aliases once)."""
    seen, out = set(), {}
    for name in names:
        t = getattr(eng, name, None)
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            out[name] = t.numel() * t.element_size()
    return out


def phase_chromosome(dev):
    """The map path at chromosome scale (bench.py's 64 Mb case), on the
    binned gate: the path kernels' launches over the three timed passes
    (``PATH_LAUNCHES``), the warm-up pass's launches held against their
    plain versions."""
    from downpore_tpu_torch.core import Sequence
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    t0 = time.perf_counter()
    genome, reads, truth = make_case(CHR_READS, CHR_GENOME)
    ref = Sequence.from_string(genome, id=0, name="ref")
    del genome
    log(f"chromosome case: {CHR_GENOME} b genome, {len(reads)} reads "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    values = score_seed_values(kmer_occurrences([ref], CHR_K), CHR_K)
    t_values = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapper = Mapper(ref, False, CHR_K, values, seed_rate=40,
                    edge_size=1000, chunk_size=10000, device=dev)
    sync(dev)
    t_index = time.perf_counter() - t0
    eng = mapper.engine
    if not eng._binned:
        raise SystemExit(f"{eng.C} chunks did not engage the binned gate")
    res = resident_bytes(eng, ("membership", "bin_mem1", "bin_mem2",
                               "t_seeds", "t_pos", "usable_dev"))
    log(f"chromosome index: {eng.C} chunks, {eng.num_seeds} seeds, H={eng.H} "
        f"(hashed {eng._hashed}), H1={eng.H1}, NB={eng._NB}, CB={eng._CB}, "
        f"nq={eng.nq}, nt={eng.nt}; host seconds: k-mer values "
        f"{t_values:.1f}, index build {t_index:.1f}; resident bytes "
        f"{res} = {sum(res.values())}")

    bases = sum(len(r) for r in reads)
    calls = []
    with patched(record_all(calls)):
        t0 = time.perf_counter()
        mapper.map_batch(reads)                   # warm-up, recorded
        sync(dev)
    log(f"chromosome warm-up pass {time.perf_counter() - t0:.3f} s; its "
        f"{len(calls)} recorded launches against the plain versions:")
    check_recorded(calls)
    del calls
    mapper.map_batch(reads)     # the second warm-up, at settled budgets
    sync(dev)

    eng.routes.clear()
    eng.bins.clear()
    zero_launches()
    walls = []
    with counted_reruns() as reruns:
        for _ in range(TIMED_PASSES):
            t0 = time.perf_counter()
            results = mapper.map_batch(reads)
            sync(dev)
            walls.append(time.perf_counter() - t0)
    launches = path_launches("map 64 Mb")
    routes = dict(eng.routes)
    wall = float(np.median(walls))
    n_bin = max(n for n, _ in eng.bins)
    log(f"chromosome map_batch, {TIMED_PASSES} passes: wall "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; median {wall:.4f} s = "
        f"{bases / wall:.0f} bases/s ({bases} bases); launches "
        f"{launches}; routes {routes}; binned dispatches by (n_bin, BB) "
        f"{dict(sorted(eng.bins.items()))}: largest n_bin {n_bin}, final BB "
        f"{max(bb for _, bb in eng.bins)}; re-runs at collect "
        f"{reruns['reruns']} of {sum(routes.values())} dispatches; peak "
        f"device memory {torch.cuda.max_memory_allocated()} bytes")
    if routes.get("_fused_map_bd", 0) <= 0:
        raise SystemExit(f"the chromosome map never took _fused_map_bd: "
                         f"{routes}")
    rec = recall(results, truth)
    log(f"chromosome recall: {rec:.4f}")
    if rec < RECALL_MIN:
        raise SystemExit(f"chromosome recall {rec:.4f} < {RECALL_MIN}")
    phase_profile(mapper, reads, PROFILE_CHR_OUT)
    map_dispatch_case("map 64 Mb (binned gate)", mapper, reads)
    phase_card_vs_cpu(mapper, reads, CHR_PAF_READS)


OV_GENOME = 2_000_000
OV_READS = 12_000
OV_READ_LEN = 8000
OV_ERR = 0.05
OV_PROFILED_ROUND = 2
# the JAX package's overlap command on this input (BENCH_r05.json's tail)
OV_STDERR = [
    "Using query set with 3958 sequences starting from 1979 against "
    "12000 sequences.",
    "Total 103007 hits across 3957 overlaps.",
    "Using query set with 3936 sequences starting from 3961 against "
    "12000 sequences.",
    "Total 116480 hits across 3936 overlaps.",
    "Using query set with 3932 sequences starting from 5973 against "
    "12000 sequences.",
    "Total 127837 hits across 3932 overlaps.",
    "Using query set with 3944 sequences starting from 8025 against "
    "12000 sequences.",
    "Total 138312 hits across 3944 overlaps.",
    "Using query set with 3958 sequences starting from 10167 against "
    "12000 sequences.",
    "Total 144600 hits across 3958 overlaps.",
    "Using query set with 3196 sequences starting from 12000 against "
    "12000 sequences.",
    "Total 119012 hits across 3196 overlaps.",
]
OV_PAF_LINES = 721_379
PROFILE_OV_OUT = "chiprun_out/profile_overlap.txt"
OV_RANGES = (
    ("downpore_tpu_torch.ops.map_engine:MapEngine", "__init__",
     "host:engine_build"),
    ("downpore_tpu_torch.ops.map_engine:MapEngine", "pack_queries",
     "host:pack_queries"),
    ("downpore_tpu_torch.ops.map_engine", "_derive_buckets",
     "dev:derive_buckets"),
    ("downpore_tpu_torch.ops.map_engine", "_count_rows_pair",
     "dev:count_rows_pair"),
    ("downpore_tpu_torch.ops.map_engine", "_count_rows", "dev:count_rows"),
    ("downpore_tpu_torch.ops.map_engine", "_overlap_from_counts",
     "dev:overlap_from_counts"),
    ("downpore_tpu_torch.ops.map_engine", "_build_anchors",
     "dev:build_anchors"),
    ("downpore_tpu_torch.ops.map_engine", "dp_forward_lean",
     "dev:dp_forward_lean"),
    ("downpore_tpu_torch.ops.map_engine:MapEngine", "collect_chains_raw",
     "host:collect_chains_raw"),
    ("downpore_tpu_torch.overlap.overlapper:Overlapper",
     "collect_find_arrays", "host:collect_find_arrays"),
    ("downpore_tpu_torch.cli.overlap_command:OverlapCommand",
     "_emit_records", "host:emit_records"),
)


def write_overlap_reads(path: str, n_reads: int = OV_READS) -> int:
    """bench.py's ``bench_overlap_gb`` input (``_make_genome_reads``):
    OV_READS reads of OV_READ_LEN bases from a OV_GENOME-base genome at
    OV_ERR substitutions, odd reads reverse-complemented (the first
    ``n_reads`` of them).  Returns the file's size in bytes."""
    genome = BASES[np.random.default_rng(SEED + 50).integers(0, 4,
                                                             OV_GENOME)]
    rng = np.random.default_rng(SEED + 51)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    B = 2048
    with open(path, "w", buffering=1 << 22) as f:
        for lo in range(0, n_reads, B):
            n = min(B, n_reads - lo)
            starts = rng.integers(0, len(genome) - OV_READ_LEN, n)
            rows = np.stack([genome[s:s + OV_READ_LEN] for s in starts])
            m = rng.random(rows.shape) < OV_ERR
            rows[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            chunks = []
            for i in range(n):
                s = rows[i].tobytes()
                if (lo + i) % 2:
                    s = s.translate(comp)[::-1]
                chunks.append(f">gr{lo + i}\n")
                chunks.append(s.decode())
                chunks.append("\n")
            f.write("".join(chunks))
    return os.path.getsize(path)


def phase_overlap(dev):
    """``overlap`` through the port's CLI on bench.py's overlap_gb input,
    with the stages of ``OV_RANGES`` ranged and round OV_PROFILED_ROUND
    under ``torch.profiler`` (tables in PROFILE_OV_OUT): the path kernels'
    launches of the run (``PATH_LAUNCHES``), the first round's launches
    held against their plain versions."""
    import hashlib
    import io
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    import downpore_tpu_torch.utils as port_utils
    from downpore_tpu_torch.cli.main import main as cli_main
    from downpore_tpu_torch.cli.overlap_command import OverlapCommand
    from downpore_tpu_torch.ops import captured
    from downpore_tpu_torch.overlap import Overlapper

    spent = {"kmers": 0.0, "prep": 0.0, "find": 0.0, "final": 0.0}
    per_round, calls = [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof_t0 = []
    launches_of = [(mod, mod._launch) for _, mod, _ in path_modules()]
    find_timed = timed(Overlapper.dispatch_find, "find", spent, dev,
                       wait=False)
    kept = {}       # round OV_PROFILED_ROUND's engine and queries
    final_timed = timed(OverlapCommand._final_checks_arrays, "final", spent,
                        dev)

    graphs_at = []      # (graphs, table copies) as each round's find starts

    def find(self, queries):
        r = len(per_round) + 1
        graphs_at.append((len(captured.GRAPHS.entries),
                          captured.GRAPHS.table_copies))
        if r == 1:     # hold the first round's launches to the plain ones
            for mod, n, wrapper in record_all(calls):
                setattr(mod, n, wrapper)
        if r == OV_PROFILED_ROUND:
            sync(dev)
            prof.start()
            prof_t0.append(time.perf_counter())
        try:
            out = find_timed(self, queries)
        finally:
            for mod, launch in launches_of:
                mod._launch = launch
        eng = out[0]
        if r == OV_PROFILED_ROUND:
            kept.update(eng=eng, queries=queries)
        per_round.append((eng.C, eng.H, eng.nt, sum(resident_bytes(
            eng, ("membership", "t_seeds", "t_pos", "usable_dev")).values())))
        return out

    def final(self, *a):
        try:
            return final_timed(self, *a)
        finally:
            if len(per_round) == OV_PROFILED_ROUND and len(prof_t0) == 1:
                prof.stop()
                prof_t0.append(time.perf_counter())

    subs = [(port_utils, "kmer_occurrences",
             timed(port_utils.kmer_occurrences, "kmers", spent, dev)),
            (Overlapper, "prepare_round",
             timed(Overlapper.prepare_round, "prep", spent, dev)),
            (Overlapper, "dispatch_find", find),
            (OverlapCommand, "_final_checks_arrays", final)]
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as d, device_env(dev.type):
        path = os.path.join(d, "reads.fasta")
        t0 = time.perf_counter()
        nbytes = write_overlap_reads(path)
        log(f"overlap case: {OV_READS} reads x {OV_READ_LEN} b from a "
            f"{OV_GENOME} b genome, {nbytes} bytes of fasta, written in "
            f"{time.perf_counter() - t0:.1f} s")
        out_path = os.path.join(d, "overlap.paf")
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        with patched(subs), ranged(OV_RANGES), counted_reruns() as reruns:
            t0 = time.perf_counter()
            with open(out_path, "w", buffering=1 << 22) as out, \
                    contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                cli_main(["overlap", "-input", path])
            sync(dev)
            wall = time.perf_counter() - t0
            launches = path_launches("overlap")
        with open(out_path, "rb") as f:
            paf = f.read()
    n_paf = paf.count(b"\n")
    stderr = err.getvalue().splitlines()
    rounds = [ln for ln in stderr if ln.startswith(("Using query set",
                                                    "Total "))]
    other = wall - spent["kmers"] - spent["find"] - spent["final"]
    log(f"overlap on the card: wall {wall:.3f} s = k-mer counting "
        f"{spent['kmers']:.3f} s + find {spent['find']:.3f} s + final "
        f"checks {spent['final']:.3f} s + the rest {other:.3f} s (parsing, "
        f"round 1's prep, waits for the worker's prep); round prep "
        f"{spent['prep']:.3f} s in all, on the worker thread after round "
        f"1, beside the find and checks; {len(per_round)} rounds; "
        f"launches {launches}; re-runs at collect "
        f"{reruns['reruns']}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; {n_paf} PAF lines, "
        f"sha256 {hashlib.sha256(paf).hexdigest()}")
    graphs_at.append((len(captured.GRAPHS.entries),
                      captured.GRAPHS.table_copies))
    new = [b[0] - a[0] for a, b in zip(graphs_at, graphs_at[1:])]
    copies = [b[1] - a[1] for a, b in zip(graphs_at, graphs_at[1:])]
    for r, (C, H, nt, nb) in enumerate(per_round, 1):
        log(f"  round {r}: {C} chunks, H={H}, nt={nt}, resident {nb} bytes; "
            f"graphs captured {new[r - 1]}, resident tables copied into the "
            f"graph cache {copies[r - 1]}")
    # the rounds whose tables have the first round's shapes (H, nt and
    # resident bytes: the padded chunk axis, not the chunk count) replay its
    # graphs: they capture only keys of budgets the job's plan grew to,
    # fewer in all than the first round
    same = [r for r in range(1, len(per_round)) if per_round[r][1:]
            == per_round[0][1:]]
    if same and sum(new[r] for r in same) >= new[0]:
        raise SystemExit(f"overlap captures grew with the rounds: {new}")
    log("overlap stderr: " + " | ".join(stderr))
    if len(prof_t0) == 2:
        pw = prof_t0[1] - prof_t0[0]
        log(f"overlap round {OV_PROFILED_ROUND} (find through final checks, "
            f"the next round's prep on the worker) under torch.profiler: "
            f"wall {pw * 1e3:.3f} ms; {device_busy(prof.events(), pw)}")
        report_ranges(prof, OV_RANGES, PROFILE_OV_OUT)
    log(f"overlap round 1's {len(calls)} recorded launches against the "
        f"plain versions:")
    errs = check_recorded(calls)
    del calls[:]
    if rounds != OV_STDERR:
        raise SystemExit("overlap's per-round stderr differs from the JAX "
                         "package's recorded run")
    if n_paf != OV_PAF_LINES:
        raise SystemExit(f"overlap gave {n_paf} PAF lines, the JAX package "
                         f"{OV_PAF_LINES}")
    if set(errs) != set(PATH_KERNELS):
        raise SystemExit(f"overlap's first round recorded launches of "
                         f"{sorted(errs)} only")
    overlap_dispatch_case(kept["eng"], kept["queries"])


def overlap_dispatch_case(eng, queries):
    """``phase_dispatch`` of one overlap sub-batch: the first 2048 queries
    of round OV_PROFILED_ROUND against that round's engine, as the
    overlapper dispatches them (its job plan's budget)."""
    from downpore_tpu_torch.overlap.overlapper import SUB
    sq = [q.query for q in queries[:SUB]]
    base_min = np.array([int(0.25 * q.num_seeds + 0.5) for q in sq],
                        np.int32)
    plan = {}
    name = (f"overlap round {OV_PROFILED_ROUND}, one sub-batch of "
            f"{len(sq)} queries")
    dispatch = lambda b: eng.dispatch_chains(sq, base_min,
                                             pair_budget=b or 0,
                                             shape_plan=plan)
    row = phase_dispatch(
        name, dispatch, eng.collect_chains_raw,
        lambda f: max(int(p.host.wait()[0][0]) for p in f[1]))
    phase_graphs(name, dispatch, eng.collect_chains_raw)
    return row


TRIM_READS = 65_536
TRIM_CORE = 3000
TRIM_NOISE = 0.02
TRIM_CHIMERA_EVERY = 16
TRIM_EDGE_BATCH = 8192
TRIM_RECORDED = 2          # launches per stage held against the plain scan
TRIM_CARD_VS_CPU = 1024
TRIM_SPLIT_MIN = 0.95
PROFILE_TRIM_OUT = "chiprun_out/profile_trim.txt"
TRIM_RANGES = (
    ("downpore_tpu_torch.ops.window_engine", "_unpack_kmers",
     "dev:unpack_kmers"),
    ("downpore_tpu_torch.ops.window_engine", "_gate_topk_pairs",
     "dev:gate_topk_pairs"),
    ("downpore_tpu_torch.ops.window_engine", "_passing", "dev:passing"),
    ("downpore_tpu_torch.ops.window_engine", "_anchors_chunked",
     "dev:anchors_chunked"),
    ("downpore_tpu_torch.ops.window_engine", "dp_from_anchors",
     "dev:dp_from_anchors"),
    ("downpore_tpu_torch.ops.window_engine", "summarize_scalars",
     "dev:summarize_scalars"),
    ("downpore_tpu_torch.ops.window_engine", "_pack_windows",
     "host:pack_windows"),
    ("downpore_tpu_torch.trim.trimmer:Trimmer", "_dispatch_edge_batch",
     "host:dispatch_edge_batch"),
    ("downpore_tpu_torch.trim.trimmer:Trimmer", "_finish_edge_batch",
     "host:finish_edge_batch"),
    ("downpore_tpu_torch.trim.trimmer:_MidStream", "add_batch",
     "host:mid_add_batch"),
    ("downpore_tpu_torch.trim.trimmer:_MidStream", "_collect",
     "host:mid_collect"),
)
# test_trim_golden.py's recorded digest of the JAX package's output
TRIM_GOLDEN_DIGEST = \
    "b7ef415758ba165151d66f047f59093b027d5e2299db656ac5ad23266ca27399"


def write_trim_reads(path: str) -> tuple:
    """TRIM_READS reads in bench.py's ``_make_reads_bulk`` recipe:
    FRONT_ADAPTERS[0] + a
    TRIM_CORE-base random core + BACK_ADAPTERS[0], TRIM_NOISE substitutions
    on the adapters, as fastq.  Every TRIM_CHIMERA_EVERY-th read also
    carries FRONT_ADAPTERS[0] over core bases [p, p + 28) for a random p in
    [1000, 2000): a chimera the middle pass must split.  Returns (bytes
    written, chimeras planted)."""
    from downpore_tpu_torch.trim import BACK_ADAPTERS, FRONT_ADAPTERS
    rng = np.random.default_rng(SEED + 77)
    f_ad = np.frombuffer(FRONT_ADAPTERS[0][1].encode(), np.uint8)
    b_ad = np.frombuffer(BACK_ADAPTERS[0][1].encode(), np.uint8)
    qual = "I" * (TRIM_CORE + len(f_ad) + len(b_ad))
    B, planted = 4096, 0
    with open(path, "w", buffering=1 << 22) as f:
        for lo in range(0, TRIM_READS, B):
            n = min(B, TRIM_READS - lo)
            cores = BASES[rng.integers(0, 4, (n, TRIM_CORE))]
            fa = np.broadcast_to(f_ad, (n, len(f_ad))).copy()
            ba = np.broadcast_to(b_ad, (n, len(b_ad))).copy()
            for arr in (fa, ba):
                m = rng.random(arr.shape) < TRIM_NOISE
                arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            for i in range(-lo % TRIM_CHIMERA_EVERY, n, TRIM_CHIMERA_EVERY):
                p = int(rng.integers(1000, 2000))
                cores[i, p:p + len(f_ad)] = f_ad
                planted += 1
            rows = np.concatenate([fa, cores, ba], axis=1)
            f.write("".join(f"@gr{lo + i}\n{rows[i].tobytes().decode()}\n+\n"
                            f"{qual}\n" for i in range(n)))
    return os.path.getsize(path), planted


def run_trim(path: str, device: str, out_path: str) -> str:
    """``trim -input path`` through the port's CLI on ``device`` with
    default flags and edge batches of TRIM_EDGE_BATCH reads (bench.py's
    trim batch), stdout to ``out_path``; returns stderr."""
    import functools
    import io
    from downpore_tpu_torch.cli.main import main as cli_main
    from downpore_tpu_torch.trim.trimmer import Trimmer
    err = io.StringIO()
    trim = functools.partialmethod(Trimmer.trim, batch_size=TRIM_EDGE_BATCH)
    with device_env(device), patched([(Trimmer, "trim", trim)]), \
            open(out_path, "w", buffering=1 << 22) as out, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli_main(["trim", "-input", path])
    return err.getvalue()


def phase_trim(dev):
    """``trim`` through the port's CLI on TRIM_READS reads with the bundled
    adapters (k = 6, 256-base edges in batches of TRIM_EDGE_BATCH, 512-base
    middle windows in batches of 16,384): wall and MB/s, the wall split by
    stage, chain and anchor launches per stage (each > 0; the first
    TRIM_RECORDED of each held against the plain versions), peak device
    memory, the chimeras split.  Then one edge and one middle batch under
    ``torch.profiler`` (PROFILE_TRIM_OUT), card-vs-CPU fastq identity on
    the first TRIM_CARD_VS_CPU reads, and the golden digest on the card.
    The run's launches go to ``PATH_LAUNCHES["trim"]``."""
    import tempfile
    import threading
    from collections import Counter
    from downpore_tpu_torch.io import SequenceSet
    from downpore_tpu_torch.ops import captured
    from downpore_tpu_torch.ops import window_engine as we
    from downpore_tpu_torch.trim.trimmer import Trimmer, _MidStream

    where = threading.local()      # the stage the calling thread is in
    per_stage, recorded, calls = Counter(), Counter(), []

    def staged_launch(name, launch, plain):
        def wrapper(*a):
            # _launch launches the kernel (and counts it) unless it has
            # no rows; inside a capture it counts, and so does its stage,
            # at each replay of the graph, where the kernel runs
            if not a[0].numel():
                return launch(*a)
            stage = (name, getattr(where, "stage", "other"))

            def count():
                per_stage[stage] += 1

            def want():
                if recorded[stage] >= TRIM_RECORDED:
                    return False
                recorded[stage] += 1
                return True
            captured.each_run(count)
            return recording(launch, plain, calls, want)(*a)
        return wrapper

    def staged(fn, stage):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            prev = getattr(where, "stage", None)
            where.stage = stage
            try:
                return fn(*a, **kw)
            finally:
                where.stage = prev
        return wrapper

    spent = Counter()
    # trim's gate is not a retrieval count: its path kernels are the
    # anchor build and the chain
    trim_kernels = ("chain_scan", "anchors_topk")
    subs = [(mod, "_launch", staged_launch(name, mod._launch, plain))
            for name, mod, plain in path_modules() if name in trim_kernels]
    subs += [(we, n, staged(getattr(we, n), stage)) for n, stage in (
        ("_fused_enable", "determine"), ("_fused_edge_verdict", "edges"),
        ("_fused_window_verdict", "middle"))]
    subs += [(owner, n, timed(getattr(owner, n), key, spent, dev))
             for owner, n, key in (
                 (Trimmer, "determine_adapters", "determine"),
                 (Trimmer, "_finish_edge_batch", "edges"),
                 (_MidStream, "finish", "mid_finish"),
                 (SequenceSet, "write", "write"))]
    # the dispatches, timed without a wait: their work overlaps the
    # caller's next steps, as in the command
    subs += [(owner, n, timed(getattr(owner, n), key, spent, dev, False))
             for owner, n, key in (
                 (Trimmer, "_dispatch_edge_batch", "edges"),
                 (_MidStream, "add_batch", "mid_add"))]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "reads.fastq")
        t0 = time.perf_counter()
        nbytes, planted = write_trim_reads(path)
        log(f"trim case: {TRIM_READS} reads of {TRIM_CORE} b cores between "
            f"the first bundled adapters, {planted} chimeras, {nbytes} bytes "
            f"of fastq, written in {time.perf_counter() - t0:.1f} s")
        out_path = os.path.join(d, "trimmed.fastq")
        torch.cuda.reset_peak_memory_stats()
        with patched(subs), counted_reruns() as reruns:
            zero_launches()
            t0 = time.perf_counter()
            err = run_trim(path, dev.type, out_path)
            sync(dev)
            wall = time.perf_counter() - t0
            launches = path_launches("trim", trim_kernels)
        peak = torch.cuda.max_memory_allocated()
        out_bytes = os.path.getsize(out_path)
        split = [int(ln.split()[0]) for ln in err.splitlines()
                 if ln.endswith("sequences require splitting")]
        rest = wall - spent["determine"] - spent["edges"] \
            - spent["mid_finish"] - spent["write"]
        log(f"trim on the card: wall {wall:.3f} s = {nbytes / wall / 1e6:.2f} "
            f"MB/s of fastq; determine-adapters {spent['determine']:.3f} s + "
            f"edge pass {spent['edges']:.3f} s + middle-pass finish "
            f"{spent['mid_finish']:.3f} s + write {spent['write']:.3f} s + "
            f"the rest {rest:.3f} s (parsing, edge cuts, stream feed); "
            f"middle-window packing and dispatch on the worker thread "
            f"{spent['mid_add']:.3f} s, beside the edge pass; launches "
            f"{launches}, by (kernel, stage) {dict(per_stage)}; re-runs at "
            f"collect "
            f"{reruns['reruns']}; peak device memory {peak} bytes; "
            f"{out_bytes} bytes out; split {split} of {planted} chimeras")
        log("trim stderr: " + " | ".join(
            ln for ln in err.splitlines() if not ln.startswith(
                ("Front adapter:", "Back adapter:"))))
        log(f"trim's first {TRIM_RECORDED} chain and anchor launches of "
            f"each stage against the plain versions:")
        check_recorded(calls)
        for name in trim_kernels:
            by_stage = sum(n for (k, _), n in per_stage.items() if k == name)
            if by_stage != launches[name]:
                raise SystemExit(f"trim's {name} launches by stage "
                                 f"{dict(per_stage)} do not add up to the "
                                 f"kernel's count {launches[name]}")
            for stage in ("determine", "edges", "middle"):
                if per_stage[name, stage] <= 0 or recorded[name, stage] <= 0:
                    raise SystemExit(f"trim's {stage} stage launched no "
                                     f"{name} kernel")
        if not split or split[0] < TRIM_SPLIT_MIN * planted:
            raise SystemExit(f"trim split {split} reads of {planted} "
                             f"planted chimeras")
        profile_trim(path, dev)
        trim_card_vs_cpu(path, d)
    trim_golden(dev)


def profile_trim(path: str, dev, out_path=PROFILE_TRIM_OUT):
    """One edge batch (TRIM_EDGE_BATCH reads) and one middle batch (16,384
    windows) under ``torch.profiler``, with the adapters the CLI run keeps
    (DetermineAdapters on the first 2048 reads): wall, device busy time
    and idle share, ranges and tables (``out_path``)."""
    from torch.profiler import ProfilerActivity, profile
    from downpore_tpu_torch.io import SequenceSet
    from downpore_tpu_torch.trim import load_trimmer

    seqs = SequenceSet(path, min_length=50)
    t = load_trimmer("", "", 6, verbosity=0, device=dev)
    t.determine_adapters(seqs, 2048, 90)
    batch = list(seqs.get_n_sequences_from(0, TRIM_EDGE_BATCH))
    t._finish_edge_batch(seqs, t._dispatch_edge_batch(batch))   # warm-up
    stream = t._mid_stream(seqs)
    # warm-up of the middle batch too: the profiled batches replay their
    # graphs, none is captured under the profiler
    stream.add_batch(batch[:2730])
    stream._dispatch()
    stream._collect()
    with ranged(TRIM_RANGES):
        sync(dev)
        for name, run in (
                ("edge batch", lambda: t._finish_edge_batch(
                    seqs, t._dispatch_edge_batch(batch))),
                # 6 windows a read: 2730 reads fill 16,380 of one batch
                ("middle batch", lambda: (stream.add_batch(batch[:2730]),
                                          stream._dispatch(),
                                          stream._collect()))):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                sync(dev)
                wall = time.perf_counter() - t0
            evts = prof.events()
            log(f"trim {name} under torch.profiler: wall {wall * 1e3:.3f} ms; "
                f"{device_busy(evts, wall)}")
            top = sorted(prof.key_averages(), key=lambda e: -_device_us(e))
            log("  top device time: " + "; ".join(
                f"{e.key} {_device_us(e) / 1e3:.3f} ms x{e.count}"
                for e in top[:8] if _device_us(e) > 0))
            report_ranges(prof, TRIM_RANGES,
                          out_path.replace(".txt", f"_{name.split()[0]}.txt"))
    trim_dispatch_cases(t, batch, stream)


def trim_dispatch_cases(t, batch, stream):
    """``phase_dispatch`` of one edge batch (both sides' verdicts of the
    batch's reads, at the trimmer's budget of 16,384 pairs) and of one
    middle batch (the windows of 2730 reads, at max(4096, windows / 4)
    pairs and 4096 detections)."""
    from downpore_tpu_torch.trim.trimmer import EDGE_SIZE
    eng = t._engine()
    W = t.WINDOW - t.k + 1
    usable = [s for s in batch if len(s) >= EDGE_SIZE + 50]
    sides = [([s.subsequence(0, EDGE_SIZE) for s in usable], True,
              *t._edge_mins(t.front_sets), len(t.front_adapters)),
             ([s.subsequence(len(s) - EDGE_SIZE, len(s)) for s in usable],
              False, *t._edge_mins(t.back_sets), len(t.back_adapters))]
    edge = (lambda b: [eng.edge_verdict_dispatch(w, front, gm, cm, W,
                                                  pair_budget=b or 16384)
                       for w, front, gm, cm, _ in sides],
            lambda f: [eng.edge_verdict_collect(fs, n)
                       for fs, (*_, n) in zip(f, sides)])
    name = f"trim edge batch ({len(usable)} reads, both sides)"
    phase_dispatch(name, *edge,
                   lambda f: max(int(p.host.wait()[2][0]) for fs in f
                                 for _, blocks in fs for p in blocks))
    phase_graphs(name, *edge)
    stream.add_batch(batch[:2730])
    n = stream.count
    rows, lens = stream.rows[:n].copy(), stream.lens[:n].copy()
    stream.metas, stream.count = [], 0

    def mid(b):
        keep = []
        up = eng.upload_rows(rows, lens, n, keep)
        return eng.window_verdict_dispatch_packed(
            [up + (0,)], stream.min_matches, stream.min_matches,
            t.mid_threshold, stream.W, pair_budget=b or max(4096, n // 4),
            keep=keep)
    phase_dispatch(f"trim middle batch ({n} windows)", mid,
                   eng.window_verdict_collect,
                   lambda f: max(int(p.host.wait()[0][-1, 0]) for p in f))
    phase_graphs(f"trim middle batch ({n} windows)", mid,
                 eng.window_verdict_collect)


def _device_us(evt) -> float:
    """An averaged profiler event's own device time, in microseconds
    (``self_device_time_total``, ``self_cuda_time_total`` before torch
    2.4)."""
    us = getattr(evt, "self_device_time_total", None)
    return us if us is not None else evt.self_cuda_time_total


def trim_card_vs_cpu(path: str, d: str):
    """The first TRIM_CARD_VS_CPU reads trimmed on the card and on the CPU
    (plain versions): byte-identical fastq."""
    sub = os.path.join(d, "head.fastq")
    with open(path) as src, open(sub, "w") as dst:
        for _ in range(4 * TRIM_CARD_VS_CPU):
            dst.write(src.readline())
    outs = []
    for device in ("cuda", "cpu"):
        out = os.path.join(d, f"head_{device}.fastq")
        t0 = time.perf_counter()
        run_trim(sub, device, out)
        with open(out, "rb") as f:
            outs.append(f.read())
        log(f"trim of {TRIM_CARD_VS_CPU} reads on {device}: "
            f"{time.perf_counter() - t0:.3f} s")
    same = outs[0] == outs[1]
    log(f"trim card vs cpu on {TRIM_CARD_VS_CPU} reads: {len(outs[0])} / "
        f"{len(outs[1])} bytes, byte-identical: {same}")
    if not same or not outs[0]:
        raise SystemExit("trim fastq on the card differs from the CPU's")


def golden_trim_records():
    """test_trim_golden.py's fixture: 30 reads with mutated adapters at
    both ends, a chimera and a clean read, as (name, bases)."""
    rng = np.random.default_rng(9)
    letters = "ACGT"
    front = "AATGTACTTCGTTCAGTTACGTATTGCT"
    back = "GCAATACGTAACTGAACGAAGT"

    def rb(n):
        return "".join(letters[i] for i in rng.integers(0, 4, n))

    def mut(s, r=0.08):
        return "".join(letters[rng.integers(0, 4)] if rng.random() < r
                       else c for c in s)

    records = []
    for i in range(30):
        core = rb(int(rng.integers(600, 1200)))
        records.append((f"read{i}", mut(front) + core + mut(back)))
    records.append(("chimera", rb(1500) + front + rb(1600)))
    records.append(("clean", rb(900)))
    return records


def trim_golden(dev):
    """test_trim_golden.py's fixture and calls on the card: the output's
    SHA-256 must be the JAX package's recorded digest."""
    import hashlib
    import io
    import tempfile
    from downpore_tpu_torch.io import SequenceSet
    from downpore_tpu_torch.trim import load_trimmer
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "reads.fastq")
        with open(path, "w") as f:
            f.writelines(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                         for n, s in golden_trim_records())
        trimmer = load_trimmer("", "", 6, verbosity=0, device=dev)
        seq_set = SequenceSet(path, min_length=50)
        trimmer.determine_adapters(seq_set, 10000, 90)
        trimmer.set_trim_params(85, 5, 50, 1000, True, True, False)
        trimmer.trim(seq_set)
        out = io.StringIO()
        seq_set.write(out, True)
    digest = hashlib.sha256(out.getvalue().encode()).hexdigest()
    log(f"trim golden fixture on the card: sha256 {digest}")
    if digest != TRIM_GOLDEN_DIGEST:
        raise SystemExit("the golden trim digest differs from the JAX "
                         "package's")


# the multi-device paths on one card (phase_grid)
GRID_OV_READS = 2000
# trim CLI flags that give test_trim_golden.py's trim parameters
GRID_TRIM_FLAGS = ["-chunk_size", "1000", "-extra_middle_trim", "50",
                   "-verbosity", "0"]
# the JAX package's make_mesh error for -seed_shards 2 on one device
JAX_SEED_SHARDS_ERROR = ("mesh needs n_data x n_seed <= devices: have 1 "
                         "device(s), asked for n_data=0 x n_seed=2")


def run_cli(argv, device: str, listing=None) -> tuple:
    """The port's CLI on ``device`` (with the default grid's device listing
    replaced by ``listing`` when given); returns (stdout, stderr)."""
    import io
    from downpore_tpu_torch.cli.main import main as cli_main
    from downpore_tpu_torch.parallel import mesh as mesh_mod
    out, err = io.StringIO(), io.StringIO()
    subs = [] if listing is None else [(mesh_mod, "local_devices",
                                        lambda: list(listing))]
    with device_env(device), patched(subs), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli_main(argv)
    return out.getvalue(), err.getvalue()


def grid_counted(name: str, dev, calls: list, run):
    """``run()`` with the path kernels' launches recorded into ``calls``
    and counted from 0; returns (its result, the launch counts, seconds).
    Every grid run chains and builds anchors."""
    zero_launches()
    with patched(record_all(calls)):
        t0 = time.perf_counter()
        out = run()
        sync(dev)
        wall = time.perf_counter() - t0
    launches = launch_counts()
    log(f"grid {name}: {wall:.3f} s, launches {launches}")
    if launches["chain_scan"] <= 0 or launches["anchors_topk"] <= 0:
        raise SystemExit(f"grid {name} launched {launches}")
    return out, launches, wall


def phase_grid(mapper, reads, dev):
    """The multi-device paths on the one card, as grids that place
    several shards on it: the k-mer histogram on a 2 x 2 grid against the
    host bincount; ``Mapper(mesh=make_mesh(2, 2, [card] * 4))`` on the
    slice's genome and reads (PAF equal to the unsharded mapper's, warm-up
    launches held to the plain scan, three timed passes with the chain
    launch count, resident bytes per shard); the ``map`` CLI with
    ``-data_parallel true`` (the 1 x 1 grid of one card) against no flag,
    and ``-seed_shards 2`` against the JAX package's error; seed-sharded
    ``overlap`` (2 x 2) on the first GRID_OV_READS reads of the overlap
    case against the unsharded run; ``trim -data_parallel true`` (1 x 1
    and a 2-way data grid on the card) against the golden digest.
    The path kernels' launches of the timed map passes, the sharded
    overlap and the trims go to ``PATH_LAUNCHES["grid"]``; every recorded
    launch of the phase is held against its plain version."""
    import hashlib
    import tempfile
    from collections import Counter
    from downpore_tpu_torch.mapping import Mapper
    from downpore_tpu_torch.parallel import make_mesh
    from downpore_tpu_torch.utils import kmer_occurrences, score_seed_values

    t_phase = time.perf_counter()
    grid = make_mesh(n_data=2, n_seed=2, devices=[dev] * 4)
    ref = mapper.reference
    t0 = time.perf_counter()
    hist = kmer_occurrences([ref], K, mesh=grid)
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = kmer_occurrences([ref], K)
    same = bool(np.array_equal(hist, host))
    log(f"grid k-mer histogram (2 x 2 on the card, k = {K}): {t_grid:.3f} "
        f"s against the host bincount's {time.perf_counter() - t0:.3f} s; "
        f"{int(hist.sum())} k-mers, equal: {same}")
    if not same:
        raise SystemExit("the grid k-mer histogram differs from the host "
                         "bincount")

    plain = [mapper.as_string(m) for ms in mapper.map_batch(reads)
             for m in ms]
    t0 = time.perf_counter()
    gm = Mapper(ref, False, K, score_seed_values(hist, K), seed_rate=40,
                edge_size=1000, chunk_size=10000, mesh=grid)
    sync(dev)
    eng = gm.engine
    if not eng.seed_sharded:
        raise SystemExit("the 2 x 2 grid's engine is not seed-sharded")
    shards = eng.shard_tensors()
    per_shard = {d: {n: t.numel() * t.element_size() for n, t in
                     tabs.items()} for d, tabs in shards.items()}
    unique = {}
    for tabs in shards.values():
        for t in tabs.values():
            unique[t.data_ptr()] = t.numel() * t.element_size()
    log(f"grid map index: {eng.C} chunks, H={eng.H}, padded rows "
        f"{eng._mem_shape[0]}, built in {time.perf_counter() - t0:.1f} s; "
        f"resident bytes per data shard "
        + "; ".join(f"{d}: {b} = {sum(b.values())}"
                    for d, b in per_shard.items())
        + f"; {sum(unique.values())} bytes on the card (shards that share "
        f"the card share their tables)")
    calls = []
    t0 = time.perf_counter()
    warm, _, _ = grid_counted("map warm-up pass (recorded)", dev, calls,
                              lambda: gm.map_batch(reads))
    log(f"grid map warm-up pass: its {len(calls)} recorded launches "
        f"against the plain versions:")
    check_recorded(calls)
    calls.clear()
    eng.routes.clear()
    zero_launches()
    walls = []
    with counted_reruns() as reruns:
        for _ in range(TIMED_PASSES):
            t0 = time.perf_counter()
            results = gm.map_batch(reads)
            sync(dev)
            walls.append(time.perf_counter() - t0)
    map_launches = launch_counts()
    got = [gm.as_string(m) for ms in results for m in ms]
    warm_paf = [gm.as_string(m) for ms in warm for m in ms]
    bases = sum(len(r) for r in reads)
    wall = float(np.median(walls))
    same = got == plain == warm_paf
    log(f"grid map_batch (2 x 2 on the card), {TIMED_PASSES} passes: wall "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; median {wall:.4f} s = "
        f"{bases / wall:.0f} bases/s; launches {map_launches}; "
        f"routes {dict(eng.routes)}; re-runs at collect "
        f"{reruns['reruns']}; {len(got)} PAF lines, equal to the "
        f"unsharded mapper's: {same}")
    if not same or not got:
        raise SystemExit("the 2 x 2 grid's PAF differs from the unsharded "
                         "mapper's")
    map_dispatch_case("map 4.6 Mb on the 2 x 2 grid (one card)", gm, reads)
    del gm, eng, warm, results
    # a data grid without a seed axis: both data blocks replay one key
    dp = copy.copy(mapper)
    dp.mesh = make_mesh(n_data=2, n_seed=1, devices=[dev] * 2)
    dp._build_device_index()
    map_dispatch_case("map 4.6 Mb on a 2 x 1 data grid (one card)", dp,
                      reads)
    del dp

    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(SEED + 60)
        g = BASES[rng.integers(0, 4, 30_000)].tobytes().decode()
        gpath, rpath = os.path.join(d, "g.fasta"), os.path.join(d, "r.fasta")
        with open(gpath, "w") as f:
            f.write(f">genome\n{g}\n")
        with open(rpath, "w") as f:
            for i in range(24):
                p = int(rng.integers(0, len(g) - 2000))
                read = mutate_fast(rng, np.frombuffer(
                    g[p:p + 2000].encode(), np.uint8), 0.03)
                f.write(f">r{i}\n{read.tobytes().decode()}\n")
        argv = ["map", "-input", rpath, "-reference", gpath, "-circular",
                "false"]
        base = run_cli(argv, dev.type)
        dp = run_cli(argv + ["-data_parallel", "true"], dev.type)
        try:
            run_cli(argv + ["-seed_shards", "2"], dev.type)
            raised = "nothing"
        except ValueError as e:
            raised = str(e)
        log(f"grid map CLI on one card: {base[0].count(chr(10))} PAF lines; "
            f"-data_parallel true equal to no flag: {dp == base}; "
            f"-seed_shards 2 raised: {raised!r}")
        if dp != base or not base[0]:
            raise SystemExit("map -data_parallel true differs from map")
        if raised != JAX_SEED_SHARDS_ERROR:
            raise SystemExit("map -seed_shards 2 on one card did not raise "
                             "the JAX package's error")

        path = os.path.join(d, "overlap.fasta")
        write_overlap_reads(path, GRID_OV_READS)
        t0 = time.perf_counter()
        ov_base = run_cli(["overlap", "-input", path], dev.type)
        t_base = time.perf_counter() - t0
        ov_grid, ov_launches, t_ov = grid_counted(
            "overlap -seed_shards 2 (2 x 2 on the card)", dev, calls,
            lambda: run_cli(["overlap", "-input", path, "-seed_shards", "2"],
                            dev.type, [dev] * 4))
        same = ov_grid == ov_base
        log(f"grid overlap on {GRID_OV_READS} reads: unsharded {t_base:.3f} "
            f"s, 2 x 2 {t_ov:.3f} s; {ov_base[0].count(chr(10))} PAF lines, "
            f"stdout and stderr equal: {same}")
        if not same or not ov_base[0]:
            raise SystemExit("the seed-sharded overlap differs from the "
                             "unsharded run")

        path = os.path.join(d, "golden.fastq")
        with open(path, "w") as f:
            f.writelines(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                         for n, s in golden_trim_records())
        trim_launches = Counter()
        for name, listing in (("1 x 1", None), ("2-way data", [dev] * 2)):
            (out, _), n, _ = grid_counted(
                f"trim -data_parallel true ({name})", dev, calls,
                lambda: run_cli(["trim", "-input", path, "-data_parallel",
                                 "true"] + GRID_TRIM_FLAGS, dev.type,
                                listing))
            trim_launches.update(n)
            digest = hashlib.sha256(out.encode()).hexdigest()
            log(f"grid trim ({name} grid on the card): sha256 {digest}")
            if digest != TRIM_GOLDEN_DIGEST:
                raise SystemExit("trim -data_parallel true differs from the "
                                 "golden digest")
    log(f"grid overlap and trims: their {len(calls)} recorded launches "
        f"against the plain versions:")
    check_recorded(calls)
    total = Counter(map_launches) + Counter(ov_launches) + trim_launches
    PATH_LAUNCHES["grid"] = {k: total[k] for k in PATH_KERNELS}
    log(f"phase_grid: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{PATH_LAUNCHES['grid']}")
    missing = [k for k in PATH_KERNELS if total[k] <= 0]
    if missing:
        raise SystemExit(f"the grid paths launched no {missing} kernel")


# the library phase: a map-scale retrieval shape (4096 query rows of a
# 1 kb window's run buckets against a 2^16-bucket membership of 512
# chunks) and a chain batch of 4096 pairs, 64 x 320 seeds, 128 anchors
LIB_Q, LIB_H, LIB_C = 4096, 65_536, 512
LIB_ROW_BUCKETS = 128
LIB_MEMBER_DENSITY = 0.02
LIB_P, LIB_NQ, LIB_NT, LIB_MAX_ANCHORS, LIB_K = 4096, 64, 320, 128, 11
LIB_PLANTED = 40               # query seeds copied, in order, into the target
LIB_OVERFLOW_ROWS = 256        # rows drawn from a small alphabet: > 128 matches
# the verify skill's library recipe at E. coli scale
RECIPE_GENOME = 4_600_000
RECIPE_K = 11
RECIPE_CHUNK = 1000
RECIPE_QUERIES = 256
RECIPE_QUERY_LEN = 600
RECIPE_ERR = 0.03
# int8 tensor-core peak of one H100 SXM (NVIDIA's data sheet), for the
# retrieval product's bound
INT8_OPS_S = 1979e12


def library_counts_inputs(rng):
    """Run multiplicities ``V [LIB_Q, LIB_H]`` int8 (LIB_ROW_BUCKETS bucket
    draws a row, repeats adding up) and a 0/1 membership ``M [LIB_H,
    LIB_C]`` int8; and numpy's int32 product of the two, taken over each
    row's nonzero buckets."""
    V = np.zeros((LIB_Q, LIB_H), np.int8)
    np.add.at(V, (np.repeat(np.arange(LIB_Q), LIB_ROW_BUCKETS),
                  rng.integers(0, LIB_H, LIB_Q * LIB_ROW_BUCKETS)), 1)
    M = (rng.random((LIB_H, LIB_C)) < LIB_MEMBER_DENSITY).astype(np.int8)
    ref = np.empty((LIB_Q, LIB_C), np.int32)
    for q in range(LIB_Q):
        nz = np.flatnonzero(V[q])
        ref[q] = V[q, nz].astype(np.int32) @ M[nz].astype(np.int32)
    return V, M, ref


def library_pairs(rng):
    """``[LIB_P, N]`` seed and position arrays (padded with -1 / 0) whose
    targets hold a planted run of LIB_PLANTED query seeds at the query's
    spacing, so chains are long; the first LIB_OVERFLOW_ROWS rows draw
    from a small alphabet and overflow ``LIB_MAX_ANCHORS``."""
    P, NQ, NT, R = LIB_P, LIB_NQ, LIB_NT, LIB_PLANTED
    alpha = np.where(np.arange(P) < LIB_OVERFLOW_ROWS, 150, 5000)[:, None]
    qs = (rng.random((P, NQ)) * alpha).astype(np.int32)
    ts = (rng.random((P, NT)) * alpha).astype(np.int32)
    qgap = rng.integers(6, 40, (P, NQ))
    tgap = rng.integers(6, 40, (P, NT))
    rows = np.arange(P)[:, None]
    q0 = rng.integers(0, NQ // 2 - R // 2, P)[:, None] + np.arange(R)
    t0 = rng.integers(0, NT - R, P)[:, None] + np.arange(R)
    ts[rows, t0] = qs[rows, q0]
    tgap[rows, t0[:, 1:]] = qgap[rows, q0[:, 1:]]
    qp = np.cumsum(qgap, axis=1).astype(np.int32)
    tp = np.cumsum(tgap, axis=1).astype(np.int32)
    for s, p, n in ((qs, qp, NQ), (ts, tp, NT)):
        dead = np.arange(n)[None, :] >= rng.integers(n - n // 4, n + 1, P)[
            :, None]
        s[dead], p[dead] = -1, 0
    return qs, qp, ts, tp


def same_dicts(a: dict, b: dict) -> bool:
    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return set(a) == set(b) and all(np.array_equal(host(a[k]), host(b[k]))
                                    for k in a)


def library_recipe(dev):
    """The verify skill's library recipe at a RECIPE_GENOME-base genome:
    seed index of RECIPE_CHUNK-base chunks, hashed membership, retrieval
    counts, candidates, chain DP, and each planted query's genome position
    (chunk offset + start_tp - start_qp) recovered.  Returns (queries,
    pairs, recovered, seconds)."""
    from downpore_tpu_torch.core import Sequence
    from downpore_tpu_torch.ops import chain, match
    from downpore_tpu_torch.seeds import SeedIndex

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 70)
    genome = BASES[rng.integers(0, 4, RECIPE_GENOME)].tobytes().decode()
    ref = Sequence.from_string(genome, id=0, name="ref")
    idx = SeedIndex(RECIPE_K)
    idx.add_single_seeds(ref, 40, np.ones(4 ** RECIPE_K))
    for lo in range(0, RECIPE_GENOME, RECIPE_CHUNK):
        idx.add_sequence(idx.new_seed_sequence(
            ref.subsequence(lo, lo + RECIPE_CHUNK)))
    idx.index_sequences()
    usable = idx._seed_counts < idx.num_sequences
    M = match.build_membership([s.seeds for s in idx.sequences],
                               idx.num_seeds)
    starts = rng.integers(0, RECIPE_GENOME - RECIPE_QUERY_LEN,
                          RECIPE_QUERIES)
    queries = []
    for i, p in enumerate(starts):
        arr = np.frombuffer(genome[p:p + RECIPE_QUERY_LEN].encode(),
                            np.uint8).copy()
        m = rng.random(RECIPE_QUERY_LEN) < RECIPE_ERR
        arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
        queries.append(idx.new_seed_sequence(Sequence.from_string(
            arr.tobytes().decode(), id=i, name=f"q{i}")))
    V, _, num_sets = match.build_query_rows(queries, idx.num_seeds, usable)
    counts = match.hit_counts(V, M, device=dev)
    cands = match.candidates_from_counts(counts, num_sets, 0.25)
    qi = np.repeat(np.arange(len(queries)), [len(c) for c in cands])
    ci = np.concatenate(cands)
    k = RECIPE_K
    out = chain.run_chain_batch(
        [queries[q].seeds for q in qi],
        [queries[q].seed_positions(k) for q in qi],
        [idx.sequences[c].seeds for c in ci],
        [idx.sequences[c].seed_positions(k) for c in ci], k, nq=128,
        nt=256, max_anchors=512, device=dev)
    best = out["through"].max(axis=1)
    recovered = 0
    for q, p in enumerate(starts):
        rows = np.flatnonzero(qi == q)
        if not rows.size:
            continue
        r = rows[np.argmax(best[rows])]
        a = int(np.argmax(out["through"][r]))
        found = int(ci[r]) * RECIPE_CHUNK + int(out["start_tp"][r][a]) \
            - int(out["start_qp"][r][a])
        recovered += found == p
    log(f"library recipe: {RECIPE_GENOME} b genome, k = {k}, "
        f"{idx.num_sequences} chunks of {RECIPE_CHUNK} b, {idx.num_seeds} "
        f"seeds hashed to H = {M.shape[0]}; {len(queries)} queries of "
        f"{RECIPE_QUERY_LEN} b at {RECIPE_ERR} substitutions; {len(ci)} "
        f"candidate pairs; planted position recovered exactly for "
        f"{recovered} of {len(queries)}")
    return len(queries), len(ci), recovered, time.perf_counter() - t0


def phase_library(dev):
    """The seed-query library on the card: ``hit_counts`` at the map
    path's retrieval shape against numpy's int32 product, timed beside its
    bound; ``hit_counts_packed`` against it; ``chain_batch`` and
    ``chain_batch_summary`` against the CPU's plain run; ``run_chain_batch``
    on a same-card 2 x 2 grid against no grid; ``sharded_pipeline_step``
    on a 1 x 1 and a same-card 2 x 2 grid against the unsharded functions;
    the verify skill's recipe.  Every chain launch of the phase is
    recorded and held against the plain scan.  Returns hit_counts' (ms,
    packed ms, bound ms, bound_by)."""
    from downpore_tpu_torch.ops import chain, cuda_chain, match
    from downpore_tpu_torch.parallel import make_mesh, sharded_pipeline_step

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 60)
    t0 = time.perf_counter()
    V, M, ref = library_counts_inputs(rng)
    log(f"library inputs: V [{LIB_Q}, {LIB_H}] int8 ({int((V > 0).sum())} "
        f"nonzero), M [{LIB_H}, {LIB_C}] int8 ({int(M.sum())} ones), "
        f"numpy's product in {time.perf_counter() - t0:.1f} s")
    Vd, Md = torch.from_numpy(V).to(dev), torch.from_numpy(M).to(dev)
    got = match.hit_counts(Vd, Md).cpu().numpy()
    if got.dtype != np.int32 or not np.array_equal(got, ref):
        raise SystemExit("hit_counts differs from numpy's int32 product")
    hc_ms = min(cuda_ms(lambda: match.hit_counts(Vd, Md), 20)
                for _ in range(2))
    t_ops = 2 * LIB_Q * LIB_H * LIB_C / INT8_OPS_S
    t_bytes = (V.nbytes + M.nbytes + got.nbytes) / HBM_BYTES_S
    hc_bound = (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")
    log(f"hit_counts [{LIB_Q}, {LIB_H}] x [{LIB_H}, {LIB_C}] "
        f"(torch._int_mm): equal to numpy's int32 product; {hc_ms:.4f} ms; "
        f"bound {hc_bound[0]:.4f} ms ({hc_bound[1]}: int8 operations "
        f"{t_ops * 1e3:.4f} ms at {INT8_OPS_S / 1e12:.0f} T/s, bytes "
        f"{t_bytes * 1e3:.4f} ms), share {hc_bound[0] / hc_ms:.3f}")
    packed = torch.from_numpy(np.packbits(V != 0, axis=1)).to(dev)
    bits = match.hit_counts((Vd != 0).to(torch.int8), Md)
    if not torch.equal(match.hit_counts_packed(packed, Md), bits):
        raise SystemExit("hit_counts_packed differs from hit_counts")
    pk_ms = cuda_ms(lambda: match.hit_counts_packed(packed, Md), 20)
    log(f"hit_counts_packed on the same rows bit-packed: equal to "
        f"hit_counts; {pk_ms:.4f} ms")
    del Vd, packed, bits

    calls = []
    zero_launches()
    with patched([(cuda_chain, "_launch", recording(
            cuda_chain._launch, cuda_chain.chain_scan_plain, calls))]):
        qs, qp, ts, tp = library_pairs(rng)
        mm = rng.integers(2, 8, LIB_P).astype(np.int32)
        alen = rng.integers(500, 3000, LIB_P).astype(np.int32)
        args = dict(k=LIB_K, max_anchors=LIB_MAX_ANCHORS)
        t0 = time.perf_counter()
        card = chain.chain_batch(qs, qp, ts, tp, device=dev, **args)
        card_sum = chain.chain_batch_summary(qs, qp, ts, tp, mm, alen,
                                             device=dev, **args)
        sync(dev)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = chain.chain_batch(qs, qp, ts, tp, device="cpu", **args)
        cpu_sum = chain.chain_batch_summary(qs, qp, ts, tp, mm, alen,
                                            device="cpu", **args)
        t_cpu = time.perf_counter() - t0
        over = card["overflow"].cpu().numpy()
        same = same_dicts(card, cpu) and torch.equal(card_sum.cpu(), cpu_sum)
        log(f"chain_batch + chain_batch_summary [{LIB_P}, {LIB_NQ}] x "
            f"[{LIB_P}, {LIB_NT}], max_anchors {LIB_MAX_ANCHORS}: card "
            f"{t_card:.3f} s, CPU plain {t_cpu:.3f} s; "
            f"{int(card['valid'].sum())} anchors, {int((over > 0).sum())} "
            f"pairs overflowing by up to {int(over.max())}; best chain "
            f"{int(card['through'].max())}; equal to the CPU's: {same}")
        if not same:
            raise SystemExit("chain_batch on the card differs from the CPU")
        if not (over > 0).any():
            raise SystemExit("the library pairs never overflow max_anchors")

        live_q, live_t = qs >= 0, ts >= 0
        lists = [[a[i][live[i]] for i in range(LIB_P)]
                 for a, live in ((qs, live_q), (qp, live_q), (ts, live_t),
                                 (tp, live_t))]
        grid = make_mesh(2, 2, [dev] * 4)
        one = chain.run_chain_batch(*lists, LIB_K, LIB_NQ, LIB_NT,
                                    LIB_MAX_ANCHORS, device=dev)
        two = chain.run_chain_batch(*lists, LIB_K, LIB_NQ, LIB_NT,
                                    LIB_MAX_ANCHORS, mesh=grid)
        if not same_dicts(one, two) or not same_dicts(one, card):
            raise SystemExit("run_chain_batch on a 2 x 2 grid differs from "
                             "no grid")
        through = card["through"].cpu().numpy()
        for name, g in (("1 x 1", make_mesh(1, 1, [dev])), ("2 x 2", grid)):
            c, th = sharded_pipeline_step(g, k=LIB_K,
                                          max_anchors=LIB_MAX_ANCHORS)(
                V, M, qs, qp, ts, tp)
            if not np.array_equal(c, ref) or not np.array_equal(th, through):
                raise SystemExit(f"sharded_pipeline_step ({name}) differs "
                                 f"from hit_counts and chain_batch")
        log("run_chain_batch on a same-card 2 x 2 grid equal to no grid; "
            "sharded_pipeline_step on 1 x 1 and 2 x 2 grids equal to "
            "hit_counts and chain_batch")
        n_q, n_pairs, recovered, t_recipe = library_recipe(dev)
        if recovered != n_q:
            raise SystemExit(f"the library recipe recovered {recovered} of "
                             f"{n_q} planted positions")
    launches = cuda_chain.chain_scan.launches
    PATH_LAUNCHES["library"] = launch_counts()
    log(f"library phase: chain_scan launches {launches}; their "
        f"{len(calls)} recorded launches against the plain version:")
    check_recorded(calls)
    if launches <= 0 or len(calls) != launches:
        raise SystemExit("the library phase's chain launches were not all "
                         "recorded")
    log(f"phase_library: {time.perf_counter() - t_phase:.1f} s (recipe "
        f"{t_recipe:.1f} s)")
    return (hc_ms, pk_ms) + hc_bound


# the bench sections this smoke runs at the bench's own sizes: the GB
# tails are left to the bench's own run (phase_trim and phase_overlap
# already drive those commands at that scale), and phase_chromosome runs
# the 64 Mb map case's recipe
BENCH_SECTIONS = ("trim", "map", "overlap", "consensus")
BENCH_METRICS = ["trim_reads_per_s", "map_bases_per_s", "map_1mb_bases_per_s",
                 "overlap_bases_per_s", "consensus_bases_per_s"]


def phase_bench(dev):
    """``downpore_tpu_torch.bench``'s BENCH_SECTIONS on the card (map: the
    4.6 Mb and 1 Mb cases), its files in a temporary directory: every
    section must pass and every metric line carry the card's name.
    Returns the metric rows and the chain and beam launches of the run."""
    import io
    import tempfile
    import downpore_tpu_torch.bench as bench
    from downpore_tpu_torch.ops import cuda_beam

    t0 = time.perf_counter()
    out = io.StringIO()
    old_tmp = tempfile.tempdir
    with tempfile.TemporaryDirectory() as d:
        tempfile.tempdir = d
        try:
            with patched([(bench, "RUNNING_JSON",
                           os.path.join(d, "running.jsonl")),
                          (bench, "MAP_CASES", bench.MAP_CASES[:2])]):
                zero_launches()
                cuda_beam.beam_consensus.launches = 0
                with contextlib.redirect_stdout(out):
                    rc = bench.main(list(BENCH_SECTIONS))
                sync(dev)
                launches = dict(
                    path_launches("bench sections"),
                    beam_consensus=cuda_beam.beam_consensus.launches)
        finally:
            tempfile.tempdir = old_tmp
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]
    for r in rows:
        log(f"bench {json.dumps(r)}")
    log(f"phase_bench: sections {list(BENCH_SECTIONS)}, exit {rc}, "
        f"{len(rows)} metric lines, launches {launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise SystemExit(f"the bench exited {rc}")
    if [r["metric"] for r in rows] != BENCH_METRICS:
        raise SystemExit(f"the bench printed {[r['metric'] for r in rows]}")
    name = torch.cuda.get_device_name(0)
    if any(name not in r.get("device", "") for r in rows):
        raise SystemExit("a bench line lacks the card's name")
    if launches["beam_consensus"] <= 0:
        raise SystemExit(f"the bench sections launched {launches}")
    return rows, launches


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
    global KEEP_KERNEL_ARGS
    ap = argparse.ArgumentParser(description="The port's smoke run on one "
                                 "CUDA card.")
    ap.add_argument("--keep-kernel-args", metavar="DIR",
                    help="also save the anchor and count launches timed "
                    "at the path shapes into DIR (scripts/ab_paths.py "
                    "--cases anchor_counts reads them)")
    KEEP_KERNEL_ARGS = ap.parse_args().keep_kernel_args
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
    names = ("chain_scan", "band_update", "beam_consensus", "anchors_topk",
             "retrieval_count")
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    log("kernel builds (parallel nvcc): " + ", ".join(
        f"{n} " + (f"{_build.build_seconds[n]:.2f} s"
                   if n in _build.build_seconds else "cached")
        for n in names) + f"; {time.perf_counter() - t0:.2f} s with load")

    from downpore_tpu_torch import native
    t0 = time.perf_counter()
    lib = native.load()
    log(f"native host library (downpore_tpu_torch/native/seqscan.cpp): "
        f"{'loaded' if lib is not None else 'NOT loaded'} from "
        f"{native._lib_path()} in {time.perf_counter() - t0:.2f} s")
    if lib is None:
        raise SystemExit("the native host library did not load: the host "
                         "times would be the numpy route's")

    max_err, chain_t, chain_rows = phase_kernel(dev)
    band_err, band_ms, band_plain_ms, band_bound, band_by = phase_band(dev)
    beam_err, (beam_ms, beam_plain_ms, beam_bound_ms, beam_by) = \
        phase_beam(dev)
    for name, err in phase_anchor_counts(dev).items():
        RECORDED_ERRS[name] = max(RECORDED_ERRS.get(name, 0), err)
    mapper, reads, _ = phase_slice(dev)
    phase_profile(mapper, reads)
    map_dispatch_case("map 4.6 Mb", mapper, reads)
    phase_card_vs_cpu(mapper, reads)
    phase_grid(mapper, reads, dev)
    del mapper, reads
    phase_chromosome(dev)
    correct_records, correct_launches = phase_correct(dev)
    profile_correct(correct_records, dev)
    phase_correct_card_vs_cpu()
    phase_overlap(dev)
    phase_trim(dev)
    hc = phase_library(dev)
    _, bench_launches = phase_bench(dev)
    if "jax" in sys.modules:
        raise SystemExit("the port's map, overlap, correct, trim, library "
                         "or bench path imported jax")
    jax_pkg = sorted(m for m in sys.modules
                     if m == "downpore_tpu" or m.startswith("downpore_tpu."))
    if jax_pkg:
        raise SystemExit(f"the port loaded the JAX package: {jax_pkg}")
    log("after every phase: no jax and no downpore_tpu module loaded")
    log("phase_dispatch, every case (dispatch under set_sync_debug_mode("
        "'error'); host ms / device span ms / device busy ms at the path's "
        "budget / padding ms / re-runs): " + "; ".join(
            f"{r['name']} {r['dispatch_ms']:.3f} / {r['device_span_ms']:.3f}"
            f" / {r['device_busy_ms']:.3f} / {r['padding_ms']:.3f} / "
            f"{r['reruns']}" for r in DISPATCH_ROWS))
    if len(DISPATCH_ROWS) != len(DISPATCH_CASES):
        raise SystemExit(f"phase_dispatch measured {len(DISPATCH_ROWS)} "
                         f"cases, not {len(DISPATCH_CASES)}")
    from downpore_tpu_torch.ops import captured
    log("phase_graphs, every path (keys / replays / host ms replayed vs "
        "eager / dispatch + collect ms (CUDA events) replayed vs eager / "
        "device busy ms replayed vs eager / outputs equal / pool bytes): "
        + "; ".join(
            f"{r['name']} {r['keys']} / {r['replays']} / "
            f"{r['replay']['host']:.3f} vs {r['eager']['host']:.3f} / "
            f"{r['replay']['total']:.3f} vs {r['eager']['total']:.3f} / "
            f"{r['replay']['busy']:.3f} vs {r['eager']['busy']:.3f} / "
            f"{r['equal']} / {r['pool_bytes']}" for r in GRAPH_ROWS))
    by_route = {}
    for st in captured.GRAPHS.stats().values():
        c, rp, nodes = by_route.get(st["route"], (0, 0, 0))
        by_route[st["route"]] = (c + 1, rp + st["replays"],
                                 max(nodes, st["nodes"]))
    log(f"graph cache over the whole run: {len(captured.GRAPHS.entries)} "
        f"captures, by route (captures, replays, most nodes a graph) "
        f"{by_route}; graph pools {captured.GRAPHS.pool_bytes()} bytes, "
        f"resident-table buffers {captured.GRAPHS.table_bytes()} bytes, "
        f"{captured.GRAPHS.table_copies} table copies")
    # update_bands runs on no path: in the JAX package the Pallas band
    # kernel is test-only, and its step is the beam kernel's inner loop
    from downpore_tpu_torch.ops import cuda_chain
    log(f"launches by path: {PATH_LAUNCHES}; correct {correct_launches}; "
        f"bench sections {bench_launches}; chain_scan by mode over the "
        f"whole run {dict(cuda_chain.MODE_LAUNCHES)}")
    log("anchors_topk and retrieval_count at the path shapes (the largest "
        "launch of each kind in one eager dispatch + collect of each "
        "phase_dispatch case; kernel ms / plain ms / library ms / bound ms "
        "(by) / share): " + "; ".join(
            f"{r['name']} {r['kind']} at {r['path']} [{r['shape']}] "
            f"{r['ms']:.4f} / {r['plain_ms']:.3f} / "
            + (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "null")
            + f" / {r['bound_ms']:.4f} ({r['bound_by']}) / "
            f"{r['bound_ms'] / r['ms']:.3f}" for r in KERNEL_ROWS))
    total = {k: sum(v[k] for v in PATH_LAUNCHES.values())
             for k in PATH_KERNELS}
    # the new kernels' line: the map 4.6 Mb dispatch's launches
    row_of = {}
    for name, kind in (("anchors_topk", "indexed"),
                       ("retrieval_count", "flat + first")):
        rows = [r for r in KERNEL_ROWS if r["name"] == name
                and r["kind"] == kind and r["path"] == "map 4.6 Mb"]
        if not rows or name not in RECORDED_ERRS:
            raise SystemExit(f"{name} was not timed at the map 4.6 Mb "
                             f"shape or never recorded")
        row_of[name] = rows[0]
    log(f"hit_counts (a library product, not a TPU kernel): {hc[0]:.4f} "
        f"ms, packed {hc[1]:.4f} ms, bound {hc[2]:.4f} ms ({hc[3]})")
    log("chain_scan at the path shapes: " + "; ".join(
        f"{n} {ms:.4f} ms, bound {b:.4f} ms ({by})"
        for n, ms, b, by in chain_rows))

    ms, plain_ms, chain_bound_ms, chain_by = chain_t
    # library_ms: no single PyTorch call computes any of the three
    # functions (a serial DP scan, a beam search, a saturating band step)
    kernels = [{
        "name": "chain_scan", "route": "cuda",
        "source": "downpore_tpu_torch/csrc/chain_scan.cu",
        "replaces": "downpore_tpu/ops/pallas_chain.py:42",
        "launches": total["chain_scan"],
        "max_abs_err": max(max_err, RECORDED_ERRS["chain_scan"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": chain_bound_ms,
        "bound_by": chain_by, "library_ms": None}, {
        "name": "update_bands", "route": "cuda",
        "source": "downpore_tpu_torch/csrc/band_update.cu",
        "replaces": "downpore_tpu/ops/pallas_band.py:36",
        "launches": correct_launches["update_bands"],
        "max_abs_err": band_err, "ms": band_ms, "plain_ms": band_plain_ms,
        "bound_ms": band_bound, "bound_by": band_by, "library_ms": None}, {
        "name": "beam_consensus", "route": "cuda",
        "source": "downpore_tpu_torch/csrc/beam_consensus.cu",
        "replaces": "downpore_tpu/ops/pallas_beam.py:105",
        "launches": correct_launches["beam_consensus"]
        + bench_launches["beam_consensus"],
        "max_abs_err": max(beam_err, RECORDED_ERRS["beam_consensus"]),
        "ms": beam_ms, "plain_ms": beam_plain_ms, "bound_ms": beam_bound_ms,
        "bound_by": beam_by, "library_ms": None}]
    sources = {"anchors_topk": ("downpore_tpu_torch/csrc/anchors_topk.cu",
                                "downpore_tpu/ops/chain.py:57"),
               "retrieval_count": (
                   "downpore_tpu_torch/csrc/retrieval_count.cu",
                   "downpore_tpu/ops/map_engine.py:142")}
    for name, (source, replaces) in sources.items():
        r = row_of[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total[name],
            "max_abs_err": RECORDED_ERRS[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
