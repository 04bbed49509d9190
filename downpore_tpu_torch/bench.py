"""Benchmark suite of the torch port: end-to-end throughput of the four
pipelines on the port's device (the CUDA card; the CPU with
``DOWNPORE_TORCH_DEVICE=cpu``).

    python -m downpore_tpu_torch.bench [section ...]

Sections, in order: ``trim``, ``map`` (4.6 Mb, 1 Mb and 64 Mb cases),
``overlap``, ``consensus``, then the disk-to-disk tails ``trim_gb``,
``map_gb`` and ``overlap_gb``.  They are the JAX package's ``bench.py``
sections run on the port's paths, with the same seeds, sizes, generators,
timing (best of two after warm-ups) and metric names.  Each metric is one
JSON line on stdout, also appended to ``$BENCH_RUNNING_JSON`` (default
``bench_running.json`` in the temporary directory):

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": ..., ...}

``device`` is the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, or
``"cpu"`` when the caller asked for the CPU.  Without a card, and without
``DOWNPORE_TORCH_DEVICE=cpu``, the suite raises at start.

Baselines (ours / reference; BASELINE.md has the derivations):
* trim    the reference's worst-case demultiplex anchor of ~1 GB/min of
          fastq on its 16-thread desktop (ref README.md:126), as reads/s
          at this read length;
* map     the reference maps 1.5 GB of E. coli reads in 6.7 s (ref
          README.md:240), ~2.24e8 query bases/s; 2 GB against chr20 in
          48.7 s (README.md:241) for the 64 Mb case;
* overlap the same 1 GB/min anchor as a conservative proxy (the reference
          publishes no absolute overlap time);
* consensus derived from the reference's own hot loop: the port's native
          C++ band update (``native.band_update_rounds``) x2 for hand-SIMD
          headroom x16 threads, over the band updates per consensus base
          of the host oracle (``DTWAligner``) on the same job shape.

The ``map_gb`` and ``overlap_gb`` sections check their outputs against
the JAX package's recorded runs (every read uniquely mapped; overlap's
6-round stderr and 721,379 PAF lines), and a mismatch fails the section.
A failing section is noted on stderr, the remaining sections run, and the
suite exits non-zero.  An unknown section name exits 2.

The sizes sit in module constants, so that a test can lower them.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import resolve_device

N_READS = 8192
READ_LEN = 3000
BATCH = 4096
SEED = 1234
# bench.py's three map cases: (metric, tag, genome bases, k, reads,
# anchor in query bases/s).  The headline is E. coli scale: the reference
# maps a 1.5 GB read set against the 4.6 Mb E. coli genome in 6.7 s on
# its 16-thread desktop (ref README.md:240); the 1 Mb case keeps that
# anchor, and the 64 Mb chr20-scale case has the reference's 2 GB in
# 48.7 s (README.md:241).
MAP_CASES = (("map_bases_per_s", "4.6Mb", 4_600_000, 11, 8192, 1.5e9 / 6.7),
             ("map_1mb_bases_per_s", "1Mb", 1_000_000, 11, 8192,
              1.5e9 / 6.7),
             ("map_chr20_bases_per_s", "64Mb", 64_000_000, 13, 2048,
              2.0e9 / 48.7))
MAP_READ_LEN = (6000, 10_000)
OVERLAP_GENOME = 400_000
OVERLAP_READS = 1024
OVERLAP_READ_LEN = (6000, 9600)
CONSENSUS_JOBS = 1024
CONSENSUS_MEMBERS = 6
CONSENSUS_CORE = 500
CONSENSUS_ORACLE_JOBS = 2
BAND_ROWS = 4096
BAND_REPS = 1000
TRIM_GB_READS = 163_840           # ~1 GB at 3 kb reads
TRIM_GB_WARM = 8192
TRIM_GB_BATCH = 8192
MAP_GB_GENOME = 4_600_000
MAP_GB_READS = 61_000             # ~0.5 GB at 8 kb reads
MAP_GB_READ_LEN = 8000
MAP_GB_UNIQUE = 61_000            # the JAX run (BENCH_r05.json's tail)
OV_GB_GENOME = 2_000_000
OV_GB_READS = 12_000              # ~0.1 GB at 8 kb reads
OV_GB_READ_LEN = 8000
# the JAX package's overlap command on overlap_gb's input (BENCH_r05.json)
OV_GB_PAF_LINES = 721_379
OV_GB_STDERR = [
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

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
RUNNING_JSON = os.environ.get(
    "BENCH_RUNNING_JSON", os.path.join(tempfile.gettempdir(),
                                       "bench_running.json"))


def tmp_path(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def device_label(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or ``"cpu"``."""
    if dev.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    lines = out.strip().splitlines()
    return lines[dev.index or 0] if lines else torch.cuda.get_device_name(dev)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_of(fn, dev, n=2):
    """Run fn() n times, each ending in a device sync; return
    (best_seconds, spread) where spread is (worst-best)/best."""
    times = []
    for _ in range(n):
        t0 = time.time()
        fn()
        sync(dev)
        times.append(time.time() - t0)
    best = min(times)
    return best, round((max(times) - best) / max(best, 1e-9), 3)


def emit(metric, value, unit, vs, **extra):
    row = {"metric": metric, "value": round(value, 1), "unit": unit,
           "vs_baseline": round(vs, 3)}
    for kk, vv in extra.items():
        row[kk] = round(vv, 3) if isinstance(vv, float) else vv
    print(json.dumps(row))
    sys.stdout.flush()
    # running record: a suite timeout loses the section in flight, not
    # every completed metric
    try:
        with open(RUNNING_JSON, "a") as f:
            f.write(json.dumps(row) + "\n")
    except OSError:
        pass


def note(msg):
    print("# " + msg, file=sys.stderr)
    sys.stderr.flush()


def rand_seq(rng, n):
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


def mutate(rng, s, rate=0.08):
    arr = np.frombuffer(s.encode(), dtype=np.uint8).copy()
    m = rng.random(len(arr)) < rate
    arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    return arr.tobytes().decode()


def make_reads(path, n_reads, rng):
    from .data import BACK_ADAPTERS, FRONT_ADAPTERS
    front = FRONT_ADAPTERS[0][1]
    back = BACK_ADAPTERS[0][1]
    with open(path, "w") as f:
        for i in range(n_reads):
            core = rand_seq(rng, READ_LEN)
            read = mutate(rng, front) + core + mutate(rng, back)
            f.write(f"@read{i}\n{read}\n+\n{'I' * len(read)}\n")
    return os.path.getsize(path)


def _adapters():
    from .core import Sequence
    from .data import BACK_ADAPTERS, FRONT_ADAPTERS
    return ([Sequence.from_string(s, id=i, name=n)
             for i, (n, s) in enumerate(FRONT_ADAPTERS)],
            [Sequence.from_string(s, id=i, name=n)
             for i, (n, s) in enumerate(BACK_ADAPTERS)])


# ---------------------------------------------------------------------
def bench_trim(dev, label):
    from .io import SequenceSet
    from .trim import Trimmer

    rng = np.random.default_rng(SEED)
    path = tmp_path("bench_reads.fastq")
    nbytes = make_reads(path, N_READS, rng)
    fronts, backs = _adapters()

    def run_trim(seq_set, trimmer):
        trimmer.set_trim_params(85, 5, 50, 1000, True, True, False)
        trimmer.trim(seq_set, batch_size=BATCH)

    # warm-up: a small set runs every stage once
    warm_path = tmp_path("bench_warm.fastq")
    make_reads(warm_path, BATCH, np.random.default_rng(SEED + 1))
    trimmer = Trimmer(fronts, backs, k=6, verbosity=0)
    trimmer.determine_adapters(SequenceSet(warm_path, min_length=50),
                               BATCH, 90, batch_size=BATCH)
    run_trim(SequenceSet(warm_path, min_length=50), trimmer)

    # measured: best of two fresh runs (fresh sequence set + trimmer each,
    # I/O included: the reference numbers include I/O)
    def one_run():
        seq_set = SequenceSet(path, min_length=50)
        trimmer2 = Trimmer(trimmer.original_front, trimmer.original_back,
                           k=6, verbosity=0)
        run_trim(seq_set, trimmer2)

    elapsed, spread = best_of(one_run, dev)
    reads_s = N_READS / elapsed
    # reference anchor: ~1 GB/min of fastq on the 16T desktop
    ref_bytes_s = 1e9 / 60.0
    bytes_per_read = nbytes / N_READS
    baseline_reads_s = ref_bytes_s / bytes_per_read
    note(f"trim elapsed={elapsed:.1f}s reads={N_READS} "
         f"mean_read={READ_LEN + 50}b")
    emit("trim_reads_per_s", reads_s, "reads/s", reads_s / baseline_reads_s,
         spread=spread, device=label)


# ---------------------------------------------------------------------
def _map_case(GEN, k, n_reads, tag, dev, err=0.08):
    """Build a GEN-base synthetic reference, map n_reads ONT-like reads,
    return (bases/s, extras).  Best of two timed runs
    after a full warm-up (the reference numbers are steady-state too)."""
    from .core import Sequence
    from .mapping import Mapper
    from .utils import kmer_occurrences, score_seed_values

    rng = np.random.default_rng(SEED + 10)
    genome = rand_seq(rng, GEN)
    ref = Sequence.from_string(genome, id=0, name=f"ref_{tag}")
    values = score_seed_values(kmer_occurrences([ref], k), k)
    t0 = time.time()
    mapper = Mapper(ref, False, k, values, seed_rate=40, edge_size=1000,
                    chunk_size=10000)
    t_index = time.time() - t0
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    lo, hi = MAP_READ_LEN
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, GEN - hi))
        L = int(rng.integers(lo, hi))  # ONT-scale read lengths
        s = mutate(rng, genome[p : p + L], err)
        if i % 2:
            s = s.encode().translate(comp)[::-1].decode()
        reads.append(Sequence.from_string(s, id=i, name=f"r{i}"))
    total_bases = sum(len(r) for r in reads)
    mapper.map_batch(reads)          # warm-up
    results = []

    def one_run():
        results[:] = mapper.map_batch(reads)

    elapsed, spread = best_of(one_run, dev)
    n_mapped = sum(1 for r in results if r)
    bases_s = total_bases / elapsed
    eng = mapper.engine
    note(f"map[{tag}] elapsed={elapsed:.1f}s reads={n_reads} "
         f"mapped={n_mapped} index_build={t_index:.1f}s "
         f"chunks={eng.C} binned={eng._binned}")
    return bases_s, dict(spread=spread)


def bench_map(dev, label):
    """MAP_CASES in order; the first is the headline, the others are
    secondary lines."""
    for i, (metric, tag, gen, k, n_reads, anchor) in enumerate(MAP_CASES):
        bases_s, meta = _map_case(gen, k, n_reads, tag, dev)
        emit(metric, bases_s, "bases/s", bases_s / anchor,
             scale=f"{tag} genome" + (" (secondary)" if i else ""),
             device=label, **meta)


# ---------------------------------------------------------------------
def bench_overlap(dev, label):
    from concurrent.futures import ThreadPoolExecutor

    from .core import Sequence
    from .overlap import QUERY_EDGES, Overlapper
    from .seeds import SeedIndex
    from .utils import kmer_occurrences, score_seed_values

    rng = np.random.default_rng(SEED + 20)
    GEN = OVERLAP_GENOME
    genome = rand_seq(rng, GEN)
    n_reads = OVERLAP_READS
    lo, hi = OVERLAP_READ_LEN
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, GEN - 10_000))
        L = int(rng.integers(lo, hi))  # ONT-scale read lengths
        reads.append(Sequence.from_string(
            mutate(rng, genome[p : p + L], 0.05), id=i, name=f"ov{i}"))
    total_bases = sum(len(r) for r in reads)
    k = 10
    values = score_seed_values(kmer_occurrences(reads, k), k)

    shape_plan = {}

    def prep_round(first):
        """One round's host half (the CLI's prep_round)."""
        ov = Overlapper(SeedIndex(k), 10000, 1000, 15, 0.25,
                        shape_plan=shape_plan)
        queries = ov.prepare_round(15, 100000, values,
                                   iter(reads[first:]), QUERY_EDGES,
                                   iter(reads))
        if not queries:
            return None
        nxt = max(q.sequence_id for q in queries) + 1  # read ids = index
        return ov, queries, nxt

    def run_job():
        """The full all-vs-all job: seed-budgeted rounds until every read
        has been queried (the reference's round loop,
        commands/overlap.go:115), with the CLI's two-deep pipelined loop: the
        next round's host prep runs on a worker thread under the current
        round's find and collect."""
        matches = 0
        rounds = 0
        with ThreadPoolExecutor(max_workers=1) as ex:
            prepped = prep_round(0)
            futs = prepped[0].dispatch_find(prepped[1]) if prepped else None
            prep_fut = (ex.submit(prep_round, prepped[2])
                        if prepped and prepped[2] < n_reads else None)
            while prepped is not None:
                ov, queries, nxt = prepped
                prepped_next = prep_fut.result() if prep_fut else None
                futs_next = (prepped_next[0].dispatch_find(prepped_next[1])
                             if prepped_next else None)
                prep_fut = (ex.submit(prep_round, prepped_next[2])
                            if prepped_next and prepped_next[2] < n_reads
                            else None)
                arrs = ov.collect_find_arrays(queries, futs)
                matches += len(arrs[0]) if arrs is not None else 0
                rounds += 1
                prepped, futs = prepped_next, futs_next
        return matches, rounds

    run_job()                        # warm-up
    state = {}

    def one_run():
        state["m"], state["r"] = run_job()

    elapsed, spread = best_of(one_run, dev)
    n_matches, n_rounds = state["m"], state["r"]
    bases_s = total_bases / elapsed

    # one round's find alone: dispatch through the device's last kernel
    ov, queries, _ = prep_round(0)
    t1 = time.time()
    eng, subs = ov.dispatch_find(queries)
    sync(dev)
    t_dev = time.time() - t1
    ov.collect_find(queries, (eng, subs))
    note(f"overlap round kernel: dev+dispatch={t_dev:.2f}s "
         f"queries={len(queries)} batches={len(subs)} chunks={eng.C}")

    # conservative proxy anchor: the reference's 1 GB/min trim note (it
    # publishes no absolute all-vs-all time)
    ref_bases_s = 1e9 / 60.0
    note(f"overlap elapsed={elapsed:.1f}s reads={n_reads} "
         f"rounds={n_rounds} matches={n_matches}")
    emit("overlap_bases_per_s", bases_s, "bases/s", bases_s / ref_bases_s,
         spread=spread, device=label)


# ---------------------------------------------------------------------
def bench_consensus(dev, label):
    from . import native
    from .align import SimpleMeasure
    from .align.dtw import DTWAligner
    from .ops.dtw import consensus_kmers_bulk

    rng = np.random.default_rng(SEED + 30)
    k = 5
    # 1024 jobs ~ a GB-scale correct round's consensus load
    n_jobs, n_members = CONSENSUS_JOBS, CONSENSUS_MEMBERS
    core_len = CONSENSUS_CORE

    def job_kmers():
        core = BASES[rng.integers(0, 4, core_len + k - 1)]
        members = []
        for _ in range(n_members):
            arr = core.copy()
            m = rng.random(len(arr)) < 0.08
            arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            codes = np.frombuffer(arr.tobytes().translate(
                bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))), np.uint8)
            km = np.zeros(len(codes) - k + 1, np.int64)
            for j in range(k):
                km = (km << 2) | codes[j : j + len(km)]
            members.append(km.astype(np.int32))
        return members

    jobs = [job_kmers() for _ in range(n_jobs)]
    table = SimpleMeasure(k).pair_table()
    # simple_k engages the arithmetic distance (the production path for
    # the default SimpleMeasure); one ragged beam launch per call
    consensus_kmers_bulk(jobs, table, k, simple_k=k)     # warm-up
    outs = []

    def one_run():
        outs[:] = consensus_kmers_bulk(jobs, table, k, simple_k=k)

    elapsed, spread = best_of(one_run, dev)
    total_bases = sum(len(o) + k - 1 for o in outs if len(o))
    bases_s = total_bases / elapsed

    # Baseline derived from the reference's own hot loop (no published
    # consensus throughput exists):
    #   U  = band updates per consensus base, counted by running the
    #        host oracle on this job shape;
    #   M  = measured native C++ rate of the identical band update
    #        (single thread; the data flow of updateOffsetsAsm, ref
    #        sequence/alignment/asm_amd64.s:17-149);
    #   anchor = M x 2 (hand SIMD headroom) x 16 (the reference desktop's
    #            threads, assumed to scale perfectly) / U.
    t1 = time.time()
    n_upd = n_base = 0
    for job in jobs[:CONSENSUS_ORACLE_JOBS]:
        m = SimpleMeasure(k)
        m.set_sequences(job, [False] * len(job))
        al = DTWAligner(16, 5, m, False, 200, k)
        al.global_consensus()
        n_upd += al.n_band_updates
        n_base += core_len + k - 1
    host_dt = time.time() - t1
    host_bases_s = n_base / host_dt
    upd_per_base = n_upd / max(1, n_base)

    W = 32                              # the reference's band width
    nb = BAND_ROWS
    rng2 = np.random.default_rng(SEED + 31)
    ds = rng2.integers(0, 60, (nb, W)).astype(np.uint16)
    bands = rng2.integers(0, 500, (nb, W)).astype(np.uint16)
    if native.band_update_rounds(ds, bands, 200, 50) is None:     # warm
        raise RuntimeError("the consensus anchor needs the native host "
                           "library (native.band_update_rounds)")
    t1 = time.time()
    native.band_update_rounds(ds, bands, 200, BAND_REPS)
    upd_rate = nb * BAND_REPS / (time.time() - t1)
    baseline = upd_rate * 2 * 16 / upd_per_base
    note(f"consensus elapsed={elapsed:.2f}s jobs={n_jobs} "
         f"members={n_members} host_oracle={host_bases_s:.0f} bases/s; "
         f"anchor: {upd_rate / 1e6:.0f}M native band-updates/s x2 x16T "
         f"/ {upd_per_base:.0f} updates/base = {baseline / 1e6:.2f} "
         f"Mbases/s")
    emit("consensus_bases_per_s", bases_s, "bases/s", bases_s / baseline,
         spread=spread, device=label)


# ---------------------------------------------------------------------
def _make_reads_bulk(path, n_reads, read_len=3000):
    """Vectorized GB-scale synthetic fastq generator (adapter + core +
    adapter per read, 2% adapter noise).  Reuses an existing file of the
    right size so repeated bench runs skip the generation."""
    from .data import BACK_ADAPTERS, FRONT_ADAPTERS
    marker = path + ".meta"
    if os.path.exists(path) and os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == f"{n_reads}:{read_len}":
                return os.path.getsize(path)
    rng = np.random.default_rng(SEED + 77)
    f_ad = np.frombuffer(FRONT_ADAPTERS[0][1].encode(), np.uint8)
    b_ad = np.frombuffer(BACK_ADAPTERS[0][1].encode(), np.uint8)
    B = 4096
    with open(path, "w", buffering=1 << 22) as f:
        for lo in range(0, n_reads, B):
            n = min(B, n_reads - lo)
            cores = BASES[rng.integers(0, 4, (n, read_len))]
            fa = np.broadcast_to(f_ad, (n, len(f_ad))).copy()
            ba = np.broadcast_to(b_ad, (n, len(b_ad))).copy()
            for arr in (fa, ba):
                m = rng.random(arr.shape) < 0.02
                arr[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            qual = "I" * (read_len + len(f_ad) + len(b_ad))
            rows = np.concatenate([fa, cores, ba], axis=1)
            chunks = []
            for i in range(n):
                chunks.append(f"@gr{lo + i}\n")
                chunks.append(rows[i].tobytes().decode())
                chunks.append(f"\n+\n{qual}\n")
            f.write("".join(chunks))
    with open(marker, "w") as f:
        f.write(f"{n_reads}:{read_len}")
    return os.path.getsize(path)


def bench_trim_gb(dev, label):
    """GB-scale end-to-end trim: the full trim flow (streamed edge +
    middle passes, then re-read + re-emit of the trimmed fastq) over a
    ~1 GB on-disk file, I/O included: the reference's own methodology
    (ref README.md:126,135-142).  Reports MB/s of input fastq and peak
    RSS."""
    import resource

    from .io import SequenceSet
    from .trim import Trimmer

    path = tmp_path("bench_gb.fastq")
    n_reads = TRIM_GB_READS
    t0 = time.time()
    nbytes = _make_reads_bulk(path, n_reads)
    note(f"gb-scale fastq: {nbytes / 1e9:.2f} GB, {n_reads} reads "
         f"(gen/reuse {time.time() - t0:.0f}s)")
    fronts, backs = _adapters()
    # warm the batch shapes on a small slice first
    warm_path = tmp_path("bench_gb_warm.fastq")
    _make_reads_bulk(warm_path, TRIM_GB_WARM)
    wtr = Trimmer(fronts, backs, k=6, verbosity=0)
    wtr.set_trim_params(85, 5, 50, 1000, True, True, False)
    wtr.trim(SequenceSet(warm_path, min_length=50), batch_size=TRIM_GB_BATCH)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t1 = time.time()
    seq_set = SequenceSet(path, min_length=50)
    trimmer = Trimmer(fronts, backs, k=6, verbosity=0)
    trimmer.set_trim_params(85, 5, 50, 1000, True, True, False)
    trimmer.trim(seq_set, batch_size=TRIM_GB_BATCH)
    out_path = tmp_path("bench_gb_trimmed.fastq")
    with open(out_path, "w", buffering=1 << 22) as out:
        seq_set.write(out)
    sync(dev)
    dt = time.time() - t1
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    mb_s = nbytes / dt / 1e6
    note(f"gb-scale trim: {dt:.1f}s wall (trim+re-emit), peak_rss="
         f"{rss:.1f}GB (suite baseline {rss0 / 1e6:.1f}GB), "
         f"out={os.path.getsize(out_path) / 1e9:.2f}GB")
    os.remove(out_path)
    # anchor: the reference's worst-case 1 GB/min = 16.7 MB/s.
    # peak_rss_gb is the process high-water mark; rss_delta_gb is what
    # this section itself added
    emit("trim_gb_scale_mb_per_s", mb_s, "MB/s", mb_s / 16.7,
         peak_rss_gb=rss, rss_delta_gb=rss - rss0 / 1e6, device=label)


def _make_genome_reads(path, genome, n_reads, read_len, err, seed,
                       rc_half=True):
    """Vectorized on-disk fasta of reads sampled from `genome` (bytes
    array) with substitution noise; half reverse-complemented.  Reuses an
    existing file of the right shape."""
    marker = path + ".meta"
    key = f"{len(genome)}:{n_reads}:{read_len}:{err}:{seed}"
    if os.path.exists(path) and os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == key:
                return os.path.getsize(path)
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    B = 2048
    with open(path, "w", buffering=1 << 22) as f:
        for lo in range(0, n_reads, B):
            n = min(B, n_reads - lo)
            starts = rng.integers(0, len(genome) - read_len, n)
            rows = np.stack([genome[s:s + read_len] for s in starts])
            m = rng.random(rows.shape) < err
            rows[m] = BASES[rng.integers(0, 4, int(m.sum()))]
            chunks = []
            for i in range(n):
                s = rows[i].tobytes()
                if rc_half and (lo + i) % 2:
                    s = s.translate(comp)[::-1]
                chunks.append(f">gr{lo + i}\n")
                chunks.append(s.decode())
                chunks.append("\n")
            f.write("".join(chunks))
    with open(marker, "w") as f:
        f.write(key)
    return os.path.getsize(path)


def _run_command(cmd_cls, argv, out_path) -> str:
    """Drive a real CLI command with stdout redirected to a file (the
    disk-to-disk methodology of the reference's README numbers); returns
    its stderr, which is also echoed to this process's stderr."""
    from .cli.framework import parse_argv
    cmd = cmd_cls()
    args = parse_argv(cmd, argv)
    err = io.StringIO()
    try:
        with open(out_path, "w", buffering=1 << 22) as out, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            cmd.run(args)
    finally:
        sys.stderr.write(err.getvalue())
        sys.stderr.flush()
    return err.getvalue()


def bench_map_gb(dev, label):
    """Disk-to-disk map: a ~0.5 GB on-disk fasta of 8 kb reads streamed
    through the real map command (index build, PAF to a file, I/O
    included) against a 4.6 Mb genome: the reference's own methodology
    (1.5 GB E. coli fasta in 6.7 s end-to-end, ref README.md:240).  Every
    read must map uniquely (``MAP_GB_UNIQUE``), as in the JAX run."""
    import resource

    from .cli.map_command import MapCommand

    rng = np.random.default_rng(SEED + 40)
    genome = BASES[rng.integers(0, 4, MAP_GB_GENOME)]
    gpath = tmp_path("bench_map_gb_ref.fasta")
    with open(gpath, "w") as f:
        f.write(">ref\n" + genome.tobytes().decode() + "\n")
    n_reads = MAP_GB_READS
    rpath = tmp_path("bench_map_gb_reads.fasta")
    t0 = time.time()
    nbytes = _make_genome_reads(rpath, genome, n_reads, MAP_GB_READ_LEN,
                                0.08, SEED + 41)
    note(f"map_gb fasta: {nbytes / 1e9:.2f} GB, {n_reads} reads "
         f"(gen/reuse {time.time() - t0:.0f}s)")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out_path = tmp_path("bench_map_gb.paf")
    t1 = time.time()
    err = _run_command(MapCommand, ["-input", rpath, "-reference", gpath,
                                    "-circular", "false"], out_path)
    sync(dev)
    dt = time.time() - t1
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    with open(out_path) as f:
        n_out = sum(1 for _ in f)
    mb_s = nbytes / dt / 1e6
    note(f"map_gb: {dt:.1f}s wall (index+map+PAF), {n_out} PAF lines, "
         f"peak_rss={rss:.1f}GB (delta {rss - rss0 / 1e6:.2f}GB)")
    os.remove(out_path)
    want = f"Uniquely mapped: {MAP_GB_UNIQUE}"
    if want not in err.splitlines():
        raise RuntimeError(f"map_gb: stderr lacks {want!r}")
    # anchor: the reference's flagship 1.5 GB / 6.7 s = 224 MB/s
    emit("map_gb_mb_per_s", mb_s, "MB/s", mb_s / 224.0,
         peak_rss_gb=rss, rss_delta_gb=rss - rss0 / 1e6, device=label)


def bench_overlap_gb(dev, label):
    """Disk-to-disk all-vs-all overlap through the real overlap command
    (full seed-budgeted round loop, final checks, PAF to a file).  MB/s is
    whole-job wall over input bytes, against the same conservative
    1 GB/min proxy anchor as the in-memory metric.  The per-round stderr
    and the PAF line count must equal the JAX run's (``OV_GB_STDERR``,
    ``OV_GB_PAF_LINES``)."""
    import resource

    from .cli.overlap_command import OverlapCommand

    rng = np.random.default_rng(SEED + 50)
    genome = BASES[rng.integers(0, 4, OV_GB_GENOME)]
    n_reads = OV_GB_READS
    rpath = tmp_path("bench_ov_gb_reads.fasta")
    t0 = time.time()
    nbytes = _make_genome_reads(rpath, genome, n_reads, OV_GB_READ_LEN,
                                0.05, SEED + 51)
    note(f"overlap_gb fasta: {nbytes / 1e9:.2f} GB, {n_reads} reads "
         f"(gen/reuse {time.time() - t0:.0f}s)")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out_path = tmp_path("bench_ov_gb.paf")
    t1 = time.time()
    err = _run_command(OverlapCommand, ["-input", rpath], out_path)
    sync(dev)
    dt = time.time() - t1
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    with open(out_path) as f:
        n_out = sum(1 for _ in f)
    mb_s = nbytes / dt / 1e6
    note(f"overlap_gb: {dt:.1f}s wall (full job), {n_out} PAF lines, "
         f"peak_rss={rss:.1f}GB (delta {rss - rss0 / 1e6:.2f}GB)")
    os.remove(out_path)
    rounds = [ln for ln in err.splitlines()
              if ln.startswith(("Using query set", "Total "))]
    if rounds != OV_GB_STDERR:
        raise RuntimeError("overlap_gb: the per-round stderr differs from "
                           "the JAX package's recorded run")
    if n_out != OV_GB_PAF_LINES:
        raise RuntimeError(f"overlap_gb: {n_out} PAF lines, the JAX "
                           f"package's run {OV_GB_PAF_LINES}")
    emit("overlap_gb_mb_per_s", mb_s, "MB/s", mb_s / 16.7,
         peak_rss_gb=rss, rss_delta_gb=rss - rss0 / 1e6, device=label)


SECTIONS = [("trim", bench_trim), ("map", bench_map),
            ("overlap", bench_overlap), ("consensus", bench_consensus),
            ("trim_gb", bench_trim_gb), ("map_gb", bench_map_gb),
            ("overlap_gb", bench_overlap_gb)]


def main(argv=None) -> int:
    t_setup = time.time()
    dev = resolve_device()
    label = device_label(dev)
    note(f"device={label} torch={torch.__version__} "
         f"cuda={torch.version.cuda}")
    # headline metrics first, the GB-scale disk-to-disk tails last: a
    # time-out then loses a tail section, never the headline lines
    sections = SECTIONS
    only = set(sys.argv[1:] if argv is None else argv)
    if only:
        known = {n for n, _ in sections}
        unknown = only - known
        if unknown:  # a typo must not silently produce an empty run
            note(f"ERROR: unknown section(s) {sorted(unknown)}; "
                 f"known: {sorted(known)}")
            return 2
        sections = [(n, f) for n, f in sections if n in only]
    try:
        os.remove(RUNNING_JSON)
    except OSError:
        pass
    failed = []
    for name, fn in sections:
        t0 = time.time()
        try:
            fn(dev, label)
        except Exception as e:  # note it, run the rest, exit non-zero
            traceback.print_exc()
            note(f"{name} FAILED: {type(e).__name__}: {e}")
            failed.append(name)
        note(f"{name} section total {time.time() - t0:.1f}s")
    note(f"suite total {time.time() - t_setup:.1f}s")
    if failed:
        note(f"FAILED sections: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
