"""ctypes bindings for the native host kernels (native/seqscan.cpp).

Compiles the shared library on first use (g++ -O3) into the package's
``_build/`` directory (git-ignored), keyed by a hash of the source; if no
toolchain is available every entry point falls back to the numpy
implementations in ``downpore_tpu_torch.core``, which give the same bytes.
``chip_smoke.py`` requires the library, so no host time on the card is
the numpy route's.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")


def _source_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "seqscan.cpp")


def _cpu_identity() -> bytes:
    """The host's machine type and CPU feature flags: the library is built
    with ``-march=native``, so a build is only valid on a like CPU."""
    import platform
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine().encode() + b"\0" + flags


def _lib_path() -> str:
    """Library path in the package's ``_build/`` directory, keyed by a
    hash of the source and of the host's CPU, so neither an edited source
    nor a tree copied with its ``_build/`` to another machine is served a
    stale or foreign binary."""
    import hashlib
    with open(_source_path(), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(_cpu_identity())
    return os.path.join(BUILD_DIR, f"seqscan_{h.hexdigest()[:16]}.so")


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None when
    unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = _source_path()
    lib = _lib_path()
    try:
        if not os.path.exists(lib):
            # build under a private name, then rename: concurrent
            # processes never load a half-written library
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-pthread", src, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
        L = ctypes.CDLL(lib)
        # all pointer args are c_void_p and call sites pass the raw
        # ``arr.ctypes.data`` integer: data_as(POINTER(...)) casts cost
        # ~10 us each and dominated per-sequence native calls (overlap
        # query prep made ~45k of them per round)
        u8p = ctypes.c_void_p
        i32p = ctypes.c_void_p
        i64p = ctypes.c_void_p
        f64p = ctypes.c_void_p
        L.encode_bases.argtypes = [u8p, ctypes.c_int64, u8p]
        L.rolling_kmers.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, i32p]
        L.count_seed_kmers.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                       u8p, ctypes.c_int64]
        L.count_seed_kmers.restype = ctypes.c_int64
        L.write_segments.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                     u8p, i32p, i32p]
        L.write_segments.restype = ctypes.c_int64
        L.index_fastq.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                  i64p, i64p, i64p, i64p, i64p]
        L.index_fastq.restype = ctypes.c_int64
        L.write_segments_batch.argtypes = [u8p, i64p, i64p,
                                           ctypes.c_int64, ctypes.c_int32,
                                           u8p, i32p, i32p, i64p, i64p,
                                           ctypes.c_int32]
        L.write_segments_batch.restype = ctypes.c_int64
        L.pack_windows.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, u8p, i32p, u8p,
            ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p, i32p,
            i32p, i64p, ctypes.c_int32]
        L.add_seeds_walk.argtypes = [i32p, f64p, u8p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int64, i32p]
        L.add_seeds_walk.restype = ctypes.c_int64
        L.add_single_seeds_walk.argtypes = [i32p, f64p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int32,
                                            ctypes.c_int64, u8p, i32p]
        L.add_single_seeds_walk.restype = ctypes.c_int64
        L.walk_candidates.argtypes = [i64p, i64p, ctypes.c_int64,
                                      i32p, i32p, ctypes.c_int64, i32p,
                                      i64p, ctypes.c_int32, ctypes.c_int32,
                                      i32p, i32p, i32p, u8p,
                                      ctypes.c_int64]
        L.walk_candidates.restype = ctypes.c_int64
        L.pair_ends.argtypes = [
            ctypes.c_int64, i64p, ctypes.c_int64, i64p, i64p, i64p, i64p,
            i64p, u8p, i64p, ctypes.c_int32, ctypes.c_int64, u8p, i64p,
            i64p, i64p, i64p, i64p, i64p, u8p, i64p]
        L.pair_ends.restype = ctypes.c_int64
        L.band_update_rounds.argtypes = [u8p, u8p, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32]
        L.band_update_rounds.restype = ctypes.c_int64
        L.msa_consensus.argtypes = [i32p, i64p, ctypes.c_int64,
                                    ctypes.c_int32, i32p, i32p, i32p,
                                    i64p, i64p]
        L.msa_consensus.restype = ctypes.c_int64
        L.final_check_round.argtypes = [
            i32p, i64p, i64p, i64p, i32p, i32p, u8p, i32p, i32p, i64p,
            i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p,
            ctypes.c_int64]
        L.final_check_round.restype = ctypes.c_int64
        _LIB = L
    except Exception as e:  # no toolchain / build failure -> numpy fallback
        print(f"downpore_tpu_torch.native: falling back to numpy ({e})",
              file=sys.stderr)
        _LIB = None
    return _LIB


def _ptr(a: np.ndarray, typ=None):
    """Raw data pointer as int (argtypes are c_void_p; the caller keeps
    the array referenced for the duration of the call)."""
    return a.ctypes.data


def encode_bases(raw: bytes) -> Optional[np.ndarray]:
    L = load()
    if L is None:
        return None
    n = len(raw)
    inp = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    L.encode_bases(_ptr(inp, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8))
    return out


def count_seed_kmers(codes: np.ndarray, k: int, table: np.ndarray,
                     up_to: Optional[int] = None) -> Optional[int]:
    L = load()
    if L is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    tbl = np.ascontiguousarray(table, dtype=np.uint8)
    cap = (1 << 62) if up_to is None else up_to
    return int(L.count_seed_kmers(_ptr(codes, ctypes.c_uint8), len(codes),
                                  k, _ptr(tbl, ctypes.c_uint8), cap))


import threading

_ws_tls = threading.local()


def write_segments(codes: np.ndarray, k: int, table: np.ndarray):
    L = load()
    if L is None:
        return None
    n = len(codes)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    tbl = np.ascontiguousarray(table, dtype=np.uint8)
    # reused scratch: two fresh ~read-size allocations per call showed up
    # in overlap query-prep profiles (page-fault pathology).  Thread-local
    # so concurrent prep threads (query re-extract || chunk indexing)
    # cannot race on the buffers.
    scr = getattr(_ws_tls, "scratch", None)
    if scr is None or scr[0].shape[0] < n + 1:
        scr = _ws_tls.scratch = [np.empty(max(n + 1, 65536), np.int32),
                                 np.empty(max(n + 1, 65536), np.int32)]
    gaps, kmers = scr
    cnt = L.write_segments(_ptr(codes, ctypes.c_uint8), n, k,
                           _ptr(tbl, ctypes.c_uint8),
                           _ptr(gaps, ctypes.c_int32),
                           _ptr(kmers, ctypes.c_int32))
    g = np.empty(cnt + 1, dtype=np.int32)
    g[:cnt] = gaps[:cnt]
    g[cnt] = gaps[cnt]
    return g, kmers[:cnt].copy()


def write_segments_batch(codes: np.ndarray, off: np.ndarray,
                         lens: np.ndarray, k: int, table: np.ndarray):
    """Batched ``write_segments`` over B sequences packed back-to-back in
    ``codes`` (sequence i at ``off[i]``, ``lens[i]`` bases); one native
    call + thread fan-out instead of a Python/ctypes round trip per read.
    Returns ``(gaps_flat, kmers_flat, gout_off, counts)`` where sequence
    i's gaps are ``gaps_flat[gout_off[i] : gout_off[i] + counts[i] + 1]``
    and its seed k-mers ``kmers_flat[gout_off[i] : gout_off[i] +
    counts[i]]``, or None without the toolchain."""
    L = load()
    if L is None or not hasattr(L, "write_segments_batch"):
        return None
    B = len(lens)
    if B == 0:
        z32, z64 = np.empty(0, np.int32), np.empty(0, np.int64)
        return z32, z32, z64, z64
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    off = np.ascontiguousarray(off, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    tbl = np.ascontiguousarray(table, dtype=np.uint8)
    # per-row output region: lens[i] + 1 entries (gaps hold count+1)
    gout_off = np.empty(B, np.int64)
    np.cumsum(lens[:-1] + 1, out=gout_off[1:])
    gout_off[0] = 0
    total = int(gout_off[-1] + lens[-1] + 1) if B else 0
    gaps = np.empty(max(1, total), np.int32)
    kmers = np.empty(max(1, total), np.int32)
    counts = np.empty(max(1, B), np.int64)
    nt = min(os.cpu_count() or 1, 16)
    L.write_segments_batch(_ptr(codes), _ptr(off), _ptr(lens), B, k,
                           _ptr(tbl), _ptr(gaps), _ptr(kmers),
                           _ptr(gout_off), _ptr(counts), nt)
    return gaps, kmers, gout_off, counts


def pack_windows(codes: np.ndarray, off: np.ndarray, lens: np.ndarray,
                 k: int, nq: int, nqs: int, kmer_table: np.ndarray,
                 kmer_map: np.ndarray, usable: np.ndarray,
                 num_seed_ids: int, H: int):
    """Batched window packing (fw+rc rows) in one native pass; returns
    (q_seeds, q_pos, q_rb, q_db, num_sets, num_seeds) or None.  Outputs
    are freshly allocated (the package-level mallopt tuning makes these
    heap-arena reuses, not mmap faults) since callers hold them across
    dispatch-ahead windows."""
    L = load()
    if L is None or not hasattr(L, "pack_windows"):
        return None
    m = len(lens)
    rows = 2 * m
    q_seeds = np.empty((rows, nq), np.int32)
    q_pos = np.empty((rows, nq), np.int32)
    q_rb = np.empty((rows, nq), np.int32)
    q_db = np.empty((rows, nq), np.int32)
    num_sets = np.empty(rows, np.int32)
    num_seeds = np.empty(rows, np.int64)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    off = np.ascontiguousarray(off, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    kmer_table = np.ascontiguousarray(kmer_table, dtype=np.uint8)
    kmer_map = np.ascontiguousarray(kmer_map, dtype=np.int32)
    usable = np.ascontiguousarray(usable, dtype=np.uint8)
    nt = min(os.cpu_count() or 1, 16)
    L.pack_windows(
        _ptr(codes, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), m, k, nq, nqs,
        _ptr(kmer_table, ctypes.c_uint8), _ptr(kmer_map, ctypes.c_int32),
        _ptr(usable, ctypes.c_uint8), num_seed_ids, H,
        _ptr(q_seeds, ctypes.c_int32), _ptr(q_pos, ctypes.c_int32),
        _ptr(q_rb, ctypes.c_int32), _ptr(q_db, ctypes.c_int32),
        _ptr(num_sets, ctypes.c_int32), _ptr(num_seeds, ctypes.c_int64), nt)
    return q_seeds, q_pos, q_rb, q_db, num_sets, num_seeds


def add_seeds_walk(kmers: np.ndarray, values: np.ndarray,
                   in_index: np.ndarray, n: int, k: int, cap: int):
    """Windowed top-N seed-selection walk (exact twin of the Python loop
    in ``SeedIndex.add_seeds``); returns selected k-mers in add order, or
    None without the toolchain."""
    L = load()
    if L is None or not hasattr(L, "add_seeds_walk"):
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    in_index = np.ascontiguousarray(in_index, dtype=np.uint8)
    out = np.empty(max(1, cap), np.int32)
    cnt = L.add_seeds_walk(_ptr(kmers, ctypes.c_int32),
                           _ptr(values, ctypes.c_double),
                           _ptr(in_index, ctypes.c_uint8),
                           len(kmers), n, k, cap,
                           _ptr(out, ctypes.c_int32))
    return out[:cnt]


def add_single_seeds_walk(kmers: np.ndarray, vals: np.ndarray, n: int,
                          k: int, seed_rate: int, table: np.ndarray):
    """Live-table windowed single-seed selection (exact twin of the
    Python loop in ``SeedIndex.add_single_seeds``).  ``table`` (bool,
    4^k) is updated IN PLACE; returns selected k-mers in order, or None
    without the toolchain."""
    L = load()
    if L is None or not hasattr(L, "add_single_seeds_walk"):
        return None
    assert table.dtype == np.bool_ and table.flags.c_contiguous
    kmers = np.ascontiguousarray(kmers, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    out = np.empty(max(1, n // max(1, seed_rate) + 1), np.int32)
    cnt = L.add_single_seeds_walk(
        _ptr(kmers, ctypes.c_int32), _ptr(vals, ctypes.c_double),
        len(kmers), n, k, seed_rate,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _ptr(out, ctypes.c_int32))
    return out[:cnt]


# the summary fields the walk reads, in the order of its column offsets
WALK_FIELDS = ("best", "top_valid", "top_sqp", "top_stp", "top_eqp",
               "top_etp", "top_cov_t", "top_len")


def walk_candidates(bounds: np.ndarray, num_seeds: np.ndarray, nq: int,
                    head: np.ndarray, packed: np.ndarray, cols: dict,
                    qlen: np.ndarray, k: int, K: int):
    """Sequential adaptive-threshold mapper candidate walk (exact twin of
    the Python loop in ``mapping.mapper._walk_candidates_py``; ref
    mapping/mapping.go:494-589), read in place from the collected rows:
    ``head`` [N, 3] (query row, chunk, distinct count) and the packed
    summaries ``packed`` [N, W], whose fields start at the columns
    ``cols`` names (``ops.chain.summary_columns``); ``qlen`` holds the
    windows' lengths, for the 2/3-coverage rule.  One pass in row order;
    neither matrix is copied when it arrives C-contiguous int32, as the
    collect hands it.  Returns accepted ``(qi, b, j, rc)`` arrays in walk
    order, or None without the toolchain."""
    L = load()
    if L is None or not hasattr(L, "walk_candidates"):
        return None
    head = np.ascontiguousarray(head, np.int32)
    packed = np.ascontiguousarray(packed, np.int32)
    N, W = packed.shape
    offs = np.array([cols[f] for f in WALK_FIELDS], np.int32)
    bounds = np.ascontiguousarray(bounds, np.int64)
    num_seeds = np.ascontiguousarray(num_seeds, np.int64)
    qlen = np.ascontiguousarray(qlen, np.int64)
    if (head.shape != (N, 3) or offs.min() < 0 or offs[0] >= W
            or offs[1:].max() + K > W or len(bounds) != 2 * nq + 1
            or len(num_seeds) < 2 * nq or len(qlen) < nq
            or bounds.min() < 0 or bounds.max() > N
            or (np.diff(bounds) < 0).any()):
        raise ValueError("walk_candidates: rows, columns and bounds "
                         "disagree")
    cap = max(1, N * K)
    out_qi = np.empty(cap, np.int32)
    out_b = np.empty(cap, np.int32)
    out_j = np.empty(cap, np.int32)
    out_rc = np.empty(cap, np.uint8)
    cnt = L.walk_candidates(
        _ptr(bounds), _ptr(num_seeds), nq, _ptr(head), _ptr(packed), W,
        _ptr(offs), _ptr(qlen), k, K, _ptr(out_qi), _ptr(out_b),
        _ptr(out_j), _ptr(out_rc), cap)
    if cnt < 0:
        return None
    cnt = min(int(cnt), cap)  # cap = N*K is the true worst case
    return (out_qi[:cnt], out_b[:cnt], out_j[:cnt],
            out_rc[:cnt].astype(bool))


def pair_ends(win_bounds: np.ndarray, read_len: np.ndarray, es: int,
              start: np.ndarray, end: np.ndarray, q_offset: np.ndarray,
              q_inset: np.ndarray, rc: np.ndarray, ids: np.ndarray,
              circular: bool, ref_len: int):
    """The mapper's ends phase after the walk, every long read in one call
    (exact twin of ``mapping.mapper.Mapper._pair_ends_py``): read t's end
    windows are 2t and 2t+1, window w's accepted rows in walk order at
    ``[win_bounds[w], win_bounds[w+1])``.  Returns ``(status, n_a, n_b,
    start, end, q_offset, q_inset, rc, ids)``: per read 0 matched, 1
    closed (under 3 * ``es``: its open ends are the result), 2 still open;
    its rows read-major, ``n_a`` then ``n_b`` of them (a matched read's
    pairs in ``n_a``).  None without the toolchain."""
    L = load()
    if L is None or not hasattr(L, "pair_ends"):
        return None
    n = len(read_len)
    win_bounds = np.ascontiguousarray(win_bounds, np.int64)
    read_len = np.ascontiguousarray(read_len, np.int64)
    ins = [np.ascontiguousarray(a, np.int64)
           for a in (start, end, q_offset, q_inset)]
    rc = np.ascontiguousarray(rc, np.uint8)
    ids = np.ascontiguousarray(ids, np.int64)
    rows = int(win_bounds[-1]) if len(win_bounds) else -1
    if len(win_bounds) != 2 * n + 1 or \
            any(len(a) != rows for a in (*ins, rc, ids)):
        raise ValueError("pair_ends: 2 * reads + 1 window bounds, and one "
                         "value a row in every column")
    cap = max(1, rows)
    status = np.empty(n, np.uint8)
    n_a = np.empty(n, np.int64)
    n_b = np.empty(n, np.int64)
    outs = [np.empty(cap, np.int64) for _ in range(4)]
    o_rc = np.empty(cap, np.uint8)
    o_ids = np.empty(cap, np.int64)
    cnt = L.pair_ends(
        n, _ptr(read_len), es, _ptr(win_bounds), *[_ptr(a) for a in ins],
        _ptr(rc), _ptr(ids), int(bool(circular)), ref_len, _ptr(status),
        _ptr(n_a), _ptr(n_b), *[_ptr(a) for a in outs], _ptr(o_rc),
        _ptr(o_ids))
    return (status, n_a, n_b, *[a[:cnt] for a in outs],
            o_rc[:cnt].astype(bool), o_ids[:cnt])


def index_fastq(buf: bytes):
    """Record table for a single-line fastq buffer, or None."""
    L = load()
    if L is None:
        return None
    n = len(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    max_rec = max(16, n // 8)
    cols = [np.empty(max_rec, dtype=np.int64) for _ in range(5)]
    cnt = L.index_fastq(_ptr(arr, ctypes.c_uint8), n, max_rec,
                        *[_ptr(c, ctypes.c_int64) for c in cols])
    if cnt < 0:
        return None
    return tuple(c[:cnt].copy() for c in cols)


def band_update_rounds(ds: np.ndarray, bands: np.ndarray, threshold: int,
                       reps: int):
    """Run `reps` feedback passes of the reference DTW band update over
    ``bands`` (modified in place).  Returns the checksum (sum of band
    minima) or None when the native library is unavailable.  Used by the
    bench suite to derive the consensus baseline anchor from a measured
    host speed-of-light of the reference's hottest loop."""
    L = load()
    if L is None:
        return None
    assert ds.dtype == np.uint16 and bands.dtype == np.uint16
    assert ds.shape == bands.shape and bands.flags.c_contiguous
    n_bands, W = bands.shape
    return int(L.band_update_rounds(_ptr(ds), _ptr(bands), n_bands, W,
                                    threshold, reps))


def msa_consensus(segments, k: int):
    """Native seed-space MSA sweep (seqscan.cpp msa_consensus; the
    reference multiAligner.Consensus, seeds/alignment.go:9-268).

    ``segments``: per member, the REDUCED interleaved (gap, seed)
    int32 segment array, or None for members the reduction dropped.
    Returns ``(cons_segments, per_member_match_a, per_member_match_b)``
    with match_b in REDUCED indices (the caller maps through its
    seed_map), or None when the native library is unavailable.
    Bit-identical to the Python sweep in seeds/msa.py by parity test."""
    L = load()
    if L is None:
        return None
    n = len(segments)
    lens = np.fromiter(((len(s) if s is not None else 0)
                        for s in segments), np.int64, n)
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=seg_off[1:])
    seg = np.empty(int(seg_off[-1]), np.int32)
    for i, s in enumerate(segments):
        if s is not None:
            seg[seg_off[i] : seg_off[i + 1]] = s
    # caps: the consensus emits at most one (gap, seed) pair per total
    # input seed; each member matches at most once per own seed
    total_seeds = int(sum(ln // 2 for ln in lens))
    cons = np.empty(2 * total_seeds + 2, np.int32)
    mcap = lens // 2
    match_off = np.zeros(n + 1, np.int64)
    np.cumsum(mcap, out=match_off[1:])
    match_a = np.empty(int(match_off[-1]), np.int32)
    match_b = np.empty(int(match_off[-1]), np.int32)
    match_cnt = np.zeros(n, np.int64)
    cons_len = int(L.msa_consensus(_ptr(seg), _ptr(seg_off), n, k,
                                   _ptr(cons), _ptr(match_a),
                                   _ptr(match_b), _ptr(match_off),
                                   _ptr(match_cnt)))
    out_a = [match_a[match_off[i] : match_off[i] + match_cnt[i]].copy()
             for i in range(n)]
    out_b = [match_b[match_off[i] : match_off[i] + match_cnt[i]].copy()
             for i in range(n)]
    return cons[:cons_len].copy(), out_a, out_b


def final_check_round(checks, seq_table, seq_ids, rc_lut, k: int):
    """Native round-level overlap final check (seqscan.cpp
    final_check_round): ``checks`` is a list of match-lists (each a
    query's SeedMatch hits), ``seq_table`` the marshaled unique
    sequences as (segments int32, meta int64[6]) pairs, ``seq_ids`` a
    dict id(obj) -> table index, ``rc_lut`` seed -> RC-seed.  Returns
    per check a list of (id, rc, offset, length, seq_len, ident)
    records (empty = no contig), or None when native is unavailable.
    Bit-identical to the Python build_consensus path by parity test."""
    if load() is None:
        return None
    n_checks = len(checks)
    n_matches = sum(len(c) for c in checks)
    chk_off = np.zeros(n_checks + 1, np.int64)
    m_ia = np.empty(n_matches, np.int32)
    m_ib = np.empty(n_matches, np.int32)
    m_rcq = np.empty(n_matches, np.uint8)
    pair_cnt = np.empty(n_matches, np.int64)
    mi = 0
    for c, ms in enumerate(checks):
        for m in ms:
            m_ia[mi] = seq_ids[id(m.seq_a)]
            m_ib[mi] = seq_ids[id(m.seq_b)]
            m_rcq[mi] = 1 if m.rc_query else 0
            pair_cnt[mi] = len(m.match_a)
            mi += 1
        chk_off[c + 1] = mi
    m_off = np.zeros(n_matches + 1, np.int64)
    np.cumsum(pair_cnt, out=m_off[1:])
    ma_flat = np.empty(int(m_off[-1]), np.int32)
    mb_flat = np.empty(int(m_off[-1]), np.int32)
    mi = 0
    for ms in checks:
        for m in ms:
            ma_flat[m_off[mi] : m_off[mi + 1]] = m.match_a
            mb_flat[m_off[mi] : m_off[mi + 1]] = m.match_b
            mi += 1
    return final_check_round_arrays(seq_table, chk_off, m_ia, m_ib,
                                    m_rcq, ma_flat, mb_flat, m_off,
                                    rc_lut, k)


def final_check_round_arrays(seq_table, chk_off, m_ia, m_ib, m_rcq,
                             ma_flat, mb_flat, m_off, rc_lut, k: int):
    """Array-direct entry to the native final check: callers that hold
    the round's matches as flat arrays (the overlap CLI's fetch-to-
    check fast path) skip the per-object marshaling entirely."""
    L = load()
    if L is None:
        return None
    segs, metas = seq_table
    ns = len(segs)
    n_checks = len(chk_off) - 1
    n_matches = len(m_ia)
    lens = np.fromiter((s.shape[0] for s in segs), np.int64, ns)
    sseg_off = np.zeros(ns + 1, np.int64)
    np.cumsum(lens, out=sseg_off[1:])
    sseg = np.empty(int(sseg_off[-1]), np.int32)
    for i, s in enumerate(segs):
        sseg[sseg_off[i] : sseg_off[i + 1]] = s
    smeta = np.ascontiguousarray(metas, np.int64)
    chk_off = np.ascontiguousarray(chk_off, np.int64)
    m_ia = np.ascontiguousarray(m_ia, np.int32)
    m_ib = np.ascontiguousarray(m_ib, np.int32)
    m_rcq = np.ascontiguousarray(m_rcq, np.uint8)
    ma_flat = np.ascontiguousarray(ma_flat, np.int32)
    mb_flat = np.ascontiguousarray(mb_flat, np.int32)
    m_off = np.ascontiguousarray(m_off, np.int64)
    rc_lut = np.ascontiguousarray(rc_lut, np.int32)
    out_cnt = np.zeros(n_checks, np.int64)
    # fixed per-check slots at chk_off[c] (parts <= match count) so the
    # C++ thread pool writes without coordination
    cap = max(1, n_matches)
    out_rec = np.empty((cap, 6), np.int64)
    total = int(L.final_check_round(
        _ptr(sseg), _ptr(sseg_off), _ptr(smeta), _ptr(chk_off),
        _ptr(m_ia), _ptr(m_ib), _ptr(m_rcq), _ptr(ma_flat),
        _ptr(mb_flat), _ptr(m_off), _ptr(rc_lut), n_checks, k,
        _ptr(out_cnt), _ptr(out_rec), cap))
    if total < 0:
        return None
    out = []
    for c in range(n_checks):
        cnt = int(out_cnt[c])
        base = int(chk_off[c])
        out.append(out_rec[base : base + cnt].tolist())
    return out


def marshal_seq_table(seqs):
    """Flatten unique SeedSequence objects for final_check_round:
    returns ((segments list, meta array), id(obj) -> index dict)."""
    segs = []
    metas = np.empty((len(seqs), 6), np.int64)
    ids = {}
    for i, s in enumerate(seqs):
        ids[id(s)] = i
        segs.append(s.segments())
        root = s
        while root.parent is not None:
            root = root.parent
        metas[i, 0] = s.id
        metas[i, 1] = s.offset
        metas[i, 2] = s.inset
        metas[i, 3] = s.length
        metas[i, 4] = 1 if s.rc else 0
        metas[i, 5] = root.length
    return (segs, metas), ids
