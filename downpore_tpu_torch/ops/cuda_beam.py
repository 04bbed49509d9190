"""Fixed-beam DTW consensus scan: the hand-written Hopper kernel and its
plain torch version.

Counterpart of ``downpore_tpu/ops/pallas_beam.py`` (``_kernel`` /
``pallas_consensus_records``, ``_records_to_chains``, ``pallas_consensus``)
and so of the XLA engine ``downpore_tpu/ops/dtw.py:device_consensus``
vmapped over jobs, which both compute step for step.

``beam_consensus(seqs, lens, firsts, table, k, beam, t_max, threshold,
gap_cost, simple_k)`` takes ``seqs [J, N, L]`` int32 member k-mers (-1
fill), ``lens [J, N]`` and ``firsts [J]`` int32, and ``table`` (the
``[4^k, 4^k]`` uint16 distance table as int16 bits) or None when
``simple_k`` names the arithmetic measure.  It returns ``(chains [J, t_max]
int32, -1 padded, n_valid [J] int32)``; with ``return_records`` it runs all
``t_max`` steps and returns the ``[J, t_max, 4, B]`` records (k-mer,
parent, finished, cost per step and beam state) instead.

``beam_consensus_ragged(seqs, lens, firsts, shapes, ...)`` takes jobs of
differing shapes, one ``(N, L, T)`` each, as flat k-mers and lengths, and
runs them all in one launch; ``beam_consensus`` is its uniform case.

A tensor on the CPU goes to ``beam_consensus_plain``, the XLA engine's
step written once over the batch ``[J, B, 4, N, W]`` (the ragged form
groups its jobs by shape first).  A CUDA tensor launches the kernel in
``csrc/beam_consensus.cu`` or raises; there is no fallback and no switch.
``beam_warps`` picks the kernel's warps per job from the launch's size.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .dtw import (BIG, FULL, INIT, REG_SLACK, W, _SIMPLE_WEIGHTS,
                  _argmin_last, _band_update, _barrel_shift,
                  _simple_distance, _win_base, _win_params)

CENTRE = W // 2
PAD = W
MAX_BEAM = 8  # 4 * beam candidates fit one warp in the kernel's selection

_count_lock = threading.Lock()


def _distances(nextk, km_c, table, k: int, simple_k: int):
    """``[J, B, 4, 1, 1]`` next k-mers against ``[J, B, 1, N, W]`` member
    k-mers: the simple-k measure or a table lookup, int32."""
    if simple_k:
        return _simple_distance(nextk, km_c, simple_k)
    idx = nextk.long() * (1 << (2 * k)) + km_c.long()
    flat = table.reshape(-1)
    return flat[idx].to(torch.int32) & 0xFFFF


def beam_consensus_plain(seqs, lens, firsts, table, k: int, beam: int,
                         t_max: int, threshold: int, gap_cost: int,
                         simple_k: int, return_records: bool = False):
    """Plain torch beam scan, batched over jobs; see the module docstring.

    Without ``return_records`` the scan stops once every job has had a
    finished beam state: the traceback reads nothing past a job's first
    finishing step, so the chains equal those of the full scan."""
    J, N, L = seqs.shape
    dev = seqs.device
    i32 = torch.int32
    B = beam
    mask = (1 << (2 * k)) - 1
    lane = torch.arange(W, dtype=i32, device=dev)
    branch = torch.arange(4, dtype=i32, device=dev)
    sw, _ = _win_params(L)
    f95 = torch.tensor(0.95, dtype=torch.float32, device=dev)
    seqs_flat = seqs.reshape(J, N * L)
    nbase = (torch.arange(N, device=dev) * L).view(1, 1, N, 1)
    live_m = lens > 0                                         # [J, N]
    jr = torch.arange(J, device=dev)[:, None]

    # initial state: all beams identical, one live
    off0 = torch.full((J, N, W), gap_cost, dtype=i32, device=dev)
    off0[:, :, :INIT] = FULL
    match0 = seqs[:, :, 0] == firsts[:, None]
    off0[:, :, INIT] = torch.where(match0, 0, gap_cost).to(i32)
    kmer = firsts[:, None].expand(J, B).to(i32).clone()
    off = off0[:, None].expand(J, B, N, W).clone()
    pos = torch.full((J, B, N), INIT, dtype=i32, device=dev)
    cost = torch.full((J, B), BIG, dtype=i32, device=dev)
    cost[:, 0] = 0
    quality = torch.ones((J, B, N), dtype=torch.float32, device=dev)
    fin = torch.zeros((J, B), dtype=torch.bool, device=dev)

    ci = torch.arange(4 * B, device=dev)
    not_parent = (ci[:, None] // 4) != torch.arange(B, device=dev)[None, :]
    earlier = ci[None, :] < ci[:, None]                       # cj < ci
    recs = []
    done = torch.zeros(J, dtype=torch.bool, device=dev)
    for t in range(t_max):
        shifted = (kmer << 2) & mask
        nextk = shifted[..., None] | branch                   # [J, B, 4]
        pos2 = pos + 1                                        # [J, B, N]
        o = pos2 - CENTRE + PAD
        wb = _win_base(t, L)
        ov = (o >= 0) & (o < L + PAD) & (o - wb >= 0) & (o - wb <= sw - W)
        idx = (pos2 - CENTRE)[..., None] + lane               # [J, B, N, W]
        inr = ov[..., None] & (idx >= 0) & (idx < L)
        flat = (nbase + idx.clamp(0, L - 1)).reshape(J, -1)
        km = torch.gather(seqs_flat, 1, flat).view(J, B, N, W)
        km = torch.where(inr, km, -1)
        km_bad = km < 0
        km_c = km.clamp(min=0)
        ds = _distances(nextk[..., None, None], km_c[:, :, None], table, k,
                        simple_k)                             # [J,B,4,N,W]
        extra = (torch.abs(idx - (INIT + 1 + t)) - REG_SLACK).clamp(min=0)
        ds = ds + extra[:, :, None]
        ds = torch.where(km_bad[:, :, None], FULL, ds).to(i32)
        out, m = _band_update(off[:, :, None], ds, threshold)
        seq_cost = torch.where(live_m[:, None, None], m, 0).sum(
            dim=-1, dtype=i32)                                # [J, B, 4]
        bl = _argmin_last(off)                                # [J, B, N]
        ahead = lane >= bl[..., None]
        exact = ((ds == 0) & (out < FULL) & ahead[:, :, None]).any(dim=-1)
        vote_w = torch.floor(8.0 * quality + 0.5)             # [J, B, N]
        vote_sum = torch.where(exact, vote_w[:, :, None], 0.0).sum(dim=-1)
        cc = cost[..., None] + seq_cost
        cc = torch.where(vote_sum > 0, cc, BIG)
        cc = torch.where(fin[..., None],
                         torch.where(branch == 0, cost[..., None], BIG), cc)
        # duplicate-state suppression (downpore_tpu/ops/dtw.py:294-322)
        eff_k = torch.where(fin[..., None], kmer[..., None], nextk)
        cand_k = eff_k.reshape(J, 4 * B)
        cand_c = cc.reshape(J, 4 * B).to(i32)
        p_fin = fin.repeat_interleave(4, dim=1)
        dup_beam = ((cand_k[:, :, None] == kmer[:, None, :])
                    & (cost[:, None, :] <= cand_c[:, :, None])
                    & ~fin[:, None, :] & not_parent).any(dim=2) & ~p_fin
        better = (cand_c[:, None, :] < cand_c[:, :, None]) | (
            (cand_c[:, None, :] == cand_c[:, :, None]) & earlier)
        dup_cand = ((cand_k[:, :, None] == cand_k[:, None, :]) & better
                    & ~p_fin[:, None, :]).any(dim=2) & ~p_fin
        flat_cost = torch.where(dup_beam | dup_cand, BIG, cand_c).to(i32)
        # beam select: the B cheapest, lower index first on ties
        top = torch.sort(flat_cost, dim=1, stable=True).indices[:, :B]
        parent = top // 4
        pick = lambda a: a[jr, parent]
        fin_p = pick(fin)                                     # [J, B]
        new_kmer = torch.where(fin_p, pick(kmer),
                               nextk.reshape(J, 4 * B)[jr, top])
        new_off = torch.where(fin_p[..., None, None], pick(off),
                              out.reshape(J, 4 * B, N, W)[jr, top])
        new_pos = torch.where(fin_p[..., None], pick(pos), pick(pos2))
        q_p = pick(quality)
        ex_sel = exact.reshape(J, 4 * B, N)[jr, top]
        new_q = torch.where(fin_p[..., None], q_p,
                            torch.where(ex_sel, 1.0, q_p * f95))
        # drift recentring (ref: alignment.go:245-273)
        bp = _argmin_last(new_off)
        drift = CENTRE - bp
        do = (torch.abs(drift) > 4) & ~fin_p[..., None]
        shift = torch.where(do, drift, 0)
        new_off = _barrel_shift(new_off, shift, FULL).to(i32)
        new_pos = (new_pos - shift).to(i32)
        best_lane = torch.where(do, CENTRE, bp)
        seq_pos = new_pos + best_lane - CENTRE
        new_fin = fin_p | ((seq_pos >= lens[:, None, :] - 1)
                           & live_m[:, None, :]).any(dim=2)
        new_cost = flat_cost[jr, top]
        recs.append(torch.stack([new_kmer.to(i32), parent.to(i32),
                                 new_fin.to(i32), new_cost], dim=1))
        kmer, off, pos, cost = new_kmer.to(i32), new_off, new_pos, new_cost
        quality, fin = new_q.to(torch.float32), new_fin
        if not return_records:
            done = done | new_fin.any(dim=1)
            if bool(done.all()):
                break
    rec = torch.stack(recs, dim=1)                            # [J, T', 4, B]
    if return_records:
        return rec
    return traceback_plain(rec, t_max)


def traceback_plain(rec, t_max: int):
    """``_device_traceback`` over ``[J, T', 4, B]`` records, batched: the
    first step at which any beam state finished, its cheapest finished
    state (lowest index on ties), or the cheapest final state if none
    finished; the parent walk back from there.  Returns ``(chains
    [J, t_max] int32, -1 padded, n_valid [J] int32)``; ``T' < t_max`` is
    allowed when every job finished within the first ``T'`` steps."""
    J, Tr, _, B = rec.shape
    dev = rec.device
    kmers, parents, fin_at, costs = rec.unbind(dim=2)         # [J, Tr, B]
    any_fin = (fin_at != 0).any(dim=2)                        # [J, Tr]
    has = any_fin.any(dim=1)
    steps = torch.arange(Tr, device=dev)
    first = torch.where(any_fin, steps, Tr).amin(dim=1)
    t_end = torch.where(has, first, t_max - 1)
    if bool((t_end >= Tr).any()):
        raise ValueError("records end before a job's traceback step")
    jr = torch.arange(J, device=dev)
    cost_row = costs[jr, t_end]
    masked = torch.where(has[:, None] & (fin_at[jr, t_end] == 0), BIG,
                         cost_row)
    b = torch.argmin(masked, dim=1)  # first minimum, as jnp.argmin
    chains = torch.full((J, t_max), -1, dtype=torch.int32, device=dev)
    for t in range(int(t_end.max()) if J else -1, -1, -1):
        on = t <= t_end
        tt = min(t, Tr - 1)
        km = kmers[jr, tt, b]
        chains[:, t] = torch.where(on, km, -1)
        b = torch.where(on, parents[jr, tt, b].long(), b)
    return chains, (t_end + 1).to(torch.int32)


def beam_consensus_ragged_plain(seqs, lens, firsts, shapes, table, k: int,
                                beam: int, threshold: int, gap_cost: int,
                                simple_k: int, return_records: bool = False):
    """The ragged form's plain version: jobs grouped by their (N, L, T),
    each group one ``beam_consensus_plain`` scan over ``[nj, N, L]``, the
    chains scattered into ``[J, max T]`` with -1 past each job's own.  With
    ``return_records`` the jobs must share one shape (see ``_launch``)."""
    J = len(shapes)
    dev = seqs.device
    blocks, rows = _offsets(shapes)
    groups = {}
    for j, shape in enumerate(shapes):
        groups.setdefault(tuple(shape), []).append(j)
    if return_records:
        if len(groups) > 1:
            raise ValueError("records mode takes jobs of one shape")
        N, L, T = shapes[0]
        return beam_consensus_plain(seqs.view(J, N, L), lens.view(J, N),
                                    firsts, table, k, beam, T, threshold,
                                    gap_cost, simple_k, True)
    t_top = max((T for _, _, T in shapes), default=0)
    chains = torch.full((J, t_top), -1, dtype=torch.int32, device=dev)
    n_valid = torch.zeros((J,), dtype=torch.int32, device=dev)
    for (N, L, T), js in groups.items():
        g_seqs = torch.stack([seqs[blocks[j]:blocks[j] + N * L]
                              for j in js]).view(len(js), N, L)
        g_lens = torch.stack([lens[rows[j]:rows[j] + N] for j in js])
        idx = torch.tensor(js, device=dev)
        ch, nv = beam_consensus_plain(g_seqs, g_lens, firsts[idx], table, k,
                                      beam, T, threshold, gap_cost, simple_k)
        chains[idx, :T] = ch
        n_valid[idx] = nv
    return chains, n_valid


def _offsets(shapes):
    """Start of each job's ``[N, L]`` block in the flat k-mers and of its
    ``[N]`` row in the flat lengths."""
    blocks, rows = [0], [0]
    for N, L, _ in shapes:
        blocks.append(blocks[-1] + N * L)
        rows.append(rows[-1] + N)
    return blocks, rows


# warps an SM holds that the beam kernel aims to keep busy: half of
# Hopper's 64 resident, so a few jobs' blocks fit beside each other on an SM
WARPS_PER_SM = 32
MIN_WARPS = 4
MAX_WARPS = 32


def beam_warps(J: int, N: int, beam: int, sm_count: int) -> int:
    """Warps per job of a beam-kernel launch over ``J`` jobs of up to
    ``N`` members on a card of ``sm_count`` SMs: as many as WARPS_PER_SM
    on every SM spread over the jobs allow, between MIN_WARPS and
    MAX_WARPS, no more than the ``beam x N`` (beam state, member) tasks of
    a step, then evened out so every warp takes the same number of tasks a
    step (an H100's 132 SMs: 1-2 jobs at N = 12, beam 4: 24 warps, 2 tasks
    each; 1024 jobs: 4 warps)."""
    tasks = max(1, beam * N)
    w = max(MIN_WARPS, min(MAX_WARPS, sm_count * WARPS_PER_SM // max(J, 1)))
    w = min(w, max(MIN_WARPS, tasks))
    rounds = -(-tasks // w)
    return max(MIN_WARPS, -(-tasks // rounds))


def _check_scalars(k: int, beam: int, simple_k: int, table, dev):
    if not 1 <= k <= 7:
        raise ValueError(f"beam_consensus takes 1 <= k <= 7, got {k}")
    if not 1 <= beam <= MAX_BEAM:
        raise ValueError(f"beam_consensus takes 1 <= beam <= {MAX_BEAM}")
    if simple_k:
        if simple_k not in _SIMPLE_WEIGHTS:
            raise ValueError(f"no simple measure for k={simple_k}")
    else:
        if table is None or table.dtype != torch.int16 \
                or tuple(table.shape) != (4 ** k, 4 ** k) \
                or table.device != dev or not table.is_contiguous():
            raise ValueError("the table measure takes a contiguous "
                             "[4^k, 4^k] int16 table on the seqs' device")


def _check_tensors(*arrays):
    for a in arrays:
        if a.dtype != torch.int32:
            raise TypeError(f"beam_consensus takes int32, got {a.dtype}")
        if a.device != arrays[0].device:
            raise ValueError("beam_consensus inputs must share one device")
        if not a.is_contiguous():
            raise ValueError("beam_consensus inputs must be contiguous")


def _check(seqs, lens, firsts, table, k: int, beam: int, simple_k: int):
    if seqs.dim() != 3:
        raise ValueError(f"beam_consensus takes seqs [J, N, L], got "
                         f"{tuple(seqs.shape)}")
    J, N, _ = seqs.shape
    if tuple(lens.shape) != (J, N) or tuple(firsts.shape) != (J,):
        raise ValueError("beam_consensus takes lens [J, N] and firsts [J]")
    _check_tensors(seqs, lens, firsts)
    _check_scalars(k, beam, simple_k, table, seqs.device)


def _check_ragged(seqs, lens, firsts, shapes, table, k: int, beam: int,
                  simple_k: int):
    shapes = [tuple(int(v) for v in s) for s in shapes]
    if any(len(s) != 3 or min(s) < 1 for s in shapes):
        raise ValueError("beam_consensus_ragged takes one (N, L, T) of "
                         "positive ints per job")
    blocks, rows = _offsets(shapes)
    if seqs.dim() != 1 or lens.dim() != 1 \
            or tuple(firsts.shape) != (len(shapes),):
        raise ValueError("beam_consensus_ragged takes flat seqs and lens "
                         "and firsts [J]")
    if seqs.numel() != blocks[-1] or lens.numel() != rows[-1]:
        raise ValueError(f"the shapes need {blocks[-1]} k-mers and "
                         f"{rows[-1]} lengths, got {seqs.numel()} and "
                         f"{lens.numel()}")
    _check_tensors(seqs, lens, firsts)
    _check_scalars(k, beam, simple_k, table, seqs.device)
    return shapes


def plan(shapes):
    """The kernel's per-job parameters for ``shapes``: ``meta [J, 8]``
    int64 (k-mer offset, length offset, N, L, T, sw, hi, 0; sw and hi
    ``_win_params(L)``) on the CPU, the largest N and the largest sw."""
    blocks, rows = _offsets(shapes)
    meta = []
    for j, (N, L, T) in enumerate(shapes):
        sw, hi = _win_params(L)
        meta.append((blocks[j], rows[j], N, L, T, sw, hi, 0))
    return (torch.tensor(meta, dtype=torch.int64).view(-1, 8),
            max(N for N, _, _ in shapes), max(m[5] for m in meta))


def _lib():
    lib = _build.load("beam_consensus")
    fn = lib.beam_consensus_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.beam_consensus_scratch_bytes.argtypes = [ctypes.c_int] * 4
        lib.beam_consensus_scratch_bytes.restype = ctypes.c_longlong
        lib.beam_consensus_error_string.argtypes = [ctypes.c_int]
        lib.beam_consensus_error_string.restype = ctypes.c_char_p
    return lib


def _launch(seqs, lens, firsts, shapes, table, k, beam, threshold, gap_cost,
            simple_k, return_records):
    """One launch over the ragged job set (every job in one grid).  In
    records mode the jobs must share one (N, L, T): the records are
    ``[J, T, 4, B]``."""
    J = len(shapes)
    dev = seqs.device
    if return_records and len(set(shapes)) > 1:
        raise ValueError("records mode takes jobs of one shape")
    if gap_cost < 0 or threshold < 1:
        # the kernel's bands then stay in [0, FULL], which its one-reduction
        # row minimum and _argmin_last rely on
        raise ValueError("the beam kernel takes gap_cost >= 0 and "
                         "threshold >= 1")
    t_top = max((T for _, _, T in shapes), default=1)
    chains = torch.empty((J, t_top), dtype=torch.int32, device=dev)
    n_valid = torch.empty((J,), dtype=torch.int32, device=dev)
    rec = torch.empty((J, t_top, 4, beam), dtype=torch.int32, device=dev)
    if J == 0:
        return rec if return_records else (chains, n_valid)
    meta, n_top, sw_top = plan(shapes)
    lib = _lib()
    with torch.cuda.device(dev):
        meta = meta.to(dev)
        need = lib.beam_consensus_scratch_bytes(n_top, beam, sw_top, t_top)
        if need < 0:
            raise RuntimeError("beam_consensus: no current CUDA device")
        scratch = None
        if need > 0:   # the candidate store does not fit in shared memory
            scratch = torch.empty((J * need,), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = lib.beam_consensus_launch(
            seqs.data_ptr(), lens.data_ptr(), firsts.data_ptr(),
            meta.data_ptr(), None if table is None else table.data_ptr(),
            chains.data_ptr(), n_valid.data_ptr(), rec.data_ptr(),
            None if scratch is None else scratch.data_ptr(), J, n_top,
            t_top, sw_top, k, beam, threshold, gap_cost, simple_k,
            0 if return_records else 1, beam_warps(J, n_top, beam, sms),
            stream)
    if err != 0:
        msg = lib.beam_consensus_error_string(err).decode()
        raise RuntimeError(
            f"beam_consensus kernel launch failed: {msg} ({err})")
    with _count_lock:
        beam_consensus.launches += 1
    return rec if return_records else (chains, n_valid)


def _route(dev):
    if dev.type == "cpu":
        return "plain"
    if dev.type != "cuda":
        raise ValueError(f"beam_consensus has no kernel for {dev.type!r}")
    return "kernel"


def beam_consensus(seqs, lens, firsts, table, k: int, beam: int,
                   t_max: int, threshold: int, gap_cost: int,
                   simple_k: int, return_records: bool = False):
    """The beam scan over ``J`` jobs of one shape; see the module
    docstring.  CPU tensors run ``beam_consensus_plain``; CUDA tensors
    launch the kernel once (``beam_consensus.launches`` counts those
    launches): the uniform case of ``beam_consensus_ragged``."""
    _check(seqs, lens, firsts, table, k, beam, simple_k)
    if _route(seqs.device) == "plain":
        return beam_consensus_plain(seqs, lens, firsts, table, k, beam,
                                    t_max, threshold, gap_cost, simple_k,
                                    return_records)
    J, N, L = seqs.shape
    return _launch(seqs.view(-1), lens.view(-1), firsts, [(N, L, t_max)] * J,
                   table, k, beam, threshold, gap_cost, simple_k,
                   return_records)


def beam_consensus_ragged(seqs, lens, firsts, shapes, table, k: int,
                          beam: int, threshold: int, gap_cost: int,
                          simple_k: int):
    """The beam scan over jobs of differing shapes in one launch.
    ``shapes`` holds one ``(N, L, T)`` per job; ``seqs`` is the flat
    concatenation of the jobs' ``[N, L]`` int32 k-mer blocks, ``lens``
    of their ``[N]`` lengths, ``firsts [J]``.  Each job computes what
    ``beam_consensus`` computes on its own ``[1, N, L]`` with ``t_max =
    T``.  Returns ``(chains [J, max T], -1 padded, n_valid [J])``.  CPU
    tensors run ``beam_consensus_ragged_plain``; CUDA tensors launch the
    kernel once (counted in ``beam_consensus.launches``)."""
    shapes = _check_ragged(seqs, lens, firsts, shapes, table, k, beam,
                           simple_k)
    if _route(seqs.device) == "plain":
        return beam_consensus_ragged_plain(seqs, lens, firsts, shapes, table,
                                           k, beam, threshold, gap_cost,
                                           simple_k)
    return _launch(seqs, lens, firsts, shapes, table, k, beam, threshold,
                   gap_cost, simple_k, False)


beam_consensus.launches = 0
