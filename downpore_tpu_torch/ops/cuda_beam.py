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

A tensor on the CPU goes to ``beam_consensus_plain``, the XLA engine's
step written once over the batch ``[J, B, 4, N, W]``.  A CUDA tensor
launches the kernel in ``csrc/beam_consensus.cu`` or raises; there is no
fallback, no size-based route and no switch.
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


def _check(seqs, lens, firsts, table, k: int, beam: int, simple_k: int):
    if seqs.dim() != 3:
        raise ValueError(f"beam_consensus takes seqs [J, N, L], got "
                         f"{tuple(seqs.shape)}")
    J, N, _ = seqs.shape
    if tuple(lens.shape) != (J, N) or tuple(firsts.shape) != (J,):
        raise ValueError("beam_consensus takes lens [J, N] and firsts [J]")
    for a in (seqs, lens, firsts):
        if a.dtype != torch.int32:
            raise TypeError(f"beam_consensus takes int32, got {a.dtype}")
        if a.device != seqs.device:
            raise ValueError("beam_consensus inputs must share one device")
        if not a.is_contiguous():
            raise ValueError("beam_consensus inputs must be contiguous")
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
                or table.device != seqs.device or not table.is_contiguous():
            raise ValueError("the table measure takes a contiguous "
                             "[4^k, 4^k] int16 table on the seqs' device")


def _launch(seqs, lens, firsts, table, k, beam, t_max, threshold, gap_cost,
            simple_k, return_records):
    J, N, L = seqs.shape
    dev = seqs.device
    chains = torch.empty((J, t_max), dtype=torch.int32, device=dev)
    n_valid = torch.empty((J,), dtype=torch.int32, device=dev)
    rec = torch.empty((J, t_max, 4, beam), dtype=torch.int32, device=dev)
    if J == 0:
        return rec if return_records else (chains, n_valid)
    lib = _build.load("beam_consensus")
    fn = lib.beam_consensus_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.beam_consensus_member_bytes.argtypes = [ctypes.c_int] * 2
        lib.beam_consensus_member_bytes.restype = ctypes.c_longlong
        lib.beam_consensus_max_smem.argtypes = []
        lib.beam_consensus_max_smem.restype = ctypes.c_int
        lib.beam_consensus_error_string.argtypes = [ctypes.c_int]
        lib.beam_consensus_error_string.restype = ctypes.c_char_p
    sw, hi = _win_params(L)
    with torch.cuda.device(dev):
        # per-member state lives in shared memory when one job's fits
        # (next to ~1 KB of small state); else in a device scratch
        member = lib.beam_consensus_member_bytes(N, beam)
        scratch = None
        if member + 1024 > lib.beam_consensus_max_smem():
            scratch = torch.empty((J * member,), dtype=torch.uint8,
                                  device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(seqs.data_ptr(), lens.data_ptr(), firsts.data_ptr(),
                 None if table is None else table.data_ptr(),
                 chains.data_ptr(), n_valid.data_ptr(), rec.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 J, N, L, t_max, k, beam, threshold, gap_cost, simple_k, sw,
                 hi, 0 if return_records else 1, stream)
    if err != 0:
        msg = lib.beam_consensus_error_string(err).decode()
        raise RuntimeError(
            f"beam_consensus kernel launch failed: {msg} ({err})")
    with _count_lock:
        beam_consensus.launches += 1
    return rec if return_records else (chains, n_valid)


def beam_consensus(seqs, lens, firsts, table, k: int, beam: int,
                   t_max: int, threshold: int, gap_cost: int,
                   simple_k: int, return_records: bool = False):
    """The beam scan over ``J`` jobs; see the module docstring.  CPU
    tensors run ``beam_consensus_plain``; CUDA tensors launch the kernel
    (``beam_consensus.launches`` counts those launches)."""
    _check(seqs, lens, firsts, table, k, beam, simple_k)
    dev = seqs.device
    if dev.type == "cpu":
        return beam_consensus_plain(seqs, lens, firsts, table, k, beam,
                                    t_max, threshold, gap_cost, simple_k,
                                    return_records)
    if dev.type != "cuda":
        raise ValueError(f"beam_consensus has no kernel for {dev.type!r}")
    return _launch(seqs, lens, firsts, table, k, beam, t_max, threshold,
                   gap_cost, simple_k, return_records)


beam_consensus.launches = 0
