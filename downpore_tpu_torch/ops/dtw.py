"""Device beam-search DTW consensus (torch port of
``downpore_tpu/ops/dtw.py``).

Consensus is a fixed-width beam search over k-mer extensions: per step,
for every beam state and each of its 4 k-mer extensions, the 32-wide cost
band of every member sequence updates with the step/stay/skip recurrence
of ``align.band``; extensions with no exact k-mer support are pruned,
quality decays 0.95 on non-matching members, drifting bands recentre and
the beam keeps the B cheapest states.  The consensus is walked back from
the per-step (k-mer, parent) records.

This module holds the engine's helpers (window schedule, band update,
distances, job padding) and the host wrappers ``consensus_kmers`` and
``consensus_kmers_bulk``.  The scan itself is ``cuda_beam.beam_consensus``:
the hand-written Hopper kernel on a CUDA device, its plain torch version
on the CPU.  Every bucket and both measures (the arithmetic simple-k
measure and a ``[4^k, 4^k]`` table) take that one route; the JAX
package's engine switch, VMEM estimate and 8-member Pallas padding have
no counterpart here (padded members are inert, so member padding does not
change results).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from .cuda_band import update_bands_plain

BIG = 1 << 28
# dead-lane sentinel of the device engines: bands only ever hold
# {0 .. threshold} or FULL
FULL = 0x7FFF
# static per-step window of member lanes (see downpore_tpu/ops/dtw.py:WINW)
WINW = 512
# expected-position slack of the regularizer (downpore_tpu/ops/dtw.py)
REG_SLACK = 64
W = 32
INIT = 8  # initialOffset (ref: alignment.go:15)

# (shift, weight) pairs per k: the schedule of
# align.measures.build_simple_table (ref: measures.go:45-104)
_SIMPLE_WEIGHTS = {
    5: ((4, 8), (6, 2), (2, 2), (0, 1), (8, 1)),
    4: ((4, 4), (2, 4), (6, 2), (0, 2)),
    3: ((2, 8), (4, 2), (0, 2)),
    6: ((4, 4), (6, 4), (2, 2), (8, 2), (0, 1), (10, 1)),
    1: ((0, 8),),
}


def _win_params(L: int):
    """(slice width, max base) of the static window for member arrays of
    logical length ``L``: width min(WINW, padded length), base range
    sized so base + width reaches the padded end."""
    lp = ((L + 2 * 32 + 127) // 128) * 128
    sw = min(WINW, lp)
    hi = max(0, lp - sw)
    return sw, hi


def _win_base(t: int, L: int) -> int:
    """128-aligned window base at consensus step ``t``, biased +64 forward
    of the expected band position o = t + 25 (clipped before the floor
    division, so the operand is non-negative)."""
    sw, hi = _win_params(L)
    return (min(max(t + 25 + 64 - sw // 2, 0), hi) // 128) * 128


def _argmin_last(x, dim: int = -1):
    """Index of the minimum along ``dim``, ties broken toward the HIGHEST
    index (the band frontier is the furthest-advanced minimal lane).  A
    min over the key ``x * 2n + (n - 1 - lane)``, exact while
    0 <= x <= FULL; ``torch.argmin`` would take the lowest index."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    lane = torch.arange(n, dtype=torch.int32, device=x.device).view(shape)
    key = x.to(torch.int32) * (2 * n) + (n - 1 - lane)
    return (n - 1) - torch.remainder(key.amin(dim=dim), 2 * n)


def _band_update(poffs, ds, threshold: int):
    """Band update over ``[..., W]`` saturating at FULL (see
    ``cuda_band.update_bands_plain``)."""
    return update_bands_plain(ds, poffs, threshold, FULL)


def _simple_distance(a, b, k: int):
    """Position-weighted XOR mismatch cost: the simple measure's table
    value computed arithmetically (ref: measures.go:45-104)."""
    d = torch.bitwise_xor(a, b)
    cost = None
    for sh, w in _SIMPLE_WEIGHTS[k]:
        term = (((d >> sh) | (d >> (sh + 1))) & 1) * w
        cost = term if cost is None else cost + term
    return cost


def _barrel_shift(x, shift, fill: int):
    """x[..., w] -> x[..., w - shift] along the last axis, vacated lanes
    ``fill``; ``shift`` broadcasts over the leading axes."""
    n = x.shape[-1]
    lane = torch.arange(n, device=x.device)
    src = lane - shift[..., None]
    y = torch.gather(x, -1, src.clamp(0, n - 1).long())
    return torch.where((src < 0) | (src >= n), fill, y)


def _pad_job(seq_kmers_list, N: int, L: int):
    seq = np.full((N, L), -1, np.int32)
    lens = np.zeros(N, np.int32)
    for i, s in enumerate(seq_kmers_list):
        seq[i, : len(s)] = s
        lens[i] = len(s)
    # majority first kmer (the reference tries every distinct first kmer;
    # the beam converges from the most common one)
    firsts = [int(s[0]) for s in seq_kmers_list if len(s)]
    first = max(set(firsts), key=firsts.count)
    return seq, lens, first


def _assemble(chain: np.ndarray, n: int, first: int) -> np.ndarray:
    return np.concatenate(([np.int32(first)],
                           np.asarray(chain[:n], np.int32)))


def _t_max(L: int) -> int:
    """Scan length for member arrays of length ``L``: 1.3 L + 32 steps,
    rounded up to a multiple of 32."""
    t_max = int(L * 1.3) + 32
    return ((t_max + 31) // 32) * 32


def _device_table(table, simple_k: int, device):
    """The ``[4^k, 4^k]`` uint16 distance table on ``device`` (its bits in
    an int16 tensor), or None for a simple-k measure."""
    if simple_k:
        return None
    t = np.ascontiguousarray(np.asarray(table, np.uint16))
    return torch.from_numpy(t.view(np.int16)).to(device)


def consensus_kmers(seq_kmers_list: List[np.ndarray], table: np.ndarray,
                    k: int, beam: int = 4, threshold: int = 300,
                    gap_cost: int = 8, simple_k: int = 0,
                    device=None) -> np.ndarray:
    """One job: pad it, run the beam scan and traceback.  Returns the
    consensus k-mer array."""
    from .cuda_beam import beam_consensus
    dev = resolve_device(device)
    N = len(seq_kmers_list)
    L = max(len(s) for s in seq_kmers_list)
    seq, lens, first = _pad_job(seq_kmers_list, N, L)
    chains, ns = beam_consensus(
        torch.from_numpy(seq[None]).to(dev),
        torch.from_numpy(lens[None]).to(dev),
        torch.tensor([first], dtype=torch.int32, device=dev),
        _device_table(table, simple_k, dev), k, beam, _t_max(L), threshold,
        gap_cost, simple_k)
    return _assemble(chains[0].cpu().numpy(), int(ns[0]), first)


def consensus_kmers_bulk(jobs: List[List[np.ndarray]], table: np.ndarray,
                         k: int, beam: int = 4, threshold: int = 300,
                         gap_cost: int = 8, simple_k: int = 0,
                         device=None) -> List[np.ndarray]:
    """Many consensus jobs in one beam-scan call.

    Empty members are dropped and empty jobs skipped (their result is an
    empty array).  Each job keeps the shape of its bucket in the JAX
    package, (member count rounded up to 4, longest member rounded up to
    128): the rounded length sets its window schedule (``_win_params``)
    and scan length (``_t_max``), exactly as there.  The buckets were the
    JAX package's compiled shapes; here every job goes into one ragged
    scan (``cuda_beam.beam_consensus_ragged``: one kernel launch on a
    card).  Returns consensus k-mer arrays in job order."""
    from .cuda_beam import beam_consensus_ragged
    dev = resolve_device(device)
    entries, shapes, blocks, rows, firsts = [], [], [], [], []
    for ji, job in enumerate(jobs):
        job = [s for s in job if len(s)]
        if not job:
            continue
        N = ((len(job) + 3) // 4) * 4
        L = max(len(s) for s in job)
        L = ((L + 127) // 128) * 128
        seq, lens, first = _pad_job(job, N, L)
        entries.append(ji)
        shapes.append((N, L, _t_max(L)))
        blocks.append(seq.reshape(-1))
        rows.append(lens)
        firsts.append(first)
    results = [np.zeros(0, np.int32)] * len(jobs)
    if not entries:
        return results
    chains, ns = beam_consensus_ragged(
        torch.from_numpy(np.concatenate(blocks)).to(dev),
        torch.from_numpy(np.concatenate(rows)).to(dev),
        torch.tensor(firsts, dtype=torch.int32, device=dev), shapes,
        _device_table(table, simple_k, dev), k, beam, threshold, gap_cost,
        simple_k)
    chains = chains.cpu().numpy()
    ns = ns.cpu().numpy()
    for i, ji in enumerate(entries):
        results[ji] = _assemble(chains[i], int(ns[i]), firsts[i])
    return results
