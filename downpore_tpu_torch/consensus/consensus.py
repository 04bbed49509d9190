"""Base-space consensus glue (ref: consensus/consensus.go:15-131): slice
contig parts, run a consensus engine, write the result back.

Two engines: the faithful host landmark beam (``engine="host"``,
``align.dtw``), which also refines the contig offsets, and the fixed-beam
scan on the port's beam-consensus kernel (``engine="device"`` and
``build_consensus_bulk``, ``ops.dtw``), which leaves offsets
approximate.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..align import DTWAligner, SimpleMeasure
from ..core.sequence import Sequence
from ..ops.dtw import consensus_kmers, consensus_kmers_bulk
from ..overlap.combine import SeedContig


def _measure_params(model):
    """(k, cost threshold, initial gap cost) of the consensus measure."""
    if model is not None:
        return model.k, 200, 2
    return 5, 200, 5


def build_consensus(contig: SeedContig, sequences, model=None,
                    full_match: bool = False, engine: str = "host",
                    device=None
                    ) -> Tuple[Optional[SeedContig], Optional[Sequence]]:
    """``sequences`` maps read id -> Sequence (list or dict).  Returns the
    updated contig and the consensus Sequence (carrying the base read's
    id/offsets when one part is the query itself), or (None, None).

    ``engine="device"`` runs the fixed-beam scan on ``device`` (offsets
    are left approximate); ``engine="host"`` runs the faithful landmark
    beam on the host."""
    k, cost_threshold, initial_gap_cost = _measure_params(model)
    seqs, rcs, seq_map, base_seq_index = _prepare_parts(contig, sequences, k)
    if len(seqs) < 3:
        return None, None
    if engine == "device":
        table = SimpleMeasure(k).pair_table() if model is None \
            else model.pair_table()
        kmers = consensus_kmers(seqs, table, k, threshold=cost_threshold,
                                gap_cost=initial_gap_cost,
                                simple_k=k if model is None else 0,
                                device=device)
        if len(kmers) < 100:
            return None, None
        consensus_len = len(kmers) - k + 1
        for i in range(len(contig.lengths)):
            contig.lengths[i] = consensus_len
            contig.approximate[i] = True
        return contig, Sequence(_kmers_to_codes(kmers, k), id=-1)
    measure = model.clone() if model is not None else SimpleMeasure(k)
    measure.set_sequences(seqs, rcs)
    dtw = DTWAligner(16, initial_gap_cost, measure, full_match,
                     cost_threshold, k)
    kmers, costs, positions = dtw.global_alignment()
    if len(kmers) < 100:  # too short; bad sequence match
        return None, None
    start_positions = positions[0]
    end_positions = positions[-1]
    consensus_len = len(kmers) - k + 1

    for i in range(len(contig.lengths)):
        contig.lengths[i] = consensus_len
        contig.approximate[i] = True
    for i, index in enumerate(seq_map):
        contig.approximate[index] = False
        if contig.reverse_complement[index]:
            contig.offsets[index] += len(seqs[i]) - end_positions[i]
        else:
            contig.offsets[index] += start_positions[i]
        contig.lengths[index] = end_positions[i] - start_positions[i] + k - 1

    codes = _kmers_to_codes(kmers, k)
    if base_seq_index == -1:
        consensus = Sequence(codes, id=-1)
    else:
        offset = contig.offsets[base_seq_index]
        inset = contig.seq_lengths[base_seq_index] - offset - consensus_len
        consensus = Sequence(codes, id=contig.parts[base_seq_index],
                             offset=offset, inset=inset)
    return contig, consensus


def _prepare_parts(contig: SeedContig, sequences, k: int):
    """Slice each contig part to its window, RC-normalize, emit k-mer
    streams (the loop shared by both engines; ref:
    consensus/consensus.go:30-63)."""
    seqs: List[np.ndarray] = []
    rcs: List[bool] = []
    seq_map: List[int] = []
    base_seq_index = -1
    for i, rid in enumerate(contig.parts):
        if contig.matches is not None and \
                contig.matches[i].seq_a.id == contig.matches[i].seq_b.id:
            base_seq_index = i
        if contig.approximate[i]:
            continue
        b = sequences[rid]
        start = contig.offsets[i]
        if start < 0:
            if start < -5:
                continue
            start = 0
        end = contig.offsets[i] + contig.lengths[i]
        if end > len(b):
            if end > len(b) + 100 or (contig.reverse_complement[i]
                                      and end > len(b) + 5):
                continue
            end = len(b)
        if start >= end:
            start = end - 1
        sub = b.subsequence(start, end)
        if contig.reverse_complement[i]:
            sub = sub.reverse_complement()
        rcs.append(contig.reverse_complement[i])
        seqs.append(sub.short_kmers(k, False))
        seq_map.append(i)
    return seqs, rcs, seq_map, base_seq_index


def build_consensus_bulk(contigs: List[SeedContig], sequences, model=None,
                         device=None
                         ) -> List[Tuple[Optional[SeedContig],
                                         Optional[Sequence]]]:
    """Device-engine consensus over many contigs in few scan calls.

    The per-contig prep matches ``build_consensus``; all valid jobs then
    run through ``ops.dtw.consensus_kmers_bulk``.  Offsets are left
    approximate.  Returns (contig, consensus) per input."""
    k, cost_threshold, initial_gap_cost = _measure_params(model)
    table = (SimpleMeasure(k).pair_table() if model is None
             else model.pair_table())
    jobs = []
    job_map = []
    out: List[Tuple[Optional[SeedContig], Optional[Sequence]]] = \
        [(None, None)] * len(contigs)
    for ci, contig in enumerate(contigs):
        seqs, _, _, _ = _prepare_parts(contig, sequences, k)
        if len(seqs) < 3:
            continue
        job_map.append(ci)
        jobs.append(seqs)
    if not jobs:
        return out
    all_kmers = consensus_kmers_bulk(jobs, table, k,
                                     threshold=cost_threshold,
                                     gap_cost=initial_gap_cost,
                                     simple_k=k if model is None else 0,
                                     device=device)
    for ji, ci in enumerate(job_map):
        kmers = all_kmers[ji]
        if len(kmers) < 100:
            continue
        contig = contigs[ci]
        consensus_len = len(kmers) - k + 1
        for i in range(len(contig.lengths)):
            contig.lengths[i] = consensus_len
            contig.approximate[i] = True
        out[ci] = (contig, Sequence(_kmers_to_codes(kmers, k), id=-1))
    return out


def _kmers_to_codes(kmers, k: int) -> np.ndarray:
    """k-mer stream -> base codes (ref: sequence/sequence.go:107-117)."""
    n = len(kmers)
    codes = np.empty(n + k - 1, dtype=np.uint8)
    first = int(kmers[0])
    for i in range(k - 1):
        codes[i] = (first >> (2 * (k - i - 1))) & 3
    for i, v in enumerate(kmers):
        codes[i + k - 1] = int(v) & 3
    return codes
