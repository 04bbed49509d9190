"""Base-space consensus glue on the torch engine (port of
``downpore_tpu/consensus/consensus.py``): slice contig parts, run the
beam-consensus scan (``ops.dtw``), write the consensus back.

The host helpers ``_prepare_parts`` and ``_kmers_to_codes`` and the
faithful host landmark engine (``engine="host"``) are the JAX package's
own JAX-free code; only the device engine is ported.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from downpore_tpu.align import SimpleMeasure
from downpore_tpu.consensus.consensus import (_kmers_to_codes,
                                              _prepare_parts)
from downpore_tpu.consensus.consensus import \
    build_consensus as _host_build_consensus
from downpore_tpu.core.sequence import Sequence
from downpore_tpu.overlap.combine import SeedContig

from ..ops.dtw import consensus_kmers, consensus_kmers_bulk


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
    updated contig and the consensus Sequence, or (None, None).

    ``engine="device"`` runs the fixed-beam scan on ``device`` (offsets
    are left approximate); ``engine="host"`` is the JAX package's faithful
    landmark beam, which runs on the host."""
    if engine != "device":
        return _host_build_consensus(contig, sequences, model, full_match,
                                     engine)
    k, cost_threshold, initial_gap_cost = _measure_params(model)
    seqs, _, _, _ = _prepare_parts(contig, sequences, k)
    if len(seqs) < 3:
        return None, None
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
