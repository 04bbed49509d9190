"""The correct command (ref: commands/correct.go) on the torch engine:
two overlap rounds around a base-space consensus of the first round's
pileups, emitting the consensus sequences as fasta on stdout.

Same flags, defaults, help text and flow as ``downpore_tpu``'s correct
command, whose host helpers (duplicate removal, seed-space consensus,
query collation) it reuses.  The overlap rounds run on the port's
``Overlapper`` and the consensus on the port's beam scan
(``-device_consensus true``, the default) or on the host landmark engine
(``false``).  A failure of the device engine ends the run: there is no
fallback to the host engine.  ``-trim 1`` trims the reads first with the
port's ``Trimmer`` at k = 5, as the JAX command does.
``-data_parallel true`` raises until the multi-GPU port.
"""
from __future__ import annotations

import sys

from downpore_tpu.cli import correct_command as _ref
from downpore_tpu.cli.framework import parse_bool, parse_float, parse_int


class CorrectCommand(_ref.CorrectCommand):
    def run(self, args):
        from downpore_tpu.align.model import Model
        from downpore_tpu.io import SequenceSet
        from downpore_tpu.overlap.pileup import cleanup_overlaps, new_pileup
        from downpore_tpu.seeds import SeedIndex
        from .. import resolve_device
        from ..consensus import build_consensus, build_consensus_bulk
        from ..overlap import QUERY_ALL, Overlapper
        from ..trim import load_trimmer
        from ..utils import kmer_occurrences, score_seed_values

        if parse_bool(args["data_parallel"]):
            raise NotImplementedError(
                "-data_parallel is not ported yet: ROADMAP.md, 'Multi-GPU'")
        device = resolve_device()
        overlap_size = parse_int(args["overlap_size"])
        num_seeds = parse_int(args["num_seeds"])
        seed_batch_size = parse_int(args["seed_batch_size"])
        chunk_size = parse_int(args["chunk_size"])
        k = parse_int(args["k"])
        hit_fraction = parse_float(args["min_hits"])
        mod = Model(args["model"], False) if args.get("model") else None

        seq_set = SequenceSet(args["input"], min_length=overlap_size,
                              cache=parse_bool(args["himem"]))
        if args.get("trim") == "1":
            trimmer = load_trimmer(args["front_adapters"],
                                   args["back_adapters"], 5, device=device)
            trimmer.trim(seq_set)
            trimmer.print_stats()
        counts = kmer_occurrences(seq_set.get_sequences(), k)
        values = score_seed_values(counts, k)

        def overlap_round(queries_from):
            """One overlap round: index the reads, query ``queries_from``,
            collate and reduce the hits to seed-space contigs."""
            index = SeedIndex(k)
            overlapper = Overlapper(index, chunk_size, overlap_size, 10,
                                    hit_fraction, device=device)
            queries = overlapper.prepare_queries(
                num_seeds, seed_batch_size, values, queries_from,
                QUERY_ALL)
            return index, queries, overlapper

        def seed_contigs(index, queries, overlapper, ids):
            """Collate a round's hits per query read and reduce them to
            seed-space contigs (ref: correct.go:111-140)."""
            results = _ref._perform_queries(queries, overlapper,
                                            overlap_size, seq_set, ids)
            seed_consensus = []
            seq_ids = set()
            for rs in results:
                for hits in rs:
                    if hits:
                        _ref._remove_duplicates(hits)
                rs.sort(key=lambda h: h[0].seq_a.offset if h else 1 << 30)
                cleanup_overlaps(rs, overlap_size, k)
                seed_consensus.append(
                    _ref._seed_space_consensus(rs, index, seq_ids))
            return seed_consensus, seq_ids

        while True:
            ids, lengths = seq_set.get_ids_by_length()
            if not ids or lengths[-1] < 1000:
                break
            # pick the longest sequences to fill the seed budget
            # (ref: correct.go:72-89; the reference then clamps to one)
            last = len(lengths) - 1
            start = last
            approx = (lengths[start] // overlap_size + 1) * num_seeds
            while start >= 0 and approx < seed_batch_size:
                approx += (lengths[start] // overlap_size + 1) * num_seeds
                start -= 1
            if start < last:
                start = last - 1
                ids = ids[start + 1:]
            else:
                ids = ids[last:]
            print("Query ids are", ids, file=sys.stderr)

            index, queries, overlapper = overlap_round(
                seq_set.get_sequences_by_id(ids))
            print(f"Produced a query set of {len(queries)} queries using "
                  f"{index.num_seeds} seeds.", file=sys.stderr)
            seed_consensus, seq_ids = seed_contigs(index, queries,
                                                   overlapper, ids)
            all_seq = {}
            if seq_ids:
                for s in seq_set.get_sequences_by_id(sorted(seq_ids)):
                    all_seq[s.id] = s
            print("Preparing base-space consensus of all query results.",
                  file=sys.stderr)
            consensus_seqs = []
            if parse_bool(args["device_consensus"]):
                flat = [c for contigs in seed_consensus for c in contigs
                        if c is not None]
                for _, cons in build_consensus_bulk(flat, all_seq, mod,
                                                    device=device):
                    if cons is not None:
                        consensus_seqs.append(cons)
            else:
                for contigs in seed_consensus:
                    for contig in contigs:
                        if contig is None:
                            continue
                        _, cons = build_consensus(contig, all_seq, mod,
                                                  False)
                        if cons is not None:
                            consensus_seqs.append(cons)
            print(f"Received {len(consensus_seqs)} consensus results.",
                  file=sys.stderr)

            # round 2: consensus outputs become queries
            index, queries, overlapper = overlap_round(
                iter(consensus_seqs))
            seed_consensus, _ = seed_contigs(index, queries, overlapper,
                                             ids)
            if seed_consensus and any(c is not None
                                      for c in seed_consensus[0]):
                new_pileup(seed_consensus[0])
            # emit the corrected (consensus) sequences: the reference's
            # unimplemented step 7
            for i, cons in enumerate(consensus_seqs):
                name = seq_set.get_name(cons.id) if cons.id >= 0 \
                    else f"consensus_{i}"
                print(f">{name}_corrected\n{cons}")
            break  # the reference breaks after one outer round
