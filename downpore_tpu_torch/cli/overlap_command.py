"""The overlap command (ref: commands/overlap.go:22-233) on the torch
engine: batched all-vs-all rounds with PAF output.

Same flags, defaults, help text, round loop and stderr lines as
``downpore_tpu``'s overlap command: each round indexes every read and
queries the edges of the next batch of reads, with ``-checkpoint`` save
and resume at round boundaries, the next round's host prep speculated on a
worker thread (redone when the round's final checks moved the ignore
flags), and the array-direct native final check it inherits.  The rounds
run on the port's ``Overlapper``.  The JAX command's cross-round shape
plan is dropped: it pins only compiled shapes, never an output.
``-data_parallel true`` and ``-seed_shards`` above 1 raise until the
multi-GPU port.
"""
from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

from downpore_tpu.cli import overlap_command as _ref
from downpore_tpu.cli.framework import parse_bool, parse_float, parse_int


class OverlapCommand(_ref.OverlapCommand):
    def run(self, args):
        from downpore_tpu.io import SequenceSet
        from downpore_tpu.seeds import SeedIndex
        from .. import resolve_device
        from ..overlap import QUERY_EDGES, Overlapper
        from ..utils import kmer_occurrences, score_seed_values

        if parse_bool(args["data_parallel"]) or \
                parse_int(args["seed_shards"]) > 1:
            raise NotImplementedError(
                "-data_parallel / -seed_shards are not ported yet: "
                "ROADMAP.md, 'Multi-GPU'")
        device = resolve_device()
        overlap_size = parse_int(args["overlap_size"])
        num_seeds = parse_int(args["num_seeds"])
        seed_batch_size = parse_int(args["seed_batch_size"])
        query_batch_size = parse_int(args["query_batch_size"])
        chunk_size = parse_int(args["chunk_size"])
        k = parse_int(args["k"])
        hit_fraction = parse_float(args["min_hits"])

        seq_set = SequenceSet(args["input"], min_length=overlap_size,
                              cache=parse_bool(args["himem"]))
        print(f"Counting all {k}-mers in the input...", file=sys.stderr)
        counts = kmer_occurrences(seq_set.get_sequences(), k)
        values = score_seed_values(counts, k, args.get("seed_values", ""))
        print("Counting complete. Starting indexing and querying...",
              file=sys.stderr)
        first_sequence = 0
        round_no = 0
        ckpt = args.get("checkpoint") or None
        if ckpt and os.path.exists(ckpt):
            progress = seq_set.load_state(ckpt)
            first_sequence = int(progress.get("first_sequence", 0))
            round_no = int(progress.get("round", 0))
            print(f"Resuming from round {round_no} "
                  f"(sequence {first_sequence}).", file=sys.stderr)

        def prep_round(first):
            """Host half of a round: fresh index, query prep, chunk
            indexing.  Independent of earlier rounds' results."""
            index = SeedIndex(k)
            overlapper = Overlapper(index, chunk_size, overlap_size,
                                    num_seeds, hit_fraction, device=device)
            seqs = seq_set.get_n_sequences_from(first, query_batch_size)
            queries = overlapper.prepare_round(
                num_seeds, seed_batch_size, values, seqs, QUERY_EDGES,
                seq_set.get_sequences())
            if not queries:
                return None
            nxt = max(q.sequence_id for q in queries) + 1
            return index, overlapper, queries, nxt

        with ThreadPoolExecutor(max_workers=1) as ex:

            def submit_prep(first):
                # the prep reads the ignore flags that a round's final
                # checks set: snapshot their count to validate it later
                return (sum(seq_set.ignore), first,
                        ex.submit(prep_round, first))

            prepped = prep_round(first_sequence)
            futs = prepped[1].dispatch_find(prepped[2]) if prepped else None
            next_sub = submit_prep(prepped[3]) if prepped else None
            while prepped is not None:
                index, overlapper, queries, next_first = prepped
                num_query_seqs = max(q.id for q in queries) + 1
                print(f"Using query set with {num_query_seqs} sequences "
                      f"starting from {next_first} against "
                      f"{seq_set.size} sequences.", file=sys.stderr)
                done = self._final_checks_arrays(overlapper, queries, futs,
                                                 index, seq_set,
                                                 overlap_size)
                if not done:
                    self._final_checks_matches(overlapper, queries, futs,
                                               num_query_seqs, index,
                                               seq_set, overlap_size)
                first_sequence = next_first
                round_no += 1
                if ckpt:
                    seq_set.save_state(ckpt,
                                       {"first_sequence": first_sequence,
                                        "round": round_no})
                # settle the speculative prep against the flags the final
                # checks just set, then dispatch it
                prepped_next = None
                if next_sub is not None:
                    snap, sub_first, prep_fut = next_sub
                    prepped_next = prep_fut.result()
                    if (prepped_next is not None
                            and sum(seq_set.ignore) != snap):
                        prepped_next = prep_round(sub_first)
                futs = (prepped_next[1].dispatch_find(prepped_next[2])
                        if prepped_next else None)
                next_sub = (submit_prep(prepped_next[3])
                            if prepped_next else None)
                prepped = prepped_next

    def _final_checks_matches(self, overlapper, queries, futs,
                              num_query_seqs, index, seq_set, overlap_size):
        """The final checks from ``SeedMatch`` objects: the path the JAX
        command takes without the native toolchain."""
        matches = overlapper.collect_find(queries, futs)
        query_results = [[] for _ in range(num_query_seqs)]
        for m in matches:
            query_results[m.query_id].append(m)
        q_hits = sum(1 for r in query_results if len(r) > 1)
        print(f"Total {len(matches)} hits across {q_hits} overlaps.",
              file=sys.stderr)
        work = [r for r in query_results if len(r) > 1]
        if not self._final_checks_native(work, index, seq_set,
                                         overlap_size):
            for results in work:
                self._final_check(results, index, seq_set, overlap_size)
