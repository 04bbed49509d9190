"""The overlap command (ref: commands/overlap.go:22-233) on the torch
engine: batched all-vs-all rounds with PAF output.

Same flags, defaults, help text, round loop and stderr lines as
``downpore_tpu``'s overlap command: each round indexes every read and
queries the edges of the next batch of reads, with ``-checkpoint`` save
and resume at round boundaries, the next round's host prep speculated on a
worker thread (redone when the round's final checks moved the ignore
flags), and the array-direct native final check.  The rounds run on the
port's ``Overlapper``.  The JAX command's cross-round shape
plan is dropped: it pins only compiled shapes, never an output.
``-data_parallel true`` and ``-seed_shards N`` build a device grid
(``parallel.make_mesh``) where the JAX command builds its mesh.
"""
from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

from .framework import Command, parse_bool, parse_float, parse_int


class OverlapCommand(Command):
    name = "overlap"

    def __init__(self):
        super().__init__(
            ["overlap_size", "k", "num_seeds", "seed_batch_size",
             "chunk_size", "query_batch_size", "min_hits", "num_workers",
             "input", "seed_values", "himem", "data_parallel",
             "checkpoint", "seed_shards"],
            ["1000", "10", "15", "100000", "10000", "20000", "0.25", "4",
             "", "", "true", "false", "", "1"],
            ["Size of overlap to search for in bases",
             "Number of bases in each seed",
             "Minimum number of seeds to generate for each overlap query",
             "Maximum total unique seeds to use in each query batch "
             "(the reference defaults to 10000 to bound host RAM; TPU "
             "HBM affords 10x, so the default here is 100000 — fewer, "
             "bigger rounds mean fewer whole-file re-index passes)",
             "Size to chop long reads into for querying against, in bases",
             "Maximum number of queries per batch (if max seeds not reached)",
             "Minimum proportion of seeds that must match each query",
             "Number of worker threads to spawn",
             "Fasta/fastq input file",
             "File containing values to use during seed selection.",
             "Whether to cache all reads in memory",
             "Shard query batches across all attached devices "
             "(jax.sharding data mesh; the chunk index replicates)",
             "Snapshot file for checkpoint/resume at round boundaries",
             "Shard the chunk seed index over this many devices (with "
             "-data_parallel: a data x seed mesh; retrieval counts merge "
             "with a psum over the seed axis)"])

    def run(self, args):
        from .. import resolve_device
        from ..io import SequenceSet
        from ..overlap import QUERY_EDGES, Overlapper
        from ..seeds import SeedIndex
        from ..utils import kmer_occurrences, score_seed_values

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
        mesh = None
        n_seed = parse_int(args["seed_shards"])
        if parse_bool(args["data_parallel"]) or n_seed > 1:
            from ..parallel import make_mesh
            mesh = make_mesh(n_seed=n_seed)
        print(f"Counting all {k}-mers in the input...", file=sys.stderr)
        # grids of several devices count on them (sharded bincount)
        counts = kmer_occurrences(seq_set.get_sequences(), k, mesh=mesh)
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
        shape_plan = {}  # one plan for the whole job: the pair budget

        def prep_round(first):
            """Host half of a round: fresh index, query prep, chunk
            indexing.  Independent of earlier rounds' results."""
            index = SeedIndex(k)
            overlapper = Overlapper(index, chunk_size, overlap_size,
                                    num_seeds, hit_fraction, mesh=mesh,
                                    device=device, shape_plan=shape_plan)
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
        """The final checks from ``SeedMatch`` objects: the path without
        the native toolchain."""
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

    def _rc_lut(self, index):
        """seed -> RC-seed table, or None if any twin is missing."""
        import numpy as np
        from ..core.sequence import kmer_reverse_complement_vec
        km = index.seed_kmers_of(np.arange(index.num_seeds))
        rc_lut = index.kmer_map[
            kmer_reverse_complement_vec(km, index.k)].astype(np.int32)
        if rc_lut.size and rc_lut.min() < 0:
            return None
        return rc_lut

    def _emit_records(self, recs, seq_set, overlap_size):
        """Apply native final-check records: ignores + PAF lines."""
        for rows in recs:
            if len(rows) <= 1:
                continue
            id0, rc0, off0, len0, seqlen0, _ = rows[0]
            if seqlen0 <= overlap_size * 2:
                seq_set.set_ignore(id0, True)
            for pid in range(1, len(rows)):
                pi, rci, start, length, seq_len, ident = rows[pid]
                rc = "-" if rci != rc0 else "+"
                end = start + length
                covered = max(overlap_size, end - start)
                if seq_len * 9 <= covered * 10:
                    seq_set.set_ignore(pi, True)
                print(f"{seq_set.get_name(id0)}\t{seqlen0}\t{off0}\t"
                      f"{off0 + len0}\t{rc}\t{seq_set.get_name(pi)}\t"
                      f"{seq_len}\t{start}\t{end}\t{ident}\t0\t255")

    def _final_checks_arrays(self, overlapper, queries, futs, index,
                             seq_set, overlap_size):
        """Fetch-to-check fast path: the round's matches go from the
        device fetch straight into the native final check as flat
        arrays — no SeedMatch objects (they were rebuilt into arrays by
        the native marshaling anyway).  Returns False to fall back."""
        import os
        if futs is None or os.environ.get("DOWNPORE_TPU_PY_FINAL") == "1":
            return False
        from .. import native
        if native.load() is None:
            return False
        import numpy as np
        rc_lut = self._rc_lut(index)
        if rc_lut is None:
            return False
        arrs = overlapper.collect_find_arrays(queries, futs)
        if arrs is None:
            print("Total 0 hits across 0 overlaps.", file=sys.stderr)
            return True
        qids, rcq, ia, ib, ma_flat, mb_flat, m_off = arrs
        hits = len(qids)
        # contiguous qid runs (entries of one qid are adjacent)
        starts = np.flatnonzero(
            np.concatenate([[True], qids[1:] != qids[:-1]]))
        run_len = np.diff(np.concatenate([starts, [hits]]))
        q_hits = int((run_len > 1).sum())
        print(f"Total {hits} hits across {q_hits} overlaps.",
              file=sys.stderr)
        keep_run = run_len > 1
        if not keep_run.any():
            return True
        rowmask = np.repeat(keep_run, run_len)
        bl = np.diff(m_off)
        pairmask = np.repeat(rowmask, bl)
        bl2 = bl[rowmask]
        m_off2 = np.zeros(len(bl2) + 1, np.int64)
        np.cumsum(bl2, out=m_off2[1:])
        kept_len = run_len[keep_run]
        chk_off = np.zeros(len(kept_len) + 1, np.int64)
        np.cumsum(kept_len, out=chk_off[1:])
        table, _ = native.marshal_seq_table(
            overlapper.seq_objects(queries))
        recs = native.final_check_round_arrays(
            table, chk_off, ia[rowmask],
            ib[rowmask] + np.int32(len(queries)), rcq[rowmask],
            ma_flat[pairmask], mb_flat[pairmask], m_off2, rc_lut,
            index.k)
        if recs is None:
            return False
        self._emit_records(recs, seq_set, overlap_size)
        return True

    def _final_checks_native(self, work, index, seq_set, overlap_size):
        """Run a round's final checks through the native
        ``final_check_round``; returns False (caller falls back to the
        Python path) when the toolchain or a complete RC seed mapping is
        unavailable."""
        import os
        if not work or os.environ.get("DOWNPORE_TPU_PY_FINAL") == "1":
            return False
        from .. import native
        if native.load() is None:
            return False
        k = index.k
        rc_lut = self._rc_lut(index)
        if rc_lut is None:
            return False          # partial RC twin set: python path
        uniq = []
        seen = set()
        for ms in work:
            for m in ms:
                for s in (m.seq_a, m.seq_b):
                    if id(s) not in seen:
                        seen.add(id(s))
                        uniq.append(s)
        table, ids = native.marshal_seq_table(uniq)
        recs = native.final_check_round(work, table, ids, rc_lut, k)
        if recs is None:
            return False
        self._emit_records(recs, seq_set, overlap_size)
        return True

    def _final_check(self, results, index, seq_set, overlap_size):
        """PAF emission + full-coverage ignore
        (ref: commands/overlap.go:197-233)."""
        lines, ignores = self._final_check_compute(results, index,
                                                   seq_set, overlap_size)
        for sid in ignores:
            seq_set.set_ignore(sid, True)
        for ln in lines:
            print(ln)

    def _final_check_compute(self, results, index, seq_set, overlap_size):
        """Side-effect-free final check: returns (PAF lines, read ids to
        ignore) so a worker pool can run checks concurrently."""
        from ..overlap import build_consensus
        k = index.k
        lines = []
        ignores = []
        contig = build_consensus(index, results)
        if contig is None or len(contig.parts) <= 1:
            return lines, ignores
        if contig.seq_lengths[0] <= overlap_size * 2:
            ignores.append(contig.parts[0])
        query_start = contig.offsets[0]
        query_end = query_start + contig.lengths[0]
        for i, part in enumerate(contig.parts[1:]):
            pid = i + 1
            rc = "+"
            start = contig.offsets[pid]
            end = start + contig.lengths[pid]
            if contig.reverse_complement[0] != contig.reverse_complement[pid]:
                rc = "-"
            covered = max(overlap_size, end - start)
            if contig.seq_lengths[pid] * 9 <= covered * 10:
                ignores.append(part)
            ident, _ = contig.matches[i].bases_covered(k)
            lines.append(
                f"{seq_set.get_name(contig.parts[0])}\t"
                f"{contig.seq_lengths[0]}\t{query_start}\t{query_end}\t"
                f"{rc}\t{seq_set.get_name(part)}\t"
                f"{contig.seq_lengths[pid]}\t{start}\t{end}\t{ident}\t"
                f"0\t255")
        return lines, ignores
