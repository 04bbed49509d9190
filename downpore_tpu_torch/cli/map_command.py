"""The map command (ref: commands/map.go:17-116) on the torch engine.

Same flags, defaults and help text as ``downpore_tpu``'s map command,
plus the trim command's ``-profile DIR``: a ``torch.profiler`` Chrome
trace, ``DIR/trace.json``, with the program's spans in it
(``utils.metrics``).  ``-data_parallel true`` and ``-seed_shards N``
build a device grid (``parallel.make_mesh``) where the JAX command builds
its mesh."""
from __future__ import annotations

import sys

from .framework import Command, parse_bool, parse_int


class MapCommand(Command):
    name = "map"

    def __init__(self):
        super().__init__(
            ["input", "reference", "circular", "k", "query_size",
             "min_length", "chunk_size", "seed_rate", "num_workers",
             "data_parallel", "seed_shards", "profile"],
            ["", "", "true", "11", "1000", "500", "10000", "40", "4",
             "false", "1", ""],
            ["Fasta/fastq input file",
             "A fasta file containing a reference sequence to align against",
             "Whether the reference genome is circular",
             "Length of seeds in bases",
             "The number of bases to query at a time",
             "The minimum sequence size to generate queries from",
             "The number of bases for reference index chunks",
             "The maximum number of bases between seeds in the reference",
             "The number of worker process to use for mapping",
             "Shard query batches across all attached devices "
             "(jax.sharding data mesh; the reference index replicates)",
             "Shard the seed index over this many devices (with "
             "-data_parallel: a data x seed mesh; retrieval counts merge "
             "with a psum over the seed axis)",
             "Directory to write a JAX profiler trace to"])

    def run(self, args):
        from ..io import SequenceSet
        from ..mapping import Mapper
        from ..utils import (kmer_occurrences, score_seed_values,
                             start_profiler, stop_profiler)
        from ..utils.metrics import span

        k = parse_int(args["k"])
        ref_set = SequenceSet(args["reference"])
        reference = next(iter(ref_set.get_sequences()))
        mesh = None
        n_seed = parse_int(args["seed_shards"])
        if parse_bool(args["data_parallel"]) or n_seed > 1:
            from ..parallel import make_mesh
            mesh = make_mesh(n_seed=n_seed)
        # grids of several devices count on them (sharded bincount)
        counts = kmer_occurrences(ref_set.get_sequences(), k, mesh=mesh)
        values = score_seed_values(counts, k)
        print("K-mer counting complete. Preparing to start indexing and "
              "querying...", file=sys.stderr)
        mapper = Mapper(reference, parse_bool(args["circular"]), k, values,
                        parse_int(args["seed_rate"]),
                        parse_int(args["query_size"]),
                        parse_int(args["chunk_size"]), mesh=mesh)
        seq_set = SequenceSet(args["input"],
                              min_length=parse_int(args["min_length"]))
        mapped = multiple = unmapped = total = 0
        batch_size = 8192  # big batches keep the device fed

        def flush(batch):
            nonlocal mapped, multiple, unmapped, total
            results = mapper.map_batch(batch)
            with span("map.write"):
                lines = []
                for maps in results:
                    if maps:
                        for m in maps:
                            lines.append(mapper.as_string(m))
                        if len(maps) == 1:
                            mapped += 1
                        else:
                            multiple += 1
                        total += len(maps)
                    else:
                        unmapped += 1
                if lines:                  # one buffered write per batch
                    lines.append("")
                    sys.stdout.write("\n".join(lines))

        # parse-ahead: the next batch parses on a worker thread while the
        # current batch maps
        from concurrent.futures import ThreadPoolExecutor
        it = seq_set.get_sequences()

        def take_batch():
            b = []
            for seq in it:
                b.append(seq)
                if len(b) >= batch_size:
                    break
            return b

        if args.get("profile"):
            start_profiler(args["profile"], mapper.device)
        try:
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(take_batch)
                while True:
                    with span("map.parse_wait"):
                        batch = fut.result()
                    if not batch:
                        break
                    fut = ex.submit(take_batch)
                    flush(batch)
        finally:
            if args.get("profile"):
                stop_profiler()
        print("Uniquely mapped:", mapped, file=sys.stderr)
        print("Multiple mappings:", multiple, file=sys.stderr)
        print("total:", total, file=sys.stderr)
        print("Unmapped:", unmapped, file=sys.stderr)
