"""The trim command (ref: commands/trim.go:16-50) on the torch engine.

Same flags, defaults, help text and flow as ``downpore_tpu``'s trim
command: determine the adapters present, trim read edges, split reads on
interior adapters, then write the reads to stdout or demultiplex them.
``-profile DIR`` writes a ``torch.profiler`` trace to DIR.
``-data_parallel true`` builds a device grid (``parallel.make_mesh``)
where the JAX command builds its mesh.
"""
from __future__ import annotations

import sys

from .framework import Command, parse_bool, parse_int


class TrimCommand(Command):
    name = "trim"

    def __init__(self):
        super().__init__(
            ["input", "k", "chunk_size", "middle_threshold", "discard_middle",
             "check_reads", "adapter_threshold", "extra_end_trim",
             "extra_middle_trim", "tag_adapters", "verbosity",
             "front_adapters", "back_adapters", "num_workers", "himem",
             "demultiplex", "require_pairs", "determine_adapters",
             "data_parallel", "checkpoint", "profile"],
            ["", "6", "5000", "85", "false", "10000", "90", "5", "100",
             "true", "1", "", "", "4", "false", "", "false", "true",
             "false", "", ""],
            ["Fasta/fastq/gzip input file",
             "k-mer size to use when matching adapters",
             "Split long reads into chunks of this size when indexing",
             "% identity for matching adapters that split reads",
             "Whether to keep halves of split reads",
             "Number of reads to use to determine which adapters are present",
             "% identity required at check_adapters stage",
             "Number of bases to remove around adapters at read edges",
             "Number of bases to remove around read-splitting adapters",
             "Whether to add adapter names to output sequence names",
             "Level (0-2) of output to stderr",
             "Fasta/fastq file containing front adapters",
             "Fasta/fastq file containing back adapters",
             "Number of threads to use",
             "Whether to cache all reads in memory",
             "A path to demultiplex to, otherwise write sequences to stdout",
             "Whether front/back adapters with the same name must appear together",
             "Whether to use a fixed set of adapters or to search for those present",
             "Shard window batches across all attached devices "
             "(jax.sharding data mesh; adapter tables replicate)",
             "Snapshot file for checkpoint/resume at batch boundaries",
             "Directory to write a JAX profiler trace to"])

    def run(self, args):
        from .. import resolve_device
        from ..io import SequenceSet
        from ..trim import load_trimmer
        from ..utils import StageTimer, start_profiler, stop_profiler

        mesh = None
        if parse_bool(args["data_parallel"]):
            from ..parallel import make_mesh
            mesh = make_mesh()
        device = resolve_device()
        trimmer = load_trimmer(args["front_adapters"], args["back_adapters"],
                               parse_int(args["k"]), mesh=mesh,
                               device=device)
        seq_set = SequenceSet(args["input"], min_length=50,
                              cache=parse_bool(args["himem"]))
        trimmer.set_verbosity(parse_int(args["verbosity"]))
        if parse_bool(args["determine_adapters"]):
            trimmer.determine_adapters(seq_set, parse_int(args["check_reads"]),
                                       parse_int(args["adapter_threshold"]))
        trimmer.set_trim_params(
            parse_int(args["middle_threshold"]),
            parse_int(args["extra_end_trim"]),
            parse_int(args["extra_middle_trim"]),
            parse_int(args["chunk_size"]),
            not parse_bool(args["discard_middle"]),
            parse_bool(args["tag_adapters"]),
            parse_bool(args["require_pairs"]))
        timer = StageTimer(enabled=parse_int(args["verbosity"]) >= 1)
        if args.get("profile"):
            start_profiler(args["profile"], device)
        try:
            with timer.stage("trim"):
                trimmer.trim(seq_set,
                             checkpoint=args.get("checkpoint") or None,
                             timer=timer)
        finally:
            if args.get("profile"):
                stop_profiler()
        trimmer.print_stats()
        timer.report()
        print("Writing trimmed sequences...", file=sys.stderr)
        if args.get("demultiplex"):
            seq_set.demultiplex(args["demultiplex"])
        else:
            seq_set.write(sys.stdout, True)
