"""The trim command (ref: commands/trim.go:16-50) on the torch engine.

Same flags, defaults, help text and flow as ``downpore_tpu``'s trim
command: determine the adapters present, trim read edges, split reads on
interior adapters, then write the reads to stdout or demultiplex them.
``-profile DIR`` writes a ``torch.profiler`` trace to DIR.
``-data_parallel true`` raises until the multi-GPU port.
"""
from __future__ import annotations

import sys

from downpore_tpu.cli import trim_command as _ref
from downpore_tpu.cli.framework import parse_bool, parse_int


class TrimCommand(_ref.TrimCommand):
    def run(self, args):
        from downpore_tpu.io import SequenceSet
        from .. import resolve_device
        from ..trim import load_trimmer
        from ..utils import StageTimer, start_profiler, stop_profiler

        if parse_bool(args["data_parallel"]):
            raise NotImplementedError(
                "-data_parallel is not ported yet: ROADMAP.md, 'Multi-GPU'")
        device = resolve_device()
        trimmer = load_trimmer(args["front_adapters"], args["back_adapters"],
                               parse_int(args["k"]), device=device)
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
