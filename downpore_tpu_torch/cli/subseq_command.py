"""The subseq command: stdin-driven random-access subsequence server
(ref: commands/subseq.go:32-102).  Each input line is
``start end rc [name]``; circular wrap when start > end."""
from __future__ import annotations

import sys

from .framework import Command, parse_bool, parse_int


class SubSeqCommand(Command):
    name = "subseq"

    def __init__(self):
        super().__init__(
            ["input", "num_workers", "himem"],
            ["", "4", "false"],
            ["Fasta/fastq input file",
             "Number of worker threads to use",
             "Whether to cache reads in memory"])

    def run(self, args):
        from ..io import SequenceSet
        seq_set = SequenceSet(args["input"], cache=parse_bool(args["himem"]),
                              ignore_quality=True)
        ids = {}
        for seq in seq_set.get_sequences():
            name = seq.get_name()
            ids[name] = seq.id
            if " " in name:
                ids[name.split(" ")[0]] = seq.id
        for line in sys.stdin:
            tokens = line.strip().split(" ")
            if len(tokens) < 3:
                continue
            start = parse_int(tokens[0])
            end = parse_int(tokens[1])
            rc = parse_bool(tokens[2])
            name = tokens[3] if len(tokens) > 3 else ""
            seq = None
            if name:
                if name in ids:
                    seq = next(iter(seq_set.get_n_sequences_from(ids[name], 1)),
                               None)
                else:
                    print(name, "not found in", args["input"])
            else:
                seq = next(iter(seq_set.get_n_sequences_from(0, 1)), None)
            if seq is None:
                print("No sequence found.")
                continue
            if name and not seq.get_name().startswith(name):
                print("Invalid name:", seq.get_name(), " != ", name, "\n")
                continue
            print(f">{seq.get_name()}_{start}")
            if start > end:  # circular wrap
                sub1 = seq.subsequence(start, len(seq))
                sub2 = seq.subsequence(0, end)
                if rc:
                    print(str(sub2.reverse_complement())
                          + str(sub1.reverse_complement()))
                else:
                    print(str(sub1) + str(sub2))
            else:
                end = min(end, len(seq))
                sub = seq.subsequence(start, end)
                print(sub.reverse_complement() if rc else sub)
