"""The consensus and align commands (ref: commands/consensus.go,
commands/align.go)."""
from __future__ import annotations

import sys

from .framework import Command, parse_int


def _choose_measure(args, allow_matrix=True):
    from ..align import (SimpleMeasure, EditDistanceMeasure, MatrixMeasure)
    from ..align.model import Model

    k = parse_int(args["k"])
    initial_gap = 5
    cost_threshold = 200
    if args.get("model"):
        mod = Model(args["model"], False)
        return mod.k, mod, 2, cost_threshold
    if allow_matrix and args.get("matrix"):
        from ..utils import load_confusion_matrix
        matrix, mk = load_confusion_matrix(args["matrix"])
        return mk, MatrixMeasure(mk, matrix), initial_gap, cost_threshold
    if k == 1:
        return 1, SimpleMeasure(1), initial_gap, cost_threshold
    if k <= 3:
        return 3, SimpleMeasure(3), initial_gap, cost_threshold
    if k == 4:
        return 4, SimpleMeasure(4), initial_gap, cost_threshold
    if k == 5:
        return 5, SimpleMeasure(5), initial_gap, cost_threshold
    # the reference falls back to 5-mer edit distance for k >= 6
    return 5, EditDistanceMeasure(5, mismatch=3, insert=4, delete=1), \
        initial_gap, cost_threshold


def _load_kmer_seqs(args, k):
    from ..io import SequenceSet
    kmer_seqs = []
    seq_set = SequenceSet(args["input"])
    for seq in seq_set.get_sequences():
        kmer_seqs.append(seq.short_kmers(k, False))
    non_rc = len(kmer_seqs)
    if args.get("rc_input"):
        seq_set = SequenceSet(args["rc_input"])
        for seq in seq_set.get_sequences():
            kmer_seqs.append(seq.short_kmers(k, False))
    rc = [i >= non_rc for i in range(len(kmer_seqs))]
    return kmer_seqs, rc


class ConsensusCommand(Command):
    name = "consensus"

    def __init__(self):
        super().__init__(
            ["input", "rc_input", "model", "matrix", "k"],
            ["", "", "", "", "5"],
            ["Fasta/fastq input file",
             "Additional input file containing sequences from "
             "reverse-complement reads",
             "Model file containing current levels",
             "K-mer confusion matrix to use in place of a model",
             "K-mer size for alignment when no model specified"])

    def run(self, args):
        from ..align import DTWAligner
        from ..core.sequence import kmer_string
        k, measure, initial_gap, cost_threshold = _choose_measure(args)
        kmer_seqs, rc = _load_kmer_seqs(args, k)
        measure.set_sequences(kmer_seqs, rc)
        dtw = DTWAligner(16, initial_gap, measure, False, cost_threshold, k)
        kmers, costs, _ = dtw.global_consensus()
        costs_string = "." * k
        votes_string = "." * k
        space_string = "." * k
        out = []
        for kmer, cost in zip(kmers, costs):
            dc = cost.cost_delta
            if dc > 0:
                dc = 1 + dc // 30
                if dc >= 10:
                    dc = 9
            sp = cost.state_space_size // 2
            if sp > 7:
                sp = 9 if sp > 50 else 8
            costs_string += str(dc)
            votes_string += str(int(cost.exact_fraction * 9.99))
            space_string += str(sp)
            if not out:
                out.append(kmer_string(int(kmer), k))
            else:
                out.append(kmer_string(int(kmer), k)[-1])
        print("".join(out))
        print(costs_string)
        print(votes_string)
        print(space_string)


class AlignCommand(Command):
    name = "align"

    def __init__(self):
        super().__init__(
            ["input", "rc_input", "model", "k", "reference"],
            ["", "", "", "5", ""],
            ["Fasta/fastq input file",
             "Additional input file containing sequences from "
             "reverse-complement reads",
             "Model file containing current levels",
             "K-mer size for alignment when no model specified",
             "(optional) A fasta file containing a reference sequence to "
             "align against"])

    def run(self, args):
        from ..align import DTWAligner
        from ..core.sequence import kmer_string
        from ..io import SequenceSet
        k, measure, initial_gap, cost_threshold = _choose_measure(
            args, allow_matrix=False)
        kmer_seqs, rc = _load_kmer_seqs(args, k)
        ref = None
        if args.get("reference"):
            seq_set = SequenceSet(args["reference"])
            seq = next(iter(seq_set.get_sequences()))
            ref = seq.short_kmers(k, False)
        measure.set_sequences(kmer_seqs, rc)
        dtw = DTWAligner(16, initial_gap, measure, False, cost_threshold, k)
        if ref is None:
            kmers, costs, positions = dtw.global_alignment()
        else:
            kmers, costs, positions = dtw.global_alignment_to(ref)
        self._pretty_print(kmers, costs, positions, kmer_seqs, k)

    def _pretty_print(self, kmers, costs, positions, kmer_seqs, k):
        """Aligned MSA rows (ref: commands/align.go:100-190)."""
        from ..core.sequence import kmer_string
        prev_pos = [-1] * len(kmer_seqs)
        prev_stay = [False] * len(kmer_seqs)
        lines = [""] * (len(kmer_seqs) + 1)
        first = True
        for kmer, cs, pos in zip(kmers, costs, positions):
            ks = kmer_string(int(kmer), k)
            mid = ks[len(ks) // 2: len(ks) // 2 + 1]
            skips = 1
            for i, p in enumerate(pos):
                sk = p - prev_pos[i]
                if sk == 2 and prev_stay[i]:
                    sk = 1
                    next_kmer = kmer_string(int(kmer_seqs[i][p]), k)
                    prev = next_kmer[len(next_kmer) // 2 - 1:
                                     len(next_kmer) // 2]
                    lines[i + 1] = lines[i + 1][:-1] + prev
                if sk > skips:
                    skips = sk
            for _ in range(1, skips):
                lines[0] += "."
            if first:
                lines[0] = ks[: len(ks) // 2 + 1]
            else:
                lines[0] += mid
            for i, p in enumerate(pos):
                sk = p - prev_pos[i]
                if sk == 2 and prev_stay[i]:
                    sk = 1
                prev_stay[i] = sk == 0 and p > 0
                if sk <= 0:
                    lines[i + 1] += "." * skips
                    continue
                bases = skips
                next_kmer = kmer_string(int(kmer_seqs[i][p]), k)
                while sk > len(next_kmer) // 2 + 1:
                    src = 0 if p - sk < 0 else p - sk
                    old = kmer_string(int(kmer_seqs[i][src]), k)[
                        len(next_kmer) // 2: len(next_kmer) // 2 + 1]
                    lines[i + 1] += old
                    bases -= 1
                    sk -= 1
                mid_s = next_kmer[len(next_kmer) // 2 + 1 - sk:
                                  len(next_kmer) // 2 + 1]
                bases -= len(mid_s)
                while bases > 0:
                    lines[i + 1] += "."
                    bases -= 1
                if first:
                    lines[i + 1] = next_kmer[: len(next_kmer) // 2 + 1]
                else:
                    lines[i + 1] += mid_s
            prev_pos = list(pos)
            first = False
        for line in lines:
            print(line)
