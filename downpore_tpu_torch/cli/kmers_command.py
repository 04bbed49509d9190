"""The kmers command: seed-value training from SAM alignments
(ref: commands/kmers.go).

Counts, per k-mer, how often reads match the reference at aligned
positions (good) vs mismatch (bad), converts accuracies to ranks, and
writes heatmap files correlating accuracy with lexicographic order, mean
quality and forward/RC balance.  k > 8 switches to the sparse-map variant
(ref: commands/kmers.go:104-210).
"""
from __future__ import annotations

import math
import sys
from collections import defaultdict

import numpy as np

from .framework import Command, parse_int

IGNORE = 1 << 62


def rankify(values: np.ndarray, indices: np.ndarray):
    """Replace values by dense ranks, dropping flagged indices
    (ref: commands/kmers.go:507-530)."""
    order = np.argsort(values, kind="stable")
    values = values[order]
    indices = indices[order]
    ranks = np.zeros(len(values))
    rank = 0
    prev = None
    for i in range(len(values)):
        if indices[i] == IGNORE:
            continue
        if prev is None or values[i] != prev:
            rank += 1
            prev = values[i]
        ranks[i] = rank
    order = np.argsort(indices, kind="stable")
    ranks = ranks[order]
    indices = indices[order]
    back = len(indices)
    while back > 0 and indices[back - 1] == IGNORE:
        back -= 1
    return ranks[:back], indices[:back]


def write_heatmap(size: int, xs, ys, indices, name: str):
    """2D rank heatmap + correlation (ref: commands/kmers.go:533-597)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    keep = np.asarray(indices) != IGNORE
    x = xs[keep]
    y = ys[keep]
    if len(x) == 0:
        return
    max_x = x.max()
    max_y = y.max()
    dx = x - x.mean()
    dy = y - y.mean()
    den = math.sqrt((dx * dx).sum()) * math.sqrt((dy * dy).sum())
    corr = (dx * dy).sum() / den if den else 0.0
    print("Correlation: ", corr, file=sys.stderr)
    hm = np.zeros((size, size), dtype=np.int64)
    xi = np.clip((x * (size - 1) / max(max_x, 1e-9) + 0.5).astype(int), 0, size - 1)
    yi = np.clip((y * (size - 1) / max(max_y, 1e-9) + 0.5).astype(int), 0, size - 1)
    np.add.at(hm, (xi, yi), 1)
    with open(name, "w") as f:
        for xx in range(size):
            for yy in range(size):
                f.write(f"{xx} {yy} {hm[xx, yy]}\n")


class KmersCommand(Command):
    name = "kmers"

    def __init__(self):
        super().__init__(
            ["input", "alignment", "reference", "training",
             "training_alignment", "training_ref", "k", "map_size",
             "num_workers"],
            ["", "", "", "", "", "", "10", "100", "4"],
            ["Reads input file", "SAM input file", "Reference fasta file",
             "Training input file", "SAM training file",
             "Training reference fasta file", "K-mer size",
             "Dimensions for heatmaps", "Number of worker threads to use"])

    def run(self, args):
        import sys
        for req in ("input", "alignment", "reference"):
            if not args.get(req):
                print(f"kmers requires -{req} (fastq reads, a SAM "
                      "alignment and the reference fasta)",
                      file=sys.stderr)
                raise SystemExit(1)
        k = parse_int(args["k"])
        map_size = parse_int(args["map_size"])
        if k > 8:
            self._do_long(k, args)
            return
        size = 4 ** k
        good = np.zeros(size, dtype=np.int64)
        bad = np.zeros(size, dtype=np.int64)
        good_q = np.zeros(size, dtype=np.int64)
        bad_q = np.zeros(size, dtype=np.int64)
        from ..io import SequenceSet
        ref_set = SequenceSet(args["reference"], ignore_quality=True)
        ref = str(next(iter(ref_set.get_sequences())))
        self._count(args["input"], args["alignment"], ref, k, good, bad,
                    good_q, bad_q)
        indices = np.arange(size, dtype=np.int64)
        total = good + bad
        accuracies = np.zeros(size)
        usable = total > 2
        accuracies[usable] = good[usable] / total[usable]
        indices[~usable] = IGNORE
        accuracies, indices = rankify(accuracies, indices)
        values = indices.astype(np.float64)
        base = args["alignment"]
        write_heatmap(map_size, values, accuracies, indices,
                      f"{base}_lex_{k}.txt")
        # quality heatmap
        q_vals = np.zeros(len(indices))
        ok = indices != IGNORE
        idx = indices[ok]
        q_vals[ok] = (good_q[idx] + bad_q[idx]) / np.maximum(
            1, good[idx] + bad[idx])
        q_vals, indices = rankify(q_vals, indices)
        write_heatmap(map_size, q_vals, accuracies[: len(q_vals)], indices,
                      f"{base}_qual_{k}.txt")
        # rc-balance heatmap (ref: commands/kmers.go:291-306)
        from ..utils.kmers import _rc_table
        rc = _rc_table(k)
        b_vals = np.zeros(len(indices))
        ok = indices != IGNORE
        idx = indices[ok]
        fwd = (good[idx] + bad[idx]).astype(np.float64)
        bwd = (good[rc[idx]] + bad[rc[idx]]).astype(np.float64)
        ratio = np.abs(0.5 - fwd / np.maximum(fwd + bwd, 1e-9))
        b_vals[ok] = 0.5 - ratio
        b_vals, indices = rankify(b_vals, indices)
        write_heatmap(map_size, b_vals, accuracies[: len(b_vals)], indices,
                      f"{base}_bal_{k}.txt")
        # emit trained seed values (KMER accuracy-rank lines, consumable by
        # -seed_values; the reference's commented-out block,
        # ref: commands/kmers.go:456-473)
        from ..core.sequence import kmer_string
        out_name = f"{base}_kmers_{k}.txt"
        with open(out_name, "w") as f:
            for i, index in enumerate(indices):
                if index != IGNORE and accuracies[i] > 0:
                    f.write(f"{kmer_string(int(index), k)} "
                            f"{accuracies[i]}\n")
        print("Wrote", out_name, file=sys.stderr)

    def _count(self, input_file, alignment_file, ref, k, good, bad,
               good_q, bad_q):
        """Per-alignment good/bad k-mer counting
        (ref: commands/kmers.go:629-677)."""
        from ..io import SequenceSet
        from ..io.formats import load_sam
        seq_set = SequenceSet(input_file, cache=True)
        ids = {}
        for s in seq_set.get_sequences():
            ids[s.get_name()] = s.id
        prev_seq = None
        from ..core.sequence import kmer_value
        for a in load_sam(alignment_file):
            if a.name_a == prev_seq or a.name_a not in ids:
                continue
            prev_seq = a.name_a
            seq = next(iter(seq_set.get_n_sequences_from(ids[a.name_a], 1)))
            original = str(seq)
            if a.reverse_complement:
                seq = seq.reverse_complement()
            s = str(seq)
            q = seq.quality
            prev_spos = 0
            for seq_index, ref_index in a.cigar.kmer_matches(k):
                ref_index += a.start_b
                if prev_spos == 0:
                    prev_spos = seq_index
                s_kmer = kmer_value(
                    original[len(original) - k - seq_index:
                             len(original) - seq_index]) \
                    if len(original) - k - seq_index >= 0 else None
                if s_kmer is not None:
                    if (ref_index + k <= len(ref)
                            and ref[ref_index:ref_index + k]
                            == s[seq_index:seq_index + k]):
                        good[s_kmer] += 1
                        if q is not None:
                            good_q[s_kmer] += int(q[seq_index + k // 2])
                    else:
                        bad[s_kmer] += 1
                        if q is not None:
                            bad_q[s_kmer] += int(q[seq_index + k // 2])
                while prev_spos < seq_index:
                    if len(s) - k - prev_spos >= 0:
                        s_kmer = kmer_value(
                            original[len(s) - k - prev_spos:
                                     len(s) - prev_spos])
                        bad[s_kmer] += 1
                        if q is not None:
                            bad_q[s_kmer] += int(q[prev_spos + k // 2])
                    prev_spos += 1
                prev_spos = seq_index + 1

    def _do_long(self, k, args):
        """Sparse-map variant for k > 8 (ref: commands/kmers.go:340-383)."""
        from ..io import SequenceSet
        ref_set = SequenceSet(args["reference"], ignore_quality=True)
        ref = str(next(iter(ref_set.get_sequences())))
        data = self._long_counts(args["input"], args["alignment"], ref, k)
        training = {}
        if args.get("training"):
            t_ref = str(next(iter(SequenceSet(
                args["training_ref"], ignore_quality=True).get_sequences())))
            training = self._long_counts(args["training"],
                                         args["training_alignment"], t_ref, k)
        self._long_correlations(data, training, args["alignment"], k)

    def _long_counts(self, input_file, alignment_file, ref, k):
        """(ref: commands/kmers.go:104-210)"""
        from ..io import SequenceSet
        from ..io.formats import load_sam
        from ..core.sequence import kmer_value
        seq_set = SequenceSet(input_file)
        ids = {s.get_name(): s.id for s in seq_set.get_sequences()}
        data = defaultdict(lambda: [0, 0, 0])  # good, bad, quality
        prev_seq = None
        for a in load_sam(alignment_file):
            if a.name_a == prev_seq or a.name_a not in ids:
                continue
            prev_seq = a.name_a
            seq = next(iter(seq_set.get_n_sequences_from(ids[a.name_a], 1)))
            original = str(seq)
            if a.reverse_complement:
                seq = seq.reverse_complement()
            s = str(seq)
            q = seq.quality
            prev_spos = 0
            for seq_index, ref_index in a.cigar.kmer_matches(k):
                ref_index += a.start_b
                if prev_spos == 0:
                    prev_spos = seq_index
                if len(original) - k - seq_index >= 0:
                    s_kmer = kmer_value(
                        original[len(original) - k - seq_index:
                                 len(original) - seq_index])
                    d = data[s_kmer]
                    if (ref_index + k <= len(ref)
                            and ref[ref_index:ref_index + k]
                            == s[seq_index:seq_index + k]):
                        d[0] += 1
                    else:
                        d[1] += 1
                    if q is not None:
                        d[2] += int(q[seq_index + k // 2])
                while prev_spos < seq_index:
                    if len(s) - k - prev_spos >= 0:
                        s_kmer = kmer_value(original[len(s) - k - prev_spos:
                                                     len(s) - prev_spos])
                        d = data[s_kmer]
                        d[1] += 1
                        if q is not None:
                            d[2] += int(q[prev_spos + k // 2])
                    prev_spos += 1
                prev_spos = seq_index + 1
        return {km: d for km, d in data.items() if d[0] + d[1] > 2}

    def _long_correlations(self, data, training, alignment_file, k):
        """(ref: commands/kmers.go:212-288)"""
        from ..core.sequence import kmer_reverse_complement
        n = len(data)
        accuracies = np.zeros(n)
        qualities = np.zeros(n)
        rc_ratios = np.zeros(n)
        lex = np.zeros(n)
        trained = np.zeros(n)
        indices = np.arange(n, dtype=np.int64)
        for i, (kmer, d) in enumerate(data.items()):
            total = d[0] + d[1]
            lex[i] = kmer
            accuracies[i] = d[0] / total
            qualities[i] = d[2] / total
            rc = kmer_reverse_complement(kmer, k)
            if rc in data:
                rd = data[rc]
                ratio = abs(0.5 - total / (total + rd[0] + rd[1]))
                rc_ratios[i] = 0.5 - ratio
            if kmer in training:
                td = training[kmer]
                if td[0] + td[1] > 2:
                    trained[i] = td[0] / (td[0] + td[1])
        map_size = {10: 100, 11: 75}.get(k, 50)
        accuracies, indices = rankify(accuracies, indices)
        lex, indices = rankify(lex, indices)
        base = alignment_file
        write_heatmap(map_size, lex, accuracies, indices,
                      f"{base}_lex_{k}.txt")
        qualities, indices = rankify(qualities, indices)
        write_heatmap(map_size, qualities, accuracies, indices,
                      f"{base}_qual_{k}.txt")
        rc_ratios, indices = rankify(rc_ratios, indices)
        write_heatmap(map_size, rc_ratios, accuracies, indices,
                      f"{base}_bal_{k}.txt")
        trained, indices2 = rankify(trained, indices)
        indices2[trained == 0] = IGNORE
        write_heatmap(map_size, trained, accuracies, indices2,
                      f"{base}_train_{k}.txt")
