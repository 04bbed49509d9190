"""PAF and SAM readers + CIGAR utilities
(ref: util/formats/paf.go, util/formats/sam.go)."""
from __future__ import annotations

import re
from typing import Iterator, List, Optional, Tuple


class Overlap:
    """One PAF record (ref: util/formats/paf.go:13-26)."""
    __slots__ = ("name_a", "name_b", "length_a", "length_b", "start_a",
                 "start_b", "end_a", "end_b", "reverse_complement",
                 "matches", "length", "quality")

    def __init__(self, **kw):
        for f in self.__slots__:
            setattr(self, f, kw.get(f))


def _to_int(s: str) -> int:
    try:
        return int(s)
    except ValueError:
        return 0


def load_paf(filename: str) -> Iterator[Overlap]:
    """(ref: util/formats/paf.go:33-52)"""
    with open(filename) as f:
        for line in f:
            tokens = line.split()
            if len(tokens) < 12:
                continue
            yield Overlap(
                name_a=tokens[0], name_b=tokens[5],
                length_a=_to_int(tokens[1]), length_b=_to_int(tokens[6]),
                start_a=_to_int(tokens[2]), end_a=_to_int(tokens[3]),
                start_b=_to_int(tokens[7]), end_b=_to_int(tokens[8]),
                reverse_complement=tokens[4] == "-",
                matches=_to_int(tokens[9]), length=_to_int(tokens[10]),
                quality=_to_int(tokens[11]))


class SAMAlignment:
    """(ref: util/formats/sam.go:11-18)"""
    __slots__ = ("name_a", "name_b", "cigar", "start_a", "start_b",
                 "reverse_complement")

    def __init__(self, name_a, name_b, cigar, start_a, start_b, rc):
        self.name_a = name_a
        self.name_b = name_b
        self.cigar = cigar
        self.start_a = start_a
        self.start_b = start_b
        self.reverse_complement = rc


def load_sam(filename: str) -> Iterator[SAMAlignment]:
    """(ref: util/formats/sam.go:20-47)"""
    with open(filename) as f:
        for line in f:
            if not line or line[0] == "@":
                continue
            tokens = line.split()
            if len(tokens) < 6 or tokens[5] == "*":
                continue
            flags = _to_int(tokens[1])
            yield SAMAlignment(tokens[0], tokens[2], Cigar(tokens[5]), 0,
                               _to_int(tokens[3]) - 1, (flags & 0x10) != 0)


_CIGAR_RE = re.compile(r"(\d+)([MIDNSHPX=])")


class Cigar(str):
    def ops(self) -> List[Tuple[int, str]]:
        return [(int(n), op) for n, op in _CIGAR_RE.findall(self)]

    def count_matches(self, k: int) -> int:
        """k-mers fully inside M runs (ref: util/formats/sam.go:49-69)."""
        count = 0
        for n, op in self.ops():
            if op == "M" and n >= k:
                count += n - k + 1
        return count

    def length(self) -> Tuple[int, int]:
        """(query length, reference length) consumed
        (ref: util/formats/sam.go:72-94)."""
        a = b = 0
        for n, op in self.ops():
            if op in "MX=":
                a += n
                b += n
            elif op in "DN":
                b += n
            elif op in "IHS":
                a += n
        return a, b

    def kmer_matches(self, k: int) -> Iterator[Tuple[int, int]]:
        """(query_index, ref_index) pairs of matching k-mers
        (ref: util/formats/sam.go:98-133)."""
        seq_i = ref_i = 0
        for n, op in self.ops():
            if op == "M" and n >= k:
                for m in range(n - k + 1):
                    yield seq_i + m, ref_i + m
            if op in "MX=":
                seq_i += n
                ref_i += n
            elif op in "DN":
                ref_i += n
            elif op in "IHS":
                seq_i += n
