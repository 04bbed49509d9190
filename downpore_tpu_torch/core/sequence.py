"""2-bit sequence core: encoding, reverse complement, k-mer scans.

Host-side representation is a numpy ``uint8`` array of 2-bit base codes
(A=0, C=1, G=2, T=3) — one code per base.  This is the analogue of the
reference's ``byteSequence``/``packedSequence`` pair
(ref: sequence/sequence.go:31-53); on the device there is no reason to
bit-pack on the host because device transfers ship whole ``uint8`` lanes and the scan
kernels operate on unpacked codes.  All per-base loops are vectorized numpy
(the role the reference gives its SSSE3/BSWAP assembly in
sequence/asm_amd64.s); a faithful scalar oracle for each op lives in
``tests/`` following the reference's dual-implementation test pattern
(ref: sequence/sequence_test.go:42).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# ((b>>1) ^ ((b&4)>>2)) & 3 maps ASCII acgtACGT -> 0..3 and tolerates other
# letters (ref: sequence/sequence.go:59).  Precompute as a 256-entry LUT so
# encoding a read is a single numpy gather.
_ENCODE_LUT = np.empty(256, dtype=np.uint8)
for _b in range(256):
    _ENCODE_LUT[_b] = ((_b >> 1) ^ ((_b & 4) >> 2)) & 3

_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(seq, out: np.ndarray = None) -> np.ndarray:
    """Encode an ASCII string/bytes of bases into 2-bit codes (uint8).

    ``out`` reuses a caller buffer — fresh multi-MB result allocations
    fault pages at pathological cost in some environments."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    if out is not None:
        return np.take(_ENCODE_LUT, raw, out=out[: raw.shape[0]])
    return _ENCODE_LUT[raw]


def decode_bases(codes: np.ndarray) -> str:
    """Decode 2-bit codes back into an ACGT string."""
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8) & 3].tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array: complement is ``code ^ 3``
    (ref: sequence/sequence.go:134-148)."""
    return (codes[::-1] ^ 3).astype(np.uint8)


def rolling_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All overlapping k-mer values of the sequence as int32, length
    ``len(codes) - k + 1`` (empty if shorter than k).

    Equivalent to repeated ``NextKmer`` (ref: sequence/sequence.go:444) but
    vectorized: a k-term shifted sum, O(k) numpy passes.
    """
    codes = np.asarray(codes)
    dtype = np.int64 if 2 * k > 31 else np.int32
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.empty(0, dtype=dtype)
    out = np.zeros(n, dtype=dtype)
    c = codes.astype(dtype)
    for j in range(k):
        out |= c[j : j + n] << (2 * (k - 1 - j))
    return out


def short_kmers(codes: np.ndarray, k: int, collapse: bool) -> np.ndarray:
    """k-mer list (k<=8) as uint16, optionally dropping a k-mer equal to its
    predecessor (homopolymer-ish collapse), mirroring ``ShortKmers``
    (ref: sequence/sequence.go:456-504)."""
    kmers = rolling_kmers(codes, k)
    if kmers.size == 0:
        return kmers.astype(np.uint16)
    if collapse:
        keep = np.empty(kmers.shape[0], dtype=bool)
        keep[0] = True
        np.not_equal(kmers[1:], kmers[:-1], out=keep[1:])
        kmers = kmers[keep]
    return kmers.astype(np.uint16)


def count_seed_kmers(codes: np.ndarray, k: int, seed_table: np.ndarray,
                     up_to: Optional[int] = None) -> int:
    """Number of positions whose k-mer is flagged in ``seed_table``
    (bool[4**k]); the vectorized analogue of ``packedCountKmers``
    (ref: sequence/asm_amd64.s:81).  ``up_to`` caps the count."""
    if k <= 15 and seed_table.dtype == np.bool_:
        from .. import native
        if native.load() is not None:
            c = native.count_seed_kmers(np.ascontiguousarray(codes), k,
                                        seed_table.view(np.uint8), up_to)
            if c is not None:
                return min(c, up_to) if up_to is not None else c
    kmers = rolling_kmers(codes, k)
    count = int(seed_table[kmers].sum())
    if up_to is not None and count > up_to:
        return up_to
    return count


def write_segments(codes: np.ndarray, k: int, seed_table: np.ndarray):
    """Gapped-seed extraction: returns ``(gaps, kmers)`` where ``kmers`` are
    the flagged k-mers in order and ``gaps[i]`` is the number of bases
    between the end of seed i-1 and the start of seed i (may be negative for
    overlapping seeds); ``gaps`` has one trailing entry with the bases after
    the final seed.  Mirrors ``packedWriteSegments``
    (ref: sequence/asm_amd64.s:206, scalar at sequence/sequence.go:308-324).

    Dispatches to the native one-pass scan when available (~10x less
    host time than the k-pass numpy form; this is the per-sequence hot
    loop of overlap/correct query prep and index build)."""
    if k <= 15 and seed_table.dtype == np.bool_:
        from .. import native
        if native.load() is not None:
            out = native.write_segments(np.ascontiguousarray(codes), k,
                                        seed_table.view(np.uint8))
            if out is not None:
                return out
    kmers = rolling_kmers(codes, k)
    hits = np.flatnonzero(seed_table[kmers]) if kmers.size else np.empty(0, dtype=np.int64)
    seeds = kmers[hits] if hits.size else np.empty(0, dtype=np.int32)
    gaps = np.empty(hits.shape[0] + 1, dtype=np.int32)
    if hits.size:
        gaps[0] = hits[0]
        gaps[1:-1] = np.diff(hits) - k
        gaps[-1] = len(codes) - (hits[-1] + k)
    else:
        gaps[0] = len(codes)
    return gaps, seeds.astype(np.int32)


def kmer_value(s: str) -> int:
    """ASCII k-mer -> integer value (ref: sequence/sequence.go:520)."""
    v = 0
    for ch in s.encode("ascii"):
        v = (v << 2) | int(_ENCODE_LUT[ch])
    return v


def kmer_string(value: int, k: int) -> str:
    """Integer k-mer -> ASCII (ref: sequence/sequence.go:530)."""
    out = bytearray(k)
    for i in range(k - 1, -1, -1):
        out[i] = _DECODE_LUT[value & 3]
        value >>= 2
    return out.decode("ascii")


def kmer_reverse_complement_vec(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized ``kmer_reverse_complement`` over an int array (k numpy
    passes instead of a Python loop per k-mer — the scalar form was a
    hot spot of overlap query prep)."""
    km = np.asarray(kmers, dtype=np.int64).copy()
    rc = np.zeros_like(km)
    for _ in range(k):
        rc = (rc << 2) | ((km ^ 3) & 3)
        km >>= 2
    return rc


def kmer_reverse_complement(kmer: int, k: int) -> int:
    """Reverse complement of an integer k-mer (ref: seeds/sequence.go:125)."""
    rc = 0
    for _ in range(k):
        rc = (rc << 2) | ((kmer ^ 3) & 3)
        kmer >>= 2
    return rc


class Sequence:
    """A read (or subsequence of one) with 2-bit codes and optional quality.

    Tracks ``offset``/``inset`` — bases trimmed from the front/back of the
    parent read — exactly like the reference's ``Sequence`` interface
    (ref: sequence/sequence.go:7-29), so coordinates can always be mapped
    back to the original read.  Slicing is zero-copy.
    """

    __slots__ = ("codes", "quality", "id", "offset", "inset", "name")

    def __init__(self, codes: np.ndarray, id: int = -1,
                 name: Optional[str] = None,
                 quality: Optional[np.ndarray] = None,
                 offset: int = 0, inset: int = 0):
        self.codes = codes
        self.quality = quality
        self.id = id
        self.name = name
        self.offset = offset
        self.inset = inset

    @classmethod
    def from_string(cls, seq: str, id: int = -1, name: Optional[str] = None,
                    quality: Optional[np.ndarray] = None) -> "Sequence":
        return cls(encode_bases(seq), id=id, name=name, quality=quality)

    def __len__(self) -> int:
        return self.codes.shape[0]

    def __str__(self) -> str:
        return decode_bases(self.codes)

    def get_name(self) -> str:
        return self.name if self.name is not None else str(self.id)

    def subsequence(self, start: int, end: int) -> "Sequence":
        """Zero-copy slice; offset/inset updated
        (ref: sequence/sequence.go:342-370)."""
        end = min(end, len(self))
        q = self.quality[start:end] if self.quality is not None else None
        return Sequence(self.codes[start:end], id=self.id, name=self.name,
                        quality=q, offset=self.offset + start,
                        inset=self.inset + len(self) - end)

    def reverse_complement(self) -> "Sequence":
        q = self.quality[::-1] if self.quality is not None else None
        return Sequence(reverse_complement(self.codes), id=self.id,
                        name=self.name, quality=q,
                        offset=self.inset, inset=self.offset)

    def append(self, other: "Sequence", id: int = -1,
               name: Optional[str] = None) -> "Sequence":
        codes = np.concatenate([self.codes, other.codes])
        q = None
        if self.quality is not None and other.quality is not None:
            q = np.concatenate([self.quality, other.quality])
        s = Sequence(codes, id=id, name=name, quality=q,
                     offset=self.offset, inset=other.inset)
        return s

    # k-mer scans -----------------------------------------------------
    def kmer_at(self, index: int, k: int) -> int:
        v = 0
        for c in self.codes[index : index + k]:
            v = (v << 2) | int(c)
        return v

    def kmers(self, k: int) -> np.ndarray:
        return rolling_kmers(self.codes, k)

    def short_kmers(self, k: int, collapse: bool) -> np.ndarray:
        return short_kmers(self.codes, k, collapse)

    def count_kmers(self, k: int, seed_table: np.ndarray,
                    up_to: Optional[int] = None) -> int:
        return count_seed_kmers(self.codes, k, seed_table, up_to)

    def write_segments(self, k: int, seed_table: np.ndarray):
        return write_segments(self.codes, k, seed_table)
