"""Streaming fasta/fastq I/O with re-readable trim/ignore state.

Mirrors the reference ``SequenceSet`` contract (ref: sequence/seqio.go:21-43):
the first pass over the file records byte offsets/lengths/names per record;
later passes seek and re-read, applying accumulated front/back trims and
skipping ignored reads, so trimming never rewrites the input.  Unlike the
reference (which assumes single-line records and mutates stored byte
offsets, ref: sequence/seqio.go:378-386) this implementation records spans
per record — multi-line fasta works — and keeps trims as explicit fields
applied at read time; the observable behaviour is identical.

Gzip input is handled by Python's ``gzip`` (forward-only seek by
re-decompression, the same strategy as util/gzip.go:38-62).
"""
from __future__ import annotations

import gzip
import os
import sys
from typing import Iterator, List, Optional, TextIO

import numpy as np

from ..core.sequence import Sequence, encode_bases, decode_bases


def _open(filename: str, for_index: bool = False):
    if filename.endswith(".gz"):
        return gzip.open(filename, "rb")
    return open(filename, "rb")


def _mean_quality(q: Optional[np.ndarray]) -> int:
    """The reference's 'median' quality is actually a mean, default 20
    (ref: sequence/seqio.go:331-342)."""
    if q is None or len(q) == 0:
        return 20
    return int(q.astype(np.int64).sum() // len(q))


class SequenceSet:
    def __init__(self, filename: str, min_length: int = 0,
                 cache: bool = False, ignore_quality: bool = False):
        self.filename = filename
        self.min_length = min_length
        self.cache = cache
        self.ignore_quality = ignore_quality
        self.is_fastq = False

        self.spans: List[List] = []     # per record: list of (offset, length)
        self.q_spans: List[List] = []   # fastq quality line spans
        self.lengths: List[int] = []    # untrimmed base length - trims
        self.names: List[str] = []
        self.ignore: List[bool] = []
        self.front_trim: List[int] = []
        self.back_trim: List[int] = []
        self.quality: List[int] = []    # mean quality per read
        self.bases = 0
        self._cached: List[Optional[Sequence]] = []
        self._extras: List[Sequence] = []
        self._extra_names: List[str] = []
        self._indexed = False

    # -- first-pass index ---------------------------------------------
    def _build_index(self):
        if self._indexed:
            return
        if self._try_native_index():
            return
        with _open(self.filename) as f:
            offset = 0
            pending_name: Optional[str] = None
            cur_spans: List = []
            cur_len = 0

            def finish_record():
                nonlocal cur_spans, cur_len, pending_name
                if pending_name is None or not cur_spans:
                    cur_spans = []
                    cur_len = 0
                    return
                if cur_len + 1 >= self.min_length:  # ref: len(buf) >= minLen
                    self.spans.append(cur_spans)
                    self.q_spans.append([])
                    self.lengths.append(cur_len)
                    self.names.append(pending_name)
                    self.ignore.append(False)
                    self.front_trim.append(0)
                    self.back_trim.append(0)
                    self.quality.append(20)
                    self.bases += cur_len
                cur_spans = []
                cur_len = 0

            line = f.readline()
            while line:
                c = line[:1]
                if c == b">":
                    finish_record()
                    pending_name = line[1:].decode().strip()
                elif c == b"@":
                    finish_record()
                    self.is_fastq = True
                    pending_name = line[1:].decode().strip()
                    offset += len(line)
                    seq_line = f.readline()
                    seq_len = len(seq_line.rstrip(b"\r\n"))
                    seq_off = offset
                    offset += len(seq_line)
                    plus = f.readline()
                    if not plus.startswith(b"+"):
                        raise ValueError(
                            f"Invalid fastq format (on + line): {plus[:40]!r}")
                    offset += len(plus)
                    q_off = offset
                    q_line = f.readline()
                    offset += len(q_line)
                    if seq_len + 1 >= self.min_length:
                        self.spans.append([(seq_off, seq_len)])
                        self.q_spans.append([(q_off, seq_len)])
                        self.lengths.append(seq_len)
                        self.names.append(pending_name)
                        self.ignore.append(False)
                        self.front_trim.append(0)
                        self.back_trim.append(0)
                        self.quality.append(20)
                        self.bases += seq_len
                    pending_name = None
                    line = f.readline()
                    continue
                else:
                    stripped = line.rstrip(b"\r\n")
                    if stripped:
                        cur_spans.append((offset, len(stripped)))
                        cur_len += len(stripped)
                offset += len(line)
                line = f.readline()
            finish_record()
        self._cached = [None] * len(self.spans)
        self._indexed = True

    def _try_native_index(self) -> bool:
        """Index plain single-line fastq via the native scanner (mmap +
        C++ record walk); returns False to fall back to the python path
        (gz, fasta, malformed input)."""
        if self.filename.endswith(".gz"):
            return False
        try:
            import mmap
            from .. import native
            if native.load() is None:
                return False
            with open(self.filename, "rb") as f:
                head = f.read(1)
                if head != b"@":
                    return False
                f.seek(0)
                buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                res = native.index_fastq(buf)
                if res is None:
                    return False
                seq_off, seq_len, name_off, name_len, qual_off = res
                for i in range(len(seq_off)):
                    if seq_len[i] + 1 < self.min_length:
                        continue
                    self.spans.append([(int(seq_off[i]), int(seq_len[i]))])
                    self.q_spans.append([(int(qual_off[i]),
                                          int(seq_len[i]))])
                    self.lengths.append(int(seq_len[i]))
                    self.names.append(
                        buf[name_off[i]:name_off[i] + name_len[i]]
                        .decode("ascii", "replace"))
                    self.ignore.append(False)
                    self.front_trim.append(0)
                    self.back_trim.append(0)
                    self.quality.append(20)
                    self.bases += int(seq_len[i])
                buf.close()
            self.is_fastq = True
            self._cached = [None] * len(self.spans)
            self._indexed = True
            return True
        except Exception:
            return False

    # -- reading -------------------------------------------------------
    class _SegReader:
        """Rolling segment buffer for sequential record streaming: one
        file read + one base-encode per ~32 MB segment, then records are
        zero-copy slices — ``_read_record``'s per-record seek/read/encode
        (2-4 syscalls + an allocation each) dominated the trim pipeline's
        host side at ~60 us/read."""
        SEG = 32 << 20

        def __init__(self, sset, f):
            self.s = sset
            self.f = f
            self.lo = self.hi = 0
            self.raw = b""
            self.codes = None

        def _ensure(self, off: int, end: int):
            self.f.seek(off)
            data = self.f.read(max(self.SEG, end - off))
            self.lo, self.hi = off, off + len(data)
            self.raw = data
            # records are zero-copy views of this array, so it must stay
            # immutable — a fresh array per segment (NOT a reused buffer,
            # which would corrupt sequences held across segments)
            self.codes = encode_bases(data)

        def record(self, rid: int) -> Sequence:
            s = self.s
            spans = s.spans[rid]
            if len(spans) != 1:        # split records: rare, direct path
                return s._read_record(self.f, rid)
            off, ln = spans[0]
            q = s.q_spans[rid] if s.is_fastq else None
            qoff = q[0][0] if q else None
            end = (qoff + ln) if qoff is not None else (off + ln)
            if off < self.lo or end > self.hi:
                self._ensure(off, end)
            codes = self.codes[off - self.lo : off - self.lo + ln]
            quality = None
            if qoff is not None and not s.ignore_quality:
                quality = np.frombuffer(self.raw, np.uint8, count=ln,
                                        offset=qoff - self.lo) - 33
            ft, bt = s.front_trim[rid], s.back_trim[rid]
            seq = Sequence(codes, id=rid, name=s.names[rid],
                           quality=quality)
            s.quality[rid] = _mean_quality(quality)
            if ft or bt:
                seq = seq.subsequence(ft, len(seq) - bt)
            return seq

    def _read_record(self, f, rid: int) -> Sequence:
        parts = []
        for off, ln in self.spans[rid]:
            f.seek(off)
            parts.append(f.read(ln))
        raw = b"".join(parts)
        codes = encode_bases(raw)
        quality = None
        if self.is_fastq and self.q_spans[rid] and not self.ignore_quality:
            qparts = []
            for off, ln in self.q_spans[rid]:
                f.seek(off)
                qparts.append(f.read(ln))
            qraw = np.frombuffer(b"".join(qparts), dtype=np.uint8)
            if qraw.shape[0] == codes.shape[0]:
                quality = qraw - 33
        ft, bt = self.front_trim[rid], self.back_trim[rid]
        seq = Sequence(codes, id=rid, name=self.names[rid], quality=quality)
        self.quality[rid] = _mean_quality(quality)
        if ft or bt:
            seq = seq.subsequence(ft, len(seq) - bt)
        return seq

    def get_sequences(self, start: int = 0,
                      max_n: Optional[int] = None) -> Iterator[Sequence]:
        """Stream non-ignored sequences with trims applied, then extras
        (ref: sequence/seqio.go:106-276)."""
        self._build_index()
        sent = 0
        limit = max_n if max_n is not None else float("inf")
        with _open(self.filename) as f:
            reader = self._SegReader(self, f)
            for rid in range(start, len(self.spans)):
                if sent >= limit:
                    return
                if self.ignore[rid]:
                    continue
                if self.cache and self._cached[rid] is not None:
                    base = self._cached[rid]
                    ft, bt = self.front_trim[rid], self.back_trim[rid]
                    seq = base.subsequence(ft, len(base) - bt) if (ft or bt) else base
                    seq.id = rid
                    yield seq
                else:
                    seq = reader.record(rid)
                    if self.cache:
                        full = seq
                        if self.front_trim[rid] or self.back_trim[rid]:
                            full = self._read_full(f, rid)
                        self._cached[rid] = full
                    yield seq
                sent += 1
        n_records = len(self.spans)
        for i, seq in enumerate(self._extras):
            rid = n_records + i
            if rid >= len(self.ignore):
                self.ignore.append(False)
                self.names.append(self._extra_names[i])
                self.lengths.append(len(seq))
                self.front_trim.append(0)
                self.back_trim.append(0)
                self.quality.append(_mean_quality(seq.quality))
            if sent >= limit or self.ignore[rid]:
                continue
            seq.id = rid
            yield seq
            sent += 1

    def _read_full(self, f, rid: int) -> Sequence:
        ft, bt = self.front_trim[rid], self.back_trim[rid]
        self.front_trim[rid] = 0
        self.back_trim[rid] = 0
        try:
            return self._read_record(f, rid)
        finally:
            self.front_trim[rid] = ft
            self.back_trim[rid] = bt

    def get_n_sequences_from(self, index: int, n: int) -> Iterator[Sequence]:
        return self.get_sequences(start=index, max_n=n)

    def get_sequences_by_id(self, ids) -> Iterator[Sequence]:
        wanted = set(int(i) for i in ids)
        old = self.ignore
        self.ignore = [i not in wanted for i in range(len(old))]
        try:
            yield from self.get_sequences()
        finally:
            self.ignore = old

    # -- metadata ------------------------------------------------------
    def get_ids_by_length(self):
        """Non-ignored ids sorted by ascending length
        (ref: sequence/seqio.go:360-373)."""
        self._build_index()
        ids = [i for i in range(len(self.lengths)) if not self.ignore[i]]
        lengths = [self.lengths[i] for i in ids]
        order = np.argsort(np.asarray(lengths), kind="stable")
        return [ids[i] for i in order], [lengths[i] for i in order]

    def get_length(self, rid: int) -> int:
        return self.lengths[rid]

    def get_bases(self) -> int:
        return self.bases

    def get_name(self, rid: int) -> str:
        return self.names[rid] if rid < len(self.names) else str(rid)

    def set_name(self, rid: int, name: str):
        self.names[rid] = name

    def get_median_quality(self, rid: int) -> int:
        return self.quality[rid]

    @property
    def size(self) -> int:
        self._build_index()
        return len(self.spans)

    # -- trim state ----------------------------------------------------
    def set_ignore(self, rid: int, ignore: bool):
        self.ignore[rid] = ignore

    def set_front_trim(self, rid: int, trim: int):
        self.lengths[rid] -= trim - self.front_trim[rid]
        self.front_trim[rid] = trim

    def set_back_trim(self, rid: int, trim: int):
        self.lengths[rid] -= trim - self.back_trim[rid]
        self.back_trim[rid] = trim

    def get_front_trim(self, rid: int) -> int:
        return self.front_trim[rid]

    def get_back_trim(self, rid: int) -> int:
        return self.back_trim[rid]

    def add_sequence(self, seq: Sequence, name: str):
        """Extra in-memory sequences appended after the file's reads
        (split halves; ref: sequence/seqio.go:396)."""
        self._extras.append(seq)
        self._extra_names.append(name)

    # -- checkpoint/resume ---------------------------------------------
    # The reference has no in-process checkpointing; its trims are
    # re-readable offsets (ref: sequence/seqio.go:378-386), which makes
    # the whole mutable state small enough to snapshot at batch/round
    # boundaries (SURVEY §5).
    def save_state(self, path: str, progress: Optional[dict] = None):
        """Snapshot trims/ignores/renames/extras plus a caller progress
        dict to a JSON file (atomic rename)."""
        import json
        import os
        self._build_index()
        n = len(self.spans)
        state = {
            "filename": self.filename,
            "names": self.names[:n],
            "ignore": self.ignore[:n],
            "front_trim": self.front_trim[:n],
            "back_trim": self.back_trim[:n],
            "extras": [[nm, str(s)]
                       for s, nm in zip(self._extras, self._extra_names)],
            "extra_ignore": self.ignore[n:n + len(self._extras)],
            "progress": progress or {},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def load_state(self, path: str) -> dict:
        """Restore a snapshot written by ``save_state``; returns the
        progress dict.  Refuses snapshots from a different input file."""
        import json
        with open(path) as f:
            state = json.load(f)
        if state.get("filename") != self.filename:
            raise ValueError(
                f"checkpoint is for {state.get('filename')!r}, "
                f"not {self.filename!r}")
        self._build_index()
        n = len(self.spans)
        self.names[:n] = state["names"]
        self.ignore[:n] = state["ignore"]
        # lengths track trims; reapply via the setters
        for rid, t in enumerate(state["front_trim"]):
            if t:
                self.set_front_trim(rid, t)
        for rid, t in enumerate(state["back_trim"]):
            if t:
                self.set_back_trim(rid, t)
        self._extras = []
        self._extra_names = []
        ex_ignore = state.get("extra_ignore", [])
        for i, (name, bases) in enumerate(state["extras"]):
            rid = n + i
            s = Sequence.from_string(bases, id=rid)
            self._extras.append(s)
            self._extra_names.append(name)
            # materialize bookkeeping so streaming sees restored flags
            self.ignore.append(bool(ex_ignore[i]) if i < len(ex_ignore)
                               else False)
            self.names.append(name)
            self.lengths.append(len(s))
            self.front_trim.append(0)
            self.back_trim.append(0)
            self.quality.append(20)
        return state.get("progress", {})

    # -- output --------------------------------------------------------
    def _format(self, seq: Sequence, full_names: bool) -> str:
        name = self.get_name(seq.id) if full_names else str(seq.id)
        if self.is_fastq and seq.quality is not None:
            q = (seq.quality + 33).astype(np.uint8).tobytes().decode("latin1")
            return f"@{name}\n{seq}\n+\n{q}\n"
        prefix = "@" if self.is_fastq else ">"
        if self.is_fastq:
            q = "I" * len(seq)
            return f"{prefix}{name}\n{seq}\n+\n{q}\n"
        return f">{name}\n{seq}\n"

    def write(self, out: TextIO, full_names: bool = True):
        """Re-read input, emitting trimmed non-ignored reads
        (ref: sequence/seqio.go:438-458).

        Fast path: main records are sliced at the BYTE level straight
        from the input file (trims are line-slice offsets), skipping
        Sequence construction and two code<->string translations per
        read — the re-emit was ~25%% of a GB-scale trim run.  Split
        extras go through the object path; himem (cache) keeps the
        object path to honour its no-re-read intent.  Output is
        byte-identical to the object path."""
        self._build_index()
        if not self.cache and self._write_fast(out, full_names):
            for seq in self._iter_extras():
                out.write(self._format(seq, full_names))
            return
        for seq in self.get_sequences():
            out.write(self._format(seq, full_names))

    def _write_fast(self, out: TextIO, full_names: bool) -> bool:
        with _open(self.filename) as f:
            pos = 0
            for rid in range(len(self.spans)):
                if self.ignore[rid]:
                    continue
                ft, bt = self.front_trim[rid], self.back_trim[rid]
                parts = []
                for off, ln in self.spans[rid]:
                    if off != pos:
                        f.seek(off)
                    parts.append(f.read(ln))
                    pos = off + ln
                sb = parts[0] if len(parts) == 1 else b"".join(parts)
                sb = sb[ft : len(sb) - bt]
                name = self.get_name(rid) if full_names else str(rid)
                if self.is_fastq:
                    qs = self.q_spans[rid]
                    if qs:
                        parts = []
                        for off, ln in qs:
                            if off != pos:
                                f.seek(off)
                            parts.append(f.read(ln))
                            pos = off + ln
                        qb = parts[0] if len(parts) == 1 else b"".join(parts)
                        qb = qb[ft : len(qb) - bt]
                    else:
                        qb = b"I" * len(sb)
                    out.write(f"@{name}\n{sb.decode('latin1')}\n+\n"
                              f"{qb.decode('latin1')}\n")
                else:
                    out.write(f">{name}\n{sb.decode('latin1')}\n")
        return True

    def _iter_extras(self):
        """Register + yield non-ignored split extras (the tail of
        ``get_sequences``)."""
        n_records = len(self.spans)
        for i, seq in enumerate(self._extras):
            rid = n_records + i
            if rid >= len(self.ignore):
                self.ignore.append(False)
                self.names.append(self._extra_names[i])
                self.lengths.append(len(seq))
                self.front_trim.append(0)
                self.back_trim.append(0)
                self.quality.append(_mean_quality(seq.quality))
            if self.ignore[rid]:
                continue
            seq.id = rid
            yield seq

    def demultiplex(self, out_path: str):
        """One output file per Barcode* name prefix; the barcode label is
        removed from the emitted name (ref: sequence/seqio.go:460-523)."""
        ext = ".fastq" if self.is_fastq else ".fasta"
        outputs = {}
        try:
            for seq in self.get_sequences():
                n = self.get_name(seq.id)
                if not n.startswith("Barcode"):
                    continue
                pos = n.find("_")
                if pos == -1:
                    continue
                label = n[:pos]
                if label not in outputs:
                    outputs[label] = open(os.path.join(out_path, label + ext), "w")
                self.set_name(seq.id, n[pos + 1:])
                outputs[label].write(self._format(seq, True))
        finally:
            for f in outputs.values():
                f.close()
