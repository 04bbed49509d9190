"""Overlap graph: consensus nodes linked by their shared reads
(ref: overlap/graph.go — work-in-progress in the reference and not wired
into any command; this port implements the functioning parts: node/read
bookkeeping, arc generation between adjacent nodes with RC colouring,
bridgeable-gap discovery and GFA output).
"""
from __future__ import annotations

from typing import List, Optional

from ..core.sequence import Sequence
from .combine import SeedContig


class SequenceArc:
    """Connection between a contig Node and a read SequenceNode
    (ref: overlap/graph.go:23-30)."""
    __slots__ = ("sequence", "node", "approximate", "offset", "length", "rc")

    def __init__(self, sequence, node, approximate, offset, length, rc):
        self.sequence = sequence
        self.node = node
        self.approximate = approximate
        self.offset = offset
        self.length = length
        self.rc = rc


class Node:
    """One consensus contig and its member reads
    (ref: overlap/graph.go:12-20)."""
    __slots__ = ("id", "colour", "sequences", "consensus", "in_arcs",
                 "out_arcs")

    def __init__(self, id: int, consensus):
        self.id = id
        self.colour = 0
        self.sequences: List[SequenceArc] = []
        self.consensus = consensus
        self.in_arcs: List[Arc] = []
        self.out_arcs: List[Arc] = []

    def is_adjacent(self, other: "Node") -> bool:
        return any(a.to is other for a in self.out_arcs)

    def reverse(self):
        """(ref: overlap/graph.go:252-263)"""
        self.consensus = self.consensus.reverse_complement()
        if self.colour != 0:
            self.colour = rc_colour(self.colour)
        for arc in self.sequences:
            arc.rc = not arc.rc


class SequenceNode:
    """A read with its ordered list of contig nodes
    (ref: overlap/graph.go:33-45)."""
    __slots__ = ("id", "colour", "length", "is_rc", "is_not_rc", "nodes",
                 "covered", "covered_front", "covered_back")

    def __init__(self, id: int, length: int):
        self.id = id
        self.colour = 0
        self.length = length
        self.is_rc = 0
        self.is_not_rc = 0
        self.nodes: List[SequenceArc] = []
        self.covered = False
        self.covered_front = False
        self.covered_back = False


class Arc:
    """(ref: overlap/graph.go:48-54)"""
    __slots__ = ("from_node", "to", "length", "from_rc", "to_rc")

    def __init__(self, from_node, to, length, from_rc, to_rc):
        self.from_node = from_node
        self.to = to
        self.length = length
        self.from_rc = from_rc
        self.to_rc = to_rc


def rc_colour(colour: int) -> int:
    return colour ^ 1


def is_rc_colour(colour: int) -> bool:
    return colour & 1 == 0


class OverlapGraph:
    def __init__(self, max_seqs: int):
        self.nodes: List[Node] = []
        self.sequences: List[Optional[SequenceNode]] = [None] * max_seqs
        self.next_colour = 2

    # -- construction ---------------------------------------------------
    def add_node(self, contig: SeedContig, consensus) -> Node:
        """(ref: overlap/graph.go:307-351)"""
        n = Node(len(self.nodes), consensus)
        self.nodes.append(n)
        for i, s in enumerate(contig.parts):
            seq = self.sequences[s]
            if seq is None:
                seq = SequenceNode(s, contig.seq_lengths[i])
                self.sequences[s] = seq
            arc = SequenceArc(seq, n, contig.approximate[i],
                              contig.offsets[i], contig.lengths[i],
                              contig.reverse_complement[i])
            n.sequences.append(arc)
            if arc.offset < arc.length:
                seq.covered_front = True
                seq.covered = seq.covered_back
            if arc.offset + arc.length * 2 > seq.length:
                seq.covered_back = True
                seq.covered = seq.covered_front
            # insert in offset order
            index = len(seq.nodes) - 1
            while index >= 0 and seq.nodes[index].offset >= arc.offset:
                index -= 1
            seq.nodes.insert(index + 1, arc)
        return n

    def _add_arc(self, from_node: Node, to: Node, size: int,
                 from_rc: bool, to_rc: bool):
        """Arcs kept in distance order (ref: overlap/graph.go:112-134)."""
        arc = Arc(from_node, to, size, from_rc, to_rc)
        from_node.out_arcs.append(arc)
        from_node.out_arcs.sort(key=lambda a: a.length)
        to.in_arcs.append(arc)
        to.in_arcs.sort(key=lambda a: a.length)

    def generate_arcs(self):
        """Walk each read's node chain, colouring connected components and
        adding arcs between adjacent non-overlapping nodes
        (ref: overlap/graph.go:561-588 + colour at 589-693)."""
        for seq in self.sequences:
            if seq is not None and seq.colour == 0:
                self._colour_component(seq)
        for seq in self.sequences:
            if seq is None:
                continue
            prev = None
            for arc in seq.nodes:
                if prev is not None and arc.node is not prev.node:
                    gap = arc.offset - (prev.offset + prev.length)
                    if gap >= 0 and not prev.node.is_adjacent(arc.node):
                        if prev.rc:
                            self._add_arc(arc.node, prev.node, gap,
                                          arc.rc, prev.rc)
                        else:
                            self._add_arc(prev.node, arc.node, gap,
                                          prev.rc, arc.rc)
                prev = arc

    def _colour_component(self, seq: SequenceNode):
        """Propagate RC-consistent colours across the connected component
        reachable from ``seq`` (behavioural port of graph.go:589-693)."""
        first = self.next_colour
        second = rc_colour(first)
        if is_rc_colour(first):
            first, second = second, first
        self.next_colour = max(first, second) + 1
        stack = [(seq, first)]
        while stack:
            s, colour = stack.pop()
            if s.colour != 0:
                continue
            s.colour = colour
            for arc in s.nodes:
                node = arc.node
                node_colour = rc_colour(colour) if arc.rc else colour
                if node.colour == 0:
                    node.colour = node_colour
                    for sa in node.sequences:
                        nxt = sa.sequence
                        if nxt.colour == 0:
                            c = rc_colour(node_colour) if sa.rc \
                                else node_colour
                            stack.append((nxt, c))

    # -- queries --------------------------------------------------------
    def get_covered_sequences(self) -> List[bool]:
        """Reads with nodes at both ends (used by the reference's correct
        pipeline sketch)."""
        out = [False] * len(self.sequences)
        for i, s in enumerate(self.sequences):
            if s is not None and s.covered:
                out[i] = True
        return out

    def get_bridgable_contigs(self, min_coverage: int) -> List[SeedContig]:
        """SeedContigs for gaps between adjacent nodes with enough shared
        spanning reads (ref: overlap/graph.go:513-561)."""
        bridges = []
        used_before = [False] * len(self.nodes)
        used_after = [False] * len(self.nodes)
        for s in self.sequences:
            if s is None or not s.nodes:
                continue
            prev = s.nodes[0]
            for arc in s.nodes[1:]:
                reversed_ = prev.rc
                already = ((not reversed_ and (used_after[prev.node.id]
                                               or used_before[arc.node.id]))
                           or (reversed_ and (used_after[arc.node.id]
                                              or used_before[prev.node.id])))
                if not already and arc.offset > prev.offset + prev.length:
                    left = {a.sequence.id for a in prev.node.sequences
                            if not a.approximate}
                    right = {a.sequence.id for a in arc.node.sequences
                             if not a.approximate}
                    shared = left & right
                    if len(shared) > min_coverage:
                        bridges.append(self._build_contig(
                            shared, prev.node, arc.node, prev.rc))
                        if prev.rc:
                            used_before[prev.node.id] = True
                            used_after[arc.node.id] = True
                        else:
                            used_after[prev.node.id] = True
                            used_before[arc.node.id] = True
                prev = arc
        return bridges

    def _build_contig(self, shared, left_node: Node, right_node: Node,
                      reversed_: bool) -> SeedContig:
        """(ref: overlap/graph.go:468-510)"""
        edge_buffer = 20
        parts, rcs, offsets, lengths, approx, seq_lens = \
            [], [], [], [], [], []
        for sid in sorted(shared):
            i = next(idx for idx, a in enumerate(left_node.sequences)
                     if a.sequence.id == sid)
            j = next(idx for idx, a in enumerate(right_node.sequences)
                     if a.sequence.id == sid)
            la = left_node.sequences[i]
            ra = right_node.sequences[j]
            parts.append(sid)
            seq_lens.append(la.sequence.length)
            if reversed_:
                off = ra.offset + ra.length - edge_buffer
                length = la.offset - off + edge_buffer * 2
            else:
                off = la.offset + la.length - edge_buffer
                length = ra.offset - off + edge_buffer * 2
            offsets.append(off)
            lengths.append(length)
            rcs.append(la.rc)
            approx.append(False)
        return SeedContig(None, parts, rcs, offsets, lengths, approx,
                          seq_lens, None)

    # -- output ---------------------------------------------------------
    def gfa(self) -> str:
        """GFA 1.0 text (ref: overlap/graph.go:840-867)."""
        lines = ["H\tVN:Z:1.0"]
        for n in self.nodes:
            if n is not None:
                lines.append(f"S\t{n.id}_{n.colour}\t*\t"
                             f"LN:i:{len(n.consensus)}")
        for n in self.nodes:
            if n is None:
                continue
            for a in n.out_arcs:
                if a.from_rc != a.to_rc:
                    if a.from_rc:
                        lines.append(f"L\t{a.from_node.id}_"
                                     f"{a.from_node.colour}\t-\t{a.to.id}_"
                                     f"{a.to.colour}\t+\t{a.length}M")
                    else:
                        lines.append(f"L\t{a.from_node.id}_"
                                     f"{a.from_node.colour}\t+\t{a.to.id}_"
                                     f"{a.to.colour}\t-\t{a.length}M")
                else:
                    lines.append(f"L\t{a.from_node.id}_"
                                 f"{a.from_node.colour}\t+\t{a.to.id}_"
                                 f"{a.to.colour}\t+\t{a.length}M")
        return "\n".join(lines) + "\n"
