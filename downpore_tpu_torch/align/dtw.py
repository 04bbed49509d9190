"""Beam-search banded DTW consensus over k-mer sequences.

A faithful port of the reference engine (ref:
sequence/alignment/alignment.go): each beam state is a candidate consensus
k-mer holding, per input sequence, a 32-wide cost band over positions
(``offsets``), plus landmark bookkeeping — high-confidence anchor k-mers
that prune the beam and lock positions (alignment.go:67-72, 115-243).
Successor generation tries the four k-mer extensions, votes with
quality-decayed weights, detects homopolymer run-lengths at traceback and
recentres drifting bands.

The band update itself runs through ``align.band`` (the vectorized twin of
the reference's SSE kernel); all bands of a state update in one call.
This host engine is the behavioural reference; the device beam engine in
``ops.dtw`` batches whole pileups of consensus jobs.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .band import update_offsets_np, MAX_COST, BAND_FULL

INITIAL_OFFSET = 8  # ref: alignment.go:15


class QualityMetrics:
    __slots__ = ("exact_fraction", "cost_delta", "state_space_size")

    def __init__(self, exact_fraction=0.0, cost_delta=0, state_space_size=0):
        self.exact_fraction = exact_fraction
        self.cost_delta = cost_delta
        self.state_space_size = state_space_size


class _Landmark:
    __slots__ = ("k", "cost", "seqs", "positions")

    def __init__(self, k, cost, seqs, positions):
        self.k = k
        self.cost = cost
        self.seqs = seqs          # bool per sequence
        self.positions = positions  # int per sequence

    def matches_landmark(self, positions) -> bool:
        count = c2 = 0
        for i, use in enumerate(self.seqs):
            if use:
                c2 += 1
                if positions[i] == self.positions[i]:
                    count += 1
        return count >= c2 // 2

    def matches(self, positions) -> bool:
        count = c2 = 0
        for i, use in enumerate(self.seqs):
            if use:
                c2 += 1
                if self.positions[i] - 6 <= positions[i] <= self.positions[i] + 6:
                    count += 1
        return count >= c2 // 2

    def is_prior_to(self, positions) -> bool:
        for i, use in enumerate(self.seqs):
            if use and positions[i] - 4 < self.positions[i]:
                return False
        return True

    def is_prior_landmark_to(self, other_seqs, other_positions) -> bool:
        for i, use in enumerate(self.seqs):
            if use and other_seqs[i] and other_positions[i] < self.positions[i]:
                return False
        return True

    def lock_state(self, s: "_State", seqs, max_cost):
        """Prune band lanes that can't match the landmark k-mer
        (ref: alignment.go:164-207)."""
        centre = s.offsets.shape[1] // 2
        for j, p in enumerate(self.positions):
            if not self.seqs[j] or p < s.positions[j] - centre:
                continue
            seq = seqs[j]
            offs = s.offsets[j]
            start = int(s.positions[j]) - centre
            ip = start + np.arange(offs.shape[0])
            inb = (ip >= 0) & (ip < len(seq)) & (offs < max_cost)
            bad = inb & (seq[np.clip(ip, 0, len(seq) - 1)] != self.k)
            offs[bad] = max_cost
            live = inb & ~bad
            new_min = int(offs[live].min()) if live.any() else max_cost
            offs[offs < max_cost] -= new_min
            s.min_cost += new_min

    def crop_state(self, s: "_State", seqs, max_cost):
        """Rule out band lanes before the landmark position
        (ref: alignment.go:210-243)."""
        centre = s.offsets.shape[1] // 2
        for j, p in enumerate(self.positions):
            if not self.seqs[j]:
                continue
            pos = int(s.positions[j]) - centre
            p = int(p) - pos
            offs = s.offsets[j]
            if p >= offs.shape[0] or p < 0:
                continue
            for n in range(int(p)):
                if n + pos < 0 or seqs[j][n + pos] != self.k:
                    offs[n] = max_cost
                else:
                    p = n
                    break
            tail = offs[int(p):]
            new_min = int(tail.min()) if tail.size else max_cost
            s.min_cost += new_min
            tail[tail < max_cost] -= new_min


class _State:
    __slots__ = ("k", "positions", "offsets", "prev", "min_cost", "votes",
                 "space_size", "finished", "next_landmark", "quality")

    def __init__(self, k, positions, offsets, prev, min_cost, votes,
                 space_size, finished, next_landmark, quality):
        self.k = k
        self.positions = positions
        self.offsets = offsets
        self.prev = prev
        self.min_cost = min_cost
        self.votes = votes
        self.space_size = space_size
        self.finished = finished
        self.next_landmark = next_landmark
        self.quality = quality

    def write_best_positions(self):
        bp = np.argmin(self.offsets, axis=1)
        self.positions = self.positions + (bp - self.offsets.shape[1] // 2)


def _is_homopolymer(kmer: int, k: int) -> bool:
    prev = kmer & 3
    kmer >>= 2
    for _ in range(k - 1):
        nxt = kmer & 3
        if nxt != prev:
            return False
        kmer >>= 2
    return True


def _run_length(seq, pos) -> int:
    kmer = seq[pos]
    count = 1
    i = pos - 1
    while i >= 0 and seq[i] == kmer:
        count += 1
        i -= 1
    i = pos + 1
    while i < len(seq) and seq[i] == kmer:
        count += 1
        i += 1
    return count


def _passed_landmark(mark: _Landmark, s: _State) -> Optional[_State]:
    """ref: alignment.go:1056-1078"""
    count = 0
    delta = 0
    for i, in_mark in enumerate(mark.seqs):
        if in_mark:
            count += 1
            delta += int(s.positions[i]) - int(mark.positions[i])
    if delta < 0 or count == 0:
        return None
    delta = delta // count + 3
    while delta > 0 and s is not None:
        if s.k == mark.k and mark.matches(s.positions):
            return s
        s = s.prev
        delta -= 1
    return None


class DTWAligner:
    def __init__(self, max_warp: int, initial_gap_cost: int, measure,
                 full: bool, cost_threshold: int, k: int):
        while max_warp % 8 != 0:
            max_warp += 1
        self.W = max_warp * 2
        self.max_cost = MAX_COST
        self.initial_gap_cost = initial_gap_cost
        self.cost_threshold = cost_threshold
        self.measure = measure
        self.full = full
        self.k = k
        self.k_mask = (1 << (2 * k)) - 1
        self.landmarks: List[_Landmark] = []
        self.expected_positions = None
        self.depth = 0
        # band-update call counter: the bench suite divides a measured
        # native band-update rate by (updates / consensus base) from
        # this counter to derive the consensus baseline anchor
        self.n_band_updates = 0

    # -- helpers -------------------------------------------------------
    def _prepare_distances(self, seq_i: int, kmer: int, pos: int) -> np.ndarray:
        """Distances plus the expected-position regularizer
        (ref: alignment.go:280-331)."""
        W = self.W
        centre = W // 2
        seq_start = pos - centre
        ds = np.full(W, self.max_cost // 4, dtype=np.uint32)
        lo = max(0, seq_start)
        hi = min(seq_start + W, self.measure.sequence_len(seq_i))
        if hi > lo:
            d = self.measure.distances(kmer, seq_i, lo, hi - lo)
            ds[lo - seq_start : hi - seq_start] = d
            # expected position regularizer +-16
            exp = self.depth + int(self.expected_positions[seq_i])
            p = np.arange(lo, hi)
            delta = p - exp
            extra = np.where(delta < -16, -16 - delta,
                             np.where(delta > 16, delta - 16, 0))
            ds[lo - seq_start : hi - seq_start] += extra.astype(np.uint32)
        return np.minimum(ds, 0xFFFF).astype(np.uint16)

    def _update_costs(self, s: _State, prev: _State, j: int):
        """Band update + drift fix for one sequence
        (ref: alignment.go:357-386)."""
        pos = int(s.positions[j])
        ds = self._prepare_distances(j, s.k, pos)
        self.n_band_updates += 1
        out, m = update_offsets_np(ds, prev.offsets[j], self.cost_threshold)
        s.offsets[j] = out
        zero = np.flatnonzero(out == 0)
        min_pos = int(zero[0]) if zero.size else out.shape[0] // 2
        exact_idx = np.flatnonzero((ds == 0) & (out < self.max_cost))
        exact = -1
        if exact_idx.size:
            exact = int(exact_idx[np.argmin(out[exact_idx])])
        if self.depth > INITIAL_OFFSET:
            delta = self._fix_drift(s, min_pos, j)
            min_pos += delta
            pos -= delta
        finished = pos + min_pos - out.shape[0] // 2 >= \
            self.measure.sequence_len(j) - 1
        return min_pos, exact, int(m), finished

    def _fix_drift(self, s: _State, best_pos: int, j: int) -> int:
        """Recentre a drifting band (ref: alignment.go:245-273)."""
        offs = s.offsets[j]
        centre = offs.shape[0] // 2
        drift = centre - best_pos
        if drift < -4:
            offs[:drift] = offs[-drift:].copy()
            offs[drift:] = self.max_cost
            s.positions[j] -= drift
        elif drift > 4:
            offs[drift:] = offs[:-drift].copy()
            offs[:drift] = self.max_cost
            s.positions[j] -= drift
        else:
            return 0
        return drift

    def _new_state(self, k: int) -> _State:
        seqs = self.measure.seqs
        N = len(seqs)
        positions = np.full(N, INITIAL_OFFSET, dtype=np.int64)
        offsets = np.full((N, self.W), self.initial_gap_cost, dtype=np.uint16)
        offsets[:, :INITIAL_OFFSET] = self.max_cost
        for i, seq in enumerate(seqs):
            offsets[i, INITIAL_OFFSET] = 0 if seq[0] == k \
                else self.initial_gap_cost
        return _State(k, positions, offsets, None, 0, 0.0, 0, False, 0,
                      np.ones(N))

    def _first_states(self) -> List[_State]:
        firsts = sorted(set(int(seq[0]) for seq in self.measure.seqs))
        states = [self._new_state(k) for k in firsts]
        for s in states:
            s.space_size = len(states)
        return states

    def _update_expected_positions(self):
        lm = self.landmarks[-1]
        for i, use in enumerate(lm.seqs):
            if use:
                self.expected_positions[i] = lm.positions[i] - self.depth

    # -- single-successor stepping (alignment to a reference) -----------
    def _next_state(self, current: List[_State], nxt: List[_State],
                    next_k: int) -> bool:
        """ref: alignment.go:521-554"""
        self.depth += 1
        s = current[0]
        if s.finished:
            nxt.append(s)
            return True
        N = len(s.positions)
        succ = _State(next_k, s.positions + 1,
                      np.zeros_like(s.offsets), s, s.min_cost, 1.0, 1,
                      self.full, s.next_landmark, s.quality.copy())
        tail_gap = 0
        finished_acc = self.full
        for j in range(N):
            _, _, cost, finished = self._update_costs(succ, s, j)
            succ.min_cost += cost
            if not finished:
                tail_gap += self.measure.sequence_len(j) - 1 \
                    - int(succ.positions[j])
            if self.full:
                finished_acc = finished_acc and finished
            else:
                finished_acc = finished_acc or finished
        succ.finished = finished_acc
        if succ.finished:
            succ.min_cost += tail_gap * self.initial_gap_cost
        nxt.append(succ)
        return succ.finished

    # -- full beam stepping ---------------------------------------------
    def _next_states(self, current: List[_State], nxt: List[_State]) -> bool:
        """The beam step with landmark machinery
        (ref: alignment.go:556-1052)."""
        self.depth += 1
        prev_kmers = set()
        min_finished_cost = math.inf
        all_finished = True
        landmark_added = False
        lowest_cost = math.inf
        for s in current:
            if (not self.landmarks or s.next_landmark == len(self.landmarks)) \
                    and s.min_cost < lowest_cost:
                lowest_cost = s.min_cost
            if s.finished and s.min_cost < min_finished_cost:
                min_finished_cost = s.min_cost
        seqs = self.measure.seqs
        N = len(seqs)
        centre = self.W // 2
        lowest_cost += centre * self.cost_threshold

        m = -1
        while m + 1 < len(current):
            m += 1
            s = current[m]
            if s.finished:
                if min_finished_cost >= s.min_cost:
                    nxt.append(s)
                continue
            if s.min_cost > lowest_cost:
                continue
            shifted = (s.k << 2) & self.k_mask
            update = shifted in prev_kmers
            added = False
            qs = np.sort(s.quality)
            min_q = qs[N // 4]
            vs = np.floor(8.0 * s.quality + 0.5).astype(np.int64)

            for i in range(4):
                next_k = shifted | i
                succ = _State(next_k, s.positions + 1,
                              np.zeros_like(s.offsets), s, s.min_cost, 0.0,
                              0, self.full, s.next_landmark,
                              s.quality.copy())
                vote_sum = 0
                max_votes = 0
                single_vote = True
                last_voted = -1
                last_voted_index = -1
                extra_cost = 0
                finished_acc = self.full
                v_count = 0
                min_indices = np.zeros(N, dtype=np.int64)
                for j in range(N):
                    min_index, exact, cost, finished = \
                        self._update_costs(succ, s, j)
                    if exact >= 0 and next_k == s.k:
                        min_index, exact, cost = self._homopolymer_rescan(
                            succ, j, next_k, min_index)
                    if exact >= 0:
                        single_vote = vote_sum == 0
                        vote_sum += int(vs[j])
                        v_count += 1
                        last_voted = j
                        last_voted_index = min_index
                        succ.quality[j] = 1.0
                    else:
                        succ.quality[j] *= 0.95
                    max_votes += int(vs[j])
                    if s.quality[j] >= min_q:
                        extra_cost += cost
                    if self.full:
                        finished_acc = finished_acc and finished
                    else:
                        finished_acc = finished_acc or finished
                    min_indices[j] = min_index
                succ.finished = finished_acc
                if max_votes == 0:
                    continue
                succ.min_cost += extra_cost
                votes = vote_sum / max_votes
                succ.votes = v_count / N
                if succ.finished and min_finished_cost > succ.min_cost:
                    min_finished_cost = succ.min_cost
                if vote_sum == 0:
                    continue
                if single_vote:
                    # pin to the only exact match (ref: alignment.go:717-733)
                    dc = int(succ.offsets[last_voted][last_voted_index])
                    succ.min_cost += dc
                    seq = seqs[last_voted]
                    # NB the reference divides len(offsets) (the number of
                    # sequences!) by 2 here, not the band width — replicated
                    off = int(succ.positions[last_voted]) - N // 2
                    offs = succ.offsets[last_voted]
                    for n in range(offs.shape[0]):
                        if (n != last_voted_index and 0 <= n + off < len(seq)
                                and seq[n + off] != succ.k):
                            offs[n] = self.max_cost
                        else:
                            offs[n] = max(0, int(offs[n]) - dc)
                # landmark ordering checks (ref: alignment.go:735-758)
                if succ.next_landmark < len(self.landmarks):
                    lm = self.landmarks[succ.next_landmark]
                    if succ.min_cost > lm.cost:
                        continue
                    if next_k == lm.k and lm.matches(succ.positions):
                        if votes <= 0.5:
                            lm.crop_state(succ, seqs, self.max_cost)
                        succ.next_landmark += 1
                    elif lm.is_prior_to(succ.positions):
                        continue
                keep_going = True
                if (not succ.finished and self.depth > INITIAL_OFFSET
                        and votes > 0.5):
                    keep_going, landmark_added_now = self._landmark_step(
                        succ, s, next_k, votes, vs, max_votes, seqs,
                        current, nxt, m)
                    landmark_added = landmark_added or landmark_added_now
                if not keep_going:
                    continue
                if min_finished_cost >= succ.min_cost:
                    added = True
                    if update:
                        found = False
                        keep = False
                        for jj, other in enumerate(nxt):
                            if other.k == next_k:
                                found = True
                                if (other.min_cost >= succ.min_cost
                                        and other.next_landmark <= succ.next_landmark):
                                    nxt[jj] = succ
                                else:
                                    keep = keep or \
                                        other.next_landmark < succ.next_landmark
                        if not found or keep:
                            all_finished = False
                            nxt.append(succ)
                    else:
                        all_finished = False
                        nxt.append(succ)
            if not update and added:
                prev_kmers.add(shifted)
        if landmark_added:
            self._update_expected_positions()
        for s in nxt:
            s.space_size = len(nxt)
        return all_finished

    def _homopolymer_rescan(self, succ: _State, j: int, next_k: int,
                            min_index: int):
        """Rule out the earliest matching k-mer on homopolymer repeats
        (ref: alignment.go:641-675)."""
        seqs = self.measure.seqs
        seq = seqs[j]
        centre = self.W // 2
        offs = succ.offsets[j]
        pos = int(succ.positions[j]) - centre
        new_min = self.max_cost
        n = 0
        p = pos
        while n <= min_index and p < len(seq):
            cost = int(offs[n])
            if p >= 0 and cost < self.max_cost and seq[p] == next_k:
                offs[n] = self.max_cost
            elif cost < new_min:
                new_min = cost
                min_index = n
            p += 1
            n += 1
        exact = -1
        n = min_index + 1
        while n < offs.shape[0] and p < len(seq):
            cost = int(offs[n])
            if cost < self.max_cost and seq[p] == next_k:
                exact = n
                min_index = n
            if cost < new_min:
                new_min = cost
            p += 1
            n += 1
        if new_min != 0 and new_min < self.max_cost:
            offs[offs < self.max_cost] -= new_min
        return min_index, exact, new_min

    def _landmark_step(self, succ: _State, s: _State, next_k: int,
                       votes: float, vs, max_votes: int, seqs,
                       current, nxt, m: int):
        """Landmark creation/achievement (ref: alignment.go:760-980).
        Returns (keep_successor, landmark_added)."""
        N = len(seqs)
        centre = self.W // 2
        lm_positions = np.zeros(N, dtype=np.int64)
        lm_seq = [False] * N
        lm_cost = succ.min_cost
        land_votes = 0
        for j in range(N):
            seq = seqs[j]
            seq_len = len(seq)
            offs = succ.offsets[j]
            pos = int(succ.positions[j])
            off = int(offs[centre])
            if (pos > INITIAL_OFFSET and pos < seq_len
                    and seq[pos] == next_k and off < self.max_cost):
                lm_seq[j] = True
                lm_positions[j] = pos
                lm_cost += off
                land_votes += int(vs[j])
            else:
                best_off = self.max_cost
                best_pos = 0
                for kk in range(1, 16):
                    if (pos + kk > INITIAL_OFFSET and pos + kk < seq_len
                            and seq[pos + kk] == next_k):
                        off2 = int(offs[centre + kk])
                        if off2 < best_off:
                            best_pos = pos + kk
                            best_off = off2
                    if (pos - kk > INITIAL_OFFSET and pos - kk < seq_len
                            and seq[pos - kk] == next_k):
                        off2 = int(offs[centre - kk])
                        if off2 < best_off:
                            best_pos = pos - kk
                            best_off = off2
                if best_off < self.max_cost:
                    lm_seq[j] = True
                    lm_positions[j] = best_pos
                    lm_cost += best_off
                    land_votes += int(vs[j])
        new_votes = land_votes / max_votes if max_votes else 0.0
        if new_votes <= 0.5:
            return True, False
        if (succ.next_landmark < len(self.landmarks)
                and self.landmarks[succ.next_landmark]
                .is_prior_landmark_to(lm_seq, lm_positions)):
            return False, False
        mark = None
        updated_landmark = False
        skipped_landmark = False
        if self.landmarks:
            j = max(0, succ.next_landmark - 1)
            while j < len(self.landmarks):
                lm = self.landmarks[j]
                if lm.k == next_k and lm.matches_landmark(lm_positions):
                    skipped_landmark = skipped_landmark or \
                        succ.next_landmark < j
                    mark = lm
                    if j > succ.next_landmark - 1:
                        return True, False  # repeat match; ignore
                    if not skipped_landmark and lm.cost > lm_cost:
                        lm.cost = lm_cost
                        lm.positions = lm_positions
                        lm.seqs = lm_seq
                        lm.lock_state(succ, seqs, self.max_cost)
                        del self.landmarks[j + 1:]
                        updated_landmark = True
                    else:
                        succ.next_landmark = j + 1
                        lm.lock_state(succ, seqs, self.max_cost)
                        return True, False
                    break
                j += 1
        if skipped_landmark:
            return False, False
        landmark_added = False
        if mark is None:
            mark = _Landmark(next_k, lm_cost, lm_seq, lm_positions)
            new_len = len(self.landmarks)
            while new_len > 0 and mark.is_prior_landmark_to(
                    self.landmarks[new_len - 1].seqs,
                    self.landmarks[new_len - 1].positions):
                new_len -= 1
            if new_len > 0 and self.landmarks[new_len - 1].k == mark.k:
                return True, False  # no repeats
            del self.landmarks[new_len:]
            self.landmarks.append(mark)
            succ.next_landmark = len(self.landmarks)
            mark.lock_state(succ, seqs, self.max_cost)
            landmark_added = True
        # purge later states (ref: alignment.go:901-974)
        jj = len(nxt) - 1
        while jj >= 0:
            n = nxt[jj]
            if ((updated_landmark and n.next_landmark >= len(self.landmarks))
                    or mark.is_prior_to(n.positions)
                    or n.min_cost > mark.cost):
                nxt[jj] = nxt[-1]
                nxt.pop()
            else:
                match = _passed_landmark(mark, n)
                if match is not None:
                    if match.min_cost > mark.cost:
                        nxt[jj] = nxt[-1]
                        nxt.pop()
                    else:
                        mark.cost = match.min_cost
                        n.next_landmark = len(self.landmarks)
                        mark.crop_state(n, seqs, self.max_cost)
                elif n.next_landmark > len(self.landmarks) - 1:
                    n.next_landmark = len(self.landmarks) - 1
            jj -= 1
        jj = len(current) - 1
        while jj >= m + 1:
            cj = current[jj]
            if cj.next_landmark >= len(self.landmarks) - 1:
                match = _passed_landmark(mark, cj)
                if match is not None and match.min_cost <= mark.cost:
                    cj.next_landmark = len(self.landmarks)
                    mark.crop_state(cj, seqs, self.max_cost)
                    mark.cost = match.min_cost
                elif mark.is_prior_to(cj.positions) \
                        or mark.cost < cj.min_cost:
                    current[jj] = current[-1]
                    current.pop()
            elif updated_landmark and mark.is_prior_to(cj.positions):
                current[jj] = current[-1]
                current.pop()
            jj -= 1
        return True, landmark_added

    # -- tracebacks ------------------------------------------------------
    def _trace_back(self, s: _State, kmers, costs):
        """Consensus traceback with homopolymer run-length calling
        (ref: alignment.go:416-464)."""
        seqs = self.measure.seqs
        chain = []
        t = s
        while t is not None:
            chain.append(t)
            t = t.prev
        chain.reverse()
        first = chain[0]
        for idx, t in enumerate(chain):
            delta = t.min_cost - (chain[idx - 1].min_cost if idx else 0)
            if _is_homopolymer(t.k, self.k):
                if t.prev is None or t.prev.k != t.k:
                    counts = [0] * t.offsets.shape[1]
                    for i in range(t.offsets.shape[0]):
                        run_len = 0
                        offs = t.offsets[i]
                        base = int(t.positions[i]) - offs.shape[0] // 2
                        for j in range(offs.shape[0]):
                            p = base + j
                            if (offs[j] == 0 and 0 <= p < len(seqs[i])
                                    and seqs[i][p] == t.k):
                                run_len = _run_length(seqs[i], p)
                                break
                        counts[run_len] += 1
                    extras = 0
                    for i in range(1, len(counts)):
                        if counts[i] > counts[extras]:
                            extras = i
                    for _ in range(extras):
                        kmers.append(t.k)
                        costs.append(QualityMetrics(t.votes, t.min_cost,
                                                    t.space_size))
            else:
                kmers.append(t.k)
                costs.append(QualityMetrics(t.votes, delta, t.space_size))
        return first

    def _trace_back_full(self, s: _State, kmers, costs, positions):
        """ref: alignment.go:466-519"""
        chain = []
        t = s
        while t is not None:
            chain.append(t)
            t = t.prev
        chain.reverse()
        # initial current positions from the final state's best offsets
        W = s.offsets.shape[1]
        current_pos = []
        for i in range(s.offsets.shape[0]):
            offs = s.offsets[i]
            best = offs.shape[0] - 1
            bc = offs[best]
            for j in range(best - 1, -1, -1):
                if offs[j] < bc:
                    bc = offs[j]
                    best = j
            current_pos.append(int(s.positions[i]) + best - W // 2)
        out = []
        for t in reversed(chain):
            pos = []
            for i in range(t.offsets.shape[0]):
                offs = t.offsets[i]
                latest = current_pos[i] - int(t.positions[i]) + W // 2
                best_cost = 0xFFFF + 1
                best_pos = -1
                for j in range(latest, max(latest - 4, -1), -1):
                    if 0 <= j < offs.shape[0] and offs[j] < best_cost:
                        best_cost = int(offs[j])
                        best_pos = j
                pos.append(best_pos + int(t.positions[i]) - W // 2)
            out.append((t, pos))
            current_pos = pos
        prev_cost = 0
        for t, pos in reversed(out):
            delta = t.min_cost - (t.prev.min_cost if t.prev else 0)
            kmers.append(t.k)
            costs.append(QualityMetrics(t.votes, delta, t.space_size))
            positions.append(pos)
        return chain[0]

    # -- public API ------------------------------------------------------
    def global_consensus(self):
        """Returns (kmer list, QualityMetrics list, end positions)
        (ref: alignment.go:1149-1207)."""
        self.depth = 0
        self.landmarks = []
        seqs = self.measure.seqs
        self.expected_positions = np.zeros(len(seqs), dtype=np.int64)
        states = self._first_states()
        kmers: List[int] = []
        costs: List[QualityMetrics] = []
        finished = False
        guard = 0
        max_steps = 4 * max(len(s) for s in seqs) + 64
        while not finished and guard < max_steps:
            guard += 1
            nxt: List[_State] = []
            finished = self._next_states(states, nxt)
            if not finished and len(nxt) == 1 and nxt[0].prev is not None \
                    and not _is_homopolymer(nxt[0].k, self.k):
                self._trace_back(nxt[0].prev, kmers, costs)
                nxt[0].prev = None
            if not nxt:
                break
            states = nxt
        end_positions = None
        if states:
            best = min(states, key=lambda s: s.min_cost)
            first = self._trace_back(best, kmers, costs)
            best.write_best_positions()
            first.write_best_positions()
            end_positions = best.positions
        return kmers, costs, end_positions

    def global_alignment(self):
        """(ref: alignment.go:1209-1249)"""
        self.depth = 0
        self.landmarks = []
        seqs = self.measure.seqs
        self.expected_positions = np.zeros(len(seqs), dtype=np.int64)
        states = self._first_states()
        kmers: List[int] = []
        costs: List[QualityMetrics] = []
        positions: List[List[int]] = []
        finished = False
        guard = 0
        max_steps = 4 * max(len(s) for s in seqs) + 64
        while not finished and guard < max_steps:
            guard += 1
            nxt: List[_State] = []
            finished = self._next_states(states, nxt)
            if not finished and len(nxt) == 1 and nxt[0].prev is not None:
                self._trace_back_full(nxt[0].prev, kmers, costs, positions)
                nxt[0].prev = None
            if not nxt:
                break
            states = nxt
        if states:
            best = min(states, key=lambda s: s.min_cost)
            self._trace_back_full(best, kmers, costs, positions)
        return kmers, costs, positions

    def global_alignment_to(self, reference):
        """(ref: alignment.go:1251-1276)"""
        self.depth = 0
        self.landmarks = []
        seqs = self.measure.seqs
        self.expected_positions = np.zeros(len(seqs), dtype=np.int64)
        states = [self._new_state(int(reference[0]))]
        states[0].space_size = 1
        kmers: List[int] = []
        costs: List[QualityMetrics] = []
        positions: List[List[int]] = []
        finished = False
        for i in range(1, len(reference)):
            if finished:
                break
            nxt: List[_State] = []
            finished = self._next_state(states, nxt, int(reference[i]))
            states = nxt
        self._trace_back_full(states[0], kmers, costs, positions)
        return kmers, costs, positions

    def consensus_cost(self, reference) -> int:
        """(ref: alignment.go:1278-1292)"""
        self.depth = 0
        self.landmarks = []
        seqs = self.measure.seqs
        self.expected_positions = np.zeros(len(seqs), dtype=np.int64)
        states = [self._new_state(int(reference[0]))]
        finished = False
        for i in range(1, len(reference)):
            if finished:
                break
            nxt: List[_State] = []
            finished = self._next_state(states, nxt, int(reference[i]))
            states = nxt
        return states[0].min_cost
