"""Candidate retrieval: seed-hit counting as an integer matrix product
(torch port of ``downpore_tpu/ops/match.py``).

With the inverted index as a 0/1 membership matrix ``M[S, C]`` (seed or
hash bucket x chunk) and a batch of queries as per-seed run multiplicities
``V[Q, S]`` (consecutive duplicates collapsed, the multiset the reference
feeds GetSharedIDs), the shared-seed counts are ``V @ M``: one int8
product in place of the reference's bitset soft-union cascade and its
per-candidate popcount gate (ref: util/bitset.go:179,308-411,
overlap/overlap.go:359).  The counts are exact: the reference's slow-path
semantics.

The product is a library call, as in the JAX package (``lax.dot_general``
left to XLA, not a Pallas kernel).  It returns the JAX function's int32
``[Q, C]``:

* on a CUDA card, ``torch._int_mm`` (int8 operands on the tensor cores,
  int32 sums): it needs more than 16 rows and K and N multiples of 8, so
  the operands are zero-padded to those, which adds nothing to a count;
* on the CPU, an int32 product (``torch.matmul`` of int8 would stay int8
  and wrap around).

Either sum is exact in int32: entries are int8 (|v| <= 128) against a 0/1
membership, and S is at most ``choose_hash_size``'s cap of 2^17 rows, so
every count lies within 128 x 2^17 = 16,777,216 of zero.

Seed ids map to a power-of-two bucket space ``H``: identity when every id
fits, else Knuth multiplicative hashing.  Hash collisions only add
retrieval counts, so recall is preserved; the chain DP filters.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device

KNUTH = 2654435761


def _tensor(a, device) -> torch.Tensor:
    """``a`` as a tensor: a tensor stays on its device, a numpy array goes
    to ``resolve_device(device)``."""
    if torch.is_tensor(a):
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        resolve_device(device))


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x.contiguous()
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _product(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``[Q, S] int8 x [S, C] int8 -> [Q, C] int32``, exact (module
    docstring)."""
    if v.shape[1] != m.shape[0]:
        raise ValueError(f"hit_counts: query width {v.shape[1]} != "
                         f"membership rows {m.shape[0]}")
    m = m.to(v.device)
    if v.device.type != "cuda":
        return torch.matmul(v.to(torch.int32), m.to(torch.int32))
    Q, S = v.shape
    C = m.shape[1]
    if Q == 0 or S == 0 or C == 0:
        return torch.zeros((Q, C), dtype=torch.int32, device=v.device)
    r8 = lambda n: -(-n // 8) * 8
    Qp, Sp, Cp = max(17, Q), r8(S), r8(C)
    out = torch._int_mm(_pad_to(v.to(torch.int8), Qp, Sp),
                        _pad_to(m.to(torch.int8), Sp, Cp))
    return out[:Q, :C] if (Qp, Cp) != (Q, C) else out


def hit_counts_packed(packed, membership, device=None) -> torch.Tensor:
    """``[Q, S//8] uint8 (bit-packed rows) x [S, C] -> [Q, C]`` int32
    counts.  The query matrix ships to the device bit-packed (8x fewer
    bytes to upload) and unpacks there, most significant bit first, cut
    to the membership's S rows, before the same product as
    ``hit_counts``."""
    packed = _tensor(packed, device)
    membership = _tensor(membership, packed.device)
    Q, SB = packed.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.to(torch.uint8)[:, :, None] >> shifts) & 1
    unpacked = bits.reshape(Q, SB * 8).to(torch.int8)
    return _product(unpacked[:, :membership.shape[0]], membership)


def hit_counts(query_multi, membership, device=None) -> torch.Tensor:
    """``[Q, S] x [S, C] -> [Q, C]`` shared-seed counts (int32).

    ``query_multi`` is int8 per-seed run multiplicities; ``membership`` is
    the int8 0/1 seed->chunk matrix.  Numpy inputs go to
    ``resolve_device(device)``; tensors stay where they are."""
    query_multi = _tensor(query_multi, device)
    return _product(query_multi, _tensor(membership, query_multi.device))


def candidates_from_counts(counts, num_sets: np.ndarray,
                           hit_fraction: float, min_sets: int = 5):
    """Threshold hit counts into candidate lists, mirroring
    ``SeedIndex.Matches`` (ref: seeds/seeds.go:348-352).

    ``counts``: [Q, C] int (numpy or a tensor); ``num_sets``: [Q] number
    of usable query seed runs.  Queries with fewer than ``min_sets``
    usable seeds get no candidates.  Returns a list of np arrays of chunk
    indices."""
    if torch.is_tensor(counts):
        counts = counts.cpu().numpy()
    counts = np.asarray(counts)
    num_sets = np.asarray(num_sets)
    min_count = (hit_fraction * num_sets + 0.5).astype(np.int64)
    out = []
    for qi in range(counts.shape[0]):
        if num_sets[qi] < min_sets:
            out.append(np.empty(0, dtype=np.int64))
        else:
            out.append(np.flatnonzero(counts[qi] >= min_count[qi]))
    return out


def choose_hash_size(num_seeds: int, max_h: int = 1 << 17) -> int:
    """Bucket-space size: the next power of two over ``num_seeds``,
    capped at ``max_h``."""
    h = 1
    while h < num_seeds:
        h *= 2
    return min(h, max_h)


def hash_ids(ids: np.ndarray, num_seeds: int, H: int) -> np.ndarray:
    """Seed id -> bucket.  Identity when everything fits; Knuth
    multiplicative hashing otherwise."""
    if num_seeds <= H:
        return np.asarray(ids, dtype=np.int64)
    return ((np.asarray(ids, dtype=np.uint64) * np.uint64(KNUTH))
            % np.uint64(H)).astype(np.int64)


def build_membership(chunk_seed_lists, num_seeds: int,
                     H: Optional[int] = None) -> np.ndarray:
    """Hashed 0/1 membership matrix ``[H, C]`` int8 from per-chunk seed-id
    lists: the inverted index in product-ready form."""
    if H is None:
        H = choose_hash_size(num_seeds)
    C = len(chunk_seed_lists)
    M = np.zeros((H, C), dtype=np.int8)
    for ci, seeds in enumerate(chunk_seed_lists):
        if len(seeds):
            M[hash_ids(np.unique(seeds), num_seeds, H), ci] = 1
    return M


def build_query_rows(queries, num_seeds: int, usable: np.ndarray,
                     H: Optional[int] = None):
    """Hashed query matrices: returns (V_runs [Q, H] int8 with per-run
    multiplicities, V_distinct [Q, H] int8 0/1, num_sets [Q]).

    ``num_sets`` (the usable-run count feeding min_count) is exact even
    when buckets collide."""
    if H is None:
        H = choose_hash_size(num_seeds)
    qs = list(queries)
    V = np.zeros((len(qs), H), dtype=np.int8)
    VD = np.zeros((len(qs), H), dtype=np.int8)
    num_sets = np.zeros(len(qs), dtype=np.int32)
    for i, q in enumerate(qs):
        prev = -1
        n = 0
        distinct = set()
        for s in q.seeds:
            s = int(s)
            if s != prev and usable[s]:
                b = int(hash_ids(np.int64(s), num_seeds, H))
                V[i, b] += 1
                distinct.add(b)
                n += 1
                prev = s
        for b in distinct:
            VD[i, b] = 1
        num_sets[i] = n
    return V, VD, num_sets


def build_query_matrix(queries, num_seeds: int, usable: np.ndarray):
    """Stack per-query seed run multiplicities into ``[Q, S]`` int8.

    ``queries`` is an iterable of SeedSequence; ``usable`` a bool mask over
    seed ids (seeds absent from every chunk or present in all chunks are
    unusable, ref: seeds/seeds.go:343).  Returns (matrix, num_sets).
    """
    qs = list(queries)
    V = np.zeros((len(qs), num_seeds), dtype=np.int8)
    num_sets = np.zeros(len(qs), dtype=np.int32)
    for i, q in enumerate(qs):
        prev = -1
        n = 0
        for s in q.seeds:
            s = int(s)
            # prev only advances on an accepted seed, as in the reference
            if s != prev and usable[s]:
                V[i, s] += 1
                n += 1
                prev = s
        num_sets[i] = n
    return V, num_sets
