"""Multi-device scaling: a (data, seed) grid of torch devices (torch port
of ``downpore_tpu/parallel/mesh.py``).

The JAX package expresses scaling as a ``jax.sharding.Mesh`` with a
``data`` axis (query and window batches split over devices) and a ``seed``
axis (the hash-bucket rows of the seed index split over devices).  Here
the mesh is a ``DeviceGrid``: a ``[n_data, n_seed]`` array of
``torch.device`` with the ``shape``, ``size`` and ``axis_names`` that the
engines read, and the shards are placed by hand:

* a batch splits into ``n_data`` contiguous, equal row blocks (padded at
  the end), as ``PartitionSpec("data")`` splits it; each block runs on its
  data shard's device, and the host concatenates the blocks' rows in
  order;
* seed-sharded retrieval sums the int32 partial counts of every seed
  shard on the data shard's device (integer sums are exact in any order);
* the k-mer histogram is a ``torch.bincount`` per block, summed in int64.

A grid may repeat a device: several shards then share one card (or the
CPU), which is how the shard logic is checked on a single device.  Under
an initialized ``torch.distributed`` group (gloo on the CPU, NCCL on
cards, one process per card with its device set), ``make_mesh()`` spans
every rank's devices in rank order; each process runs only the shards on
its own devices, and the collect steps all-gather the shards' rows, so
that every process returns the full output.

The query pipeline's sharded step (``sharded_hit_counts``,
``sharded_chain``, ``sharded_pipeline_step``) places its shards the same
way and returns host arrays.  Like the JAX functions, it raises
``ValueError`` on a shape that the grid does not divide.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..ops.chain import chain_batch
from ..ops.match import hit_counts


def _distributed() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def _rank() -> int:
    return torch.distributed.get_rank() if _distributed() else 0


def local_devices() -> List[torch.device]:
    """The devices this process computes on: every CUDA card it sees when
    the port's device is CUDA (under a ``torch.distributed`` group, only
    the card set as the process's current device), else the CPU."""
    dev = resolve_device()
    if dev.type != "cuda":
        return [dev]
    if _distributed():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_listing():
    """``(devices, ranks)``: the devices of a default grid and the rank of
    the process that owns each.  Without a distributed group these are
    this process's ``local_devices()``; under one, every rank's local
    devices in rank order."""
    local = local_devices()
    if not _distributed():
        return local, [0] * len(local)
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, [str(d) for d in local])
    devices, ranks = [], []
    for r, names in enumerate(every):
        devices += [torch.device(n) for n in names]
        ranks += [r] * len(names)
    return devices, ranks


class DeviceGrid:
    """A ``[n_data, n_seed]`` grid of torch devices, each owned by one
    process (``ranks``)."""

    axis_names = ("data", "seed")

    def __init__(self, devices, ranks=None):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2:
            raise ValueError("a device grid is two-dimensional: "
                             "[n_data, n_seed]")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = torch.device(grid[idx])
        self.ranks = (np.zeros(grid.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(grid.shape))
        rank = _rank()
        owned = [self.devices[d, 0] for d in range(grid.shape[0])
                 if self.ranks[d, 0] == rank]
        # the device an engine builds its tables on before replicating
        self.home = owned[0] if owned else self.devices[0, 0]
        for d in range(grid.shape[0]):
            if len(set(self.ranks[d].tolist())) > 1:
                raise ValueError("the seed shards of a data shard must "
                                 "belong to one process")

    @classmethod
    def single(cls, device) -> "DeviceGrid":
        """The 1 x 1 grid of one device of this process."""
        return cls([[device]], [[_rank()]])

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.devices.shape[0], "seed": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_ranks(self) -> bool:
        return len(set(self.ranks.ravel().tolist())) > 1

    def owns(self, d: int) -> bool:
        """Whether data shard ``d`` runs in this process."""
        return int(self.ranks[d, 0]) == _rank()

    def data_device(self, d: int) -> torch.device:
        return self.devices[d, 0]

    def split_rows(self, arrays: Sequence, fills: Sequence):
        """Split each array's rows (numpy arrays or tensors, one row count)
        into ``n_data`` contiguous, equal blocks, the last ones padded with
        the array's fill value.  Returns ``[(d, lo, [block, ...])]`` over
        the data shards ``d`` this process owns, each block on its shard's
        device, ``lo`` the global index of the block's first row."""
        R = arrays[0].shape[0]
        D = self.shape["data"]
        B = max(1, -(-R // D))
        out = []
        for d in range(D):
            if not self.owns(d):
                continue
            dev = self.data_device(d)
            lo = d * B
            out.append((d, lo, [_to(_rows(a, lo, lo + B, f), dev)
                                for a, f in zip(arrays, fills)]))
        return out

    def gather(self, parts: dict) -> list:
        """Every data shard's value in block order: ``parts`` maps the
        ``lo`` of this process's blocks to their host values; under a
        distributed grid the other processes' blocks are all-gathered."""
        if self.spans_ranks:
            every = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(every, parts)
            parts = {}
            for p in every:
                parts.update(p)
        return [parts[lo] for lo in sorted(parts)]

    def __repr__(self):
        return (f"DeviceGrid(data={self.shape['data']}, "
                f"seed={self.shape['seed']}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def _rows(a, lo: int, hi: int, fill):
    """Rows ``lo:hi`` of ``a``, padded with ``fill`` past its end."""
    part = a[lo:hi]
    short = (hi - lo) - part.shape[0]
    if short <= 0:
        return part
    shape = (short,) + tuple(a.shape[1:])
    if torch.is_tensor(a):
        return torch.cat([part, torch.full(shape, fill, dtype=a.dtype,
                                           device=a.device)])
    return np.concatenate([part, np.full(shape, fill, a.dtype)])


def _to(a, dev):
    if torch.is_tensor(a):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def make_mesh(n_data: int = None, n_seed: int = 1,
              devices=None) -> DeviceGrid:
    """A (data, seed) grid over the available devices (``device_listing``)
    or over ``devices``, which may repeat a device."""
    if devices is None:
        devices, ranks = device_listing()
    else:
        devices = [torch.device(d) for d in devices]
        ranks = [_rank()] * len(devices)
    n = len(devices)
    if n_data is None:
        n_data = n // n_seed
    if n_data < 1 or n_data * n_seed > n:
        raise ValueError(
            f"mesh needs n_data x n_seed <= devices: have {n} device(s), "
            f"asked for n_data={n_data} x n_seed={n_seed}")
    return DeviceGrid([devices[i * n_seed:(i + 1) * n_seed]
                       for i in range(n_data)],
                      [ranks[i * n_seed:(i + 1) * n_seed]
                       for i in range(n_data)])


def sharded_kmer_histogram(mesh: DeviceGrid, k: int):
    """``kmers [E, L]`` int32 (E a multiple of the grid's size, padded with
    -1) -> int64 counts ``[4**k]`` on the grid's home device: entry e's
    rows go to device ``e`` of the grid in (data, seed) order, as
    ``PartitionSpec(("data", "seed"))`` splits them; each block is one
    ``torch.bincount`` on its device and the blocks' counts are summed
    (ref: util/sequtil/kmers.go:34-51)."""
    size = 4 ** k
    entries = list(zip(mesh.devices.ravel(), mesh.ranks.ravel()))
    rank = _rank()

    def hist(kmers) -> torch.Tensor:
        E = len(entries)
        rows = kmers.shape[0] // E
        total = torch.zeros(size, dtype=torch.int64, device=mesh.home)
        for e, (dev, owner) in enumerate(entries):
            if owner != rank:
                continue
            flat = _to(kmers[e * rows:(e + 1) * rows], dev).reshape(-1)
            part = torch.bincount(flat[flat >= 0].long(), minlength=size)
            total += part.to(mesh.home)
        if mesh.spans_ranks:
            torch.distributed.all_reduce(total)
        return total

    return hist


def _divides(n: int, parts: int, what: str):
    """The JAX functions' check: a sharded axis must split evenly."""
    if n % parts:
        raise ValueError(f"{what} of size {n} is not divisible by the "
                         f"grid's {parts} shard(s) on it")


def _grid_counts(mesh: DeviceGrid, V, M) -> Dict[int, np.ndarray]:
    """Per owned data shard: ``{first row: int32 counts}`` of its V rows,
    the seed shards' partial products summed on the data shard's device."""
    D, S = mesh.shape["data"], mesh.shape["seed"]
    Q, H = V.shape
    _divides(Q, D, "V's rows (data axis)")
    _divides(H, S, "V's columns (seed axis)")
    _divides(M.shape[0], S, "M's rows (seed axis)")
    qb, hb, mb = Q // D, H // S, M.shape[0] // S
    parts = {}
    for d in range(D):
        if not mesh.owns(d):
            continue
        total = None
        for s in range(S):
            dev = mesh.devices[d, s]
            part = hit_counts(_to(V[d * qb:(d + 1) * qb, s * hb:(s + 1) * hb],
                                  dev),
                              _to(M[s * mb:(s + 1) * mb], dev))
            part = part.to(mesh.data_device(d))
            total = part if total is None else total + part
        parts[d * qb] = total.cpu().numpy()
    return parts


def sharded_hit_counts(mesh: DeviceGrid):
    """``V [Q, H] x M [H, C] -> counts [Q, C]`` int32 (numpy) with V split
    by rows over the data shards and by columns over the seed shards, and
    M by rows over the seed shards: each shard's int32 partial product is
    summed on its data shard's device (the JAX function's psum over
    ``seed``), and the data shards' rows concatenate in order."""
    def counts(V, M) -> np.ndarray:
        return np.concatenate(mesh.gather(_grid_counts(mesh, V, M)))

    return counts


CHAIN_OUTS = ("through", "cov_q", "cov_t", "start_qp", "start_tp", "end_qp",
              "end_tp")


def sharded_chain(mesh: DeviceGrid, k: int, max_anchors: int):
    """Chain DP over a pair batch split over every device of the grid in
    (data, seed) order, as ``PartitionSpec(("data", "seed"))`` splits it:
    returns the numpy ``(through, cov_q, cov_t, start_qp, start_tp,
    end_qp, end_tp)`` of ``chain_batch``, rows in order."""
    entries = list(zip(mesh.devices.ravel(), mesh.ranks.ravel()))
    rank = _rank()

    def run(qs, qp, ts, tp):
        E = len(entries)
        _divides(qs.shape[0], E, "the pair batch (data x seed axes)")
        rows = qs.shape[0] // E
        parts = {}
        for e, (dev, owner) in enumerate(entries):
            if owner != rank:
                continue
            sl = slice(e * rows, (e + 1) * rows)
            out = chain_batch(*[_to(a[sl], dev) for a in (qs, qp, ts, tp)],
                              k=k, max_anchors=max_anchors)
            parts[e * rows] = [out[n].cpu().numpy() for n in CHAIN_OUTS]
        parts = mesh.gather(parts)
        return tuple(np.concatenate([p[i] for p in parts])
                     for i in range(len(CHAIN_OUTS)))

    return run


def sharded_pipeline_step(mesh: DeviceGrid, k: int = 6,
                          max_anchors: int = 64):
    """The full sharded query step: retrieval (``sharded_hit_counts``)
    followed by the chain DP over the pairs split on the data axis.
    Returns numpy ``(counts, through)``: the multi-device execution shape
    of the trim/map/overlap inner loop."""
    counts_fn = sharded_hit_counts(mesh)

    def run(V, M, qseeds, qpos, tseeds, tpos):
        counts = counts_fn(V, M)
        _divides(qseeds.shape[0], mesh.shape["data"],
                 "the pair batch (data axis)")
        parts = {}
        for _, lo, blocks in mesh.split_rows([qseeds, qpos, tseeds, tpos],
                                             [-1, 0, -1, 0]):
            out = chain_batch(*blocks, k=k, max_anchors=max_anchors)
            parts[lo] = out["through"].cpu().numpy()
        return counts, np.concatenate(mesh.gather(parts))

    return run
