"""The benchmark's frozen bound functions give what ``chip_smoke.py``'s
give on fixed inputs."""
import os
import sys

import pytest
import torch

from benchmark import bounds, run

sys.path.insert(0, run.ROOT)
chip_smoke = pytest.importorskip("chip_smoke")


def test_peaks_and_bound():
    assert bounds.INT32_OPS_S == chip_smoke.INT32_OPS_S
    assert bounds.HBM_BYTES_S == chip_smoke.HBM_BYTES_S
    for ops, nbytes in ((1e9, 1e6), (1e6, 1e9), (0, 0)):
        assert bounds.bound(ops, nbytes) == chip_smoke.bound(ops, nbytes)


@pytest.mark.parametrize("mode", ["forward", "fb", "lean"])
def test_chain_bound(mode):
    g = torch.Generator().manual_seed(1)
    valid = (torch.rand((64, 96), generator=g) < 0.6).int()
    assert bounds.chain_bound(valid, mode) == \
        chip_smoke.chain_bound(valid, mode)


def _anchor_args(indexed: bool):
    g = torch.Generator().manual_seed(2)
    M, C, NQ, NT, P = 12, 9, 16, 40, 30
    qs = torch.randint(-1, 50, (M, NQ), generator=g, dtype=torch.int32)
    qpos = torch.randint(0, 900, (M, NQ), generator=g, dtype=torch.int32)
    ts = torch.randint(-1, 50, (C, NT), generator=g, dtype=torch.int32)
    tpos = torch.randint(0, 9000, (C, NT), generator=g, dtype=torch.int32)
    if not indexed:
        return (qs[:C], qpos[:C], ts, tpos)
    mi = torch.randint(0, M, (P,), generator=g)
    ci = torch.randint(0, C, (P,), generator=g)
    live = torch.rand(P, generator=g) < 0.8
    return (qs, qpos, ts, tpos, mi, ci, live)


@pytest.mark.parametrize("indexed", [False, True])
def test_anchors_bound(indexed):
    from downpore_tpu_torch.ops.cuda_anchors import anchors_topk_plain
    args = _anchor_args(indexed)
    outs = anchors_topk_plain(*args)
    assert bounds.anchors_bound(args, outs) == \
        chip_smoke.anchors_bound(args, outs)


@pytest.mark.parametrize("binned", [False, True])
def test_counts_bound(binned):
    g = torch.Generator().manual_seed(3)
    H, W, M, R, NB, BB = 64, 32, 10, 12, 4, 2
    mem = torch.randint(0, 2, (H * (NB if binned else 1), W), generator=g,
                        dtype=torch.int8)
    b = torch.randint(-1, H, (M, R), generator=g, dtype=torch.int32)
    first = torch.rand((M, R), generator=g) < 0.5
    topbin = torch.randint(0, NB, (M, BB), generator=g) if binned else None
    args = (mem, b, first, topbin, NB if binned else 1)
    assert bounds.counts_bound(args) == chip_smoke.counts_bound(args)
