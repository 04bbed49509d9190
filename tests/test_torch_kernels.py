"""The port's CUDA kernel against its plain torch version, and the kernel
wrapper's contract.  This file imports no JAX, so it also runs on a card
machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX).  Tests
marked ``cuda`` skip without a card.  Kernel and plain version must agree
exactly (tolerance 0: integer DP).
"""
import numpy as np
import pytest
import torch

from downpore_tpu_torch.ops import cuda_chain

torch.set_num_threads(2)

SCAN_NAMES = ["score", "cov_q", "cov_t", "s_qp", "s_tp", "bp"]
VARIANTS = ["extend", "aligner"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain kernel has no CPU mode")
    return torch.device("cuda")


def anchor_batch(rng, P, A):
    """Random anchors: sorted positions, rank indices with swapped
    neighbours, 85% valid (the recipe of test_align.py's Pallas test)."""
    qp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    tp = np.sort(rng.integers(0, 400, (P, A)), axis=1).astype(np.int32)
    qi = np.argsort(np.argsort(qp, axis=1), axis=1).astype(np.int32)
    tj = np.argsort(np.argsort(tp, axis=1), axis=1).astype(np.int32)
    for p in range(P):
        for s in rng.integers(0, A - 1, 20):
            tj[p, s], tj[p, s + 1] = tj[p, s + 1], tj[p, s]
    valid = (rng.random((P, A)) < 0.85).astype(np.int32)
    return [torch.from_numpy(a) for a in (qi, tj, qp, tp, valid)]


def test_chain_scan_checks_inputs():
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_chain.chain_scan(a.long(), a, a, a, a, 10)
    with pytest.raises(ValueError):
        cuda_chain.chain_scan(a, a, a, a, a[:, :4], 10)
    with pytest.raises(ValueError):
        cuda_chain.chain_scan(a, a, a, a, a.t().contiguous().t(), 10)
    with pytest.raises(ValueError):
        cuda_chain.chain_scan(a, a, a, a, a, 10, "greedy")


def test_chain_scan_empty_batch():
    a = torch.zeros((0, 16), dtype=torch.int32)
    outs = cuda_chain.chain_scan(a, a, a, a, a, 11)
    assert len(outs) == 6 and all(o.shape == (0, 16) for o in outs)


def test_chain_scan_plain_planted_chain():
    """Four colinear anchors 20 bases apart chain 1-2-3-4; an anchor out of
    order in the target and an invalid one start nothing."""
    k = 11
    qp = torch.tensor([[0, 20, 40, 45, 60, 80]], dtype=torch.int32)
    tp = torch.tensor([[100, 120, 140, 10, 160, 180]], dtype=torch.int32)
    qi = torch.tensor([[0, 1, 2, 3, 4, 5]], dtype=torch.int32)
    tj = torch.tensor([[5, 6, 7, 0, 8, 9]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 1, 1, 0]], dtype=torch.int32)
    score, cov_q, cov_t, s_qp, s_tp, bp = cuda_chain.chain_scan(
        qi, tj, qp, tp, valid, k)
    assert score.tolist() == [[1, 2, 3, 1, 4, 0]]
    assert bp.tolist() == [[-1, 0, 1, -1, 2, -1]]
    assert cov_q.tolist() == [[11, 22, 33, 11, 44, 0]]
    assert s_qp.tolist() == [[0, 0, 0, 45, 0, 0]]
    assert s_tp.tolist() == [[100, 100, 100, 10, 100, 0]]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_scan_kernel_matches_plain_on_card(cuda_device, variant):
    rng = np.random.default_rng(0)
    for A in (64, 128, 384):
        arrs = [a.to(cuda_device) for a in anchor_batch(rng, 256, A)]
        for ins in (arrs, [torch.flip(-a, dims=(1,)) for a in arrs[:4]]
                    + [torch.flip(arrs[4], dims=(1,))]):
            before = cuda_chain.chain_scan.launches
            got = cuda_chain.chain_scan(*ins, 10, variant)
            ref = cuda_chain.chain_scan_plain(*ins, 10, variant)
            torch.cuda.synchronize()
            assert cuda_chain.chain_scan.launches == before + 1
            for name, r, g in zip(SCAN_NAMES, ref, got):
                assert torch.equal(r, g), f"A={A} {variant}:{name}"


@pytest.mark.cuda
def test_map_batch_on_card_matches_cpu(cuda_device):
    from downpore_tpu.core import Sequence
    from downpore_tpu.utils.kmers import kmer_occurrences, score_seed_values
    from downpore_tpu_torch.mapping import Mapper

    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = Sequence.from_string(
        bases[rng.integers(0, 4, 60000)].tobytes().decode(), id=0,
        name="chr")
    values = score_seed_values(kmer_occurrences([genome], 11), 11)
    args = (genome, False, 11, values, 40, 1000, 10000)
    on_card = Mapper(*args, device=cuda_device)
    on_cpu = Mapper(*args, device="cpu")
    reads = []
    for i in range(24):
        p = int(rng.integers(0, 55000))
        codes = genome.codes[p:p + int(rng.integers(1500, 5000))].copy()
        m = rng.random(len(codes)) < 0.08
        codes[m] = (codes[m] + rng.integers(1, 4, int(m.sum()))) % 4
        reads.append(Sequence(codes, id=i, name=f"r{i}"))
    before = cuda_chain.chain_scan.launches
    got = [[on_card.as_string(m) for m in ms]
           for ms in on_card.map_batch(reads)]
    assert cuda_chain.chain_scan.launches > before
    ref = [[on_cpu.as_string(m) for m in ms]
           for ms in on_cpu.map_batch(reads)]
    assert got == ref
    assert sum(1 for ms in got if ms) >= 22
