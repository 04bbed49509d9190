"""Shared set-up of the benchmark's tests: the port on the CPU, and the
cells shrunk to sizes a test run can hold."""
import json
import os

import pytest

os.environ.setdefault("DOWNPORE_TORCH_DEVICE", "cpu")

# the cells at test size: (configuration changes, traffic changes)
SMALL = {
    "random_4m6_k11.map": ({"genome_bases": 300_000},
                           {"batch_reads": 32, "batches": 2}),
    "random_64m_k13.map": ({"genome_bases": 400_000},
                           {"batch_reads": 24, "batches": 2}),
}


def small(name: str):
    """(configuration, traffic) of cell ``name`` at test size."""
    from benchmark import run
    _, _, cfg, trf = run.cell_parts(run.manifest(), name)
    cfg, trf = json.loads(json.dumps(cfg)), json.loads(json.dumps(trf))
    c, t = SMALL[name]
    cfg.update(c)
    trf.update(t)
    return cfg, trf


@pytest.fixture
def card():
    """Skips a test without a CUDA card: the port's kernels have none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
