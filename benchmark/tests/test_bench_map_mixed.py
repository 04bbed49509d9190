"""The mixed map cells driven on the CPU at test sizes of their own: the
port judged by the cells' plain reference (``correct`` true), and
``correct`` false under the control and under each fault."""
import json

import pytest

from benchmark import faults, run

MAN = run.manifest()
# the cells at test size: (configuration changes, traffic changes)
SMALL = {
    "repeats_64m_k13.map_repeats": ({"genome_bases": 300_000},
                                    {"batch_reads": 24, "batches": 2}),
    "random_4m6_k11.map_offtarget": ({"genome_bases": 300_000},
                                     {"batch_reads": 64, "batches": 2}),
}
CELLS = sorted(SMALL)


def _run(name, seed=2**31 + 23):
    _, _, cfg, trf = run.cell_parts(MAN, name)
    cfg, trf = json.loads(json.dumps(cfg)), json.loads(json.dumps(trf))
    cfg.update(SMALL[name][0])
    trf.update(SMALL[name][1])
    return run.run_cell(name, seed, 0.05, False, "cpu", config=cfg,
                        traffic=trf, man=MAN)


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    line = run.result_line(res, "cpu", 1)
    assert list(line)[-1] == "checks"
    e2e, _ = run.metrics_of(MAN, name)
    assert set(line["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("plant", sorted(faults.PLANTS))
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_are_not_correct(name, plant):
    with faults.plant(plant):
        res = _run(name)
    assert not res["correct"], (plant, res["checks"])


def test_reference_judges_offtarget_reads():
    from benchmark.reference import map_mixed as ref
    fw = "r\t8000\t10\t7990\t+\tg\t100000\t5010\t12990\t40\t7980\t255"
    args = ([8000] * 4, [5000] * 4, [False] * 4)
    # an on-target read placed, an on-target read with no line, an
    # off-target read with no line, an off-target read with a line
    got = ref.judge([[fw], [], [], [fw]], ["r"] * 4, *args,
                    [False, False, True, True], "g", 100000)
    assert got == (2, 1)
