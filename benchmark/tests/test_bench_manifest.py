"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, and a file of its own for every configuration, traffic mix,
metric reader and reference, found by name."""
import json
import os
import re

import pytest

from benchmark import run

ROOT = run.ROOT
MAN = run.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51


def test_paths_and_command():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_configuration(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _text(entry["why"])
    assert _text(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith(MAN["paths"][0] + "/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16
    for k in entry["reduced"]:
        assert NAME.match(k) and k in cfg
        assert not re.search(r"(_dim|_rank|hidden|width)", k)
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(cell[k])
    assert _text(cell["why"]) and cell["chips"] in (1, 4)
    _, _, _, trf = run.cell_parts(MAN, cell["name"])
    kind = trf["kind"]
    for sub in ("kinds", "reference"):
        assert os.path.exists(os.path.join(run.HERE, sub, kind + ".py"))
    e2e, layer = run.metrics_of(MAN, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    lim = run.limits(cell["name"])
    assert lim and all(isinstance(v, (int, float)) and v >= 0
                       for v in lim.values())


def test_names_unique_and_every_config_used():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                       "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                       "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert _text(m["layer"])
    e2e = {e["name"]: e for e in MAN["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    for w in m.get("workloads", []):
        assert w in e2e[m["moves"]].get("workloads", [w])
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"
    reader = run.reader(m["name"])
    assert callable(reader.read)


def test_layers_named_alike():
    by_prefix = {}
    for m in MAN["per_layer"]:
        if m["layer"].startswith("kernel ") or m["layer"] == "device":
            by_prefix.setdefault(m["name"].split(".")[0], set()).add(
                m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_files_under_paths_are_named_from_names():
    for root, _, files in os.walk(os.path.join(ROOT, MAN["paths"][0])):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), ROOT)
            assert PATH.match(rel), rel
