"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json``: the traffic file's
``kind`` names the driver (``benchmark/kinds/<kind>.py``) and its plain
reference (``benchmark/reference/<kind>.py``); each per-layer metric is
read by ``benchmark/metrics/<metric>.py`` or by its family's reader; the
limit of each number compared is in ``benchmark/limits/<cell>.json``.

A run sets up the cell (inputs from the seed, the port's objects, every
shape warmed), measures for ``--seconds`` seconds of closed-loop units,
then has the plain reference judge what the window produced.  The last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and, with
``--trace 1``, ``breakdown``) and, last, ``checks``: each number compared
with its limit.  The same numbers end standard error.

Exits non-zero with no result when there is no CUDA card (or fewer than
the cell asks for), when the program is missing, or when ``jax``,
``jaxlib``, ``flax`` or ``downpore_tpu`` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "downpore_tpu")
WINDOW_RANGE = "benchmark.window"


class Refused(Exception):
    """A run that must end without a result."""


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in list(names)} & set(FORBIDDEN))


def check_imports() -> None:
    bad = forbidden_modules()
    if bad:
        raise Refused(f"forbidden modules loaded: {', '.join(bad)}")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_parts(man: dict, name: str):
    """(cell entry, configuration entry, configuration file, traffic file)
    of cell ``name``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise Refused(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, conf, config, traffic


def metrics_of(man: dict, cell: str) -> tuple:
    """(end-to-end entries, per-layer entries) the cell reports."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if m["moves"] in names and cell in m.get("workloads", [cell])]
    return e2e, layer


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a per-layer metric: ``benchmark/metrics/<metric>.py``
    where there is one, else the reader of its family,
    ``benchmark/metrics/<name before the first dot>.py``; each has
    ``HOOKS`` (host spans it needs) and ``read(ctx)``."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            return load_file(path, "benchmark.metrics." +
                             stem.replace(".", "_"))
    raise Refused(f"no reader of the metric {metric!r}")


def limits(cell: str) -> dict:
    """The limit of each number compared in cell ``cell``:
    ``benchmark/limits/<cell>.json``."""
    return load_json(os.path.join(HERE, "limits", cell + ".json"))


def kind_module(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


class Context:
    """What a driver and a metric reader see of the run."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device):
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.spans = None
        self.units = 0
        self.window = (0.0, 0.0)
        self.counters = {}
        self.kernels = {}
        self.idle = None


def sync(device) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config=None, traffic=None,
             man=None) -> dict:
    """One run of cell ``name``: the result object (before the device
    entry).  ``config`` and ``traffic`` replace the cell's files (the
    tests' small sizes); ``device`` ``"cpu"`` runs the port's plain
    versions."""
    import torch

    from . import trace as tr

    man = man or manifest()
    cell, _, cfg, trf = cell_parts(man, name)
    cfg = config if config is not None else cfg
    trf = traffic if traffic is not None else trf
    lim = limits(name)
    e2e, layer = metrics_of(man, name)
    ctx = Context(cell, cfg, trf, seed, seconds, trace, device)
    on_card = trace and device == "cuda"
    w = kind_module(trf["kind"]).Workload(ctx)
    w.setup()
    readers = {m["name"]: reader(m["name"]) for m in layer} \
        if trace else {}
    spans = tr.Spans()
    hooks = [h for r in readers.values() for h in getattr(r, "HOOKS",
                                                           ())]
    hooks += getattr(kind_module(trf["kind"]), "LABELS", [])
    ctx.spans = spans
    with spans.hooks(hooks if trace else ()):
        w.warm()
        sync(device)
        # the set-up's objects (the index, and the inputs, origins and
        # outputs of every batch, which the map command would not hold
        # at once) leave the collector's generations: each collection
        # in the window then scans the program's new objects only
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - T_START
        before = w.counters()
        launches0 = tr.launches() if on_card else {}
        prof = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        try:
            done, keys = [], {}
            with torch.profiler.record_function(WINDOW_RANGE):
                t0 = time.perf_counter()
                while True:
                    key = w.unit_key()
                    bases = w.unit()
                    done.append((time.perf_counter(), bases))
                    keys[key] = keys.get(key, 0) + 1
                    if done[-1][0] - t0 >= seconds:
                        break
                sync(device)
                t_end = time.perf_counter()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        after = w.counters()
        launches1 = tr.launches() if on_card else {}
    ctx.units = len(done)
    ends = [t0] + [t for t, _ in done]
    each = sorted(b - a for a, b in zip(ends, ends[1:]))
    log(f"window: {len(done)} units in {t_end - t0:.3f} s; a unit "
        f"{each[0]:.3f} / {each[len(each) // 2]:.3f} / {each[-1]:.3f} "
        f"s (least / median / most); set-up {setup_s:.3f} s")
    ctx.window = (t0, t_end)
    ctx.counters = {k: after[k] - before.get(k, 0) for k in after}
    result = {"correct": False, "attempted": len(done), "failed": 0}
    metrics = {}
    if not trace:
        bases = sum(b for _, b in done)
        metrics[w.metric] = {"value": bases / (done[-1][0] - t0),
                             "unit": "bases/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {}
    if device == "cuda":
        dev["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(i)
            for i in range(int(cell["chips"])))
    if prof is not None:
        ws, we, acts = tr.device_activity(prof, WINDOW_RANGE)
        busy_us = tr.union_us((s, e) for s, e, _ in acts)
        dev["busy_s"] = busy_us / 1e6
        dev["window_s"] = (we - ws) / 1e6
        ctx.idle = 1.0 - busy_us / max(we - ws, 1e-9)
        result["breakdown"] = tr.breakdown(
            ws, we, acts, spans.flat(t0, t_end), t0)
        del prof
        # each unit's kernel work, after the window and the memory
        # peak: one eager pass over the units the window ran
        work, per_unit = tr.Work(), {}
        for key in keys:
            w.seek(key)
            per_unit[key] = work.unit_work(w.unit)
        ctx.kernels = tr.rooflines(
            per_unit, keys,
            {k: launches1[k] - launches0[k] for k in launches1}, acts)
    for m in layer if trace else ():
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    w.release()
    gc.unfreeze()
    checks = [(n, v, lim[n]) for n, v in w.check()]
    result["correct"] = all(v <= li for _, v, li in checks)
    result["metrics"] = metrics
    result["device_extra"] = dev
    result["checks"] = {n: {"value": v, "limit": li}
                        for n, v, li in checks}
    return result


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        check_imports()
        man = manifest()
        cell = cell_parts(man, args.workload)[0]
        # kernel and build caches stay inside the checkout, at fixed paths
        cache = os.path.join(ROOT, ".bench_cache")
        os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                              os.path.join(cache, "torch_extensions"))
        os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache,
                                                               "triton"))
        os.environ["DOWNPORE_TORCH_DEVICE"] = "cuda"
        os.environ.setdefault("USE_FLAX", "0")
        if importlib.util.find_spec("downpore_tpu_torch") is None:
            raise Refused("the program (downpore_tpu_torch) is not here")
        import torch
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{torch.cuda.device_count()} cards, the cell "
                          f"asks for {cell['chips']}")
        log(f"{args.workload}: seed {args.seed}, {args.seconds} s, trace "
            f"{args.trace}; {power_limit()}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}")
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", man=man)
        check_imports()
    except Refused as e:
        log(f"refused: {e}")
        return 1
    line = result_line(res, torch.cuda.get_device_name(0),
                       int(cell["chips"]))
    for n, c in line["checks"].items():
        log(f"check {n}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


def result_line(res: dict, device_name: str, chips: int) -> dict:
    """The printed result of ``run_cell``'s ``res``: the device entry in
    its place and the checks last."""
    line = {k: v for k, v in res.items()
            if k not in ("device_extra", "checks")}
    line["device"] = {"platform": "gpu", "kind": device_name,
                      "count": chips, **res["device_extra"]}
    line["checks"] = res["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
