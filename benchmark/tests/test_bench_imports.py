"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the
JAX package: the check by whole top-level names, and a fresh process that
imports every module of a run."""
import ast
import os
import subprocess
import sys

import pytest

from benchmark import run


@pytest.mark.parametrize("modules,found", [
    ({"downpore_tpu_torch": 1, "downpore_tpu_torch.ops": 1}, []),
    ({"downpore_tpu.ops": 1, "numpy": 1}, ["downpore_tpu"]),
    ({"jax.numpy": 1, "jaxtyping": 1, "flaxen": 1}, ["jax"]),
    ({"jaxlib": 1, "flax.linen": 1}, ["flax", "jaxlib"]),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert run.forbidden_modules(modules) == found


def _sources():
    for root, _, files in os.walk(run.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in run.FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_program():
    for path in _sources():
        if os.sep + "reference" + os.sep not in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                for n in names:
                    assert not n.startswith("downpore_tpu"), (path, n)


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, os; os.environ['DOWNPORE_TORCH_DEVICE'] = 'cpu'\n"
            "from benchmark import run, control, faults\n"
            "from benchmark.kinds import map\n"
            "from benchmark.reference import map as m2\n"
            "import downpore_tpu_torch.mapping\n"
            "for m in run.manifest()['per_layer']: run.reader(m['name'])\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
