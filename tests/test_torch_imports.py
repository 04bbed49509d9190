"""The port stands alone: no Python file of ``downpore_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax``, ``jaxlib`` or ``downpore_tpu``,
whether by an absolute import or by a relative one that climbs out of the
package.  A static check over the sources, so that an import on a branch
no test reaches is caught too."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "downpore_tpu_torch"
BANNED = {"jax", "jaxlib", "downpore_tpu"}


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def banned_imports(path: str, repo: str = REPO) -> list:
    """``(line, module)`` of each import in ``path`` that reaches a banned
    top-level package.  A relative import resolves against the file's own
    package; one that climbs above the repository root is banned too."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    rel = os.path.relpath(os.path.dirname(path), repo)
    package = [] if rel == "." else rel.split(os.sep)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names = [node.module]
            elif node.level - 1 >= len(package):
                bad.append((node.lineno, "." * node.level
                            + (node.module or "")))
                continue
            else:
                base = package[:len(package) - (node.level - 1)]
                names = [".".join(base + ([node.module] if node.module
                                          else []))]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in BANNED]
    return bad


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_package_import(path):
    assert banned_imports(path) == []


def test_sources_cover_the_device_grid():
    """The device grid package is among the checked sources."""
    checked = {os.path.relpath(p, REPO) for p in _sources()}
    for name in ("__init__.py", "mesh.py"):
        assert os.path.join(PKG, "parallel", name) in checked


def test_checker_sees_every_import_form(tmp_path):
    pkg = tmp_path / PKG / "sub"
    pkg.mkdir(parents=True)
    src = pkg / "mod.py"
    src.write_text(
        "import jax\n"
        "import jaxlib.xla_client\n"
        "from downpore_tpu.core import Sequence\n"
        "from downpore_tpu import native\n"
        "from .. import resolve_device\n"
        "from ..ops import chain\n"
        "from .... import escape\n"
        "def f():\n"
        "    import jax.numpy as jnp\n")
    assert banned_imports(str(src), str(tmp_path)) == [
        (1, "jax"), (2, "jaxlib.xla_client"), (3, "downpore_tpu.core"),
        (4, "downpore_tpu"), (7, "...."), (9, "jax.numpy")]
