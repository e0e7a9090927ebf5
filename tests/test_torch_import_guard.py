"""The PyTorch port stands alone: no module of photon_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib or the JAX package photon_tpu.

The import check runs in a subprocess: this test process has already
imported jax through tests/conftest.py, so an in-process check could not
see an import that the port makes.
"""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "photon_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "photon_tpu")
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


_BLOCKER = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCK = ("jax", "jaxlib", "photon_tpu")
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCK):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Blocker())
import photon_tpu_torch
names = ["photon_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(photon_tpu_torch.__path__, "photon_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCK))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_photon_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # every module of the package was imported (not an empty walk)
    assert int(proc.stdout.strip().splitlines()[-1]) >= len(
        [p for p in PORT.rglob("*.py") if p.name != "__init__.py"]
    )


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_file_names_no_jax_module(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            fname = getattr(fn, "attr", None) or getattr(fn, "id", None)
            arg = node.args[0]
            if (
                fname in ("import_module", "__import__")
                and isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)
                and _forbidden(arg.value)
            ):
                bad.append(arg.value)
    assert not bad, f"{path.name} imports {bad}"


def test_mesh_package_and_rank_worker_are_covered():
    """``photon_tpu_torch/parallel/`` is in both checks above (the
    subprocess walk imports every module of the package; the per-file
    check holds each file), and the rank processes of the mesh tests
    (tests/torch_mesh_worker.py) import no JAX module either."""
    parallel = sorted((PORT / "parallel").glob("*.py"))
    assert {p.stem for p in parallel} >= {"__init__", "mesh", "sparse", "distributed"}
    assert all(p in PORT_FILES for p in parallel)
    test_port_file_names_no_jax_module(ROOT / "tests" / "torch_mesh_worker.py")
