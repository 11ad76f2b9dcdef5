"""The port stands alone: no module of ``clima_oceananigans_jl_torch``, and
neither of its scripts on the card (``chip_smoke.py``,
``chip_breakdown.py``), imports JAX or the JAX package.

Every module is imported, one after another, in a fresh interpreter
whose ``sys.meta_path`` starts with a finder that raises on ``jax``,
``jaxlib`` and ``clima_oceananigans_jl_tpu`` (and their submodules), so
an import anywhere below a module fails its case; the interpreter reports
each module's outcome once and each case reads its own. The scripts'
imports, which need a card to run, are read with ``ast``.
"""
import ast
import functools
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import clima_oceananigans_jl_torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "clima_oceananigans_jl_tpu")

GUARD = """
import importlib, json, sys
FORBIDDEN = {forbidden!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"the port imported {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
out = {{}}
for module in {modules!r}:
    try:
        importlib.import_module(module)
        out[module] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    except Exception as e:  # the case of this module reports it
        out[module] = repr(e)
print(json.dumps(out))
"""

MODULES = sorted(
    ["clima_oceananigans_jl_torch"]
    + [m.name for m in pkgutil.walk_packages(clima_oceananigans_jl_torch.__path__,
                                             "clima_oceananigans_jl_torch.")])


def test_every_module_is_listed():
    names = set(MODULES)
    for sub in ("solvers.tridiagonal", "solvers.fourier_tridiagonal",
                "closures.eddy_viscosity", "closures.implicit_vertical_diffusion"):
        assert f"clima_oceananigans_jl_torch.{sub}" in names


@functools.lru_cache(maxsize=None)
def guarded_imports():
    """{module: [forbidden modules loaded] or the import's error}."""
    code = GUARD.format(forbidden=FORBIDDEN, modules=MODULES)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(module):
    assert guarded_imports()[module] == []


def imported_names(path):
    """Every module name an import statement of ``path`` names (all
    levels of the file, functions included)."""
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_breakdown.py"])
def test_card_scripts_import_no_jax(script):
    names = imported_names(ROOT / script)
    assert any(n.startswith("clima_oceananigans_jl_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
