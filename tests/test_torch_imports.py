"""The port imports neither JAX nor the JAX package: every module under
src/repro_torch and chip_smoke.py is walked as an AST, and a fresh
interpreter that imports every module of the port finds neither `jax` nor
any `repro.` module in sys.modules (a transitive import would show there)."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_port_files_found():
    assert len(PORT_FILES) >= 12, PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({m for m in _imported_modules(tree) if _forbidden(m)})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_check_matches_by_module_name():
    tree = ast.parse(
        "import jax.numpy as jnp\nfrom repro.core import ising\n"
        "from repro_torch.core import ising\nimport reprolib\n"
    )
    assert [m for m in _imported_modules(tree) if _forbidden(m)] == ["jax.numpy", "repro.core"]


def _port_modules():
    src = REPO / "src"
    return sorted(".".join(p.relative_to(src).with_suffix("").parts).removesuffix(".__init__")
                  for p in (src / "repro_torch").rglob("*.py"))


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    modules = _port_modules()
    assert "repro_torch.core.sampler_api" in modules and len(modules) >= 18, modules
    assert {"repro_torch.examples.quickstart", "repro_torch.examples.serve_lm"} <= set(modules)
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'loaded': len(sys.modules), 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
