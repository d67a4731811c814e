"""The port imports neither JAX nor the JAX package: every module under
src/repro_torch and chip_smoke.py is walked as an AST."""
import ast
import pathlib

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
