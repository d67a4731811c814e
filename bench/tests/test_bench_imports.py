"""No module of the benchmark imports JAX, Flax or the JAX package `repro`
(top-level names compared whole: `repro_torch` is the port), and nothing the
benchmark runs reads the JAX package's old benchmark folder `benchmarks/`."""
import ast

from bench_tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = [(p.name, m) for p in files for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_the_port_is_imported_and_is_not_the_jax_package():
    names = {m.split(".")[0] for p in BENCH.rglob("*.py") for m in _imports(p)}
    assert "repro_torch" in names and "repro" not in names


def test_nothing_reads_the_old_benchmarks_folder():
    for p in BENCH.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text, p
