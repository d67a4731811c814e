"""A checkout of the benchmark cut to sizes the CPU runs in seconds: every
configuration and traffic file with its own `tiny` object (the top-level
keys it overrides) written over it, so every cell keeps its name and its
limits and runs fewer chains, steps and sites. A cell brings its CPU test
sizes in its own files; nothing here names one."""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench"


def tiny_root(tmp: Path, source: Path = REPO) -> Path:
    """A checkout under `tmp`: `source`'s bench/ and BENCHMARK.json with each
    configuration's and traffic mix's `tiny` sizes written over it, and the
    program's source linked in."""
    root = tmp / "checkout"
    shutil.copytree(source / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(source / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(REPO / "src", root / "src")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    configs = [root / c["file"] for c in bench["configs"]]
    for path in configs + sorted((root / "bench" / "traffic").glob("*.json")):
        data = json.loads(path.read_text())
        path.write_text(json.dumps({**data, **data["tiny"]}))
    return root
