"""A checkout of the benchmark cut to sizes the CPU runs in seconds: every
cell of `BENCHMARK.json` with its own configuration, traffic and limits,
fewer chains, steps and sites (the names of the cells stay)."""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench"

# what each tiny cell changes in the real configuration and traffic
SHRINK_CONFIG = {"sk2000": {"n": 64}}
SHRINK_TRAFFIC = {
    "anneal": {"n_chains": 8, "n_steps": 60, "sample_every": 20, "check_jobs": 3},
    "solve": {"n_chains": 8, "n_steps": 60, "first_hit_per_site": -0.55, "check_jobs": 3},
    "cal_solve": {"n_chains": 16, "n_steps": 40, "sample_every": 10, "check_jobs": 2},
    "cd": {"check_jobs": 3},
}


def tiny_root(tmp: Path) -> Path:
    """A checkout under `tmp`: bench/ copied with tiny sizes written over its
    configurations and traffic, BENCHMARK.json, and the program's source
    linked in."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(REPO / "src", root / "src")
    for name, change in SHRINK_CONFIG.items():
        path = root / "bench" / "configs" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    for name, change in SHRINK_TRAFFIC.items():
        path = root / "bench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    return root
