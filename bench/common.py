"""Paths, seeds and loading by name: what every part of the benchmark shares.

A cell's configuration, traffic mix, limits, entry, reference, roofline
and metric readers are files of their own under `bench/`, found by the
names `BENCHMARK.json` gives, so a new cell brings files and entries and
edits none.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def derive_seed(seed: int, *keys) -> int:
    """A seed in [0, 2**63) drawn from `seed` and `keys`: the instance's,
    job j's and the sample's seeds of one run never coincide."""
    text = ":".join(str(x) for x in (seed, *keys)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def load_json(path: Path) -> dict:
    """A JSON file, with its path in the error when it is missing."""
    if not path.is_file():
        raise FileNotFoundError(f"missing benchmark file {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = BENCH):
    """`<root>/<kind>/<name>.py` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r}: "
                                f"{path} is missing")
    key = "bench_" + hashlib.sha256(str(path).encode()).hexdigest()[:16]
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module
