"""The control, the reference in the precision below the configuration's in
the program's place, comes out not correct at a size a test run holds: at
least one of each cell's numbers goes over its limit. (On the card, at the
cells' own sizes, `bench/calibrate.py` reads it; PERF.md gives those
readings.)"""
import json

import pytest

from bench import calibrate
from bench_tiny import REPO, tiny_root

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_number(tmp_path, cell):
    root = tiny_root(tmp_path)
    limits = json.loads((root / "bench" / "limits" / f"{cell}.json").read_text())
    sound = calibrate.readings(cell, 2**31 + 5, False, "cpu", root)
    control = calibrate.readings(cell, 2**31 + 5, True, "cpu", root)
    assert set(sound) == set(control) == set(limits)
    assert all(sound[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits), control
