"""The frozen bytes and operations of each kernel at the cells' shapes give
the bounds `chip_smoke.py` published (PERF.md's table of kernels): 0.00313 ms
for tau_leap_step at (256, 2048), 0.00377 ms for the f32 lattice sweep at
(4096, 16, 16) and 0.01524 ms for the coloured sweep at (256, 16384), D = 3,
C = 4."""
import json

import pytest

from bench import peaks
from bench.common import load_module
from bench_tiny import REPO


@pytest.mark.parametrize("kernel, shape, published_ms", [
    ("tau_leap_step", {"chains": 256, "sites": 2048}, 0.00313),
    ("lattice_gibbs_sweep", {"chains": 4096, "sites": 256, "H": 16, "W": 16}, 0.00377),
    ("colored_gibbs_sweep", {"chains": 256, "sites": 16384, "degree": 3, "colours": 4}, 0.01524),
])
def test_bound_matches_the_published_one(kernel, shape, published_ms):
    got = peaks.bound_s(*load_module("roofline", kernel).work(shape)) * 1e3
    assert got == pytest.approx(published_ms, abs=5e-6)


def test_tau_leap_is_bound_by_bytes_and_the_sweep_too():
    nbytes, ops, rate = load_module("roofline", "tau_leap_step").work({"chains": 256, "sites": 2048})
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / rate
    nbytes, ops, rate = load_module("roofline", "lattice_gibbs_sweep").work(
        {"chains": 4096, "sites": 256})
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / rate
    nbytes, ops, rate = load_module("roofline", "colored_gibbs_sweep").work(
        {"chains": 256, "sites": 16384, "degree": 3, "colours": 4})
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / rate


def test_every_step_kernel_and_work_named_by_a_mix_exists():
    for mix in (REPO / "bench" / "traffic").glob("*.json"):
        t = json.loads(mix.read_text())
        for key in ("step_kernel", "step_work"):
            if t.get(key):
                module = load_module("roofline", t[key])
                assert callable(module.work) and isinstance(module.TRACE_NAMES, tuple)
