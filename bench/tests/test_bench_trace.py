"""The arithmetic that turns a trace and the power samples into metrics."""
import types

import pytest

from bench import power, trace
from bench.common import load_module


def _trace():
    # two jobs: [0, 10] and [12, 20]; device ops overlap in the first; the
    # profiler's warm job ran before the first span, and the benchmark's own
    # work between the spans
    jobs = [(0.0, 10.0), (12.0, 20.0)]
    ops = [("tau_leap_kernel<false>", -4.0, -3.0, "kernel"),  # the warm job, outside the window
           ("tau_leap_kernel<false>", 1.0, 3.0, "kernel"), ("pack_spins_kernel", 2.0, 4.0, "kernel"),
           ("Memcpy DtoD", 5.0, 6.0, "gpu_memcpy"), ("uniform_kernel", 9.0, 11.0, "kernel"),
           ("copy_kernel", 11.0, 11.5, "kernel"),  # between the spans, inside the window
           ("tau_leap_kernel<false>", 13.0, 15.0, "kernel"), ("uniform_kernel", 16.0, 16.5, "kernel"),
           ("other", 30.0, 31.0, "kernel")]  # after the window
    host = [("bench.job", 0.0, 10.0), ("cudaFree", 6.0, 8.5), ("aten::add", 6.5, 7.0),
            ("bench.job", 12.0, 20.0), ("cudaGraphLaunch", 15.0, 19.0)]
    return trace.Trace(jobs, ops, host)


def test_busy_is_a_union_inside_the_window():
    t = _trace()
    assert t.window == (0.0, 20.0) and t.window_s == 20.0
    assert t.busy_s == pytest.approx(3.0 + 1.0 + 2.5 + 2.0 + 0.5)
    assert t.job_idle_s() == pytest.approx([10.0 - 5.0, 8.0 - 2.5])


def test_kernel_seconds_by_name():
    t = _trace()
    # only what runs inside the jobs' spans counts, clipped to them
    assert t.kernel_seconds(("tau_leap_kernel",)) == pytest.approx((4.0, 2))
    assert t.kernel_seconds() == pytest.approx((2.0 + 2.0 + 1.0 + 2.0 + 0.5, 5))
    assert dict(t.top_ops()) == pytest.approx({"tau_leap_kernel<false>": 4.0, "pack_spins_kernel": 2.0,
                                               "uniform_kernel": 1.5, "Memcpy DtoD": 1.0})


def test_idle_gaps_go_to_the_innermost_host_event():
    gaps = dict(_trace().idle_gaps())
    # [0,1] and [4,5]: the job span; [6,9], mid 7.5: cudaFree (aten::add ended at 7);
    # [11.5,13], mid 12.25: the second job's span; [15,16] and [16.5,20]: cudaGraphLaunch
    assert gaps == pytest.approx({"bench.job": 3.5, "cudaFree": 3.0, "cudaGraphLaunch": 4.5})


def test_readers_on_a_trace():
    t = _trace()
    run = types.SimpleNamespace(trace=t, traced_steps=4, spec=types.SimpleNamespace(
        traffic={"step_kernel": "tau_leap_step"}), roofline=lambda n: load_module("roofline", n),
        cell=types.SimpleNamespace(shape={"chains": 256, "sites": 2048}))
    assert load_module("metrics", "launches_per_step").read(run) == 5 / 4
    assert load_module("metrics", "step_other_us").read(run) == pytest.approx(1e6 * 1.5 / 4)
    assert load_module("metrics", "idle_share").read(run) == pytest.approx(100 * 11.0 / 20)
    assert load_module("metrics", "job_idle_ms").read(run) == pytest.approx(5.25e3)
    share = load_module("metrics", "tau_leap_step_roofline").read(run)
    assert share == pytest.approx(100 * 3.1328e-6 / 3.0, rel=1e-3)  # 6 s over 2 calls
    assert load_module("metrics", "lattice_gibbs_sweep_roofline").read(run) is None


def test_power_sample_lines_and_the_energy_of_a_window():
    assert power._parse("2026/10/17 23:02:14.250, 312.50")[1] == 312.5
    assert power._parse("[N/A]") is None and power._parse("2026/10/17 23:02:14.250, [N/A]") is None
    p = power.PowerSampler.__new__(power.PowerSampler)
    p.samples = [(0.0, 100.0), (1.0, 300.0), (2.0, 300.0), (3.0, 100.0)]
    assert p.energy_j(0.5, 2.5) == pytest.approx(0.5 * 250 + 300 + 0.5 * 250)
    assert p.mean_w(0.0, 3.0) == pytest.approx(700.0 / 3)
    with pytest.raises(RuntimeError):
        p.energy_j(-1.0, 2.0)


def test_host_clock_readers_of_a_traced_run_take_the_jobs_after_the_profiler():
    from bench import harness, peaks
    from bench_tiny import REPO

    cell = types.SimpleNamespace(shape={"chains": 256, "sites": 2000}, steps_per_job=2000,
                                 first_hit=None)
    spec = types.SimpleNamespace(traffic={"step_work": "tau_leap_step"})
    # two profiled jobs of 9 s, then ten of 1 s in the 10 s after the profiler stopped
    run = harness.Run(spec, cell, REPO, latencies_s=[9.0] * 2 + [1.0] * 10, window_s=30.0,
                      trace=_trace(), traced_jobs=2, untraced_s=10.0)
    assert run.untraced == ([1.0] * 10, 10.0)
    assert load_module("metrics", "job_p90_ms.solve").read(run) == 1e3
    bound = peaks.bound_s(*load_module("roofline", "tau_leap_step").work(cell.shape))
    assert load_module("metrics", "step_mfu").read(run) == pytest.approx(100 * bound / (10.0 / 20000))
    run.trace = None  # an untraced run: every job
    assert run.untraced == (run.latencies_s, 30.0)
