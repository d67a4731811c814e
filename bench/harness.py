"""One run of one cell: set-up, a closed-loop window of jobs, the comparison
that decides `correct`, and the result line.

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs[].file`, whose `reference` names `bench/reference/<name>.py`) and
a traffic mix (`bench/traffic/<mix>.json`, whose `entry` names
`bench/entries/<entry>.py`, the one generator of that kind of job); its
limits are `bench/limits/<cell>.json` and each metric is read by
`bench/metrics/<metric>.py`. Everything is found by these names.

The window: one client runs jobs back to back from the end of set-up until
the first job that would start after `seconds`; the last job ends it. A job
runs from the call into the program to its results on the host. With
`trace`, the first `trace_jobs` jobs of the window run under torch.profiler,
each inside a `bench.job` span, and the per-layer metrics are read: those
of the device from that trace, those of the host's clock from the jobs
after it, which the profiler did not see. Otherwise the end-to-end metrics
are read. A sample of the window's jobs, drawn from the seed (job 0 and up
to `check_jobs` - 1 more), is kept and compared with the plain reference once the window has closed
and the device's memory peak has been read.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

from bench import power as power_mod
from bench import trace as trace_mod
from bench.common import BENCH, derive_seed, load_json, load_module

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


@dataclasses.dataclass
class Spec:
    """What `BENCHMARK.json` and the cell's files say of one cell."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def spec(root: Path, name: str) -> Spec:
    """The cell `name` of the benchmark at checkout `root`."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    wl = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[wl["config"]]["file"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Spec(name, wl, config, load_json(root / "bench" / "traffic" / f"{wl['traffic']}.json"),
                load_json(root / "bench" / "limits" / f"{name}.json"),
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


class Sample:
    """Job 0 and a uniform sample, drawn from the seed, of up to k - 1 of the
    later jobs (reservoir sampling): what the comparison reads."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(seed), {}, 0

    def offer(self, j: int, out) -> None:
        if j == 0:
            self.kept[0] = out
            return
        self.seen += 1
        slots = self.k - 1
        if len(self.kept) - (0 in self.kept) < slots:
            self.kept[j] = out
            return
        r = self.rng.randrange(self.seen)
        if r < slots:
            later = sorted(x for x in self.kept if x != 0)
            del self.kept[later[r]]
            self.kept[j] = out


@dataclasses.dataclass
class Run:
    """What one run measured: the metric readers read it."""

    spec: Spec
    cell: object
    root: Path
    setup_s: float = 0.0
    setup_parts: str = ""  # where set-up's seconds went
    latencies_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    wall: tuple = (0.0, 0.0)  # the window's ends, time.time()
    failed: int = 0
    power: object = None
    trace: object = None
    traced_jobs: int = 0
    untraced_s: float = 0.0  # the window's seconds after the profiler stopped

    @property
    def untraced(self) -> tuple[list, float]:
        """(latencies, seconds) of the window's jobs that ran without the
        profiler: all of them in an untraced run."""
        if self.trace is None:
            return self.latencies_s, self.window_s
        return self.latencies_s[self.traced_jobs:], self.untraced_s

    @property
    def jobs(self) -> int:
        return len(self.latencies_s)

    @property
    def updates(self) -> int:
        return self.jobs * self.cell.updates_per_job

    @property
    def steps(self) -> int:
        return self.jobs * self.cell.steps_per_job

    @property
    def traced_steps(self) -> int:
        return self.traced_jobs * self.cell.steps_per_job

    def roofline(self, name: str):
        return load_module("roofline", name, self.root / "bench")


def _synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", card: bool = True) -> tuple[dict, list, Run]:
    """One run of cell `name`; returns (the result line, the checks as
    (name, value, limit), what was measured). `t0` is the process's start
    on perf_counter's clock. `card=False` (tests on the CPU) skips the look
    for a card and the power samples."""
    import torch

    s = spec(root, name)
    if card:
        need = s.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"cell {name} needs {need} CUDA device(s); "
                             f"this machine has {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_import = time.perf_counter()
    entry = load_module("entries", s.traffic["entry"], root / "bench")
    cell = entry.Cell(s.config, s.traffic, seed, device, root / "bench")
    run = Run(s, cell, root)
    t_cell = time.perf_counter()
    sampler = None
    if card:
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        card_id = f"GPU-{uuid}" if uuid else str(torch.device(device).index or 0)
        sampler = power_mod.PowerSampler(card_id)
    try:
        cell.job("warm")
        _synchronize(device)
        t_warm = time.perf_counter()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            cell.job("warm")  # the profiler's own first use stays out of the window
            _synchronize(device)
        if sampler is not None:
            sampler.wait_for(time.time())
        run.setup_s = time.perf_counter() - t0
        run.setup_parts = (f"start and torch {t_import - t0:.3f} s, "
                           f"instance {t_cell - t_import:.3f} s, warm job {t_warm - t_cell:.3f} s, "
                           f"rest {t0 + run.setup_s - t_warm:.3f} s")
        sample = Sample(s.traffic["check_jobs"], derive_seed(seed, "sample"))
        run.window_s, run.wall, prof = _window(run, sample, seconds, prof)
        if sampler is not None:
            sampler.wait_for(run.wall[1])
    finally:
        if sampler is not None:
            sampler.stop()
    run.power = sampler
    peak = torch.cuda.max_memory_allocated(device) if card else 0
    if prof is not None:
        run.trace = trace_mod.from_profiler(prof)
    cell.release()
    checks = _checks(s, cell, sample.kept, run.failed)
    line = _line(run, checks, peak, device, trace, strict=card)
    return line, checks, run


def _window(run: Run, sample: Sample, seconds: float, prof):
    """The closed loop; returns (seconds, wall ends, the stopped profiler)."""
    import torch

    traced = run.spec.traffic["trace_jobs"] if prof is not None else 0
    w0, wall0 = time.perf_counter(), time.time()
    deadline = w0 + seconds
    j, t_untraced = 0, None
    while time.perf_counter() < deadline:
        a = time.perf_counter()
        try:
            if j < traced:
                with torch.profiler.record_function(trace_mod.JOB_SPAN):
                    out = run.cell.job(j)
            else:
                out = run.cell.job(j)
        except Exception as exc:  # a job that fails counts as failed, and the loop goes on
            print(f"job {j} failed: {exc!r}", file=sys.stderr)
            run.failed += 1
            out = None
        run.latencies_s.append(time.perf_counter() - a)
        if out is not None:
            sample.offer(j, out)
        j += 1
        if j == traced:
            prof.stop()
            run.traced_jobs = traced
            t_untraced = time.perf_counter()
    w1, wall1 = time.perf_counter(), time.time()
    if t_untraced is not None:
        run.untraced_s = w1 - t_untraced
    elif prof is not None:  # the window ended first
        prof.stop()
        run.traced_jobs = j
    return w1 - w0, (wall0, wall1), prof


def _checks(s: Spec, cell, kept: dict, failed: int) -> list:
    """(name, value, limit) of every number compared; a job that failed, or
    no job to compare, counts as one number over its limit."""
    values = cell.compare(kept) if kept else {}
    out = [(k, float(v), float(s.limits[k])) for k, v in values.items()]
    missing = [k for k in s.limits if k not in values]
    out += [(k, math.inf, float(s.limits[k])) for k in missing]
    out.append(("failed_jobs", float(failed), 0.0))
    return out


def _line(run: Run, checks: list, peak: int, device, trace: bool, strict: bool) -> dict:
    import torch

    s = run.spec
    metrics = {}
    for m in (s.per_layer if trace else s.end_to_end):
        value = load_module("metrics", m["name"], run.root / "bench").read(run)
        if value is None:
            if strict and not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} could not be read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": s.workload["chips"], "memory_peak_bytes": peak}
    line = {"correct": all(v <= lim for _, v, lim in checks), "attempted": run.jobs,
            "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(args, t0: float) -> int:
    """The command: one run, the job count and latencies, then each number
    compared beside its limit as the last lines on standard error, and the
    result line last on standard output. Exits 3, printing no result, if a
    module of JAX or of the JAX package was loaded."""
    line, checks, run = run_cell(BENCH.parent, args.workload, args.seed, args.seconds,
                                 bool(args.trace), t0=t0)
    lat = sorted(x * 1e3 for x in run.latencies_s)
    q1, median, q3 = statistics.quantiles(lat, n=4) if len(lat) > 1 else lat * 3
    print(f"jobs {run.jobs} failed {run.failed} window_s {run.window_s:.4f} "
          f"latency_ms min {lat[0]:.3f} q1 {q1:.3f} median {median:.3f} q3 {q3:.3f} "
          f"p90 {lat[math.ceil(0.9 * len(lat)) - 1]:.3f} max {lat[-1]:.3f}; "
          f"setup_s {run.setup_s:.4f} ({run.setup_parts})", file=sys.stderr)
    loaded = forbidden_modules()
    if loaded:
        print(f"refused: these modules were loaded: {loaded}", file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
