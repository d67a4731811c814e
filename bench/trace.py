"""What a torch.profiler trace of the traced jobs says, reduced to numbers.

The device's busy time is the union of its operations' intervals (kernels,
copies, fills), its idle time the rest of the traced window, which runs
from the first traced job's start to the last one's end (each job is a
`bench.job` span the benchmark records around its call). The arithmetic of
device time, idle share and launches follows `chip_ablate.py`'s (device
time summed from the kernels, idle share 1 - device / wall, launches the
kernels counted), frozen here, with the busy time taken as a union so that
overlapping operations count once.

The kernels counted (their seconds, the launches, the top operations) are
those inside the jobs' spans, clipped to them: the profiler starts before a
warm job that is no traced job, and what runs between the spans is the
benchmark's own work.

Every idle gap is put down to what the host was doing in its middle: the
innermost host event (an aten op, a CUDA runtime call, a span) open then on
the thread that ran the jobs.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "cuda_runtime", "user_annotation", "cuda_driver")
JOB_SPAN = "bench.job"


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged copies of (start, end) intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, a: float, b: float) -> float:
    """Length of [a, b] that the merged intervals cover."""
    i = max(bisect.bisect_right(merged, (a, float("inf"))) - 1, 0)
    total = 0.0
    for x, y in merged[i:]:
        if x >= b:
            break
        total += max(0.0, min(y, b) - max(x, a))
    return total


@dataclasses.dataclass
class Trace:
    """The traced window, its device operations and its host events (times
    in seconds on the profiler's clock)."""

    jobs: list  # (start, end) of each traced job
    ops: list  # (name, start, end, activity) of each device operation
    host: list  # (name, start, end) on the jobs' thread

    @property
    def window(self) -> tuple[float, float]:
        return min(a for a, _ in self.jobs), max(b for _, b in self.jobs)

    @property
    def window_s(self) -> float:
        a, b = self.window
        return b - a

    def merged(self):
        a, b = self.window
        return union((max(x, a), min(y, b)) for _, x, y, _ in self.ops if y > a and x < b)

    @property
    def busy_s(self) -> float:
        return sum(y - x for x, y in self.merged())

    def in_jobs(self) -> list:
        """(name, start, start + seconds inside the spans, activity) of each
        device operation that lies in a job's span, or overlaps one."""
        starts = [a for a, _ in self.jobs]
        out = []
        for name, x, y, kind in self.ops:
            i = bisect.bisect_right(starts, x) - 1  # the last job that starts by x
            inside = 0.0
            for a, b in self.jobs[max(i, 0):]:
                if a >= y:
                    break
                inside += max(0.0, min(y, b) - max(x, a))
            if inside > 0 or (i >= 0 and x < self.jobs[i][1]):
                out.append((name, x, x + inside, kind))
        return out

    def kernels(self) -> list:
        return [op for op in self.in_jobs() if op[3] == "kernel"]

    def kernel_seconds(self, match=None) -> tuple[float, int]:
        """(seconds, count) of the kernels inside the jobs' spans whose name
        holds any of `match` (all kernels when None)."""
        secs, count = 0.0, 0
        for name, a, b, _ in self.kernels():
            if match is None or any(m in name for m in match):
                secs += b - a
                count += 1
        return secs, count

    def job_idle_s(self) -> list[float]:
        """Each traced job's span less the device's busy time inside it."""
        merged = self.merged()
        return [(b - a) - covered(merged, a, b) for a, b in self.jobs]

    def top_ops(self, n: int = 10) -> list:
        """The device operations inside the jobs' spans that took most time,
        summed by name."""
        by = collections.Counter()
        for name, a, b, _ in self.in_jobs():
            by[name[:120]] += b - a
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The window's idle time, summed by what the host was doing."""
        a0, b0 = self.window
        merged = self.merged()
        gaps, t = [], a0
        for x, y in merged:
            if x > t:
                gaps.append((t, x))
            t = max(t, y)
        if b0 > t:
            gaps.append((t, b0))
        events = sorted(self.host, key=lambda e: (e[1], -e[2]))
        by = collections.Counter()
        stack: list = []
        i = 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while i < len(events) and events[i][1] <= mid:
                while stack and stack[-1][2] < events[i][1]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            by[stack[-1][0][:120] if stack else "(no host event)"] += b - a
        return [[k, v] for k, v in by.most_common(n)]


def _kind(e) -> str:
    """The kineto activity of an event; on a torch whose events do not say,
    told from the device and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CPU"):
        if name == JOB_SPAN:
            return "user_annotation"
        return "cuda_runtime" if name.startswith("cuda") else "cpu_op"
    if name == JOB_SPAN:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def _ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.end_ns()
    start = int(e.start_us() * 1000)
    return start, start + int(e.duration_us() * 1000)


def from_profiler(prof) -> Trace:
    """A Trace from a stopped torch.profiler.profile's kineto results."""
    results = prof.profiler.kineto_results
    events = results.events()
    # seconds from the trace's start keep their nanoseconds
    base = min(_ns(e)[0] for e in events) if events else 0

    def span(e):
        a, b = _ns(e)
        return (a - base) * 1e-9, (b - base) * 1e-9

    jobs, ops, host = [], [], []
    job_thread = None
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_ACTIVITIES:
            ops.append((e.name(), *span(e), kind))
        elif e.name() == JOB_SPAN and kind == "user_annotation":
            jobs.append(span(e))
            job_thread = e.start_thread_id()
    for e in events:  # the CUDA calls are the jobs' thread's, whatever id CUPTI gives it
        kind = _kind(e)
        if kind in HOST_ACTIVITIES and (e.start_thread_id() == job_thread
                                        or kind in ("cuda_runtime", "cuda_driver")):
            host.append((e.name(), *span(e)))
    if not jobs:
        raise RuntimeError("the trace holds no job span")
    if not ops:
        raise RuntimeError("the trace holds no device operation")
    return Trace(sorted(jobs), ops, host)
