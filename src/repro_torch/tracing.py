"""Spans and counters at the sampling driver's layer boundaries.

Tracing is on exactly while a torch profiler records: there is no switch of
its own. Run a job under `torch.profiler.profile(...)` and read `calls()`
and `counts()` afterwards.

    span(name)      a context manager. With no profiler recording it returns
                    one shared null context after one check. While one
                    records, it keeps an in-memory record of the span: its
                    name, start and end on `time.perf_counter_ns()`, the id
                    of its parent span and of its outermost span; and, where
                    this torch's kineto events declare their activity
                    (`MIRRORED`), it opens `torch.profiler.record_function
                    (name)` too, in the same trace as the device's
                    operations and the CUDA runtime calls.
    count(name, n)  adds to a process-wide counter; always on (the driver
                    counts once per block, a kernel wrapper once per launch).
    counts()        every counter by name, a `collections.Counter`: a name
                    never counted reads 0.
    calls()         one record per outermost span closed while a profiler
                    recorded, the newest MAX_CALLS: {"name", "start_ns",
                    "end_ns", "spans" (its descendants' records, by start),
                    "counts" (each counter's change over the span; on a
                    CUDA device also the caching allocator's segments
                    allocated and freed, its `cudaMalloc` and `cudaFree`
                    calls: `cuda.segment.all.allocated`, `.freed`)}.

The driver's spans: `sampler.run` (one `sampler_api.run()` call) holds
`sampler.validate` (the arguments checked, then a new run's finite-energy
probe or a kept run taken and renewed), `sampler.init`, `sampler.eager` (an
eager block), `sampler.capture` (a block captured into a CUDA graph, torch's
device sync and cache emptying on entering the capture included),
`sampler.results` and `sampler.release` (the run kept, and the least
recently used beyond the store's bound freed); `sampler.init` holds
`sampler.colour_plan` where `ColoredGibbs` on the cuda backend builds its
colour plan (`sparse_gather.colour_plan`, with its waits for the device);
`boltzmann.cd_step` holds `boltzmann.model` (with its
`sampler.run`), `boltzmann.correlations`, `boltzmann.update` and
`boltzmann.quantize`. Its counters, each 0 before its first count:
`sampler.calls`, `sampler.eager_blocks`, `sampler.captures`,
`sampler.replays`, `sampler.reuses` (calls that took a kept run, which
replay every block), `sampler.renewals` (those of them whose kept run took
another problem's values or an edited problem's, after the finite-energy
probe; the others validate without it) and `sampler.colour_plans` (the
colour plans built).

The kernel wrappers count each launch as `launch.<kernel>`, each kernel
module's docstring naming its own kernels. Under a CUDA graph a wrapper
counts once per capture; the graph loop moves those counts to the
replays (`core/graph_loop.py`).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

# Whether spans reach the profiler's trace: where this torch's kineto
# events declare their activity, the device-side event of a range around
# device work reads as a user annotation. Where they do not (torch 2.11), a
# tool that tells the device's operations apart by name counts it as a
# kernel, so no span is put there: every one encloses device work, even a
# capture (entering one fills each registered generator's seed and offset).
MIRRORED = hasattr(torch._C._autograd._KinetoEvent, "activity_type")
MAX_CALLS = 1024

_NULL = contextlib.nullcontext()
_counters = collections.Counter(dict.fromkeys(
    ("sampler.calls", "sampler.eager_blocks", "sampler.captures", "sampler.replays",
     "sampler.reuses", "sampler.renewals", "sampler.colour_plans"), 0))
_calls: collections.deque = collections.deque(maxlen=MAX_CALLS)
_ids = itertools.count()
_local = threading.local()  # each thread's open spans


def recording() -> bool:
    """Whether a torch profiler records (a C-level check)."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A span of the layer `name` (module docstring)."""
    if not torch._C._autograd._profiler_enabled():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] += n


def counts() -> collections.Counter:
    """A copy of every counter by name (module docstring); a name never
    counted reads 0."""
    return _counters.copy()


def calls() -> list[dict]:
    """The call records kept, oldest first."""
    return list(_calls)


def _snapshot() -> dict[str, int]:
    out = counts()
    if torch.cuda.is_initialized():
        # the nested form: `memory_stats()` flattens all of it in Python first
        segments = torch.cuda.memory_stats_as_nested_dict().get("segment", {}).get("all", {})
        out["cuda.segment.all.allocated"] = segments.get("allocated", 0)
        out["cuda.segment.all.freed"] = segments.get("freed", 0)
    return out


class _Span:
    """One open span; the outermost span of a thread collects the records
    of the spans inside it and, at its end, the call record."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        if self.parent is None:
            self.root, self.inner, self.before = self, [], _snapshot()
        else:
            self.root = self.parent.root
        self.mirror = torch.profiler.record_function(self.name) if MIRRORED else None
        if self.mirror is not None:
            self.mirror.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _local.stack.pop()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        if self.parent is not None:
            self.root.inner.append({
                "id": self.id, "name": self.name, "start_ns": self.start, "end_ns": self.end,
                "parent": self.parent.id, "root": self.root.id})
        elif recording():
            after = _snapshot()
            _calls.append({
                "id": self.id, "name": self.name, "start_ns": self.start, "end_ns": self.end,
                "spans": sorted(self.inner, key=lambda r: r["start_ns"]),
                "counts": {k: v - self.before.get(k, 0) for k, v in after.items()}})
        return False
