"""The driver's step loop: eager on CPU tensors, replays of captured CUDA
graphs on a CUDA device.

The JAX driver compiles its step loop once (`jax.jit` over `lax.scan`).
The port's counterpart is a CUDA graph: a block of steps is captured once
(every launch of the kernel steps, the first-hit update, the diagnostics
update and the sample records) and then replayed, so each block costs the
host one graph launch instead of every kernel launch of every step.

The run is cut into blocks by `plan_blocks`: a block holds at most
GRAPH_STEPS steps, and never runs past a recorded sample, which is written
from inside the block at a fixed offset. A run has at most four distinct
blocks (by length and record offsets), and each is captured once, at its
first use, and replayed after that. (The JAX driver's `unroll` sets how
many steps one `lax.scan` iteration runs; it does not change these
blocks.)

What a captured block reads and writes must stay at fixed addresses: the
loop's carry (the kernel state, the first-hit and diagnostics
accumulators, the step and sample counters) lives in static tensors, which
every replay overwrites at its end (a block returns new step and sample
counters even where it records nothing, so both are rewritten by every
block) or updates in place (a carry tensor a block changes in place, such
as the sparse CTMC's carried tree, counts as rewritten); the schedule, the
problem and the sample buffers are read or written in place. The per-step
betas are gathered inside the block from the device step counter.

Capture needs everything to exist before it: the kernels built, the plans
made, the libraries' handles created. So the run's first blocks execute
eagerly, on the capture stream, until a block with and a block without a
sample record have each run once (or the run ends); their output becomes
the static carry. The generator is registered with every graph, so each
replay draws the numbers the same eager steps would have drawn, in the
same order: with deterministic kernels a graphed run equals the eager run
bit for bit.

The graphs live as long as the loop, and the loop as long as its run:
`sampler_api.run()` keeps a call's run for a later call of the same shape,
which replays every block (`start` loads its initial carry), so the
captures and the eager blocks are paid once per kept run, not once per
call. Leaves that no block changes are the run's constants: the initial
carry's values of the first pass. A later call on the same problem makes
the same ones. A call that brings the run another problem's values, or an
edited problem's, loads them as well (`start(..., renew=True)`): copied
into the static carry's where a graph reads them, taken in their place
where none does yet (`forget` drops the graphs of a run whose problem moved
to other tensors). Only a carry whose every leaf is a tensor or None can be
loaded so (`renewable`): a host value, such as a colour plan's list lengths
or the versions of the tensors it read, is baked into the graphs. A carry
of another layout than the static one's begins the loop anew.

The kernel wrappers count their launches (`launch.<kernel>` in
`repro_torch.tracing`) where a kernel is launched from Python, which under
capture is once per capture, not per execution. The loop takes the counts
a capture made back and adds them at every replay, so the counters count
the launches that run.

Each eager block and each capture is a span (`sampler.eager`,
`sampler.capture`) and a count (`sampler.eager_blocks`, `sampler.captures`),
each replay a count (`sampler.replays`): see `repro_torch.tracing`. Nothing
is traced inside a block, whose body is captured.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Optional

import torch

from repro_torch import tracing

# The most steps one captured graph holds.
GRAPH_STEPS = 32


def plan_blocks(n_steps: int, sample_every: int, max_steps: int) -> list[tuple[int, tuple]]:
    """The run's blocks in order, each (steps, record offsets): after the
    step at each offset (0-based, within the block) the state is recorded.

    With sample_every in [1, max_steps] a block covers as many whole
    observation strides as fit; with a longer stride, each stride is
    max_steps-step blocks and a last, shorter one that records. The steps
    after the last observation (n_steps % sample_every) follow in blocks
    of at most max_steps. Any two ways of cutting the run run the same
    steps in the same order."""
    blocks: list[tuple[int, tuple]] = []

    def chunks(count: int, record_last: bool) -> None:
        full, rest = divmod(count, max_steps)
        sizes = [max_steps] * full + ([rest] if rest else [])
        for k, size in enumerate(sizes):
            last = record_last and k == len(sizes) - 1
            blocks.append((size, (size - 1,) if last else ()))

    n_samples = n_steps // sample_every if sample_every > 0 else 0
    if n_samples and sample_every <= max_steps:
        per = max_steps // sample_every  # strides per block
        full, rest = divmod(n_samples, per)
        for strides in [per] * full + ([rest] if rest else []):
            blocks.append((strides * sample_every,
                           tuple(range(sample_every - 1, strides * sample_every, sample_every))))
    else:
        for _ in range(n_samples):
            chunks(sample_every, True)
    chunks(n_steps - n_samples * sample_every, False)
    return blocks


def _leaves(tree) -> list:
    """The leaves of a carry: nested tuples (named or not) and lists are
    walked; anything else (tensors, None, plain values) is a leaf."""
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _fits(new, old) -> bool:
    """Whether leaf `new` loads into leaf `old` of the static carry: None
    for None, a tensor of the same shape, dtype and device for a tensor."""
    if not isinstance(old, torch.Tensor):
        return new is None and old is None
    return isinstance(new, torch.Tensor) and (new.shape, new.dtype, new.device) == (
        old.shape, old.dtype, old.device)


def _rebuild(tree, leaves):
    """`tree`'s structure with `leaves` (an iterator) in place of its own."""
    if isinstance(tree, (tuple, list)):
        parts = [_rebuild(x, leaves) for x in tree]
        if isinstance(tree, list):
            return parts
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return next(leaves)


class StepLoop:
    """Runs a run's blocks: `block(carry, steps, records) -> carry`.

    On CPU (`graph=False`) every block runs eagerly. On a CUDA device the
    blocks run as replays of CUDA graphs (module docstring). One loop
    serves every pass of its run, in one `run()` call or in the later calls
    that take the kept run: `start` loads a pass's initial carry, `run`
    executes one block, `result` returns the final carry."""

    def __init__(self, block: Callable, generator: torch.Generator, device: torch.device,
                 graph: bool):
        self.block = block
        self.generator = generator
        self.device = device
        self.graph = graph
        self.graphs: dict = {}  # (steps, records) -> (CUDAGraph, {counter: delta})
        self.static: Any = None  # the carry the graphs read and write
        self.changing: Optional[list[bool]] = None  # which leaves a block rewrites
        self.warmed: set = set()  # block kinds (with/without records) run eagerly
        self.carry: Any = None
        self.renewable: Optional[bool] = None  # every leaf a tensor or None: the first pass's
        self.stream = torch.cuda.Stream(device=device) if graph else None

    def start(self, carry, renew: bool = False) -> None:
        """Begin a pass from `carry`. Once graphs exist, the pass's initial
        values are copied into the static carry the graphs read; with
        `renew`, its constants too (module docstring)."""
        leaves = _leaves(carry)
        if self.renewable is None:
            self.renewable = all(x is None or isinstance(x, torch.Tensor) for x in leaves)
        if renew and self.static is not None:
            static = _leaves(self.static)
            if len(leaves) != len(static) or not all(map(_fits, leaves, static)):
                self.static, self.changing, self.graphs, self.warmed = None, None, {}, set()
            elif not self.graphs:
                self.static = _rebuild(self.static, iter(
                    dst if keep else new for keep, new, dst in zip(self.changing, leaves, static)))
        if self.static is None:
            self.carry = carry
            return
        for keep, new, dst in zip(self.changing, leaves, _leaves(self.static)):
            if keep or (renew and new is not dst and isinstance(new, torch.Tensor)):
                dst.copy_(new)
        self.carry = self.static

    def forget(self) -> None:
        """Drop the graphs: the next blocks are captured anew over the
        static carry, whose constants the next `start(..., renew=True)`
        takes from its carry."""
        self.graphs = {}

    def run(self, steps: int, records: tuple) -> None:
        """Execute one block of `steps` steps, recording after `records`."""
        if not self.graph:
            tracing.count("sampler.eager_blocks")
            with tracing.span("sampler.eager"):
                self.carry = self.block(self.carry, steps, records)
            return
        with torch.cuda.device(self.device):  # streams and graphs of the problem's card
            kind = bool(records)
            if self.static is None or kind not in self.warmed:
                tracing.count("sampler.eager_blocks")
                with tracing.span("sampler.eager"):
                    self._eager(steps, records)
                self.warmed.add(kind)
                return
            key = (steps, records)
            if key not in self.graphs:
                tracing.count("sampler.captures")
                with tracing.span("sampler.capture"):
                    self.graphs[key] = self._capture(steps, records)
            graph, delta = self.graphs[key]
            graph.replay()
            for name, n in delta.items():
                tracing.count(name, n)
            tracing.count("sampler.replays")

    def result(self):
        """The final carry; under graphs a copy, which later passes of the
        same loop cannot overwrite."""
        if self.static is None or self.carry is not self.static:
            return self.carry
        return _rebuild(self.carry, iter(
            x.clone() if keep else x for keep, x in zip(self.changing, _leaves(self.carry))))

    def _eager(self, steps: int, records: tuple) -> None:
        """One block, eagerly, on the capture stream; the first one makes
        the static carry from its output."""
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        before = _leaves(self.carry)
        versions = [x._version if isinstance(x, torch.Tensor) else None for x in before]
        with torch.cuda.stream(self.stream):
            out = self.block(self.carry, steps, records)
        current.wait_stream(self.stream)
        if self.static is None:
            after = _leaves(out)
            # a leaf changes if the block returns a new tensor or writes the old in place
            self.changing = [a is not b or (v is not None and b._version != v)
                             for a, b, v in zip(after, before, versions)]
            for keep, a in zip(self.changing, after):
                if keep and not isinstance(a, torch.Tensor):
                    raise TypeError(f"a block changed a carry leaf that is not a tensor: {a!r}")
            # standalone buffers: no leaf may be a view of a tensor a block reads
            self.static = _rebuild(out, iter(
                a.clone() if keep else a for keep, a in zip(self.changing, after)))
            self.carry = self.static
        else:
            for keep, new, dst in zip(self.changing, _leaves(out), _leaves(self.static)):
                if keep and new is not dst:
                    dst.copy_(new)

    def _capture(self, steps: int, records: tuple):
        """Capture one block over the static carry, the outputs copied back
        into it; returns (graph, the counts the capture made, by name)."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not torch.cuda.default_generators[torch.cuda.current_device()]:
            graph.register_generator_state(self.generator)  # the default one is registered always
        before = tracing.counts()
        # no cyclic collection inside the capture: freeing another graph
        # there is a call capture forbids, and it would void this one
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                out = self.block(self.static, steps, records)
                for keep, new, dst in zip(self.changing, _leaves(out), _leaves(self.static)):
                    if keep and new is not dst:
                        dst.copy_(new)
        finally:
            if collecting:
                gc.enable()
        after = tracing.counts()
        delta = {name: n - before[name] for name, n in after.items() if n != before[name]}
        for name, n in delta.items():  # nothing ran yet: the replays count
            tracing.count(name, -n)
        return graph, delta
