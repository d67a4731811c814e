"""Entry `sampler_ctmc`: `sampler_run`'s jobs, one `run()` call each, of the
exact CTMC: one step of a job is one Gillespie event of every chain, so a
job of `n_steps` events updates one site a chain an event and counts
`updates_per_job = n_chains x n_steps` (where `sampler_run` counts every
site of every chain a step). Each chain keeps its own model time, a sum of
its dwell times.

Traffic keys beyond `sampler_run`'s: `reference`, the plain reference the
cell is compared with (`bench/reference/<name>.py`), which wins over the
configuration's own `reference` key. No first hit.

The comparison is `sampler_run.compare`'s: each kept job replayed in the
reference from the job's seed, the same numbers drawn in the same order,
and `chains_differ` (the final state and time, a recorded sample or time)
and `energy_gap` (the program's incremental energies against float64 ones
of its own recorded states). A job is tens of thousands of events of a few
dozen small operations each, so the kept jobs are replayed together, their
chains as the rows of one batch, each job drawing from its own generator;
on a CUDA device each event of the batch is a replay of one captured CUDA
graph of those operations (no operation depends on the batch's size, and
the fields at the start come from each job's own product, so every row
rounds as it would alone)."""
from __future__ import annotations

from pathlib import Path

import torch

from bench.common import derive_seed, load_module

_run = load_module("entries", "sampler_run", Path(__file__).resolve().parents[1])


class Cell(_run.Cell):
    """`sampler_run.Cell` of an event-driven kernel, its reference named by
    the traffic."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, root):
        if traffic.get("first_hit_per_site") is not None:
            raise ValueError("the CTMC's entry replays no first hit")
        super().__init__(dict(config, reference=traffic["reference"]), traffic, seed, device, root)
        self.updates_per_job = self.chains * self.steps
        self.replayed: dict = {}  # (job, control) -> replay, while a comparison runs

    def compare(self, kept: dict, control: bool = False) -> dict:
        """`sampler_run.compare`, the kept jobs replayed in one batch first."""
        jobs = sorted(kept)
        self.replayed = self.replay_jobs(jobs)
        if control:
            self.replayed.update(self.replay_jobs(jobs, control=True))
        try:
            return super().compare(kept, control)
        finally:
            self.replayed = {}

    def replay(self, j, control: bool = False) -> dict:
        """Job j in the plain reference (or the control), from the batch
        `compare` replayed."""
        return self.replayed[(j, control)]

    def replay_jobs(self, jobs: list, control: bool = False) -> dict:
        """The jobs in the plain reference (or the control), their chains as
        one batch: each job's final state and time, and its recorded states,
        times and energies, each chain's time its own."""
        model, B, dev = self.model(control), self.chains, self.device
        every = self.traffic["sample_every"]
        betas = self.ref_schedules.betas(self.traffic["schedule"], self.steps, dev)
        gens = [torch.Generator(device=dev).manual_seed(derive_seed(self.seed, "job", j))
                for j in jobs]
        starts = [model.init(g, B) for g in gens]
        state = (torch.cat(starts), torch.cat([model.fields(s) for s in starts]),
                 torch.zeros((len(jobs) * B,), device=dev))
        step = _Events(model, gens, betas, B, state)
        samples, times = [], []
        for k in range(self.steps):
            s, _, t = step()
            if every and (k + 1) % every == 0:
                samples.append(s.clone())
                times.append(t.clone())
        s, _, t = step.state
        out = {}
        for row, j in enumerate(jobs):
            rows = slice(row * B, (row + 1) * B)
            one = {"s": s[rows], "t": t[rows]}
            if every:
                one["samples"] = torch.stack([x[rows] for x in samples], 1)
                one["times"] = torch.stack([x[rows] for x in times], 1)
                one["energies"] = model.energies(one["samples"])
            out[(j, control)] = one
        return out


class _Events:
    """The events of a batch of jobs, one a call: each job's draws from its
    generator, then the model's event at the step's beta. On a CUDA device
    the calls replay one captured graph of an event (the generators'
    states as they were before the graph was warmed up and captured)."""

    def __init__(self, model, gens, betas, chains, state):
        self.model, self.gens, self.betas, self.chains = model, gens, betas, chains
        self.state = state
        self.k = torch.zeros((1,), dtype=torch.int64, device=betas.device)
        self.graph = None
        if betas.device.type == "cuda":
            self._capture()

    def _event(self, s, h, t, k):
        draws = [self.model.draws(g, self.chains) for g in self.gens]
        expo = torch.cat([e for e, _ in draws])
        u = torch.cat([x for _, x in draws])
        beta = self.betas.index_select(0, k).expand(s.shape[0])
        s, h, dt = self.model.event(s, h, beta, expo, u)
        return s, h, t + dt

    def _capture(self) -> None:
        held = [g.get_state() for g in self.gens]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the warm-up the capture needs, on copies
            self._event(*(x.clone() for x in self.state), self.k)
        torch.cuda.current_stream().wait_stream(side)
        static = tuple(x.clone() for x in self.state)  # the graph's state, in place
        self.graph = torch.cuda.CUDAGraph()
        for g in self.gens:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph):
            new = self._event(*static, self.k)
            for x, y in zip(static, new):
                x.copy_(y)
            self.k.add_(1)
        for g, st in zip(self.gens, held):
            g.set_state(st)
        self.state = static

    def __call__(self) -> tuple:
        if self.graph is not None:
            self.graph.replay()
            return self.state
        self.state = self._event(*self.state, self.k)
        self.k += 1
        return self.state
