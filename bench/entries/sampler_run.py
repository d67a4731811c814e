"""Entry `sampler_run`: each job is one `repro_torch.core.sampler_api.run`
call, the way a user anneals or solves: a fresh seed, all chains as the rows
of one call, the results read back on the host.

Traffic keys: `kernel` (the name of a kernel the program registers and its
parameters, e.g. {"name": "tau_leap", "dt": 0.1}), `backend`, `n_chains`,
`n_steps`, `schedule` ({"kind": "geometric", "beta0", "beta1"}), `sample_every`,
`first_hit_per_site` (the first-hit target over the sites), `instance` (what the
configuration's reference builds the couplings from, where the traffic
gives them), `check_jobs`, `trace_jobs`, `step_kernel`, `step_work`.

The comparison (`compare`) replays each kept job in the configuration's
plain reference from the same seed, the same uniforms drawn in the same
order, and reads:

  chains_differ  the share of chains for which anything the program returns
                 differs from the replay: the final state, a recorded
                 sample or time, or, where first_hit is set, (hit, t_hit)
                 where the replay's float64 energies contradict it (the
                 program's hit step above the target, or an earlier step
                 at or below it, by more than HIT_BAND * |first_hit|: the
                 float32 rounding of the energies the program tracks)
  energy_gap     the widest |E_program - E(state)| / max(1, |E(state)|)
                 over the recorded energies, E in float64 of the program's
                 own recorded states (where samples are recorded)
"""
from __future__ import annotations

import math

import torch

from bench.common import derive_seed, load_module
from bench.program import problem

HIT_BAND = 1e-6


def _kernel(spec: dict):
    """The program's kernel registered under `spec["name"]`, built with the
    spec's other keys as its parameters."""
    from repro_torch.core import sampler_api

    params = {k: v for k, v in spec.items() if k != "name"}
    return sampler_api.get_kernel(spec["name"], **params)


def _schedule(spec: dict):
    from repro_torch.core import sampler_api

    params = {k: v for k, v in spec.items() if k != "kind"}
    return getattr(sampler_api, spec["kind"])(**params)


class Cell:
    """One configuration under one sampler traffic mix, on one device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, root):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ref = load_module("reference", config["reference"], root)
        self.ref_schedules = load_module("reference", "schedules", root)
        self.inst_seed = derive_seed(seed, "instance")
        inst = self.ref.instance(config, traffic.get("instance"), self.inst_seed, device)
        self.problem = problem(self.ref.KIND, inst)
        self.kernel = _kernel(traffic["kernel"])
        self.schedule = _schedule(traffic["schedule"])
        self.chains, self.steps = traffic["n_chains"], traffic["n_steps"]
        sites = self.problem.n
        per_site = traffic.get("first_hit_per_site")
        self.first_hit = None if per_site is None else per_site * sites
        self.steps_per_job = self.steps
        self.updates_per_job = self.chains * sites * self.steps
        self.shape = {"chains": self.chains, "sites": sites}  # what the rooflines read
        if "nbr_idx" in inst:  # a sparse graph: its neighbour slots and colour classes
            self.shape.update(degree=inst["nbr_idx"].shape[1], colours=inst["color_masks"].shape[0])

    def job(self, j):
        """One run() call with job j's seed; its results on the host."""
        from repro_torch.core import sampler_api

        t = self.traffic
        res = sampler_api.run(
            self.problem, self.kernel, derive_seed(self.seed, "job", j), n_steps=self.steps,
            schedule=self.schedule, n_chains=self.chains, sample_every=t["sample_every"],
            first_hit=self.first_hit, backend=t["backend"])
        for x in (res.energies, res.hit, res.t_hit):
            if x is not None and x.numel():
                x.cpu()
        return res

    def release(self) -> None:
        """Drop the program's objects before the reference runs."""
        self.problem = self.kernel = None

    # -- the comparison -----------------------------------------------------

    def model(self, control: bool = False):
        """The reference's model of the instance, drawn again from the seed
        (or the control's)."""
        inst = self.ref.instance(self.config, self.traffic.get("instance"), self.inst_seed,
                                 self.device)
        return self.ref.Model(self.config, inst, self.traffic["kernel"], control)

    def replay(self, j, control: bool = False) -> dict:
        """Job j in the plain reference (or in the control's precision), from
        the job's seed: what the program returns, plus each step's energy
        and model time for the first-hit check."""
        model = self.model(control)
        every = self.traffic["sample_every"]
        betas = self.ref_schedules.betas(self.traffic["schedule"], self.steps, self.device)
        gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "job", j))
        s = model.init(gen, self.chains)
        t = torch.zeros((self.chains,), device=self.device)
        track = self.first_hit is not None
        e_steps, t_seq, samples, times = [], [t[0].clone()], [], []
        if track:
            e_steps.append(model.energies(s))
        for k in range(self.steps):
            s = model.step(s, betas[k].expand(self.chains), gen)
            t = t + model.t_step
            t_seq.append(t[0].clone())
            if every and (k + 1) % every == 0:
                samples.append(s)
                times.append(t)
            if track:
                e_steps.append(model.energies(s))
        out = {"s": s, "t": t, "t_seq": torch.stack(t_seq)}
        if every:
            out["samples"] = torch.stack(samples, 1)
            out["times"] = torch.stack(times, 1)
            out["energies"] = model.energies(out["samples"])
        if track:
            e = torch.stack(e_steps)  # (steps + 1, chains)
            target = torch.tensor(self.first_hit, dtype=torch.float32, device=self.device)
            below = e <= target
            first = torch.where(below.any(0), below.to(torch.int8).argmax(0), -1)
            out["hit"] = first >= 0
            out["t_hit"] = torch.where(out["hit"], out["t_seq"][first.clamp(min=0)], math.inf)
            out["e_steps"] = e.to(torch.float64)
        return out

    def compare(self, kept: dict, control: bool = False) -> dict:
        """The numbers compared, over the kept jobs (j -> the program's
        RunResult); with `control`, the control's replays stand in for the
        program's results."""
        differ = chains = 0
        energy_gap = 0.0
        model = self.model()
        for j, res in sorted(kept.items()):
            want = self.replay(j)
            got = self.replay(j, control=True) if control else {
                k: getattr(res, k) for k in ("s", "t", "samples", "times", "energies", "hit",
                                             "t_hit")}
            bad = (got["s"] != want["s"]).flatten(1).any(1) | (got["t"] != want["t"])
            if self.traffic["sample_every"]:
                bad |= (got["samples"] != want["samples"]).flatten(2).any(2).any(1)
                bad |= (got["times"] != want["times"]).any(1)
                e64 = model.energies(got["samples"])
                gap = (got["energies"].to(torch.float64) - e64).abs() / e64.abs().clamp(min=1.0)
                energy_gap = max(energy_gap, float(gap.max()))
            if self.first_hit is not None:
                bad |= self._hits_contradicted(got, want)
            differ += int(bad.sum())
            chains += bad.numel()
        out = {"chains_differ": differ / chains}
        if self.traffic["sample_every"]:
            out["energy_gap"] = energy_gap
        return out

    def _hits_contradicted(self, got: dict, want: dict) -> torch.Tensor:
        """(chains,) bool: the program's (hit, t_hit) contradicts the
        replay's per-step float64 energies beyond the rounding band."""
        e = want["e_steps"]  # (steps + 1, chains)
        target = float(torch.tensor(self.first_hit, dtype=torch.float32))
        band = HIT_BAND * abs(target)
        low = e <= target - band  # a step surely at or below the target
        # whether any step strictly before each step was surely below
        before = torch.cat([torch.zeros_like(low[:1]), torch.cummax(low.to(torch.int8), 0)
                            .values[:-1].bool()])
        t_hit, hit = got["t_hit"].to(torch.float32), got["hit"]
        k = torch.searchsorted(want["t_seq"].contiguous(), t_hit.contiguous())
        k = k.clamp(max=e.shape[0] - 1)
        cols = torch.arange(e.shape[1], device=e.device)
        found = want["t_seq"][k] == t_hit
        late_or_high = before[k, cols] | (e[k, cols] > target + band)
        contradicted = torch.where(hit, ~found | late_or_high, low.any(0))
        return contradicted | (hit != torch.isfinite(t_hit))
