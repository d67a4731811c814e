"""Entry `cd_train`: each job is one `repro_torch.core.boltzmann.cd_step` of
a Boltzmann machine trained on the lattice (paper Fig. 4), its weights,
biases and persistent chains carried from job to job, the new weights read
back on the host.

Traffic keys: `cd` (CDConfig's fields: lr, n_model_steps, dt, sampler,
quantize_bits, weight_clip, n_chains), `data` (the digit batch the
reference draws: digit, count, flip, segments, digits, H, W),
`check_jobs`, `trace_jobs`, `step_kernel`, `step_work`.

The benchmark makes the data batch and the starting state (zero weights and
biases, random chains) from the seed and hands them to the program. The
comparison follows the program step by step: each kept job is recomputed by
the configuration's reference from the state the program started that job
from (its own output of the job before; job 0's, the benchmark's start),
with the job's seed, and reads:

  chains_differ  the share of chains the job returns that differ
  weight_gap     the widest |w - w_ref| or |b - b_ref| it returns
"""
from __future__ import annotations

import torch

from bench.common import derive_seed, load_module
from bench.program import problem


class Cell:
    """One configuration under one CD traffic mix, on one device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, root):
        from repro_torch.core import boltzmann

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ref = load_module("reference", config["reference"], root)
        cd = traffic["cd"]
        if cd["sampler"] != "pass":
            raise ValueError("the CD reference follows the tau-leap ('pass') sampler only")
        self.cfg = boltzmann.CDConfig(**cd)
        self.data = self.ref.digit_batch(traffic["data"], derive_seed(seed, "data"), device)
        w, b, chains = self.start()
        self.state = boltzmann.CDState(problem=problem("king", {"w": w, "b": b}), chains=chains,
                                       step=0)
        H, W = config["H"], config["W"]
        self.steps_per_job = cd["n_model_steps"]
        self.updates_per_job = cd["n_chains"] * H * W * cd["n_model_steps"]
        self.shape = {"chains": cd["n_chains"], "sites": H * W}  # what the rooflines read

    def start(self):
        """(w, b, chains) the training starts from, drawn from the seed."""
        H, W = self.config["H"], self.config["W"]
        inst = self.ref.instance(self.config, None, 0, self.device)
        gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "chains"))
        return inst["w"], inst["b"], self.ref.init_spins(gen, self.traffic["cd"]["n_chains"], H, W)

    def job(self, j):
        """One CD step with job j's seed from the carried state (the warm-up
        job, j = "warm", leaves the carried state as it was)."""
        from repro_torch.core import boltzmann

        before = self.state
        gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, "job", j))
        after = boltzmann.cd_step(before, self.data, gen, self.cfg)
        after.problem.w.cpu()
        after.problem.b.cpu()
        if j != "warm":
            self.state = after
        return before, after

    def release(self) -> None:
        self.state = None

    def compare(self, kept: dict, control: bool = False) -> dict:
        """The numbers compared over the kept jobs (j -> (state before, state
        after)); with `control`, the control's step stands in for the
        program's."""
        cd = self.traffic["cd"]
        data = self.ref.digit_batch(self.traffic["data"], derive_seed(self.seed, "data"),
                                    self.device)
        differ = chains = 0
        gap = 0.0
        for j, (before, after) in sorted(kept.items()):
            w0, b0, s0 = before.problem.w, before.problem.b, before.chains
            if j == 0:  # the start is the benchmark's own
                sw, sb, ss = self.start()
                gap = max(gap, float((w0 - sw).abs().max()), float((b0 - sb).abs().max()))
                differ += int((s0 != ss).flatten(1).any(1).sum())
                chains += ss.shape[0]

            def step(low):
                gen = torch.Generator(device=self.device).manual_seed(
                    derive_seed(self.seed, "job", j))
                return self.ref.cd_step(w0, b0, s0, data, gen, lr=cd["lr"],
                                        steps=cd["n_model_steps"], dt=cd["dt"],
                                        clip=cd["weight_clip"], bits=cd["quantize_bits"], low=low)

            w, b, s = step(False)
            gw, gb, gs = step(True) if control else (after.problem.w, after.problem.b,
                                                     after.chains)
            gap = max(gap, float((gw - w).abs().max()), float((gb - b).abs().max()))
            differ += int((gs != s).flatten(1).any(1).sum())
            chains += s.shape[0]
        return {"chains_differ": differ / chains, "weight_gap": gap}
