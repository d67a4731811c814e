"""A run whose timed path is broken underneath comes out not correct: the
harness runs a whole cell on the CPU (no look for a card) with each fault a
cell can have planted in the program, and `correct` is false. Faults: a step
that returns its state unchanged; half of the batch left out (the step of
every kernel the program registers leaves the second half of the chains as
they were; CD's means over half the batch); an answer altered where it is
produced. (No cell spans chips, so none can leave out an exchange between
them.)"""
import json
import time

import pytest
import torch

from bench import harness
from bench_tiny import REPO, tiny_root
from repro_torch.core import boltzmann, sampler_api

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _unchanged(monkeypatch, cell):
    for kernel in sampler_api.KERNELS.values():  # every kernel the program registers
        monkeypatch.setattr(kernel, "update", lambda self, problem, state, *a, **k: state)


def _half_batch(monkeypatch, cell):
    if cell.endswith(".cd"):
        monkeypatch.setattr(boltzmann, "batch_mean",
                            lambda x: torch.sum(x[: x.shape[0] // 2], 0) * (1.0 / (x.shape[0] // 2)))
        return
    for kernel in sampler_api.KERNELS.values():
        real = kernel.update

        def half(self, problem, state, *a, real=real, **k):
            out = real(self, problem, state, *a, **k)
            keep = state.s.shape[0] // 2
            return out._replace(s=torch.cat([out.s[:keep], state.s[keep:]]))

        monkeypatch.setattr(kernel, "update", half)


def _answer_altered(monkeypatch, cell):
    if cell.endswith(".cd"):
        real = boltzmann.cd_step

        def altered(*a, **k):
            out = real(*a, **k)
            w = out.problem.w.clone()
            w[4, 5, 5] += 1.0 / 64
            out.problem = out.problem.__class__(**{**vars(out.problem), "w": w})
            return out

        monkeypatch.setattr(boltzmann, "cd_step", altered)
        return
    real = sampler_api.run

    def altered(*a, **k):
        res = real(*a, **k)
        s = res.s.clone()
        s.view(s.shape[0], -1)[0, 0] *= -1
        return res._replace(s=s)

    monkeypatch.setattr(sampler_api, "run", altered)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_the_run_not_correct(tmp_path, monkeypatch, cell, fault):
    root = tiny_root(tmp_path)
    FAULTS[fault](monkeypatch, cell)
    line, checks, _ = harness.run_cell(root, cell, 2**31 + 3, 0.3, False,
                                       t0=time.perf_counter(), device="cpu", card=False)
    assert line["correct"] is False, checks
