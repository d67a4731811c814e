"""The port's examples (`repro_torch.examples`), each `main` run in-process
with `--device cpu`, held to the headlines of the JAX package's example or
of the JAX test that covers it:

  * quickstart: "ground states found: YES" and a "split-R-hat" line, as
    tests/test_diagnostics.py holds examples/quickstart.py;
  * optimization_cal: the annealed energy at or below 0.85 of the ground
    state's, and a template agreement |m| of 1 where the energy is the
    ground state's. One chain's anneal ends in the C-A-L state or, at some
    seeds (2 of 12 seen on the CPU, and the card's stream at the script's
    seeds), in a local minimum at 0.90 of its energy with |m| ~ 0.1, so the
    agreement alone is no bound; at these CPU seeds it is 1.000;
  * boltzmann_mnist at --steps 5 (as the repository's verify recipe runs
    the JAX script): the data energy drops and the reconstructed bottom
    half agrees with the template above 0.6, the bound of
    tests/test_ml_and_decision.py (0.93 seen);
  * neural_decision at 2 seeds x 120 outer steps (main's own arguments):
    every trajectory commits, and eta = 4 commits later than eta = 1 (the
    JAX test's qualitative check);
  * serve_lm at its reduced default: every request completes its tokens;
  * train_lm at its defaults (reduced gemma-2b, 60 steps) into a fresh
    checkpoint directory: the loss falls; a second run resumes from the
    last checkpoint (step 50) and says so.

The sampled numbers are the port's own (torch cannot replay threefry), so
the bounds are the examples' qualitative claims, not JAX's values. They are
chip_smoke.py's `example_misses`, which its `examples` phase holds on the
card."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.examples import (boltzmann_mnist, neural_decision, optimization_cal, quickstart,
                                  serve_lm, train_lm)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _misses(name, out):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.example_misses(name, out)


def test_quickstart(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "ground states found: YES" in text and out["ground_states_found"]
    assert "split-R-hat" in text
    assert not _misses("quickstart", out)


def test_optimization_cal(capsys):
    out = optimization_cal.main(["--device", "cpu"])
    assert "template agreement |m|" in capsys.readouterr().out
    assert not _misses("optimization_cal", out)
    assert out["energy"] == out["ground_state_energy"] and out["template_agreement"] == 1.0


def test_boltzmann_mnist_five_steps(capsys):
    out = boltzmann_mnist.main(["--steps", "5", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "bottom-half agreement with template" in text and text.count("data energy") == 5
    assert not _misses("boltzmann_mnist", out)


def test_neural_decision_at_a_reduced_size(capsys):
    out = neural_decision.main(["--device", "cpu"], n_seeds=2, max_steps=120)
    assert capsys.readouterr().out.count("commit distance (median)") == 2
    assert not _misses("neural_decision", out)
    for res in out["by_eta"].values():
        assert res["steps"] == [120, 120] and res["left"] + res["right"] <= 2


@pytest.mark.parametrize("arch", ["xlstm-125m", "phi4-mini-3p8b"])
def test_serve_lm(arch, capsys):
    out = serve_lm.main(["--arch", arch, "--device", "cpu"])
    assert out["requests"] == 6 and not _misses("serve_lm", out)
    assert all(len(t) == 16 for t in out["completions"].values())
    assert "6 requests, 96 tokens" in capsys.readouterr().out


def test_train_lm(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert not _misses("train_lm", out) and out["start"] == 0
    assert "checkpointed step 25" in text and "checkpointed step 50" in text
    assert text.count("loss") == 7 and text.strip().endswith("done.")
    again = train_lm.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert again["start"] == 50 and "resumed from checkpoint step 50" in capsys.readouterr().out
