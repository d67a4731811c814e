"""The dry run (`repro_torch.launch.dryrun`) and its report: `--list`
prints the JAX package's lines; gemma-2b x decode_32k x single traces `ok`
in a fake world of 256 ranks (a process of its own) with the JAX
package's parameter count, and so does whisper-medium's prefill of 32768
frames; a skipped cell and a cell that raises are recorded and the sweep
goes on; a cached cell is not traced again; the report renders the
records."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro_torch.launch import dryrun, report

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-W", "ignore", "-m", module, *args],
                          capture_output=True, text=True, env=env, timeout=timeout,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_list_prints_the_jax_lines(capsys):
    dryrun.main(["--list"])
    assert capsys.readouterr().out == _run("repro.launch.dryrun", "--list")


# a sweep of one arch whose every traced cell is made to raise: the
# records of the errors, and the sweep going on past each
_RAISING = r"""
import sys
from repro_torch.launch import dryrun
orig = dryrun.lower_cell


def raising(arch, shape, mesh, mesh_name):
    if dryrun.cell_skip_reason(dryrun.get_config(arch), dryrun.SHAPES[shape]):
        return orig(arch, shape, mesh, mesh_name)
    raise RuntimeError(f"made to raise: {arch} x {shape}")


dryrun.lower_cell = raising
dryrun.main(["--arch", "phi4-mini-3p8b", "--mesh", "single", "--artifacts", sys.argv[1]])
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    art = tmp_path_factory.mktemp("art")
    for arch, shape in (("gemma-2b", "decode_32k"), ("gemma-2b", "long_500k"),
                        ("whisper-medium", "prefill_32k")):
        _run("repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", "single",
             "--artifacts", str(art))
    again = _run("repro_torch.launch.dryrun", "--arch", "gemma-2b", "--shape", "decode_32k",
                 "--mesh", "single", "--artifacts", str(art))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", _RAISING, str(art)],
                          capture_output=True, text=True, env=env, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = {p.stem: json.loads(p.read_text()) for p in art.glob("*.json")}
    return art, recs, again, proc.stdout


def test_decode_cell_runs_ok_with_the_jax_param_count(records):
    _, recs, again, _ = records
    rec = recs["gemma-2b__decode_32k__single"]
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    structs, _ = jspecs.param_specs_and_axes(jget_config("gemma-2b"))
    assert rec["n_params"] == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(structs))
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] is None and mem["argument_size_in_bytes"] > 0
    # a rank's shards: far below the whole bf16 model and its 32k-token caches
    assert mem["argument_size_in_bytes"] < 2 * rec["n_params"]
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0 and rec["trace_s"] >= 0
    assert roof["model_flops"] == pytest.approx(2 * rec["n_params"] * 128 / 256)
    assert set(rec["collectives"]) == {"ici_bytes", "dcn_bytes", "by_kind", "n_while"}
    assert "[cached] gemma-2b x decode_32k x single: ok" in again


def test_skipped_and_failing_cells_are_recorded(records):
    """A skipped cell is recorded as such; a cell that raises is recorded
    with its exception and trace, and the sweep goes on to the next."""
    _, recs, _, out = records
    assert recs["gemma-2b__long_500k__single"]["status"] == "skipped"
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        err = recs[f"phi4-mini-3p8b__{shape}__single"]
        assert err["status"] == "error" and err["trace"]
        assert err["error"] == f"RuntimeError: made to raise: phi4-mini-3p8b x {shape}"
    assert recs["phi4-mini-3p8b__long_500k__single"]["status"] == "skipped"
    assert "done: {'ok': 0, 'skipped': 1, 'error': 3}" in out


def test_whisper_prefill_of_32k_frames_runs_ok(records):
    """whisper-medium's prefill_32k: 32768 frames (the stressed dimension),
    a cross cache of as many rows built by the prefill, as the JAX
    prefill's scan builds it."""
    _, recs, _, _ = records
    rec = recs["whisper-medium__prefill_32k__single"]
    assert rec["status"] == "ok" and rec["n_chips"] == 256 and rec["roofline"]["flops"] > 0


def test_report_renders_the_records(records, capsys):
    art, _, _, _ = records
    report.main(["--artifacts", str(art)])
    out = capsys.readouterr().out
    assert "**Mesh 16x16 (256 GPUs)** — 2 traced, 2 skipped, 3 errors" in out
    assert "| gemma-2b__decode_32k | ok | 2.51B |" in out
    assert "989 TFLOP/s" in out and "not measured" in out and "v5e" not in out


def test_a_sweep_needs_a_process_of_its_own(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="process of its own"):
        dryrun.fake_world("single")
