"""The dry run (`repro_torch.launch.dryrun`) and its report: `--list`
prints the JAX package's lines; gemma-2b x decode_32k x single traces `ok`
in a fake world of 256 ranks (a process of its own) with the JAX
package's parameter count; a skipped cell and a cell that raises are
recorded and the sweep goes on; a cached cell is not traced again; the
report renders the records."""
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


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    art = tmp_path_factory.mktemp("art")
    for arch, shape in (("gemma-2b", "decode_32k"), ("gemma-2b", "long_500k"),
                        ("whisper-medium", "prefill_32k")):
        _run("repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", "single",
             "--artifacts", str(art))
    again = _run("repro_torch.launch.dryrun", "--arch", "gemma-2b", "--shape", "decode_32k",
                 "--mesh", "single", "--artifacts", str(art))
    recs = {p.stem: json.loads(p.read_text()) for p in art.glob("*.json")}
    return art, recs, again


def test_decode_cell_runs_ok_with_the_jax_param_count(records):
    _, recs, again = records
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
    _, recs, _ = records
    assert recs["gemma-2b__long_500k__single"]["status"] == "skipped"
    err = recs["whisper-medium__prefill_32k__single"]
    assert err["status"] == "error" and "encoder_seq" in err["error"] and err["trace"]


def test_report_renders_the_records(records, capsys):
    art, _, _ = records
    report.main(["--artifacts", str(art)])
    out = capsys.readouterr().out
    assert "**Mesh 16x16 (256 GPUs)** — 1 traced, 1 skipped, 1 errors" in out
    assert "| gemma-2b__decode_32k | ok | 2.51B |" in out
    assert "989 TFLOP/s" in out and "not measured" in out and "v5e" not in out


def test_a_sweep_needs_a_process_of_its_own(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="process of its own"):
        dryrun.fake_world("single")
