"""The training drivers on the CPU: `launch.train.main` (4 reduced steps
that write checkpoints, then a run that resumes from the last committed
step with the JAX driver's recovery line and ends where an uninterrupted
run ends), its refusal of a mesh, and `launch.serve.main --ckpt-dir`
serving the trained params."""
import shutil

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import convert, model
from repro_torch.train import checkpoint

ARGS = ["--device", "cpu", "--reduced", "--batch", "4", "--seq", "16"]


def test_train_main_writes_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    out = train.main([*ARGS, "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", d])
    text = capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_000000002",
                                                                     "step_000000004"]
    assert "arch=gemma-2b params=0.1M mesh={'data': 1, 'model': 1} steps 0..4" in text
    assert "step     1 loss" in text and text.strip().endswith("done.")
    assert out["start"] == 0 and len(out["losses"]) == 4 and out["tokens_per_step"] == 64
    assert out["peak_bytes"] is None and all(ms > 0 for ms in out["step_ms"])
    resumed = train.main([*ARGS, "--steps", "6", "--ckpt-every", "2", "--ckpt-dir", d])
    text = capsys.readouterr().out
    assert text.startswith("[recovery] resumed from committed step 4") and "steps 4..6" in text
    assert resumed["start"] == 4 and len(resumed["losses"]) == 2
    assert checkpoint.latest_step(d) == 6

    # a 6-step run that crashed after step 4 resumes to the uninterrupted
    # run's end (the same schedule: total 6 in both)
    whole_dir, crashed = tmp_path / "whole", tmp_path / "crashed"
    whole = train.main([*ARGS, "--steps", "6", "--ckpt-every", "2", "--ckpt-dir", str(whole_dir)])
    shutil.copytree(whole_dir / "step_000000004", crashed / "step_000000004")
    replay = train.main([*ARGS, "--steps", "6", "--ckpt-dir", str(crashed)])
    assert replay["start"] == 4 and whole["losses"][4:] == replay["losses"]
    for (name, p), q in zip(whole["state"].params.named_parameters(),
                            replay["state"].params.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("flags", [["--mesh", "2x2"], ["--mesh", "1x2x2"],
                                   ["--production-mesh"], ["--multi-pod"], ["--mesh", "2"]])
def test_train_main_refuses_a_mesh(flags, tmp_path):
    with pytest.raises(SystemExit):
        train.main([*ARGS, "--steps", "1", "--ckpt-dir", str(tmp_path), *flags])
    assert checkpoint.latest_step(str(tmp_path)) is None


def test_train_main_takes_one_device_meshes(tmp_path, capsys):
    """Without torchrun a one-device mesh runs the unsharded step."""
    out = train.main([*ARGS, "--steps", "1", "--mesh", "1x1x1", "--ckpt-dir", str(tmp_path)])
    assert "mesh={'data': 1, 'model': 1} steps 0..1" in capsys.readouterr().out
    assert out["rules"] is None and not hasattr(out["state"].params.embed, "placements")


def test_serve_main_restores_the_trained_params(tmp_path, capsys):
    d = str(tmp_path)
    trained = train.main(["--device", "cpu", "--reduced", "--arch", "xlstm-125m", "--steps", "3",
                          "--batch", "2", "--seq", "8", "--ckpt-dir", d])
    capsys.readouterr()
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "4"]
    out = serve.main([*argv, "--ckpt-dir", d])
    assert "restored params from step 3" in capsys.readouterr().out and out["restored_step"] == 3
    cfg = get_config("xlstm-125m", reduced=True)
    want = serve.serve(cfg, trained["state"].params, serve.requests(cfg, 3, 4, 0.7), slots=4,
                       max_len=128)
    assert out["completions"] == want["completions"]
    fresh = serve.main(argv)
    assert fresh["restored_step"] is None and fresh["completions"] != out["completions"]
    empty = serve.main([*argv, "--ckpt-dir", str(tmp_path / "none")])  # silently random
    assert empty["completions"] == fresh["completions"]
    assert "restored" not in capsys.readouterr().out
    # the restored model is the trained one
    restored = model.init_params(cfg, 1, "cpu")
    tree = checkpoint.restore(d, 3)
    restored.load_state_dict(convert.params_from_jax(cfg, tree["params"]))
    for p, q in zip(restored.parameters(), trained["state"].params.parameters()):
        assert torch.equal(p, q)
