"""The port's train step against the JAX package's jitted one, and the
properties tests/test_train_and_serve.py pins on the JAX training path,
held on the port.

Against JAX: `make_train_step` for two steps from the same params and
batches (warmup 1, so step 1 learns at a scale near 1): the losses, grad
norms and lr scales of both steps, and the params, mu and nu after them,
within 2e-5 relative (the grads' sums run in another order). The dense
config alone, a config with a tail layer (its undecayed norms), and a
microbatched step (float32 accumulation). Compression is held bit for bit
on given gradients (tests/test_torch_train_optim.py), not here: the last
ulp of a gradient moves an element across an int8 rounding boundary now
and then, a jump of a whole quantization step. Step 0's lr scale is 0, so
its update leaves the params as they were (a reference quirk).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain_step
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.train import checkpoint
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
from test_torch_train_common import REL, batches, configs, port_model, rel


def _tcfgs(**kw):
    jt = jtrain_step.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-2), warmup_steps=1,
                                 total_steps=10, **kw)
    t = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10, **kw)
    return jt, t


def _close(cfg, got: dict, want_tree):
    want = convert.params_from_jax(cfg, jax.tree.map(np.asarray, want_tree))
    bad = {n: rel(got[n], want[n]) for n in got if rel(got[n], want[n]) > REL}
    assert not bad, bad


@pytest.mark.parametrize("arch,kw", [("gemma-2b", {}), ("recurrentgemma-9b", {}),
                                     ("xlstm-125m", dict(microbatch=2))])
def test_two_train_steps_match_jax(arch, kw):
    jcfg, cfg = configs(arch)
    jt, t = _tcfgs(**kw)
    jstate, _ = jtrain_step.init_state(jcfg, jt, jax.random.key(0))
    state = init_state(cfg, t, 0, "cpu")
    state.params.load_state_dict(port_model(cfg, jstate.params).state_dict())
    jstep, step = jax.jit(jtrain_step.make_train_step(jcfg, jt)), make_train_step(cfg, t)
    for i in range(2):
        jbatch, batch = batches(cfg, B=4, S=8, seed=i)
        jstate, jm = jstep(jstate, jbatch, jax.random.key(i))
        state, m = step(state, batch)
        for k in ("loss", "ce_loss", "grad_norm"):
            assert rel(m[k], jm[k]) < REL, (i, k)
        assert m["lr_scale"].item() == float(jm["lr_scale"])
        assert abs(float(m["aux_loss"])) == abs(float(jm["aux_loss"])) == 0.0
    assert state.step == int(jstate.step) == 2 and state.opt.count == 2
    _close(cfg, dict(state.params.named_parameters()), jstate.params)
    _close(cfg, state.opt.mu, jstate.opt.mu)
    _close(cfg, state.opt.nu, jstate.opt.nu)


def test_step_zero_learns_nothing():
    """cosine_with_warmup(0) = 0: the first update leaves every parameter as
    it was; only the moments move."""
    _, cfg = configs("gemma-2b")
    state = init_state(cfg, TrainConfig(), 0, "cpu")
    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    state, m = make_train_step(cfg, TrainConfig())(state, batches(cfg)[1])
    assert m["lr_scale"].item() == 0.0
    assert all(torch.equal(before[n], p) for n, p in state.params.named_parameters())
    assert all(float(v.abs().sum()) > 0 for v in state.opt.mu.values())


# ---------------------------------------------------------------------------
# the properties of tests/test_train_and_serve.py, on the port
# ---------------------------------------------------------------------------


def _tiny():
    _, cfg = configs("gemma-2b")
    tcfg = TrainConfig(total_steps=200, warmup_steps=2, optimizer=adamw.AdamWConfig(lr=5e-3))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4),
                         "cpu")
    return cfg, tcfg, make_train_step(cfg, tcfg), pipe


def test_loss_decreases():
    """Zipf tokens have a learnable unigram law: the loss drops well below
    the uniform log(V) start within 30 steps."""
    cfg, tcfg, step_fn, pipe = _tiny()
    state = init_state(cfg, tcfg, 0, "cpu")
    losses = []
    for i in range(30):
        state, m = step_fn(state, pipe.global_batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert state.step == 30


def test_microbatch_equals_full_batch():
    _, cfg = configs("xlstm-125m")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=4), "cpu")
    batch = pipe.global_batch(0)
    out = []
    for mb in (0, 2):
        tcfg = TrainConfig(microbatch=mb, warmup_steps=1)
        state = init_state(cfg, tcfg, 0, "cpu")
        for _ in range(2):  # step 0's lr is 0: the second step moves the params
            state, m = make_train_step(cfg, tcfg)(state, batch)
        out.append((m, dict(state.params.named_parameters())))
    (mf, pf), (mm, pm) = out
    np.testing.assert_allclose(float(mf["loss"]), float(mm["loss"]), rtol=1e-5)
    for name, p in pf.items():
        np.testing.assert_allclose(p.detach().numpy(), pm[name].detach().numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_microbatch_must_divide_the_batch():
    _, cfg = configs("xlstm-125m")
    tcfg = TrainConfig(microbatch=3)
    with pytest.raises(ValueError, match="microbatch"):
        make_train_step(cfg, tcfg)(init_state(cfg, tcfg, 0, "cpu"), batches(cfg, B=4)[1])


def test_grad_compression_converges():
    _, cfg = configs("xlstm-125m")
    tcfg = TrainConfig(compress_grads=True, total_steps=50, warmup_steps=2)
    state = init_state(cfg, tcfg, 0, "cpu")
    step_fn = make_train_step(cfg, tcfg)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=4), "cpu")
    losses = []
    for i in range(10):
        state, m = step_fn(state, pipe.global_batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert state.ef is not None
    assert sum(float(torch.linalg.norm(r)) for r in state.ef.residual.values()) > 0


def test_pipeline_deterministic_and_host_sharded():
    cfg1 = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, n_hosts=1)
    cfg2 = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, n_hosts=4)
    p1, p2 = TokenPipeline(cfg1, "cpu"), TokenPipeline(cfg2, "cpu")
    a = p1.host_batch(3, 0)
    b = TokenPipeline(cfg1, "cpu").host_batch(3, 0)
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].dtype == torch.int32
    h0, h1 = p2.host_batch(3, 0)["tokens"], p2.host_batch(3, 1)["tokens"]
    assert not torch.equal(h0, h1)
    assert h0.shape == (2, 16)
    assert not torch.equal(p1.host_batch(3, 0)["tokens"], p1.host_batch(4, 0)["tokens"])
    g = p2.global_batch(3)
    assert torch.equal(g["tokens"][2:4], h1) and torch.equal(g["labels"][:, :-1], g["tokens"][:, 1:])
    with pytest.raises(ValueError, match="hosts"):
        TokenPipeline(DataConfig(vocab_size=10, seq_len=4, global_batch=6, n_hosts=4), "cpu")


def _state_tensors(cfg, state) -> dict:
    return checkpoint._flatten(convert.train_state_to_jax(cfg, state))


def test_checkpoint_roundtrip(tmp_path):
    cfg, tcfg, _, _ = _tiny()
    state = init_state(cfg, dataclasses.replace(tcfg, compress_grads=True), 0, "cpu")
    d = str(tmp_path)
    checkpoint.save(d, 7, convert.train_state_to_jax(cfg, state), n_shards=2)
    assert checkpoint.latest_step(d) == 7
    other = init_state(cfg, dataclasses.replace(tcfg, compress_grads=True), 1, "cpu")
    other = convert.load_train_state(cfg, other, checkpoint.restore(d, 7))
    want, got = _state_tensors(cfg, state), _state_tensors(cfg, other)
    assert want.keys() == got.keys() and any(k.startswith("ef::") for k in got)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_checkpoint_elastic_reshard(tmp_path):
    """Saved with 2 shards and with 5: identical values restored."""
    cfg, tcfg, _, _ = _tiny()
    state = init_state(cfg, tcfg, 1, "cpu")
    tree = convert.train_state_to_jax(cfg, state)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    checkpoint.save(d1, 1, tree, n_shards=2)
    checkpoint.save(d2, 1, tree, n_shards=5)
    r1, r2 = checkpoint._flatten(checkpoint.restore(d1, 1)), checkpoint._flatten(
        checkpoint.restore(d2, 1))
    assert r1.keys() == r2.keys() == checkpoint._flatten(tree).keys()
    for k in r1:
        assert torch.equal(r1[k], r2[k]), k


def test_failure_recovery_resumes_identically(tmp_path):
    """Run 6 steps saving at 3; a fresh state (another seed) restores step 3,
    replays 3..5 and reaches the uninterrupted run's state exactly."""
    cfg, tcfg, step_fn, pipe = _tiny()
    d = str(tmp_path)
    state = init_state(cfg, tcfg, 0, "cpu")
    for i in range(6):
        if i == 3:
            checkpoint.save(d, 3, convert.train_state_to_jax(cfg, state))
        state, _ = step_fn(state, pipe.global_batch(i))
    state2 = init_state(cfg, tcfg, 42, "cpu")  # wrong init, must be overwritten
    step = checkpoint.latest_step(d)
    assert step == 3
    state2 = convert.load_train_state(cfg, state2, checkpoint.restore(d, step))
    assert state2.step == 3 and state2.opt.count == 3
    for i in range(3, 6):
        state2, _ = step_fn(state2, pipe.global_batch(i))
    want, got = _state_tensors(cfg, state), _state_tensors(cfg, state2)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_checkpoint_no_commit_ignored(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"x": torch.ones(3)})
    checkpoint.save(d, 2, {"x": torch.ones(3) * 2})
    os.remove(os.path.join(d, "step_000000002", "COMMIT"))  # a crash mid-write
    assert checkpoint.latest_step(d) == 1


def test_checkpoint_kill_midwrite_resumes_from_previous(tmp_path, monkeypatch):
    """A save killed before its rename, or a step directory without COMMIT,
    stays invisible: the previous checkpoint is the resume point and
    restores clean."""
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "step": np.int32(1)}
    d = str(tmp_path)
    checkpoint.save(d, 1, tree, n_shards=2)

    def killed(src, dst):
        raise KeyboardInterrupt("simulated kill mid-save")

    monkeypatch.setattr(os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save(d, 2, {"w": tree["w"] * 2, "step": np.int32(2)}, n_shards=2)
    monkeypatch.undo()
    assert checkpoint.latest_step(d) == 1
    half = os.path.join(d, "step_000000003")
    os.makedirs(half)
    with open(os.path.join(half, "manifest.json"), "w") as f:
        f.write("{}")
    assert checkpoint.latest_step(d) == 1
    restored = checkpoint.restore(d, checkpoint.latest_step(d))
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"])
    assert restored["step"].item() == 1 and checkpoint.latest_step(str(tmp_path / "no")) is None
