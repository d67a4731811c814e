"""The training forward of the port against the JAX package: the helpers
the tests/test_torch_train_*.py files share, and the tests of remat and of
the flash kernel's absence from training.

The JAX `init_params` tree is carried across by `params_from_jax`; the same
numpy-seeded batch goes through `jax.value_and_grad(model.train_forward)`
and the port's `train_forward` under `torch.autograd.grad`. Gradients are
compared tensor by tensor in relative L2 (|g_port - g_jax| / |g_jax|), the
loss relatively, within REL = 2e-5 in float32: sums run in another order
in each package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import convert, model, moe

torch.set_num_threads(1)

REL = 2e-5
# the families: dense, MoE (both routers), vlm (with patches), hybrid (a
# tail rglru layer), ssm, audio (encoder-decoder, with frames)
FAMILIES = [("gemma-2b", None), ("olmoe-1b-7b", "topk"), ("olmoe-1b-7b", "boltzmann"),
            ("internvl2-2b", None), ("recurrentgemma-9b", None), ("xlstm-125m", None),
            ("whisper-medium", None)]


def configs(arch, router=None, **changes):
    """The JAX and the port's reduced config of `arch`, with `changes` (a
    router mode for an MoE config)."""
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    if router is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, router_mode=router))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_mode=router))
    return dataclasses.replace(jcfg, **changes), dataclasses.replace(cfg, **changes)


def jax_params(jcfg, seed=0):
    params, _ = jmodel.init_params(jcfg, jax.random.key(seed))
    return params


def port_model(cfg, params):
    """The port's model on the CPU holding the JAX params."""
    m = model.init_params(cfg, 0, device="cpu")
    m.load_state_dict(convert.params_from_jax(cfg, jax.tree.map(np.asarray, params)),
                      strict=True)
    return m


def batches(cfg, B=2, S=8, seed=0):
    """(JAX batch, port batch) of the same numpy-seeded tokens and labels,
    with N(0, 0.02) image patches for a vlm and frames for the audio family."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    if cfg.family == "vlm":
        arrays["patch_embeds"] = rng.normal(0, 0.02, (B, cfg.n_patches, cfg.d_model))
    if cfg.family == "audio":
        arrays["frames"] = rng.normal(0, 0.02, (B, cfg.encoder_seq, cfg.d_model))
    arrays = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def jax_gumbels(jcfg, cfg, rng, n_tokens):
    """The Gumbel draws JAX's decoder_train gives each layer's router from
    `rng` (None for a topk router): block (u, p) of the scan the key
    split(rng, n_scan * len(unit)).reshape(n_scan, len(unit))[u, p], tail
    block p fold_in(rng, 999_000 + p)."""
    if not (cfg.moe and cfg.moe.router_mode == "boltzmann"):
        return None
    plan = jtransformer.unit_plan(jcfg)
    n = len(plan.unit)
    keys = jax.random.split(rng, plan.n_scan * n).reshape(plan.n_scan, n)
    shape = moe.router_shape(cfg, n_tokens)
    out = []
    for i in range(plan.n_scan * n + len(plan.tail)):
        key = (keys[divmod(i, n)] if i < plan.n_scan * n
               else jax.random.fold_in(rng, 999_000 + i - plan.n_scan * n))
        # passlint: ignore[PASS001] the test replays the router's own draws from its keys
        out.append(torch.tensor(np.asarray(jax.random.gumbel(key, shape))))
    return out


def jax_value_and_grads(jcfg, params, batch, rng):
    """(loss, metrics, grads) of the JAX train_forward, jitted."""
    def f(p):
        return jmodel.train_forward(jcfg, p, batch, rng)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return loss, metrics, grads


def port_value_and_grads(m, batch, gumbels=None):
    params = dict(m.named_parameters())
    loss, metrics = m.train_forward(batch, gumbels=gumbels)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, metrics, dict(zip(params, grads))


def rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def assert_grads_close(cfg, got: dict, jax_grads, tol=REL):
    want = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jax_grads))
    assert got.keys() == want.keys()
    worst = {name: rel(got[name], want[name]) for name in got}
    bad = {k: v for k, v in worst.items() if v > tol}
    assert not bad, bad


# ---------------------------------------------------------------------------
# remat, and no flash kernel in training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-medium"])
def test_remat_modes_give_equal_grads(arch):
    """"none", "dots" and "full" recompute the same ops: equal losses and
    gradients, bit for bit."""
    _, base = configs(arch)
    jcfg, _ = configs(arch)
    params = jax_params(jcfg)
    _, batch = batches(base, S=12)
    out = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        loss, _, grads = port_value_and_grads(port_model(cfg, params), batch)
        out[mode] = loss, grads
    for mode in ("dots", "full"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for name, g in out[mode][1].items():
            assert torch.equal(g, out["none"][1][name]), (mode, name)


def test_unknown_remat_raises():
    jcfg, cfg = configs("gemma-2b", remat="some")
    m = port_model(cfg, jax_params(jcfg))
    _, batch = batches(cfg)
    with pytest.raises(ValueError, match="remat"):
        m.train_forward(batch)


@pytest.mark.parametrize("arch,router", FAMILIES)
def test_train_forward_calls_no_flash_attention(arch, router, monkeypatch, launched):
    """Training attends in plain torch ops: neither ops.flash_attention nor
    the kernel's wrapper is reached (launch.flash_attention does not move)."""
    def refuse(*args, **kwargs):
        raise AssertionError("flash_attention reached from train_forward")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    monkeypatch.setattr(flash_attention, "flash_attention", refuse)
    jcfg, cfg = configs(arch, router)
    m = port_model(cfg, jax_params(jcfg))
    _, batch = batches(cfg)
    loss, _ = m.train_forward(batch, torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss) and launched()["flash_attention"] == 0


def test_flash_kernel_refuses_autograd():
    """The kernel's output has no grad_fn: with grad mode on and q, k or v
    requiring grad the kernel route raises, before any device check; the
    plain version (a CPU tensor under "auto") stays differentiable."""
    q, k, v = (torch.randn(1, 128, 8, requires_grad=(i == 1)) for i in range(3))
    for call in (lambda: flash_attention.flash_attention(q, k, v),
                 lambda: ops.flash_attention(q, k, v, mode="kernel")):
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
            call()
    out = ops.flash_attention(q, k, v)
    out.sum().backward()
    assert k.grad is not None and k.grad.abs().sum() > 0


def test_train_forward_after_serving():
    """A prefill under inference mode leaves nothing (a cached table, an
    inference tensor) that the training forward would have to save."""
    jcfg, cfg = configs("whisper-medium")
    m = port_model(cfg, jax_params(jcfg))
    _, batch = batches(cfg)
    m.prefill(batch["tokens"].long(), model.init_caches(cfg, 2, 16, "cpu"),
              frames=batch["frames"])
    loss, _ = m.train_forward(batch)
    loss.backward()
    assert all(p.grad is not None for p in m.parameters())


@pytest.mark.parametrize("S,n_chunks,softcap", [(12, 8, 0.0), (12, 5, 30.0), (7, 8, 0.0)])
def test_losses_match_jax(S, n_chunks, softcap):
    """chunked_ce (n_chunks falls to the largest divisor of S not above
    it; softcap), ce_from_logits and model.cross_entropy against the JAX
    package's, in float32."""
    from repro.train import loss as jloss
    from repro_torch.train import loss

    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (2, S, 16)).astype(np.float32)
    w_out = rng.normal(0, 1, (16, 40)).astype(np.float32)  # the JAX layout (D, V)
    labels = rng.integers(0, 40, (2, S)).astype(np.int32)
    want = jloss.chunked_ce(jnp.asarray(x), jnp.asarray(w_out), jnp.asarray(labels), n_chunks,
                            softcap)
    got = loss.chunked_ce(torch.as_tensor(x), torch.as_tensor(w_out.T), torch.as_tensor(labels),
                          n_chunks, softcap)
    assert rel(got, want) < REL
    logits = x @ w_out
    (s, n), (js, jn) = (loss.ce_from_logits(torch.as_tensor(logits), torch.as_tensor(labels)),
                        jloss.ce_from_logits(jnp.asarray(logits), jnp.asarray(labels)))
    assert n == jn == 2 * S and rel(s, js) < REL
    assert rel(model.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels)),
               jmodel.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))) < REL
