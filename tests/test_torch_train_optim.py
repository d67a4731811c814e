"""AdamW, the schedules and int8 error-feedback compression against the
JAX package (`repro/optim/`), and the decay mask's reference quirk.

  * adamw.update: two steps at lr_scale 0.7 from the same params and
    gradients (the JAX tree of a reduced config, carried across by
    params_from_jax); params, mu, nu and grad_norm within 2e-5 relative.
    recurrentgemma-9b has a tail layer and whisper-medium an encoder: both
    decay masks' branches are held.
  * cosine_with_warmup and constant: equal to the JAX float32 values, bit
    for bit.
  * compress: gq and the residual bit-equal to JAX's on float32 gradients,
    over two rounds (the residual fed back), a zero gradient included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.optim import schedules as jschedules
from repro_torch.models import convert
from repro_torch.optim import adamw, compression, schedules
from test_torch_train_common import REL, configs, jax_params, port_model, rel


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 0.3, p.shape).astype(np.float32)),
                        tree)


def _port(cfg, tree) -> dict:
    return convert.params_from_jax(cfg, jax.tree.map(np.asarray, tree))


def _close(cfg, got: dict, want_tree):
    want = _port(cfg, want_tree)
    bad = {n: rel(got[n], want[n]) for n in got if rel(got[n], want[n]) > REL}
    assert not bad, bad


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-medium"])
def test_adamw_two_updates_match_jax(arch):
    jcfg, cfg = configs(arch)
    params = jax_params(jcfg)
    m = port_model(cfg, params)
    named = dict(m.named_parameters())
    ocfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.3)
    jocfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.3)
    state, jstate = adamw.init(named), jadamw.init(params)
    decay = convert.decay_mask(cfg, named)
    for step in range(2):
        jgrads = _random_like(params, seed=step)
        grads = _port(cfg, jgrads)
        params, jstate, jm = jadamw.update(jgrads, jstate, params, jocfg, jnp.float32(0.7))
        state, metrics = adamw.update(grads, state, named, ocfg, 0.7, decay=decay)
        assert rel(metrics["grad_norm"], jm["grad_norm"]) < REL
    assert state.count == int(jstate.count) == 2
    _close(cfg, named, params)
    _close(cfg, state.mu, jstate.mu)
    _close(cfg, state.nu, jstate.nu)


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b", "whisper-medium",
                                  "olmoe-1b-7b", "xlstm-125m"])
def test_decay_mask_is_the_jax_stacked_ndim(arch):
    """JAX decays a leaf whose stacked array has ndim >= 2: the scanned
    layers' norm scales and RG-LRU vectors decay, the tail layers', the
    final norm's and the encoder norm's do not. Every port norm is 1-D."""
    jcfg, cfg = configs(arch)
    params = jax_params(jcfg)
    flags = _port(cfg, jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2, np.float32), params))
    named = dict(port_model(cfg, params).named_parameters())
    mask = convert.decay_mask(cfg, named)
    assert mask == {n: bool(t.flatten()[0]) for n, t in flags.items()}
    assert not mask["final_norm.scale"] and mask["layers.0.norm1.scale"]
    if arch == "recurrentgemma-9b":  # 4 layers: one unit of 3, then a tail rglru
        assert not any(v for n, v in mask.items() if n.startswith("layers.3.") and
                       named[n].ndim == 1)
        assert mask["layers.0.rglru.lambda_raw"]
    if arch == "whisper-medium":
        assert not mask["enc_norm.scale"] and mask["enc_layers.0.norm1.scale"]


@pytest.mark.parametrize("warmup,total", [(2, 30), (100, 10_000), (0, 5), (7, 7), (3, 50),
                                          (10, 333), (1, 12)])
def test_cosine_with_warmup_is_exact(warmup, total):
    steps = range(0, total + 6, max(1, total // 300))
    for step in [*steps, total // 2, total - 1, total + 100]:
        want = np.float32(jschedules.cosine_with_warmup(jnp.int32(step), warmup, total))
        got = schedules.cosine_with_warmup(step, warmup, total)
        assert got.dtype == torch.float32 and got.item() == want, (step, got.item(), want)
    assert schedules.cosine_with_warmup(0, warmup, total).item() == 0.0 or warmup == 0
    assert schedules.constant(3).item() == float(jschedules.constant(3)) == 1.0


def test_compress_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    shapes = {"a": (17, 5), "b": (40,), "z": (3, 3)}
    tree_r = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jef, ef = jcompression.EFState(residual={k: jnp.asarray(v) for k, v in tree_r.items()}), \
        compression.EFState(residual={k: torch.as_tensor(v) for k, v in tree_r.items()})
    for rnd in range(2):
        g = {k: (rng.normal(0, 10.0 ** (rnd - 2), s) * (k != "z")).astype(np.float32)
             for k, s in shapes.items()}
        jgq, jef = jcompression.compress({k: jnp.asarray(v) for k, v in g.items()}, jef)
        gq, ef = compression.compress({k: torch.as_tensor(v) for k, v in g.items()}, ef)
        for k in shapes:
            np.testing.assert_array_equal(gq[k].numpy(), np.asarray(jgq[k]))
            np.testing.assert_array_equal(ef.residual[k].numpy(), np.asarray(jef.residual[k]))
            assert gq[k].dtype == torch.float32
    assert float(ef.residual["a"].abs().sum()) > 0 and float(ef.residual["z"].abs().sum()) == 0


def test_compress_keeps_the_gradient_dtype_and_an_f32_residual():
    g = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    jgq, jef = jcompression.compress({"w": jnp.asarray(g["w"].float().numpy(), jnp.bfloat16)},
                                     jcompression.init({"w": jnp.zeros((8, 8))}))
    gq, ef = compression.compress(g, compression.init(g))
    assert gq["w"].dtype == torch.bfloat16 and ef.residual["w"].dtype == torch.float32
    np.testing.assert_array_equal(gq["w"].float().numpy(), np.asarray(jgq["w"], np.float32))
    np.testing.assert_array_equal(ef.residual["w"].numpy(), np.asarray(jef.residual["w"]))


def test_adamw_state_is_float32_for_bf16_params():
    jcfg, cfg = configs("gemma-2b", dtype="bfloat16")
    m = port_model(cfg, jax_params(jcfg))
    named = dict(m.named_parameters())
    state = adamw.init(named)
    assert all(t.dtype == torch.float32 for t in state.mu.values())
    grads = {n: torch.ones_like(p) for n, p in named.items()}
    before = {n: p.detach().clone() for n, p in named.items()}
    state, _ = adamw.update(grads, state, named, adamw.AdamWConfig(), 1.0,
                            decay=convert.decay_mask(cfg, named))
    assert all(p.dtype == torch.bfloat16 for p in named.values())
    assert any(not torch.equal(before[n], p) for n, p in named.items())
