"""Every family's training forward against the JAX package: the loss, its
CE and aux parts, and every gradient of `train_forward` at the reduced
configs in float32 (tests/test_torch_train_common.py), within 2e-5
relative. The MoE config runs both routers, the Boltzmann one fed the
Gumbel draws JAX's decoder_train takes from its key; the vlm scores its
text after image patches; the hybrid config has a tail rglru layer; the
audio family trains its encoder and its decoder (self-attention without
RoPE, a reference quirk)."""
import jax
import numpy as np
import pytest

from test_torch_train_common import (FAMILIES, REL, assert_grads_close, batches, configs,
                                     jax_gumbels, jax_params, jax_value_and_grads, port_model,
                                     port_value_and_grads, rel)


@pytest.mark.parametrize("arch,router", FAMILIES)
def test_train_forward_loss_and_grads_match_jax(arch, router):
    jcfg, cfg = configs(arch, router)
    params = jax_params(jcfg)
    m = port_model(cfg, params)
    jbatch, batch = batches(cfg, B=2, S=12)
    rng = jax.random.key(5)
    n_tokens = 2 * (12 + (cfg.n_patches if cfg.family == "vlm" else 0))
    jloss, jmetrics, jgrads = jax_value_and_grads(jcfg, params, jbatch, rng)
    # passlint: ignore[PASS001] the port is fed the draws JAX's train_forward takes from this key
    gumbels = jax_gumbels(jcfg, cfg, rng, n_tokens)
    loss, metrics, grads = port_value_and_grads(m, batch, gumbels)
    assert rel(loss, jloss) < REL
    assert rel(metrics["ce_loss"], jmetrics["ce_loss"]) < REL
    aux = float(metrics["aux_loss"].detach())
    assert abs(aux - float(jmetrics["aux_loss"])) <= REL * max(
        abs(float(jmetrics["aux_loss"])), 1e-3)
    if cfg.moe:
        assert aux > 0
    assert_grads_close(cfg, grads, jgrads)


@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_mlstm_gradient_stays_finite_where_jax_turns_nan(form):
    """A fault of the reference: the mLSTM's decay matrix is
    where(tri, exp(logD), 0), so once a masked logD (s > t) overflows exp
    the gradient is 0 * inf = NaN; it does at xlstm-125m's full width by
    step 4 of launch.train's defaults. The port masks before the exp: the
    same values, a finite gradient. Input gates growing by 10 a position
    force the overflow: logD ~ 10 (s - t) above the diagonal."""
    import jax.numpy as jnp
    import torch

    from repro.models import xlstm as jxlstm
    from repro_torch.models import xlstm

    jcfg, cfg = configs("xlstm-125m")
    params = jax_params(jcfg)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["scan"][0]["mlstm"])
    H, Du, S = cfg.n_heads, 2 * cfg.d_model, 12
    w_if = np.asarray(jp["w_if"]).copy()
    w_if[0] = 0.0
    w_if[0, :H] = 10.0  # feature 0 carries the position into every input gate
    jp["w_if"] = jnp.asarray(w_if)
    mod = port_model(cfg, params).layers[0].mlstm
    with torch.no_grad():
        mod.w_if.weight.copy_(torch.as_tensor(w_if.T))
    a = np.random.default_rng(0).normal(0, 0.1, (1, S, Du)).astype(np.float32)
    a[0, :, 0] = np.arange(S)

    def jfwd(a):
        if form == "parallel":
            return jxlstm.mlstm_parallel(jp, a, H)
        return jxlstm.mlstm_chunkwise(jp, a, H, S)[0]  # one chunk: s - t up to 11

    jh, jvjp = jax.vjp(jfwd, jnp.asarray(a))
    (jg,) = jvjp(jnp.ones_like(jh))
    assert np.isnan(np.asarray(jg)).any()  # the reference's NaN
    at = torch.tensor(a, requires_grad=True)
    h = (xlstm.mlstm_parallel(mod, at, H) if form == "parallel"
         else xlstm.mlstm_chunkwise(mod, at, H, S)[0])
    (g,) = torch.autograd.grad(h.sum(), [at])
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=2e-5, atol=2e-5)


def _xlstm_full_width_steps(n_steps: int = 6, threads: int = 8):
    """The reference's NaN at full width (PERF.md, section 6), on the CPU:
    xlstm-125m in bf16 at launch.train's defaults for a 6-step run (lr
    3e-3, warmup 2, batch 4 x 128 tokens), step by step on the port; before
    each port step the JAX package takes the same step from the port's
    state (carried by name through the JAX TrainState tree). torch's CPU
    sums depend on its thread count, and the trajectory on those sums.
    Returns [(step, port (loss, grad norm), JAX (loss, grad norm))]."""
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jget_config
    from repro.optim import adamw as jadamw
    from repro.train import checkpoint as jcheckpoint
    from repro.train import train_step as jtrain_step
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

    torch.set_num_threads(threads)
    jcfg, cfg = jget_config("xlstm-125m"), get_config("xlstm-125m")
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3), total_steps=6, warmup_steps=2)
    jt = jtrain_step.TrainConfig(optimizer=jadamw.AdamWConfig(lr=3e-3), total_steps=6,
                                 warmup_steps=2)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=4),
                         "cpu")
    state, step = init_state(cfg, tcfg, 0, "cpu"), make_train_step(cfg, tcfg)
    jlike, _ = jtrain_step.init_state(jcfg, jt, jax.random.key(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(jlike)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, jt))
    out = []
    for i in range(n_steps):
        batch = pipe.global_batch(i)
        flat = checkpoint._flatten(convert.train_state_to_jax(cfg, state))
        jstate = treedef.unflatten([
            jnp.asarray(flat["::".join(jcheckpoint._key_str(k) for k in path)].float().numpy(),
                        like.dtype) for path, like in paths])
        _, jm = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                      jax.random.key(i))
        state, m = step(state, batch)
        out.append((i, (float(m["loss"]), float(m["grad_norm"])),
                    (float(jm["loss"]), float(jm["grad_norm"]))))
        print(out[-1], flush=True)
    return out


if __name__ == "__main__":  # python tests/test_torch_train_models.py (~3 min on the CPU)
    _xlstm_full_width_steps()
