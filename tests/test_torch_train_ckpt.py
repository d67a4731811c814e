"""Checkpoints across the two packages, and the token pipeline's mapping.

  * A checkpoint the JAX package writes (its TrainState after one step) is
    restored by the port, equal to the JAX state: in float32, and in
    bfloat16 bit for bit (JAX writes bf16 leaves as raw "|V2" bytes, which
    the port reads by the manifest's dtype; the JAX package's own restore
    cannot read them back, a fault of the reference recorded in ROADMAP).
  * A float32 checkpoint the port writes is restored by the JAX package
    into its TrainState, equal to the port's.
  * For the same config the two packages write the same manifest: the same
    keys (with and without the ef residuals), shapes and dtypes.
  * The pipeline: fed JAX's uniforms, `ids_from_uniforms` gives JAX's ids,
    the Zipf CDF over min(V, 65536) ranks included.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.train import checkpoint as jcheckpoint
from repro.train import train_step as jtrain_step
from repro_torch.data import pipeline
from repro_torch.models import convert
from repro_torch.train import checkpoint
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
from test_torch_train_common import batches, configs, port_model


def _flat_jax(tree) -> dict:
    return {name: np.asarray(leaf) for name, leaf in jcheckpoint._flatten(tree).items()}


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _jax_state(arch, dtype, compress=False, step=True):
    jcfg, cfg = configs(arch, dtype=dtype)
    jt = jtrain_step.TrainConfig(compress_grads=compress, warmup_steps=1)
    jstate, _ = jtrain_step.init_state(jcfg, jt, jax.random.key(0))
    if step:
        jstate, _ = jax.jit(jtrain_step.make_train_step(jcfg, jt))(
            jstate, batches(cfg)[0], jax.random.key(1))
    return jcfg, cfg, jstate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-medium"])
def test_port_restores_a_jax_checkpoint(tmp_path, arch, dtype):
    jcfg, cfg, jstate = _jax_state(arch, dtype, compress=True)
    d = str(tmp_path)
    jcheckpoint.save(d, 1, jstate, n_shards=3)
    state = init_state(cfg, TrainConfig(compress_grads=True), 5, "cpu")
    assert checkpoint.latest_step(d) == 1
    state = convert.load_train_state(cfg, state, checkpoint.restore(d, 1))
    assert state.step == 1 and state.opt.count == 1
    want = _flat_jax(jstate)
    got = checkpoint._flatten(convert.train_state_to_jax(cfg, state))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert list(g.shape) == list(w.shape), name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        np.testing.assert_array_equal(_np32(g), w.astype(np.float32), err_msg=name)
    if dtype == "bfloat16":
        raw = np.load(os.path.join(d, "step_000000001", "shard_00000.npz"))["params::embed"]
        assert raw.dtype == np.dtype("V2")


def test_jax_restores_a_port_checkpoint(tmp_path):
    jcfg, cfg, jlike = _jax_state("recurrentgemma-9b", "float32", step=False)
    state = init_state(cfg, TrainConfig(warmup_steps=1), 0, "cpu")
    state.params.load_state_dict(port_model(cfg, jlike.params).state_dict())
    for i in range(2):
        state, _ = make_train_step(cfg, TrainConfig(warmup_steps=1))(state, batches(cfg, seed=i)[1])
    d = str(tmp_path)
    checkpoint.save(d, 2, convert.train_state_to_jax(cfg, state), n_shards=2)
    restored = jcheckpoint.restore(d, jcheckpoint.latest_step(d), jlike)
    want = checkpoint._flatten(convert.train_state_to_jax(cfg, state))
    got = _flat_jax(restored)
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_array_equal(g, want[name].numpy(), err_msg=name)
    assert int(restored.step) == 2 and int(restored.opt.count) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,compress", [("gemma-2b", False), ("olmoe-1b-7b", True),
                                           ("internvl2-2b", False), ("recurrentgemma-9b", True),
                                           ("xlstm-125m", False), ("whisper-medium", True)])
def test_both_packages_write_the_same_manifest(tmp_path, arch, compress, dtype):
    jcfg, cfg, jstate = _jax_state(arch, dtype, compress=compress, step=False)
    jcheckpoint.save(str(tmp_path / "jax"), 0, jstate, n_shards=2)
    state = init_state(cfg, TrainConfig(compress_grads=compress), 0, "cpu")
    checkpoint.save(str(tmp_path / "port"), 0, convert.train_state_to_jax(cfg, state), n_shards=2)
    manifests = [json.load(open(tmp_path / who / "step_000000000" / "manifest.json"))
                 for who in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert any(k.startswith("ef::") for k in manifests[1]["keys"]) == compress
    assert "params::layers::scan::#0::norm1::scale" in manifests[1]["keys"]


@pytest.mark.parametrize("vocab", [1000, 256000])
def test_pipeline_ids_from_jax_uniforms_match_jax(vocab):
    cfg = jpipeline.DataConfig(vocab_size=vocab, seq_len=33, global_batch=6)
    jp = jpipeline.TokenPipeline(cfg)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(cfg.seed), 7), 0)
    want = np.asarray(jp.host_batch(7, 0)["tokens"])
    # passlint: ignore[PASS001] the test replays the pipeline's own draw from its key
    u = np.array(jax.random.uniform(key, (6, 34)))
    cdf = torch.from_numpy(pipeline._zipf_cdf(min(vocab, pipeline.CDF_RANKS), cfg.zipf_alpha))
    np.testing.assert_array_equal(cdf.numpy(), np.asarray(jp._cdf))
    ids = pipeline.ids_from_uniforms(cdf, torch.from_numpy(u), vocab)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids[:, :-1].numpy(), want)
    assert int(ids.max()) < 65536
    c5 = cdf[5].numpy()
    edges = torch.from_numpy(np.array([0.0, 1.0, c5, np.nextafter(c5, np.float32(2))],
                                      np.float32))
    jids = jnp.clip(jnp.searchsorted(jnp.asarray(cdf.numpy()), jnp.asarray(edges.numpy())), 0,
                    vocab - 1)
    np.testing.assert_array_equal(pipeline.ids_from_uniforms(cdf, edges, vocab).numpy(),
                                  np.asarray(jids))
