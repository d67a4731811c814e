"""Sharding must not change numerics: the port's train step on a 2x2 mesh
of 4 gloo processes, under the tp_sp and the fsdp_pure rules, against the
port's unsharded step and the JAX package's, the counterpart of
tests/test_sharding_numerics.py.

Each worker runs `launch.train.train(..., mesh=mesh)` (the sharded driver)
for two steps of reduced gemma-2b from a step-0 checkpoint that holds the
JAX package's initial params (restored into the mesh's placements), and
saves the step-2 checkpoint (gathered, written by rank 0); then two steps
of reduced xlstm-125m (the recurrences on each rank's shards), of reduced
qwen2-moe-a2p7b with 3 experts (TP on their FFN width), of reduced
recurrentgemma-9b and of reduced whisper-medium, recurrentgemma's
prefill and decode step, and a
padded-head TP prefill, each held within 2e-5 of the port's unsharded run. Losses, grad
norms and the params after the steps are held within 2e-5 (relative) of
the port's unsharded driver from the same checkpoint and of JAX's jitted
step on the same batches and params; the 2x2 checkpoint restored unsharded
equals the sharded run's params bit for bit. Then `torchrun` drives
`launch.train.main --mesh 1x2`, and a mesh of another size than the world
is refused. Under the fsdp_pure rules on a fake 2x2 world, each layer
gathers its parameters where it runs and again when its checkpoint is
recomputed, and no layer's gathered weights outlive its forward.
"""
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain_step
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train
from repro_torch.models import convert, model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint
from repro_torch.train.train_step import TrainConfig, init_state
from test_torch_train_common import REL, configs, port_model, rel

REPO = pathlib.Path(__file__).resolve().parent.parent
STRATEGIES = ("tp_sp", "fsdp_pure")
B, S, STEPS = 4, 16, 2
TIMEOUT = 300

_WORKER = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import train
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig
mesh = make_test_mesh((2, 2), ("data", "model"), "cpu")
tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
res = {}
for strategy in ("tp_sp", "fsdp_pure"):
    cfg = dataclasses.replace(get_config("gemma-2b", reduced=True), strategy=strategy)
    s = train(cfg, tcfg, steps=2, batch=4, seq=16, device="cpu", ckpt_dir=f"{out}/{strategy}",
              mesh=mesh)
    full = {n: p.full_tensor() for n, p in s["state"].params.named_parameters()}
    res[strategy] = {"losses": s["losses"], "grad_norms": s["grad_norms"], "start": s["start"],
                     "rules": s["rules"],
                     "placements": {n: [str(q) for q in p.placements]
                                    for n, p in s["state"].params.named_parameters()}}
    if rank == 0:
        torch.save(full, f"{out}/{strategy}.pt")

# the sLSTM and mLSTM loops on each rank's shards
cfg = get_config("xlstm-125m", reduced=True)
s = train(cfg, tcfg, steps=2, batch=4, seq=16, device="cpu", ckpt_dir=f"{out}/xlstm_train",
          mesh=mesh)
res["xlstm_train"] = {"losses": s["losses"], "grad_norms": s["grad_norms"]}
full = {n: p.full_tensor() for n, p in s["state"].params.named_parameters()}
if rank == 0:
    torch.save(full, f"{out}/xlstm_train.pt")

# MoE experts the tensor axis does not divide (3 on 2: TP on their FFN
# width), recurrentgemma's RG-LRU (row-parallel gates, the conv and the
# scan on local shards) and whisper's encoder and cross attention
moe_cfg = get_config("qwen2-moe-a2p7b", reduced=True)
moe_cfg = dataclasses.replace(moe_cfg, qkv_bias=False,
                              moe=dataclasses.replace(moe_cfg.moe, n_experts=3))
for case, cfg in (("moe_ffn_width_train", moe_cfg),
                  ("rglru_train", get_config("recurrentgemma-9b", reduced=True)),
                  ("whisper_train", get_config("whisper-medium", reduced=True))):
    s = train(cfg, tcfg, steps=2, batch=4, seq=16, device="cpu", ckpt_dir=f"{out}/{case}",
              mesh=mesh)
    res[case] = {"losses": s["losses"], "grad_norms": s["grad_norms"]}
    full = {n: p.full_tensor() for n, p in s["state"].params.named_parameters()}
    if rank == 0:
        torch.save(full, f"{out}/{case}.pt")

# recurrentgemma serving: a 40-token prefill (the attention ring of 32 slots
# written in two slices; one KV head, so the caches' head_dim on the tensor
# axis), then a decode step under the decode rules from the unsharded caches
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.models import attention, model
from repro_torch.sharding import partition
from repro_torch.train import train_step as ts
cfg = get_config("recurrentgemma-9b", reduced=True)
toks = torch.randint(0, cfg.vocab_size, (4, 41), generator=torch.Generator().manual_seed(2))
m = model.init_params(cfg, 0, "cpu")
with torch.no_grad():
    _, plain_caches = m.prefill(toks[:, :40], model.init_caches(cfg, 4, 48, "cpu"),
                                mode="reference")
serve = {}
for kind in ("prefill", "decode"):
    rules = specs.rules_for(cfg, ShapeConfig(kind, 48, 4, kind), mesh)
    serve[kind + "_rules"] = rules
    with partition.axis_rules(mesh, rules):
        m = model.init_params(cfg, 0, "cpu")
        ts.shard_params(m, mesh, rules)
        caches = model.init_caches(cfg, 4, 48, "cpu") if kind == "prefill" else plain_caches
        caches = dryrun._placed_caches(caches, model.cache_axes(cfg), mesh, rules)
        with ts.sharded_step():
            if kind == "prefill":
                tokens = dryrun._placed({"t": toks[:, :40]}, {"t": ("batch", None)}, mesh,
                                        rules)["t"]
                logits, caches = m.prefill(tokens, caches, mode="reference")
            else:
                tokens = dryrun._placed({"t": toks[:, 40]}, {"t": ("kv_batch",)}, mesh,
                                        rules)["t"]
                logits, caches = m.decode_step(tokens, 40, caches)
    serve[kind] = {"logits": logits.full_tensor().tolist(),
                   "caches": [[t.full_tensor().tolist() for t in c] for c in caches]}
res["rglru_serve"] = serve

# padded-head TP: 3 heads on a tensor axis of 2, a prompt past the threshold
attention.BLOCKWISE_THRESHOLD = 8
pads = []
pad_groups = attention._pad_groups
attention._pad_groups = lambda t, K: pads.append(K) or pad_groups(t, K)
cfg = dataclasses.replace(get_config("qwen1p5-32b", reduced=True), n_heads=3, n_kv_heads=3,
                          head_dim=16, blockwise_context_parallel=False)
rules = specs.rules_for(cfg, ShapeConfig("p", 16, 4, "prefill"), mesh)
toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
with partition.axis_rules(mesh, rules):
    m = model.init_params(cfg, 0, "cpu")
    ts.shard_params(m, mesh, rules)
    caches = dryrun._placed_caches(model.init_caches(cfg, 4, 24, "cpu"), model.cache_axes(cfg),
                                   mesh, rules)
    tokens = dryrun._placed({"t": toks}, {"t": ("batch", None)}, mesh, rules)["t"]
    with ts.sharded_step():
        logits, caches = m.prefill(tokens, caches, mode="reference")
res["padded"] = {"logits": logits.full_tensor().tolist(), "pads": pads,
                 "k": caches[0].k.full_tensor().tolist()}
if rank == 0:
    with open(f"{out}/result.json", "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
"""


def _tcfgs():
    jt = jtrain_step.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-2), warmup_steps=1,
                                 total_steps=10)
    t = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1, total_steps=10)
    return jt, t


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                                         os.environ.get("PYTHONPATH", "")]),
                OMP_NUM_THREADS="1")


def _run_workers(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-W", "ignore", "-c", _WORKER, str(r),
                               str(tmp_path / "store"), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env()) for r in range(4)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    with open(tmp_path / "result.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(the workers' results, their directory, the JAX params at step 0)."""
    tmp = tmp_path_factory.mktemp("shard")
    jcfg, cfg = configs("gemma-2b")
    jt, t = _tcfgs()
    jstate, _ = jtrain_step.init_state(jcfg, jt, jax.random.key(0))
    state = init_state(cfg, t, 0, "cpu")
    state.params.load_state_dict(port_model(cfg, jstate.params).state_dict())
    for strategy in (*STRATEGIES, "unsharded"):
        checkpoint.save(str(tmp / strategy), 0, convert.train_state_to_jax(cfg, state))
    return _run_workers(tmp), tmp, jstate


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_2x2_step_matches_both_unsharded_steps(sharded, strategy):
    res, tmp, jstate = sharded
    jcfg, cfg = configs("gemma-2b")
    jt, t = _tcfgs()
    got = res[strategy]
    assert got["start"] == 0 and len(got["losses"]) == STEPS
    if strategy == "fsdp_pure":  # the batch divides the mesh: ZeRO-3 over both axes
        assert got["rules"]["fsdp"] == ["data", "model"]
        assert got["placements"]["embed"] == ["S(1)", "S(1)"]
    else:
        assert got["rules"] == {"seq": "model"}
        assert got["placements"]["embed"] == ["S(1)", "S(0)"]  # fsdp on data, vocab on model
    sharded_params = torch.load(tmp / f"{strategy}.pt")

    # the port's unsharded driver from the same checkpoint
    d = tmp / f"unsharded_{strategy}"
    shutil.copytree(tmp / "unsharded", d)
    plain = train.train(cfg, t, steps=STEPS, batch=B, seq=S, device="cpu", ckpt_dir=str(d))
    for a, b in zip(got["losses"] + got["grad_norms"], plain["losses"] + plain["grad_norms"]):
        assert abs(a - b) <= REL * abs(b), (got, plain["losses"], plain["grad_norms"])
    for name, p in plain["state"].params.named_parameters():
        assert rel(sharded_params[name], p.detach()) <= REL, name

    # the JAX package's jitted step on the same batches and params
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B), "cpu")
    step = jax.jit(jtrain_step.make_train_step(jcfg, jt))
    js = jstate
    for i in range(STEPS):
        batch = {k: jnp.asarray(v.numpy()) for k, v in pipe.global_batch(i).items()}
        js, m = step(js, batch, jax.random.key(i))
        assert abs(got["losses"][i] - float(m["loss"])) <= REL * abs(float(m["loss"]))
        assert abs(got["grad_norms"][i] - float(m["grad_norm"])) <= REL * float(m["grad_norm"])
    want = convert.params_from_jax(cfg, jax.tree.map(np.asarray, js.params))
    bad = {n: rel(sharded_params[n], w) for n, w in want.items() if rel(sharded_params[n], w) > REL}
    assert not bad, bad

    # the 2x2 checkpoint restored unsharded: the sharded run's params, bit for bit
    restored = convert.load_train_state(cfg, init_state(cfg, t, 1, "cpu"),
                                        checkpoint.restore(str(tmp / strategy), STEPS))
    assert restored.step == STEPS and restored.opt.count == STEPS
    for name, p in restored.params.named_parameters():
        assert torch.equal(p, sharded_params[name]), name


@pytest.mark.parametrize("case", ["xlstm_train", "moe_ffn_width_train", "rglru_train",
                                  "whisper_train", "rglru_serve", "padded_head_prefill"])
def test_2x2_matches_the_unsharded_port(sharded, case, tmp_path):
    """On the 2x2 gloo mesh, within 2e-5 of the port's unsharded run:
    two train steps of reduced xlstm-125m (the sLSTM's and the mLSTM's
    loops on each rank's shards), of reduced qwen2-moe-a2p7b with 3
    experts (the tensor axis of 2 does not divide them: TP on their FFN
    width) and no qkv bias (the k bias's gradient is zero but for rounding,
    a bias every key shares cancelling in the softmax, and AdamW scales
    that rounding to steps of the learning rate's size) and of reduced recurrentgemma-9b (the RG-LRU's row-parallel
    gates, its conv and scan on local shards); recurrentgemma's 40-token
    prefill (the attention ring of 32 slots written in two slices, the one
    KV head's caches sharded on head_dim) and a decode step under the
    decode rules (the scores' head_dim partial sums reduced before the
    softmax); and the padded-head TP prefill of a reduced config with 3
    heads on the tensor axis of 2 (a 16-token prompt past a lowered
    BLOCKWISE_THRESHOLD, blockwise_context_parallel=False: the heads padded
    to 4, sharded, and the padding dropped before wo)."""
    res, tmp, _ = sharded
    if case.endswith("_train"):
        arch = {"xlstm_train": "xlstm-125m", "moe_ffn_width_train": "qwen2-moe-a2p7b",
                "rglru_train": "recurrentgemma-9b", "whisper_train": "whisper-medium"}[case]
        cfg = configs(arch)[1]
        if case == "moe_ffn_width_train":
            cfg = dataclasses.replace(cfg, qkv_bias=False,
                                      moe=dataclasses.replace(cfg.moe, n_experts=3))
        _, t = _tcfgs()
        plain = train.train(cfg, t, steps=STEPS, batch=B, seq=S, device="cpu",
                            ckpt_dir=str(tmp_path))
        got = res[case]
        for a, b in zip(got["losses"] + got["grad_norms"], plain["losses"] + plain["grad_norms"]):
            assert abs(a - b) <= REL * abs(b), (got, plain["losses"], plain["grad_norms"])
        sharded_params = torch.load(tmp / f"{case}.pt")
        for name, p in plain["state"].params.named_parameters():
            assert rel(sharded_params[name], p.detach()) <= REL, name
        return
    if case == "rglru_serve":
        got = res["rglru_serve"]
        assert got["prefill_rules"]["kv_hd"] == got["decode_rules"]["kv_hd"] == "model"
        cfg = configs("recurrentgemma-9b")[1]
        m = model.init_params(cfg, 0, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (4, 41),
                             generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            logits, caches = m.prefill(toks[:, :40], model.init_caches(cfg, 4, 48, "cpu"),
                                       mode="reference")
            assert rel(torch.tensor(got["prefill"]["logits"]), logits) <= REL
            for c_got, c in zip(got["prefill"]["caches"], caches):
                for a, b in zip(c_got, c):
                    assert rel(torch.tensor(a), b) <= REL
            logits, caches = m.decode_step(toks[:, 40], 40, caches)
        assert rel(torch.tensor(got["decode"]["logits"]), logits) <= REL
        for c_got, c in zip(got["decode"]["caches"], caches):
            for a, b in zip(c_got, c):
                assert rel(torch.tensor(a), b) <= REL
        return
    got = res["padded"]
    assert got["pads"] == [3, 3, 3, 3, 3, 3]  # q, k and v of each of the 2 layers
    cfg = dataclasses.replace(configs("qwen1p5-32b")[1], n_heads=3, n_kv_heads=3, head_dim=16,
                              blockwise_context_parallel=False)
    m = model.init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
    logits, caches = m.prefill(toks, model.init_caches(cfg, 4, 24, "cpu"), mode="reference")
    assert rel(torch.tensor(got["logits"]), logits) <= REL
    assert rel(torch.tensor(got["k"]), caches[0].k) <= REL


def test_torchrun_drives_the_sharded_driver(tmp_path):
    """`torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 1x2`
    on gloo: the mesh line, and the step-2 checkpoint within 2e-5 of the
    unsharded driver's."""
    args = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "4", "--seq", "16"]
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args, "--mesh", "1x2",
         "--ckpt-dir", str(tmp_path / "sharded")],
        capture_output=True, text=True, env=_env(), timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 2} steps 0..2" in proc.stdout
    assert proc.stdout.count("done.") == 1  # rank 0 alone prints
    train.main([*args, "--ckpt-dir", str(tmp_path / "plain")])
    got = checkpoint.restore(str(tmp_path / "sharded"), 2)
    want = checkpoint.restore(str(tmp_path / "plain"), 2)
    cfg = configs("gemma-2b")[1]
    g, w = convert.params_from_jax(cfg, got["params"]), convert.params_from_jax(cfg, want["params"])
    bad = {n: rel(g[n], w[n]) for n in w if rel(g[n], w[n]) > REL}
    assert not bad, bad


@pytest.mark.parametrize("world,mesh", [("4", "2x1"), ("4", "1x1"), ("2", "1x1x1")])
def test_mesh_must_match_the_world(world, mesh, monkeypatch, tmp_path):
    """Under torchrun (WORLD_SIZE set) a mesh of another size than the world
    is refused before any process group starts."""
    monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--reduced", "--steps", "1", "--mesh", mesh,
                    "--ckpt-dir", str(tmp_path)])
    assert checkpoint.latest_step(str(tmp_path)) is None


_GATHER_PROBE = r"""
import contextlib, dataclasses, json, weakref
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers, model
from repro_torch.sharding import partition
from repro_torch.train import train_step as ts

mesh = make_test_mesh((2, 2), ("data", "model"), "cpu")
orig = layers.fsdp_gathered
out = {}
for remat in ("dots", "full", "none"):
    cfg = dataclasses.replace(get_config("gemma-2b", reduced=True), strategy="fsdp_pure",
                              n_layers=4, remat=remat)
    rules = sp.rules_for(cfg, ShapeConfig("t", 16, 8, "train"), mesh)
    gathered, calls = [], []

    @contextlib.contextmanager
    def probe(module):
        before = dict(module.named_parameters())
        with orig(module):
            if type(module).__name__ == "Block":
                calls.append(id(module))
                gathered.extend(weakref.ref(p) for n, p in module.named_parameters()
                                if p is not before[n])
            yield

    layers.fsdp_gathered = probe
    with partition.axis_rules(mesh, rules), ts.sharded_step():
        m = model.init_params(cfg, 0, "meta")
        ts.shard_params(m, mesh, rules)
        tok = torch.empty((8, 16), dtype=torch.int32, device="meta")
        place = partition.struct_shardings({"t": tok}, {"t": ("batch", None)}, mesh, rules)["t"]
        batch = {"tokens": partition.distribute(tok, mesh, place),
                 "labels": partition.distribute(tok.clone(), mesh, place)}
        loss, _ = m.train_forward(batch)
        fwd, n_fwd = len(calls), len(gathered)
        alive = sum(r() is not None for r in gathered)
        torch.autograd.grad(loss, list(m.parameters()))
    out[remat] = {"layers": len(set(calls)), "forward": fwd, "all": len(calls),
                  "gathered_forward": n_fwd, "alive_after_forward": alive}
layers.fsdp_gathered = orig
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_fsdp_gathers_one_layer_at_a_time():
    """fsdp_pure on a fake 2x2 world (meta tensors): with a checkpointed
    layer (remat "dots" or "full") each layer gathers once in the forward
    and once more when the backward pass recomputes it, and after the
    forward no layer's gathered weights are alive; without remat they are
    all kept for the backward, as without sharding."""
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", _GATHER_PROBE],
                          capture_output=True, text=True, env=_env(), timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for remat in ("dots", "full"):
        got = out[remat]
        assert got["layers"] == got["forward"] == 4 and got["all"] == 8, (remat, got)
        assert got["gathered_forward"] > 0 and got["alive_after_forward"] == 0, (remat, got)
    assert out["none"]["all"] == 4
    assert out["none"]["alive_after_forward"] == out["none"]["gathered_forward"] > 0
