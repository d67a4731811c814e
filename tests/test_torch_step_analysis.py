"""The per-rank op count (`repro_torch.launch.step_analysis`), the port's
counterpart of tests/test_launch.py's HLO-analysis cases: a Python loop of
L matmuls counts 2 M K K L FLOPs; a one-row cache write counts the row, not
the cache; the reduced configs' train-step FLOPs against the JAX package's
`hlo_analysis.analyze` of its compiled step; a loop over time folded to
one trip on meta tensors (the dry run's) counted as the loop on real
ones; a 256-way sharded matmul
counted at one rank's shard (the local op, not the global one a mode
around the DTensor op would see); collectives scored intra- or inter-node
by the ranks of their group."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro.launch import hlo_analysis as ha
from repro.train import train_step as jtrain_step
from repro_torch.configs import get_config
from repro_torch.launch.step_analysis import StepCounter, crosses_nodes
from repro_torch.models import xlstm
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step
from test_torch_train_common import FAMILIES, batches, configs

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_layer_loop_multiplies_flops():
    L, M, K = 7, 8, 64
    x, w = torch.randn(M, K), torch.randn(L, K, K)
    with StepCounter() as c:
        for i in range(L):
            x = torch.tanh(x @ w[i])
    s = c.summary()
    assert s.flops == 2 * M * K * K * L and s.n_while == 0
    assert s.ici_bytes == s.dcn_bytes == 0 and s.coll_by_kind == {}


def test_cache_row_write_counted_at_the_row():
    """16 one-row writes into a (4096, 64) cache cost O(row), not O(cache)."""
    cache, upd = torch.zeros(4096, 64), torch.randn(16, 64)
    buffer_bytes = 4096 * 64 * 4
    with StepCounter() as c:
        for i in range(16):
            cache[i] = upd[i]
    assert c.summary().hbm_bytes < 4 * buffer_bytes
    assert c.summary().hbm_bytes == c.summary().hbm_bytes_upper
    with StepCounter() as whole:  # the naive whole-buffer write, for contrast
        for i in range(16):
            cache.copy_(cache + 0)
    assert whole.summary().hbm_bytes > 16 * buffer_bytes


@pytest.mark.parametrize("arch,router", FAMILIES)
def test_train_step_flops_match_jax_hlo(arch, router):
    """The port's reduced train step against the JAX package's compiled
    one, within 5%, once the port's one extra product is added to the JAX
    count: the port's chunked cross-entropy recomputes each chunk's
    unembed in the backward pass (an activation checkpoint; the JAX scan
    keeps the chunk's logits), 2 B S D V more FLOPs."""
    jcfg, cfg = configs(arch, router)
    jbatch, batch = batches(cfg, B=4, S=16)
    jt = jtrain_step.TrainConfig()
    jstate, _ = jtrain_step.init_state(jcfg, jt, jax.random.key(0))
    step = jax.jit(jtrain_step.make_train_step(jcfg, jt))
    jflops = ha.analyze(step.lower(jstate, jbatch, jax.random.key(1)).compile().as_text()).flops
    state = init_state(cfg, TrainConfig(), 0, "cpu")
    with StepCounter() as c:
        make_train_step(cfg, TrainConfig())(state, batch, torch.Generator().manual_seed(1))
    B, S = batch["labels"].shape
    recompute = 2 * B * S * cfg.d_model * cfg.vocab_size
    gap = c.summary().flops / (jflops + recompute) - 1
    assert abs(gap) <= 0.05, (c.summary().flops, jflops, recompute, gap)


class _EveryTrip(StepCounter):
    fold_scans = False  # the loop itself, every trip run and counted


def _recurrence_counts(kind, device, fold, train, S=16):
    """StepCounter's FLOPs and bytes of reduced xlstm-125m's sLSTM scan or
    mLSTM chunk loop (4 chunks of 4) over S steps, forward or forward and
    backward."""
    cfg = dataclasses.replace(get_config("xlstm-125m", reduced=True), mlstm_chunk=4)
    with torch.device(device):
        mod = (xlstm.slstm_init if kind == "slstm" else xlstm.mlstm_init)(
            torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(device)
    x.requires_grad_(train)
    with (StepCounter() if fold else _EveryTrip()) as c:
        if kind == "slstm":
            h, _ = xlstm.slstm_scan(mod, x, cfg)
        else:
            h, _ = xlstm.mlstm_chunkwise(mod, mod.w_up_a(x), cfg.n_heads, cfg.mlstm_chunk)
        if train:
            h.sum().backward()
    s = c.summary()
    return s.flops, s.hbm_bytes


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
@pytest.mark.parametrize("kind,trips", [("slstm", 16), ("mlstm", 4)])
def test_folded_scan_counts_as_its_loop(kind, trips, train):
    """The dry run's form of a loop over time (`layers.scan` under
    StepCounter: one trip on meta tensors, counted `trips` times) against
    the loop itself on real tensors: the same FLOPs and bytes forward; with
    the backward pass at most one trip more, since the loop's first trip
    has no carry gradient to compute and the fold counts one trip for all."""
    loop = _recurrence_counts(kind, "cpu", fold=False, train=train)
    folded = _recurrence_counts(kind, "meta", fold=True, train=train)
    for got, want in zip(folded, loop):
        if train:
            assert want <= got <= want * (1 + 1 / trips), (kind, folded, loop)
        else:
            assert got == want, (kind, folded, loop)


def test_crosses_nodes():
    assert not crosses_nodes(range(8)) and not crosses_nodes([8, 9, 15])
    assert crosses_nodes(range(16)) and crosses_nodes([0, 8])
    assert not crosses_nodes(range(16), node_size=16)


_FAKE = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.step_analysis import StepCounter
out = {}
mesh = make_test_mesh((16, 16), ("data", "model"), "cpu")
meta = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device="meta")
w = distribute_tensor(meta(2048, 16384), mesh, [Replicate(), Shard(1)], src_data_rank=None)
x = distribute_tensor(meta(64, 128, 2048), mesh, [Shard(0), Replicate()], src_data_rank=None)
with StepCounter() as c:
    x @ w
out["local"] = c.summary().to_dict()
with FlopCounterMode(display=False) as f:
    x @ w
out["mode_around_dtensor"] = f.get_total_flops()
# (32, 8): a "model" group is 8 consecutive ranks (one node), a "data"
# group strides across nodes
nodes = make_test_mesh((32, 8), ("data", "model"), "cpu")
a = distribute_tensor(meta(64, 256), nodes, [Replicate(), Shard(0)], src_data_rank=None)
b = distribute_tensor(meta(64, 256), nodes, [Shard(0), Replicate()], src_data_rank=None)
with StepCounter() as c:
    a.redistribute(nodes, [Replicate(), Replicate()])
out["intra"] = c.summary().to_dict()
with StepCounter() as c:
    b.redistribute(nodes, [Replicate(), Replicate()])
out["inter"] = c.summary().to_dict()
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_sharded_matmul_counted_per_rank_and_groups_scored_by_node():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", _FAKE], capture_output=True,
                          text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    total = 2 * 64 * 128 * 2048 * 16384
    assert out["mode_around_dtensor"] == total  # the trap: the global op
    assert out["local"]["flops"] == total / 256
    assert out["local"]["coll_by_kind"] == {}  # both operands already laid out
    gathered = 64 * 256 * 2  # bf16 bytes of the gathered result
    assert out["intra"]["ici_bytes"] == gathered and out["intra"]["dcn_bytes"] == 0
    assert out["inter"]["dcn_bytes"] == gathered and out["inter"]["ici_bytes"] == 0
    assert out["inter"]["coll_by_kind"] == {"all-gather": {"count": 1, "bytes": gathered}}
