"""Roofline terms of a step from its per-rank counts (no hardware needed).

The port of `repro/launch/roofline.py`, at an NVIDIA H100 SXM's rates.
Three terms per (arch, shape, mesh), in seconds per step:

    compute    = FLOPs_per_rank / PEAK_FLOPS
    memory     = HBM_bytes_per_rank / HBM_BW
    collective = intra-node bytes / NVLINK_BW + inter-node bytes / NET_BW

The counts come from `step_analysis` (the torch ops one rank dispatches).
Collective bytes are weighted by the standard ring-algorithm factors:

    all-reduce      2 x size     (reduce-scatter + all-gather)
    all-gather      1 x output   (each rank receives the gathered result)
    reduce-scatter  1 x size
    all-to-all      1 x size
    collective-permute 1 x size

Hardware constants, one H100 SXM (NVIDIA's H100 data sheet, SXM part,
dense rates without sparsity, at the full 700 W):
  * PEAK_FLOPS 989 TFLOP/s bf16 on the tensor cores;
  * HBM_BW 3.35 TB/s of HBM3;
  * NVLINK_BW 450 GB/s a direction: fourth-generation NVLink's 900 GB/s
    per GPU in both directions, for a collective group inside one node of
    NODE_SIZE = 8 GPUs (an HGX H100 board, all to all through NVSwitch);
  * NET_BW 50 GB/s a GPU: one 400 Gb/s NIC per GPU (ConnectX-7 / NDR
    InfiniBand, the DGX H100 layout), for a group that spans nodes.

The record keeps the JAX package's keys: `ici_bytes` are the intra-node
(NVLink) bytes and `dcn_bytes` the inter-node (network) bytes.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12      # bf16 / GPU
HBM_BW = 3.35e12         # bytes/s / GPU
NVLINK_BW = 450e9        # bytes/s / GPU, one direction, inside a node
NET_BW = 50e9            # bytes/s / GPU across nodes (400 Gb/s NIC)
NODE_SIZE = 8            # GPUs per node

_FACTORS = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    ops: list            # (kind, bytes, weighted_bytes, crosses_node)
    ici_bytes: float     # factor-weighted bytes inside a node (per rank)
    dcn_bytes: float     # factor-weighted bytes across nodes (per rank)

    @property
    def total_ops(self):
        return len(self.ops)


@dataclasses.dataclass
class RooflineTerms:
    flops: float             # per rank
    hbm_bytes: float         # per rank
    ici_bytes: float         # per rank, factor-weighted, inside a node
    dcn_bytes: float         # per rank, factor-weighted, across nodes
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float       # 6ND (train) / 2ND (serve), per rank
    useful_ratio: float      # model_flops / counted flops

    def to_dict(self):
        return dataclasses.asdict(self)


def _terms(flops: float, hbm: float, ici: float, dcn: float,
           model_flops_per_chip: float) -> RooflineTerms:
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_x = ici / NVLINK_BW + dcn / NET_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return RooflineTerms(
        flops=flops,
        hbm_bytes=hbm,
        ici_bytes=ici,
        dcn_bytes=dcn,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops_per_chip,
        useful_ratio=(model_flops_per_chip / flops) if flops else 0.0,
    )


def compute_terms(cost: dict, coll: CollectiveStats, model_flops_per_chip: float,
                  bwd: bool = False) -> RooflineTerms:
    """Terms from a {"flops", "bytes accessed"} cost dict and collective stats."""
    return _terms(float(cost.get("flops", 0.0)), float(cost.get("bytes accessed", 0.0)),
                  coll.ici_bytes, coll.dcn_bytes, model_flops_per_chip)


def compute_terms_from_summary(summary, model_flops_per_chip: float) -> RooflineTerms:
    """Terms from a `step_analysis.StepSummary` (per-rank numbers)."""
    return _terms(summary.flops, summary.hbm_bytes, summary.ici_bytes, summary.dcn_bytes,
                  model_flops_per_chip)


def count_params(params) -> int:
    """Elements of a module's parameters, or of a {name: tensor} dict."""
    tensors = params.parameters() if hasattr(params, "parameters") else params.values()
    return sum(int(t.numel()) for t in tensors)


def model_flops(cfg, shape, n_params: int) -> float:
    """6*N*D for a train step, 2*N*tokens for one serve step (global)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        n = _active_params(cfg, n_params)
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * _active_params(cfg, n_params) * tokens
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * _active_params(cfg, n_params) * tokens


def _active_params(cfg, n_params: int) -> float:
    """MoE: only top_k (+shared) of the routed experts are active/token."""
    if cfg.moe is None:
        return float(n_params)
    m = cfg.moe
    gated = 3 if cfg.act in ("swiglu", "geglu") else 2
    per_expert = gated * cfg.d_model * m.d_expert
    routed_total = cfg.n_layers * m.n_experts * per_expert
    routed_active = cfg.n_layers * m.top_k * per_expert
    return float(n_params - routed_total + routed_active)
