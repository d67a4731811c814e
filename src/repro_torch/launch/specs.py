"""Meta-device stand-ins and sharding rules for every dry-run cell.

The port of `repro/launch/specs.py`. Where the JAX package traces
`ShapeDtypeStruct`s through `eval_shape`, the port builds its modules and
tensors on the meta device: the right shapes and dtypes, no memory. The
same functions feed the real train driver, which substitutes tensors of
the same shapes.

`rules_for(cfg, shape, mesh)` resolves the logical->mesh mapping per cell:
  * train/prefill: sequence parallelism on the residual stream
    (seq -> "model"), FSDP on "data", TP on "model"; or, under
    `fsdp_pure` when the batch divides the mesh, ZeRO-3 over every axis.
  * decode: weights replicated over "data" (fsdp -> None; serving never
    re-gathers per token), KV cache sharded (batch, heads-if-divisible,
    else head_dim).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model
from repro_torch.sharding.partition import mesh_shape, mesh_size
from repro_torch.train import train_step as ts

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """Training/prefill batch structure for one global step, as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        S_text = S - cfg.n_patches
        out = {
            "tokens": _meta((B, S_text), torch.int32),
            "patch_embeds": _meta((B, cfg.n_patches, cfg.d_model), act),
        }
        if shape.kind == "train":
            out["labels"] = _meta((B, S_text), torch.int32)
        return out
    if cfg.family == "audio":
        # the encoder consumes `S` frames (the stressed dimension); the
        # decoder the nominal target length in prefill, S in train
        S_dec = S if shape.kind == "train" else 448
        out = {
            "frames": _meta((B, S, cfg.d_model), act),
            "tokens": _meta((B, S_dec), torch.int32),
        }
        if shape.kind == "train":
            out["labels"] = _meta((B, S_dec), torch.int32)
        return out
    out = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    return out


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    return {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in batch_specs(cfg, shape).items()}


def param_specs_and_axes(cfg: ModelConfig):
    """(the model on the meta device, {parameter name: logical axes})."""
    m = model.init_params(cfg, 0, META)
    return m, m.param_axes()


def train_state_and_axes(cfg: ModelConfig, tcfg: ts.TrainConfig):
    """(a meta-device TrainState, its {name: logical axes} per part)."""
    state = ts.init_state(cfg, tcfg, 0, META)
    return state, ts.state_axes(state)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> list:
    return model.init_caches(cfg, shape.global_batch, shape.seq_len, META)


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    model_size = mesh_shape(mesh).get("model", 1)
    rules: dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.strategy == "fsdp_pure" and shape.global_batch % mesh_size(mesh) == 0:
            # ZeRO-3: batch over every axis, params/opt fsdp-sharded over
            # every axis, no tensor parallelism, no activation collectives
            rules["batch"] = ("pod", "data", "model")
            rules["kv_batch"] = ("pod", "data", "model")
            rules["fsdp"] = ("data", "model")
            rules["seq"] = None
            rules["heads"] = None
            rules["kv_heads"] = None
            rules["mlp"] = None
            rules["vocab"] = None
            rules["experts"] = None
        else:
            rules["seq"] = "model"  # sequence-parallel residual stream
    if shape.kind in ("prefill", "decode"):
        # serving: weights live TP-sharded, replicated across data
        if shape.kind == "decode":
            rules["fsdp"] = None
        if cfg.n_kv_heads % model_size == 0:
            rules["kv_heads"] = "model"
            rules["kv_hd"] = None
        else:
            rules["kv_heads"] = None
            rules["kv_hd"] = "model"
    return rules


def serve_overrides(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-cell config adjustments for serving memory: an fp8 KV cache for
    the 32B decode cell."""
    if shape.kind == "decode" and cfg.name == "qwen1p5-32b":
        return dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
    return cfg
