"""Architecture registry: --arch <id> -> (full config, reduced smoke config).

Full configs are the exact assigned public configurations (one module per
architecture in this package); reduced configs keep the family structure
(same block pattern, same mixer kinds, same MoE topology at small expert
count) at CPU-smoke scale.
"""
from __future__ import annotations

from repro_torch.configs import (
    gemma_2b,
    internvl2_2b,
    olmoe_1b_7b,
    phi3_medium_14b,
    phi4_mini_3p8b,
    qwen1p5_32b,
    qwen2_moe_a2p7b,
    recurrentgemma_9b,
    whisper_medium,
    xlstm_125m,
)
from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig

_MODULES = (
    gemma_2b,
    internvl2_2b,
    olmoe_1b_7b,
    phi3_medium_14b,
    phi4_mini_3p8b,
    qwen1p5_32b,
    qwen2_moe_a2p7b,
    recurrentgemma_9b,
    whisper_medium,
    xlstm_125m,
)

_REGISTRY: dict[str, ModelConfig] = {m.FULL.name: m.FULL for m in _MODULES}
_REDUCED: dict[str, ModelConfig] = {m.FULL.name: m.REDUCED for m in _MODULES}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    table = _REDUCED if reduced else _REGISTRY
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(table)}")
    return table[arch]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells() -> list[tuple[str, str]]:
    """All 40 (arch, shape) cells; skips resolved by cell_skip_reason."""
    return [(a, s) for a in list_archs() for s in SHAPES]


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """Why a cell is skipped (None = runnable). Mirrors DESIGN.md §4."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full quadratic attention: 512k-token decode excluded per shape card"
    return None
