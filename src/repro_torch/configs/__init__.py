"""The model and shape configurations, the port's own copy of `repro.configs`.

Plain dataclasses and a registry: `get_config(arch, reduced)`, `list_archs`,
`get_shape`, `cells` and `cell_skip_reason` behave as the JAX package's do.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ShapeConfig, SHAPES  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    cell_skip_reason,
    cells,
    get_config,
    get_shape,
    list_archs,
)
