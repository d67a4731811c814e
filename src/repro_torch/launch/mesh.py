"""Production and test meshes.

The port of `repro/launch/mesh.py`. Functions, not module-level constants,
so importing this module touches no process group: the caller decides
when (and over which ranks) a mesh is built. Each needs an initialised
default process group of as many ranks as the mesh has devices.

Single pod : (16, 16)      axes ("data", "model")          — 256 devices
Multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")   — 512 devices;
             the "pod" axis carries only data-parallel gradient reduction.

The shapes and axis names are the JAX package's, so every dry-run cell has
a JAX counterpart; on H100s a node holds 8 cards, so the roofline scores a
collective group that spans nodes as inter-node (`roofline.NODE_SIZE`).
"""
from __future__ import annotations

from repro_torch.sharding.partition import make_mesh_compat


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return make_mesh_compat(*production_shape(multi_pod), device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cuda"):
    """A small mesh over the default group's ranks (tests, the card's 1x1)."""
    return make_mesh_compat(shape, axes, device_type)
