"""Argument checks shared by the CUDA kernel wrappers.

A wrapper hands raw pointers to its kernel, so everything the kernel
assumes (device, dtype, shape, contiguity, an sm_90 card) is checked here
first and raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import functools

import torch

# The kernels are compiled for sm_90a only (Hopper: H100, H200).
KERNEL_CAPABILITY = (9, 0)
# gridDim.y counts 64-chain row blocks and may not exceed 65535.
MAX_ROWS = 64 * 65535
# Shared memory one block may use on sm_90 (227 KB).
MAX_SMEM_BYTES = 232448


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def check_cuda(t: torch.Tensor) -> torch.device:
    """The CUDA device of `t`; raise unless it is an sm_90 card."""
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got a tensor on {t.device}; "
            "use ops with mode='auto' or 'reference' for CPU tensors"
        )
    cap = _capability(t.device.index if t.device.index is not None else torch.cuda.current_device())
    if cap != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"the kernels are built for sm_90a (compute capability 9.0); "
            f"{torch.cuda.get_device_name(t.device)} has {cap[0]}.{cap[1]}"
        )
    return t.device


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless `t` has this dtype and shape, is contiguous, and lies on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_spins(name: str, s: torch.Tensor) -> tuple[int, int]:
    """(B, N) of a spin operand; raise unless it is 2-D with at most MAX_ROWS rows."""
    if s.ndim != 2:
        raise ValueError(f"{name} must be (B, N), got shape {tuple(s.shape)}")
    if s.shape[0] > MAX_ROWS:
        raise ValueError(f"{name} has {s.shape[0]} rows; the kernel takes at most {MAX_ROWS}")
    return s.shape[0], s.shape[1]


def fault_ptr(t) -> int | None:
    """A fault operand's pointer for a launcher; None (NULL) when absent."""
    return None if t is None else t.data_ptr()


def check_fault_operands(s, bias_rows, keep, dev) -> tuple | None:
    """(bias_rows, keep) of a fault-variant call on (B, ...) spins `s`, keep
    as uint8; None when both are None. Raise unless bias_rows is f32 and
    keep bool or uint8, each shaped as s, contiguous, on `dev`."""
    if bias_rows is None and keep is None:
        return None
    if bias_rows is not None:
        check_tensor("bias_rows", bias_rows, torch.float32, tuple(s.shape), dev)
    if keep is not None:
        if keep.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"keep must be bool or uint8, got {keep.dtype}")
        check_tensor("keep", keep, keep.dtype, tuple(s.shape), dev)
        keep = keep.view(torch.uint8)  # bool is one byte, 0 or 1
    return bias_rows, keep
