"""CUDA kernel: flash attention, online softmax over aligned heads.

out = softmax(q kᵀ / sqrt(d), causal mask) v for every head of (BH, S, d)
operands, the causal mask optionally banded to a sliding window, the keys
optionally bounded to the first kv_len (a non-causal call over keys padded to
a multiple of 128), with the scores, the running max and sum and the
accumulator in f32 and no score tile in device memory. Source
`csrc/flash_attention.cu`.

Replaces the TPU kernel `repro/kernels/flash_attention.py::flash_attention`
(`_flash_kernel`, the `pl.pallas_call` at line 85). The TPU kernel grids
over (head, q block, k block) and carries the accumulator and the running
statistics in VMEM scratch from one k step to the next, visiting every k
block also under the causal mask (its docstring leaves trimming the key
range of a band to the caller). Here a block walks its key tiles in a loop
from the first tile that meets the band (tile 0 without one) and stops
before the first tile wholly above the diagonal, or wholly at or past
kv_len (exact: the skipped tiles add p = 0).
GQA is the caller's: heads come aligned, with the KV heads repeated.

The kernel has no backward (nor has the TPU kernel: no custom_vjp), and
its output, written through ctypes into a fresh tensor, carries no
grad_fn. So with grad mode on and q, k or v requiring grad the wrapper
raises before anything else instead of returning a result that would
silently cut their gradients; training attends through the plain
`models.attention.attn_train`, as the JAX package does.

What bounds it on the H100: at the phi4-mini prefill shape (24 heads,
S = 4096, d = 128, causal, bf16) 101 MB of q, k, v and out (30 µs at
3.35 TB/s) against 103 GFLOP (104 µs at 989 bf16 TFLOP/s): operations.

Two kernels in one library, chosen by dtype; no call of one dtype reaches
the other's kernel. Each launch counts in `repro_torch.tracing` as
`launch.flash_attention` and as `launch.flash_attention_bf16` or
`launch.flash_attention_f32`, and also as `launch.flash_attention_window`
with a band and `launch.flash_attention_kv_len` with a key-length bound:
  bf16 — on the tensor cores: wgmma for q kᵀ and for p v, TMA loads of the
         k and v tiles into a two-stage ring fed by a producer warpgroup,
         128 query rows a block. p is split into three bf16 parts for the
         p v product, which keeps every output within one bf16 ulp of the
         f32 oracle, where one bf16 p would not at S = 4096, nor two parts
         at the first rows of a head.
  f32  — on the CUDA cores in f32 FMAs (67 TFLOP/s at most), which keeps
         f32 inputs within 2e-5 of the f32 oracle, where a TF32 or bf16
         tensor-core product would not.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_cuda, check_tensor
from repro_torch.kernels.ref import check_kv_len, check_window

DTYPES = (torch.float32, torch.bfloat16)
SEQ_MULTIPLE = 128  # the TPU kernel's default block; it asserts the same
MAX_HEAD_DIM = 256
MAX_HEADS = 65535  # gridDim.y


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel: q (BH,Sq,d), k and v (BH,Sk,d), all f32 or all
    bf16, contiguous on one sm_90 device; Sq and Sk multiples of 128, d a
    multiple of 8 up to 256 -> (BH,Sq,d) in q's dtype in a fresh tensor.
    With `causal`, query i sees keys 0..i (aligned at the top left); with
    `window` > 0 as well, only keys i - window < j <= i, which needs
    Sq <= Sk (a query past Sk - 1 + window would see no key). With `kv_len`
    (None: Sk) every query sees only keys j < kv_len, 1 <= kv_len <= Sk,
    below Sk only without `causal`."""
    check_no_autograd(q, k, v)
    check_window(causal, window)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must be all float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"q and k must be (BH, S, d), got {tuple(q.shape)} and {tuple(k.shape)}")
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    kv_len = check_kv_len(causal, kv_len, Sk)
    if Sq % SEQ_MULTIPLE or Sk % SEQ_MULTIPLE:
        raise ValueError(
            f"Sq = {Sq} and Sk = {Sk} must be multiples of {SEQ_MULTIPLE}: pad the sequence"
        )
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim d = {d} must be a multiple of 8 up to {MAX_HEAD_DIM}")
    if window and Sq > Sk:
        raise ValueError(f"a window needs Sq <= Sk, got Sq = {Sq} and Sk = {Sk}")
    if BH > MAX_HEADS:
        raise ValueError(f"{BH} heads; the kernel takes at most {MAX_HEADS}")
    dev = check_cuda(q)
    check_tensor("q", q, q.dtype, (BH, Sq, d), dev)
    check_tensor("k", k, q.dtype, (BH, Sk, d), dev)
    check_tensor("v", v, q.dtype, (BH, Sk, d), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads 16 bytes)")
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    bf16 = q.dtype == torch.bfloat16
    _launch(q, k, v, out, causal, window, kv_len, bf16, dev)
    tracing.count("launch.flash_attention")
    tracing.count("launch.flash_attention_bf16" if bf16 else "launch.flash_attention_f32")
    if window > 0:
        tracing.count("launch.flash_attention_window")
    if kv_len < Sk:
        tracing.count("launch.flash_attention_kv_len")
    return out


def check_no_autograd(q, k, v) -> None:
    """Raise if autograd would have to differentiate the kernel's output."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash attention kernel has no backward: its output would carry no gradient "
            "into q, k or v. Train through models.attention.attn_train (plain torch ops), or "
            "call the kernel under torch.no_grad() / torch.inference_mode()"
        )


def _launch(q, k, v, out, causal: bool, window: int, kv_len: int, bf16: bool, device) -> None:
    """One launch on the device's current stream: the wgmma kernel when
    `bf16`, else the CUDA-core kernel; raise on a CUDA error."""
    BH, Sq, d = q.shape
    code = _build.launcher("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq, k.shape[1], d,
        int(causal), window, kv_len, int(bf16), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check("flash_attention", code)
