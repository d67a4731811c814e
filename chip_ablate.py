#!/usr/bin/env python3
"""Where the int8 field mainloop's time goes, on one H100.

    python3 chip_ablate.py    # from the repository root, on a machine with the card

Builds variants of dense_field (src/repro_torch/kernels/csrc/dense_field.cu
over int8_field.cuh), each with one thing compiled out or changed, and
times each at (B, N) = (256, 2048) and (1024, 2048) with chip_smoke.py's
CUDA-event median, beside torch._int_mm:

  base      the kernel as it is
  no_mma    the loads without the MMAs (results wrong: time only)
  no_load   the MMAs on whatever shared memory holds, without the loads
  neither   neither: launch, cluster barriers, the k-half sums, epilogue
  split1    no split-K: one block per 64 x 64 tile, no cluster
  warps421  8 warps of 16 x 32 over the whole k of each tile (no k halves)
  stages2, stages3   a ring of 2 or 3 stages instead of 4
  empty     the launch alone: the kernel returns at once (same grid,
            cluster and shared memory)
  empty_split1   the same without the cluster

Prints one JSON line per (shape, variant), then the card's name and power
limit. The variants are built from patched copies of the sources in
src/repro_torch/kernels/_build/ablate/ (ignored by git); each patch is
asserted to apply.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "src/repro_torch/kernels/_build/ablate"
SHAPES = [(256, 2048), (1024, 2048)]


def patched_header() -> str:
    """int8_field.cuh with each ablation behind a macro."""
    h = (CSRC / "int8_field.cuh").read_text()
    patches = [
        ("constexpr int STAGES = 4;",
         "#ifndef ABL_STAGES\n#define ABL_STAGES 4\n#endif\nconstexpr int STAGES = ABL_STAGES;"),
        ("constexpr int SPLIT_K = 2;",
         "#ifndef ABL_SPLIT_K\n#define ABL_SPLIT_K 2\n#endif\nconstexpr int SPLIT_K = ABL_SPLIT_K;"),
        ("constexpr int WARPS_M = 2, WARPS_N = 2, WARPS_K = 2;",
         "#ifndef ABL_WM\n#define ABL_WM 2\n#define ABL_WN 2\n#define ABL_WK 2\n#endif\n"
         "constexpr int WARPS_M = ABL_WM, WARPS_N = ABL_WN, WARPS_K = ABL_WK;"),
        ("    if (next < k_tiles)\n      load_stage(",
         "#ifndef ABL_NO_LOAD\n    if (next < k_tiles)\n#else\n    if (false)\n#endif\n      load_stage("),
        ("    if (st < k_tiles)\n      load_stage(",
         "#ifndef ABL_NO_LOAD\n    if (st < k_tiles)\n#else\n    if (false)\n#endif\n      load_stage("),
        ("          mma_s8(acc.c[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);",
         "        {\n#ifndef ABL_NO_MMA\n"
         "          mma_s8(acc.c[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);\n"
         "#endif\n        }"),
    ]
    for old, new in patches:
        if h.count(old) != 1:
            raise RuntimeError(f"int8_field.cuh no longer holds {old!r}: update the ablation")
        h = h.replace(old, new)
    return h


VARIANTS = {
    "base": [], "no_mma": ["-DABL_NO_MMA"], "no_load": ["-DABL_NO_LOAD"],
    "neither": ["-DABL_NO_MMA", "-DABL_NO_LOAD"], "split1": ["-DABL_SPLIT_K=1"],
    "warps421": ["-DABL_WM=4", "-DABL_WN=2", "-DABL_WK=1"],
    "stages2": ["-DABL_STAGES=2"], "stages3": ["-DABL_STAGES=3"],
    "empty": ["-DABL_EMPTY"], "empty_split1": ["-DABL_EMPTY", "-DABL_SPLIT_K=1"],
}
EXACT = ("base", "split1", "warps421", "stages2", "stages3")  # the others compute nothing right


def patched_kernel() -> str:
    """dense_field.cu with ABL_EMPTY returning at the kernel's first line."""
    src = (CSRC / "dense_field.cu").read_text()
    old = "  extern __shared__ __align__(16) uint8_t smem[];\n"
    if src.count(old) != 1:
        raise RuntimeError("dense_field.cu no longer declares its shared memory so: "
                           "update the ablation")
    return src.replace(old, old + "#ifdef ABL_EMPTY\n  return;\n#endif\n")


def build() -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "int8_field.cuh").write_text(patched_header())
    (OUT / "dense_field.cu").write_text(patched_kernel())
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {v: subprocess.Popen([_build._nvcc(), *flags, *extra, "-o", str(OUT / f"lib{v}.so"),
                                  str(OUT / "dense_field.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v, extra in VARIANTS.items()}
    fns = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {v}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"lib{v}.so")).dense_field_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_ablate.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import ref

    fns = build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for B, N in SHAPES:
        s8 = torch.as_tensor(rng.choice([-1, 1], (B, N)).astype(np.int8), device=dev)
        J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
        b = torch.zeros(N, device=dev)
        one = torch.tensor(1.0, device=dev)
        out = torch.empty((B, N), device=dev)
        want = ref.dense_acc_ref(s8, J).float()
        row = {"B": B, "N": N,
               "int_mm_ms": chip_smoke.time_ms(torch, lambda: torch._int_mm(s8, J.t()))}
        for v, fn in fns.items():
            def call(fn=fn):
                code = fn(s8.data_ptr(), J.data_ptr(), b.data_ptr(), one.data_ptr(), out.data_ptr(),
                          B, N, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"variant {v}: CUDA error {code}")
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            exact = bool((out == want).all())
            if v in EXACT and not exact:
                raise AssertionError(f"variant {v} at ({B}, {N}) is not exact")
            row[v] = {"ms": chip_smoke.time_ms(torch, call), "exact": exact}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
