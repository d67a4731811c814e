#!/usr/bin/env python3
"""Where the kernels' time goes, on one H100.

    python3 chip_ablate.py            # from the repository root, on a machine with the card
    python3 chip_ablate.py int8       # only the int8 mainloop
    python3 chip_ablate.py sparse     # only the two sparse kernels
    python3 chip_ablate.py lattice    # only the lattice sweep
    python3 chip_ablate.py ctmc_tree  # only the sparse CTMC's tree: two repairs, a rebuild
    python3 chip_ablate.py faults     # only the fault variants against their base kernels
    python3 chip_ablate.py serve      # only the serving calls: where their time goes
    python3 chip_ablate.py train      # only the full-width train step: where its time goes
    python3 chip_ablate.py shard      # only the (1, 1) sharded train step against the unsharded

shard: the full-width train step (chip_smoke.py's TRAIN_FULL, gemma-2b in
bf16) through `launch.train.train`, unsharded and then on a (1, 1) NCCL mesh
under the config's rules (tp_sp; every tensor a DTensor), each from a fresh
state: the driver's host wall of a step (ended by reading the loss), median
of steps 3-5; then one step's profile, the difference of a 3-step and a
1-step run under torch.profiler, halved: its device time, the idle share,
the kernel launches, the aten ops the host dispatched, and the ops with the
most host time.

train: where a train step's time goes at full width: gemma-2b in bf16,
batch 4 x 1024 tokens (chip_smoke.py's TRAIN_FULL), after two warm steps:
the host wall of the forward and backward (`train_forward` and
`torch.autograd.grad`) and of the AdamW update (clipping included), each
ended by a synchronize, median of 3, under remat "dots" (the config's),
"full" and "none", with the peak memory of each; then one whole step of
"dots" under torch.profiler: its device time (the kernels' busy time), the
idle share 1 - device / wall, the launches, and the top kernels by device
time.

serve: where a serving call's time goes at full width, for phi4-mini-3p8b,
olmoe-1b-7b, internvl2-2b, recurrentgemma-9b, xlstm-125m and whisper-medium:
the host wall of a prefill (one 12-token prompt; internvl2-2b's after its
256 image patches, whisper-medium's from its 1500 frames, through the
encoder) and of a decode step (4 slots, text position 64, a 128-row cache;
internvl2-2b's 384 rows, as chip_smoke.py serves it), median of 20 after 3;
its device time, the kernels' busy time that torch.profiler records over 5
calls; the idle share 1 - device / wall; the launches and aten ops a call;
the top kernels by device time and the top ops by host time.

int8: builds variants of dense_field (src/repro_torch/kernels/csrc/dense_field.cu
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

sparse: times sparse_fields and colored_gibbs_sweep on
random_3regular_maxcut(16384, 0) (D = 3, C = 4, the sweep at beta = 1.7)
at B = 256 chains (the main path's shape) and 1024, through each variant
library's launcher:

  sparse_fields  rows R in {1, 2, 3} x threads in {256, 512, 1024} (base,
                 at both B); at B = 256 also: global (the first port's
                 one-thread-per-output kernel, the variant for long rows);
                 unroll1 (one site a thread at a time); no_stage (rows not
                 staged: time only)
  colored_gibbs_sweep  one chain a block x threads in {256, 512, 1024}
                 (base, at both B); at B = 256 also: generic (the table
                 entry read slot by slot, not as two 16-byte loads at
                 D <= 3); u_late (the uniforms
                 loaded after the gathers); unroll1, unroll4 (entries a
                 thread walks at once); in_place (new spins written to the
                 state at once, no copy pass: exact for a proper colouring
                 only); one_block (without ptxas's two-blocks-an-SM
                 register cap); u128 (the uniforms loaded
                 with the L2::128B fetch-size hint); no_u, no_gather,
                 no_prob (the uniforms, the gathers or the sigmoid left
                 out), u_cached (every uniform load of a thread at one
                 address: L1 hits) and u_l2 (every block reads chain 0's
                 uniforms: L2 hits) — these five time only; first_port (the first
                 port's kernel: one block per chain, every phase over all n
                 sites reading the masks)

lattice: times the lattice sweep's two kernels on cal_problem() at
(B, H, W) = (4096, 16, 16), the CAL main path's sweep (king masks, no
frozen site, beta = 1.7), in f32 (bf16: the bases):

  plan_*     the plan kernel (lattice_gibbs_sweep, one chain a block of
             the plan's 64 threads): base; no_u (a constant for the
             uniforms); u_l2 (every chain reads chain 0's uniforms: L2
             hits); no_phases (the chains loaded and stored only); empty
             (the launch alone); minb1 (no register cap); store_early (each
             site written to the output in its phase, no output pass:
             exact here, with every site in one list and none frozen);
             cpbN (N = 2 to 16 chains a block of N x 64 threads, the chains
             side by side in shared memory)
  generic_*  the two-buffer kernel (lattice_gibbs_generic, the first
             port's design): base; no_u; u_first (the uniform loaded before the
             stencil); in_place (one buffer); colour_only (in place, only
             the colour's sites walked); w_smem (weights, b and masks
             staged in shared memory); cpb1 (one chain, 256 threads a
             block); t256, t512 (4 chains at 256 or 512 threads);
             cpb16_t1024; empty; combined (u_first + colour_only +
             w_smem). in_place, colour_only and combined are exact for
             independent masks only.

and then, through the wrapper, the king colouring at (16, 128, 128) and
(1, 200, 200), whose lists are longer than a block's threads, so the plan
sends them to the two-buffer kernel (the route asserted from the counters).

ctmc_tree: the sparse CTMC of chip_smoke.py's ctmc_sparse phase (256 chains
on random_3regular_maxcut(16384, 0) at beta = 3, graphed), 5000 and 20000
events, and 2000 events on the graphs of n = 65536 and 262144, three ways: the carried tree repaired as run() does it
(`event_tree.repair_`, the affected paths recomputed from their children),
the carried tree with the JAX package's repair (leaf deltas added along the
paths, as `event_tree.update_many` does, in place, padded slots masked),
and a fresh build every event (the path of a changing beta). Per event:
the wall of one pass; for the carried trees, after the run: the root
against a fresh build of the rates of the final s and h (relative error),
the leaves against those rates (max absolute error).

faults: each of the three fault variants (the per-row bias b + eta of
field noise, the keep mask of update dropout) against its base kernel at
the same shape and inputs, through the wrappers, in turns (base, variant,
variant, base; the median of the two times of each): tau_leap_step at the
SK main path's (256, 2048) with a (B, N) bias; the lattice sweep at the CAL
main path's (4096, 16, 16) through the plan kernel and the two-buffer
kernel (a plan marked not independent), with the bias, the keep mask or
both; the coloured sweep at the maxcut3r main path's (256, 16384) with the
bias, the keep mask or both. What the extra operands cost on the card.

Prints one JSON line per (shape, variant) group, then the card's name and
power limit. The variants are built from patched copies of the sources in
src/repro_torch/kernels/_build/ablate/ (ignored by git); each patch is
asserted to apply.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
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


def compile_all(jobs: dict) -> dict:
    """{name: (source, extra flags)} -> {name: library path}, one nvcc per
    job, all started together; raises with nvcc's output on a failure."""
    from repro_torch.kernels import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {v: subprocess.Popen([_build._nvcc(), *flags, *extra, "-o", str(OUT / f"lib{v}.so"),
                                  str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v, (src, extra) in jobs.items()}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {v}:\n{log}")
    return {v: OUT / f"lib{v}.so" for v in jobs}


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "int8_field.cuh").write_text(patched_header())
    (OUT / "dense_field.cu").write_text(patched_kernel())
    libs = compile_all({v: (OUT / "dense_field.cu", extra) for v, extra in VARIANTS.items()})
    fns = {}
    for v, path in libs.items():
        fn = ctypes.CDLL(str(path)).dense_field_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def ablate_int8(torch, np, chip_smoke, dev) -> None:
    from repro_torch.kernels import ref

    fns = build()
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


# -- the sparse kernels ---------------------------------------------------------

def patch(src: str, name: str, patches) -> str:
    """`src` with each (old, new) replaced; raises unless each old occurs once."""
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name} no longer holds {old!r}: update the ablation")
        src = src.replace(old, new)
    return src


def patched_fields() -> str:
    """sparse_fields.cu with each ablation behind a macro."""
    return patch((CSRC / "sparse_fields.cu").read_text(), "sparse_fields.cu", [
        ("constexpr int kUnroll = 2;",
         "#ifndef ABL_UNROLL\n#define ABL_UNROLL 2\n#endif\nconstexpr int kUnroll = ABL_UNROLL;"),
        ("  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {",
         "#ifndef ABL_STAGE\n#define ABL_STAGE 1\n#endif\n"
         "  if (ABL_STAGE && (n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {"),
        ("  } else {\n    sparse_gather::stream_in(src, total,",
         "  } else if (ABL_STAGE) {\n    sparse_gather::stream_in(src, total,"),
    ])


def patched_sweep() -> str:
    """colored_gibbs.cu with each ablation behind a macro."""
    u_load = "        ur[q] = __ldg(uc + base + site[q]);\n"
    gather = "      for (int q = 0; q < kUnroll; ++q) h[q] = e[q].field(cur, n, D);\n"
    return patch((CSRC / "colored_gibbs.cu").read_text(), "colored_gibbs.cu", [
        ("constexpr int kUnroll = 2;",
         "#ifndef ABL_UNROLL\n#define ABL_UNROLL 2\n#endif\nconstexpr int kUnroll = ABL_UNROLL;\n"
         "#ifndef ABL_MINB\n#define ABL_MINB 2\n#endif\n"
         "#ifndef ABL_PACKED\n#define ABL_PACKED 1\n#endif\n"
         "#ifndef ABL_DST\n#define ABL_DST nxt\n#endif\n"
         "#if defined(ABL_NO_U)\n#define ABL_LOAD_U(uc, row, site, k) 0.5f\n"
         "#elif defined(ABL_U_CACHED)\n#define ABL_LOAD_U(uc, row, site, k) __ldg((uc) + (k))\n"
         "#elif defined(ABL_U_L2)\n#define ABL_LOAD_U(uc, row, site, k) __ldg((uc) + (site))\n"
         "#elif defined(ABL_U_FETCH)\n#define ABL_LOAD_U(uc, row, site, k) ld_fetch((uc) + (row) + (site))\n"
         "#else\n#define ABL_LOAD_U(uc, row, site, k) __ldg((uc) + (row) + (site))\n#endif\n"
         "#ifdef ABL_NO_PROB\n#define ABL_PROB __fadd_rn(h[q], bias[q])\n#else\n"
         "#define ABL_PROB glauber::prob_up(br, __fadd_rn(h[q], bias[q]))\n#endif"),
        ("__device__ __forceinline__ int8_t spin(",
         "#ifdef ABL_U_FETCH\n__device__ __forceinline__ float ld_fetch(const float* p) {\n"
         "  float v;\n  asm(\"ld.global.nc.L2::\" ABL_U_FETCH \".f32 %0, [%1];\" : \"=f\"(v) : \"l\"(p));\n"
         "  return v;\n}\n#endif\n__device__ __forceinline__ int8_t spin("),
        ("      P == 4 ? launch<true, kFaults>", "      ABL_PACKED && P == 4 ? launch<true, kFaults>"),
        ("__global__ void __launch_bounds__(1024, 2)\ncolored_gibbs_kernel",
         "__global__ void __launch_bounds__(1024, ABL_MINB)\ncolored_gibbs_kernel"),
        (u_load, "#ifndef ABL_U_LATE\n"
                 "        ur[q] = ABL_LOAD_U(uc, base, site[q], t + q * T);\n#endif\n"),
        (gather, "      for (int q = 0; q < kUnroll; ++q) {\n#ifndef ABL_NO_GATHER\n"
                 "        h[q] = e[q].field(cur, n, D);\n#else\n        h[q] = 0.0f;\n#endif\n"
                 "      }\n#ifdef ABL_U_LATE\n#pragma unroll\n"
                 "      for (int q = 0; q < kUnroll; ++q) "
                 "ur[q] = ABL_LOAD_U(uc, base, site[q], t + q * T);\n#endif\n"),
        ("        const int8_t v = ur[q] < glauber::prob_up(br, __fadd_rn(h[q], bias[q])) ? 1 : -1;",
         "        const int8_t v = ur[q] < ABL_PROB ? 1 : -1;"),
        ("        else nxt[site[q]] = v;", "        else ABL_DST[site[q]] = v;"),
        ("    __syncthreads();\n    for (int j0 = beg + t; j0 < end; j0 += kUnroll * T) {\n"
         "      int site[kUnroll];  // each entry's site",
         "    __syncthreads();\n#ifndef ABL_IN_PLACE\n"
         "    for (int j0 = beg + t; j0 < end; j0 += kUnroll * T) {\n"
         "      int site[kUnroll];  // each entry's site"),
        ("cur[site[q]] = nxt[site[q]];\n    }\n    __syncthreads();\n",
         "cur[site[q]] = nxt[site[q]];\n    }\n    __syncthreads();\n#endif\n"),
    ])


# The first port's sweep (one block per chain; every phase walks all n sites,
# reads the masks, and writes every site of the other buffer), for comparison.
FIRST_PORT_SWEEP = r"""
#include "glauber.cuh"
namespace {
__global__ void __launch_bounds__(1024)
first_port_kernel(const float* __restrict__ s, const int* __restrict__ idx, const float* __restrict__ w,
            const float* __restrict__ b, const float* __restrict__ u,
            const float* __restrict__ masks, const float* __restrict__ beta,
            float* __restrict__ out, int B, int n, int D, int C) {
  extern __shared__ int8_t smem[];
  int8_t* cur = smem;
  int8_t* nxt = smem + n;
  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * n;
  const float br = beta[r];
  for (int i = threadIdx.x; i < n; i += blockDim.x) cur[i] = s[base + i] > 0.0f ? 1 : -1;
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    const float* m = masks + static_cast<size_t>(c) * n;
    const float* uc = u + static_cast<size_t>(c) * B * n + base;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int8_t v = cur[i];
      if (__ldg(m + i) > 0.5f) {
        const size_t row = static_cast<size_t>(i) * D;
        float acc = 0.0f;
        for (int k = 0; k < D; ++k) {
          const int j = __ldg(idx + row + k);
          if (static_cast<unsigned>(j) < static_cast<unsigned>(n))
            acc = __fadd_rn(acc, __fmul_rn(__ldg(w + row + k), static_cast<float>(cur[j])));
        }
        v = uc[i] < glauber::prob_up(br, __fadd_rn(acc, __ldg(b + i))) ? 1 : -1;
      }
      nxt[i] = v;
    }
    __syncthreads();
    int8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + i] = static_cast<float>(cur[i]);
}
}  // namespace
extern "C" int first_port_launch(const void* s, const void* idx, const void* w, const void* b,
                           const void* u, const void* masks, const void* beta, void* out, int B,
                           int n, int D, int C, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(n);
  cudaError_t err = glauber::allow_smem(first_port_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  first_port_kernel<<<B, glauber::threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(u),
      static_cast<const float*>(masks), static_cast<const float*>(beta),
      static_cast<float*>(out), B, n, D, C);
  return static_cast<int>(cudaGetLastError());
}
"""

FIELDS_VARIANTS = {"base": [], "unroll1": ["-DABL_UNROLL=1"], "no_stage": ["-DABL_STAGE=0"]}
SWEEP_VARIANTS = {"base": [], "generic": ["-DABL_PACKED=0"], "u_late": ["-DABL_U_LATE"], "unroll1": ["-DABL_UNROLL=1"],
                  "in_place": ["-DABL_IN_PLACE", "-DABL_DST=cur"], "one_block": ["-DABL_MINB=1"],
                  "unroll4": ["-DABL_UNROLL=4"], "u128": ['-DABL_U_FETCH="128B"'], "no_u": ["-DABL_NO_U"],
                  "u_cached": ["-DABL_U_CACHED"], "u_l2": ["-DABL_U_L2"],
                  "no_gather": ["-DABL_NO_GATHER"], "no_prob": ["-DABL_NO_PROB"]}
SPARSE_EXACT = ("base", "generic", "u128", "unroll1", "unroll4", "global", "u_late", "in_place", "one_block",
                "first_port")
SPARSE_CHAINS = (256, 1024)  # the main path's chains, then four times as many
# (rows, threads) of the base runs; the sweep holds one chain a block
ROWS_THREADS = {"sparse_fields": [(r, t) for r in (1, 2, 3) for t in (256, 512, 1024)],
                "colored_gibbs_sweep": [(1, t) for t in (256, 512, 1024)]}


def build_sparse() -> dict:
    """{kernel: {variant: ctypes launcher}} of the two sparse libraries."""
    import shutil

    OUT.mkdir(parents=True, exist_ok=True)
    for header in ("sparse_gather.cuh", "glauber.cuh"):
        shutil.copy(CSRC / header, OUT / header)
    (OUT / "sparse_fields.cu").write_text(patched_fields())
    (OUT / "colored_gibbs.cu").write_text(patched_sweep())
    (OUT / "first_port_sweep.cu").write_text(FIRST_PORT_SWEEP)
    jobs = {f"fields_{v}": (OUT / "sparse_fields.cu", x) for v, x in FIELDS_VARIANTS.items()}
    jobs |= {f"sweep_{v}": (OUT / "colored_gibbs.cu", x) for v, x in SWEEP_VARIANTS.items()}
    jobs["sweep_first_port"] = (OUT / "first_port_sweep.cu", [])
    libs = compile_all(jobs)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {"sparse_fields": {}, "colored_gibbs_sweep": {}}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if name.startswith("fields_"):
            fn, argtypes = lib.sparse_fields_launch, [P] * 5 + [I] * 5 + [P]
            fns["sparse_fields"][name.removeprefix("fields_")] = fn
        elif name == "sweep_first_port":
            fn, argtypes = lib.first_port_launch, [P] * 8 + [I] * 4 + [P]
            fns["colored_gibbs_sweep"]["first_port"] = fn
        else:
            fn, argtypes = lib.colored_gibbs_launch, [P] * 7 + [I] * 6 + [P]
            fns["colored_gibbs_sweep"][name.removeprefix("sweep_")] = fn
        fn.argtypes, fn.restype = argtypes, I
    return fns


def ablate_sparse(torch, np, chip_smoke, dev) -> None:
    from repro_torch.core import problems
    from repro_torch.kernels import ops, ref, sparse_gather

    fns = build_sparse()
    mc = problems.random_3regular_maxcut(16384, 0, device=dev)
    n, D = mc.n, mc.max_deg
    masks = mc.color_masks.float()
    C = masks.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    plan = sparse_gather.colour_plan(mc.nbr_idx, mc.nbr_w, mc.b, masks)
    csr = chip_smoke.sparse_csr(torch, mc)
    stream = torch.cuda.current_stream().cuda_stream
    sms = sparse_gather._sm_count(dev)
    rng = np.random.default_rng(0)
    for B in SPARSE_CHAINS:
        s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, n)).astype(np.float32), device=dev)
        u = torch.rand((C, B, n), device=dev)
        beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
        out = torch.empty((B, n), dtype=torch.float32, device=dev)
        want = {"sparse_fields": ref.sparse_fields_ref(s, mc.nbr_idx, mc.nbr_w, zeros),
                "colored_gibbs_sweep": ops.colored_gibbs_sweep(s, mc.nbr_idx, mc.nbr_w, mc.b, u,
                                                               masks, beta, mode="reference")}
        band = chip_smoke.phase_band(
            torch, lambda x: ref.sparse_fields_ref(x, mc.nbr_idx, mc.nbr_w, mc.b), s, u,
            mc.color_masks, torch.zeros(n, dtype=torch.bool, device=dev), beta, chip_smoke.P_BAND)
        calls = {
            "sparse_fields": lambda fn, rows, threads: fn(
                s.data_ptr(), mc.nbr_idx.data_ptr(), mc.nbr_w.data_ptr(), zeros.data_ptr(),
                out.data_ptr(), B, n, D, rows, threads, stream),
            "colored_gibbs_sweep": lambda fn, rows, threads: fn(
                s.data_ptr(), plan.offsets.data_ptr(), plan.idx.data_ptr(), plan.w.data_ptr(),
                u.data_ptr(), beta.data_ptr(), out.data_ptr(), B, n, D, plan.idx.shape[1], C,
                threads, stream),
            "first_port": lambda fn, rows, threads: fn(
                s.data_ptr(), mc.nbr_idx.data_ptr(), mc.nbr_w.data_ptr(), mc.b.data_ptr(),
                u.data_ptr(), masks.data_ptr(), beta.data_ptr(), out.data_ptr(), B, n, D, C,
                stream)}
        wrapper = {"sparse_fields": (sparse_gather.fields_rows(B, n, sms),
                                     sparse_gather.BLOCK_THREADS),
                   "colored_gibbs_sweep": (1, sparse_gather.BLOCK_THREADS)}
        for kernel, variants in fns.items():
            runs = [("base", r, t) for r, t in ROWS_THREADS[kernel]]
            if B == SPARSE_CHAINS[0]:  # the variants at the main path's shape only
                runs += [(v, *wrapper[kernel]) for v in variants if v != "base"]
                if kernel == "sparse_fields":
                    runs.append(("global", 0, 0))
            row = {"kernel": kernel, "B": B, "n": n, "D": D, "colors": C,
                   "wrapper_rows": wrapper[kernel][0], "wrapper_threads": wrapper[kernel][1]}
            if kernel == "sparse_fields":
                s_t = s.t().contiguous()
                row["sparse_mm_ms"] = chip_smoke.time_ms(torch, lambda: torch.sparse.mm(csr, s_t))
            for v, rows, threads in runs:
                fn = variants["base" if v == "global" else v]
                call = calls["first_port" if v == "first_port" else kernel]

                def launch(fn=fn, call=call, rows=rows, threads=threads, v=v):
                    code = call(fn, rows, threads)
                    if code:
                        raise RuntimeError(f"{kernel} variant {v}: CUDA error {code}")
                out.fill_(float("nan"))
                launch()
                torch.cuda.synchronize()
                differ = out != want[kernel]
                if kernel == "colored_gibbs_sweep":
                    differ &= ~band
                if v in SPARSE_EXACT and bool(differ.any()):
                    raise AssertionError(f"{kernel} variant {v} (R={rows}, threads={threads}) at "
                                         f"B={B}: {int(differ.sum())} outputs differ from the "
                                         "plain version")
                label = f"R{rows}_T{threads}" if v == "base" else (
                    v if (rows, threads) == wrapper[kernel] or v in ("global", "first_port")
                    else f"{v}_R{rows}_T{threads}")
                row[label] = {"ms": chip_smoke.time_ms(torch, launch),
                              "exact": not bool(differ.any())}
            print(json.dumps(row), flush=True)
        del s, u, out, want, band


# -- the lattice sweep ----------------------------------------------------------

def patched_lattice() -> str:
    """lattice_gibbs.cu with each ablation of the plan kernel and of the
    two-buffer kernel (`lattice_gibbs_generic`, the first port's design) behind a
    macro."""
    prob = "glauber::prob_up(beta[r0 + r], to_f32(h))"
    update = "update<T>(ch, code[c], pw, __ldg(offsets + c) + t, W, uv[c], br)"
    plan_head = ("  const int HW = H * W, t = threadIdx.x, T_ = blockDim.x, r = blockIdx.x;\n"
                 "  int8_t* ch = smem + halo_bytes(W);\n")
    return patch((CSRC / "lattice_gibbs.cu").read_text(), "lattice_gibbs.cu", [
        # the plan kernel
        ("constexpr int kMaxColours = 4;",
         "#ifndef ABL_MINB\n#define ABL_MINB 2\n#endif\n#ifndef ABL_NO_PHASES\n"
         "#define ABL_NO_PHASES 0\n#endif\n#ifndef ABL_STORE_EARLY\n#define ABL_STORE_EARLY 0\n"
         "#endif\n#ifndef ABL_PLAN_CPB\n#define ABL_PLAN_CPB 1\n#endif\n"
         "constexpr int kMaxColours = 4;"),
        ("__launch_bounds__(1024, 2)\nlattice_gibbs_plan(",
         "__launch_bounds__(1024, ABL_MINB)\nlattice_gibbs_plan("),
        (plan_head,
         "#if ABL_PLAN_CPB > 1\n"
         "  const int HW = H * W, T_ = blockDim.x / ABL_PLAN_CPB, lr_ = threadIdx.x / T_;\n"
         "  const int t = threadIdx.x - lr_ * T_, r = blockIdx.x * ABL_PLAN_CPB + lr_;\n"
         "  int8_t* ch = smem + halo_bytes(W) + lr_ * HW;\n#else\n" + plan_head + "#endif\n"
         "#ifdef ABL_EMPTY\n  return;\n#endif\n"),
        ("  const T* ur = u + base;\n",
         "#ifdef ABL_U_L2\n  const T* ur = u;\n#else\n  const T* ur = u + base;\n#endif\n"),
        ("    uv[c] = code[c] != kNoEntry ? to_f32(__ldg(ur + c * plane + (code[c] >> 8))) : 0.0f;\n",
         "#ifdef ABL_NO_U\n    uv[c] = 0.5f;\n#else\n"
         "    uv[c] = code[c] != kNoEntry ? to_f32(__ldg(ur + c * plane + (code[c] >> 8))) : 0.0f;\n"
         "#endif\n"),
        ("    if (c >= C) break;\n", "    if (c >= C || ABL_NO_PHASES) break;\n"),
        (f"        ch[code[c] >> 8] = {update};\n",
         f"      {{\n        const int8_t v_ = {update};\n        ch[code[c] >> 8] = v_;\n"
         "        if (ABL_STORE_EARLY) out[base + (code[c] >> 8)] = round_to<T>(v_);\n      }\n"),
        ("  if (vec) {\n    const char4* c4 = reinterpret_cast<const char4*>(ch);",
         "  if (ABL_STORE_EARLY) {\n  } else if (vec) {\n"
         "    const char4* c4 = reinterpret_cast<const char4*>(ch);"),
        ("  const size_t smem = static_cast<size_t>(H) * W + 2 * halo_bytes(W);\n",
         "  const size_t smem = ABL_PLAN_CPB * static_cast<size_t>(H) * W + 2 * halo_bytes(W);\n"),
        ("lattice_gibbs_plan<T, kFaults><<<B, threads, smem, stream>>>(",
         "lattice_gibbs_plan<T, kFaults><<<B / ABL_PLAN_CPB, threads * ABL_PLAN_CPB, smem, stream>>>("),
        # the generic kernel
        ("template <typename T, bool kFaults>\n__global__ void __launch_bounds__(1024)\n"
         "lattice_gibbs_generic(",
         "#ifndef ABL_CPB\n#define ABL_CPB 0\n#endif\n#ifndef ABL_THREADS\n#define ABL_THREADS 0\n"
         "#endif\n#ifdef ABL_IN_PLACE\n#define ABL_BUFS 1\n#else\n#define ABL_BUFS 2\n#endif\n"
         "template <typename T, bool kFaults>\n__global__ void __launch_bounds__(1024)\n"
         "lattice_gibbs_generic("),
        ("  int8_t* nxt = smem + static_cast<size_t>(cpb) * HW;\n",
         "#ifdef ABL_EMPTY\n  return;\n#endif\n"
         "#ifdef ABL_IN_PLACE\n  int8_t* nxt = smem;\n#else\n"
         "  int8_t* nxt = smem + static_cast<size_t>(cpb) * HW;\n#endif\n"
         "#ifdef ABL_W_SMEM\n"
         "  T* wsm = reinterpret_cast<T*>(smem + ((ABL_BUFS * static_cast<size_t>(cpb) * HW + 15) & ~size_t(15)));\n"
         "  for (int i = threadIdx.x; i < 8 * HW; i += blockDim.x) wsm[i] = w[i];\n"
         "  for (int i = threadIdx.x; i < HW; i += blockDim.x) {\n"
         "    wsm[8 * HW + i] = b[i];\n    wsm[9 * HW + i] = frozen[i];\n  }\n"
         "  for (int i = threadIdx.x; i < C * HW; i += blockDim.x) wsm[10 * HW + i] = colors[i];\n"
         "#define ABL_W(j) wsm[j]\n#define ABL_B(j) wsm[8 * HW + (j)]\n"
         "#define ABL_FROZEN(j) wsm[9 * HW + (j)]\n#define ABL_COL(j) wsm[10 * HW + c * HW + (j)]\n"
         "#else\n#define ABL_W(j) __ldg(w + (j))\n#define ABL_B(j) __ldg(b + (j))\n"
         "#define ABL_FROZEN(j) __ldg(frozen + (j))\n#define ABL_COL(j) __ldg(col + (j))\n#endif\n"),
        ("    for (int i = threadIdx.x; i < sites; i += blockDim.x) {\n"
         "      const int r = i / HW, p = i - r * HW;\n",
         "#ifdef ABL_COLOUR_ONLY\n"
         "    const int cy = c >> 1, cx = c & 1, hh = (H - cy + 1) / 2, ww = (W - cx + 1) / 2;\n"
         "    for (int q = threadIdx.x; q < (sites / HW) * hh * ww; q += blockDim.x) {\n"
         "      const int r = q / (hh * ww), cell = q - r * (hh * ww);\n"
         "      const int p = (cy + 2 * (cell / ww)) * W + cx + 2 * (cell % ww), i = r * HW + p;\n"
         "#else\n"
         "    for (int i = threadIdx.x; i < sites; i += blockDim.x) {\n"
         "      const int r = i / HW, p = i - r * HW;\n#endif\n"),
        ("      bool upd = to_f32(__ldg(col + p)) > 0.5f && to_f32(__ldg(frozen + p)) <= 0.5f;\n",
         "      bool upd = to_f32(ABL_COL(p)) > 0.5f && to_f32(ABL_FROZEN(p)) <= 0.5f;\n"),
        ("      if (upd) {\n",
         "      if (upd) {\n#ifdef ABL_U_FIRST\n        const float uv = to_f32(uc[i]);\n#endif\n"),
        ("to_f32(__ldg(w + static_cast<size_t>(k) * HW + p))",
         "to_f32(ABL_W(static_cast<size_t>(k) * HW + p))"),
        ("to_f32(__ldg(b + p))", "to_f32(ABL_B(p))"),
        (f"        v = to_f32(uc[i]) < {prob} ? 1 : -1;\n",
         f"#if defined(ABL_NO_U)\n        v = 0.5f < {prob} ? 1 : -1;\n"
         f"#elif defined(ABL_U_FIRST)\n        v = uv < {prob} ? 1 : -1;\n"
         f"#else\n        v = to_f32(uc[i]) < {prob} ? 1 : -1;\n#endif\n"),
        ("    out[base + i] = to_f32(__ldg(frozen + p)) > 0.5f ?",
         "    out[base + i] = to_f32(ABL_FROZEN(p)) > 0.5f ?"),
        ("  int cpb = HW >= 1024 ? 1 : 1024 / HW;\n",
         "  int cpb = ABL_CPB ? ABL_CPB : (HW >= 1024 ? 1 : 1024 / HW);\n"),
        ("  const size_t smem = 2 * static_cast<size_t>(cpb) * HW;\n",
         "  size_t smem = ABL_BUFS * static_cast<size_t>(cpb) * HW;\n"
         "#ifdef ABL_W_SMEM\n  smem = ((smem + 15) & ~size_t(15)) + (10 + C) * static_cast<size_t>(HW) * sizeof(T);\n"
         "#endif\n"),
        ("lattice_gibbs_generic<T, kFaults><<<blocks, glauber::threads_for(static_cast<long long>(cpb) * HW),",
         "lattice_gibbs_generic<T, kFaults><<<blocks, ABL_THREADS ? ABL_THREADS : "
         "glauber::threads_for(static_cast<long long>(cpb) * HW),"),
    ])


# variants of the two-buffer kernel: (macros); in_place, colour_only and
# combined are exact only for independent masks (the king colouring here)
GENERIC_VARIANTS = {
    "base": [], "no_u": ["-DABL_NO_U"], "u_first": ["-DABL_U_FIRST"],
    "in_place": ["-DABL_IN_PLACE"], "colour_only": ["-DABL_IN_PLACE", "-DABL_COLOUR_ONLY"],
    "w_smem": ["-DABL_W_SMEM"], "cpb1": ["-DABL_CPB=1"],
    "t256": ["-DABL_THREADS=256"], "t512": ["-DABL_THREADS=512"],
    "cpb16_t1024": ["-DABL_CPB=16"], "empty": ["-DABL_EMPTY"],
    "combined": ["-DABL_U_FIRST", "-DABL_IN_PLACE", "-DABL_COLOUR_ONLY", "-DABL_W_SMEM"],
}
# variants of the plan kernel, each at the plan's threads a chain; cpbN puts
# N chains in a block of N times those threads
PLAN_CHAINS = (2, 4, 8, 16)
PLAN_VARIANTS = {
    "base": [], "no_u": ["-DABL_NO_U"], "u_l2": ["-DABL_U_L2"],
    "no_phases": ["-DABL_NO_PHASES=1"], "empty": ["-DABL_EMPTY"], "minb1": ["-DABL_MINB=1"],
    "store_early": ["-DABL_STORE_EARLY=1"],
} | {f"cpb{n}": [f"-DABL_PLAN_CPB={n}"] for n in PLAN_CHAINS}
LATTICE_INEXACT = ("no_u", "empty", "u_l2", "no_phases")  # time only
LATTICE_SHAPE = (4096, 16, 16)  # the CAL main path's sweep
LATTICE_LARGE = ((16, 128, 128), (1, 200, 200))  # lists longer than a block's threads


def build_lattice() -> dict:
    """{label: (ctypes launcher, kind)} of the lattice variants."""
    import shutil

    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "glauber.cuh", OUT / "glauber.cuh")
    (OUT / "lattice_gibbs_abl.cu").write_text(patched_lattice())
    jobs = {f"generic_{v}": (OUT / "lattice_gibbs_abl.cu", x) for v, x in GENERIC_VARIANTS.items()}
    jobs |= {f"plan_{v}": (OUT / "lattice_gibbs_abl.cu", x) for v, x in PLAN_VARIANTS.items()}
    libs = compile_all(jobs)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if name.startswith("generic_"):
            fn, kind = lib.lattice_gibbs_generic_launch, "generic"
            fn.argtypes = [P] * 9 + [I] * 5 + [P]
        else:
            fn, kind = lib.lattice_gibbs_launch, "plan"
            fn.argtypes = [P] * 9 + [I] * 7 + [P]
        fn.restype = I
        fns[name] = (fn, kind)
    return fns


def ablate_lattice(torch, np, chip_smoke, dev) -> None:
    from repro_torch.core import problems
    from repro_torch.core.ising import king_color_masks
    from repro_torch.kernels import ops, ref

    from repro_torch.kernels import lattice_gibbs

    fns = build_lattice()
    cal = problems.cal_problem(device=dev)
    B, H, W = LATTICE_SHAPE
    colors_b = king_color_masks(H, W, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    s32 = torch.as_tensor(rng.choice([-1.0, 1.0], (B, H, W)).astype(np.float32), device=dev)
    u32 = torch.rand((4, B, H, W), device=dev)
    beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
    frozen_b = cal.frozen_mask
    for dtype in (torch.float32, torch.bfloat16):
        s, w, b, u, colors, frozen, clampv = (
            t.to(dtype) for t in (s32, cal.w, cal.b, u32, colors_b.float(), frozen_b.float(),
                                  cal.frozen_values))
        out = torch.empty((B, H, W), dtype=dtype, device=dev)
        want = ops.lattice_gibbs_sweep(s, w, b, u, colors, frozen, clampv, beta, mode="reference")
        band = chip_smoke.phase_band(torch, lambda x: ref.lattice_fields_ref(x, w, b), s, u,
                                     colors_b, frozen_b, beta, chip_smoke.P_BAND)
        bf16 = int(dtype == torch.bfloat16)
        plan = lattice_gibbs.lattice_plan(w, b, colors, frozen, clampv)
        if B % max(PLAN_CHAINS) or not plan.threads:
            raise AssertionError(f"{LATTICE_SHAPE}: {plan.threads} threads a chain, B not a "
                                 "multiple of the chains a block")
        row = {"kernel": "lattice_gibbs", "dtype": str(dtype).removeprefix("torch."),
               "B": B, "H": H, "W": W, "frozen": int(frozen_b.sum()),
               "threads_per_chain": plan.threads}
        for label, (fn, kind) in fns.items():
            if bf16 and label not in ("generic_base", "plan_base"):
                continue  # the bf16 kernels at their base only

            def launch(fn=fn, kind=kind, label=label):
                if kind == "generic":
                    code = fn(s.data_ptr(), w.data_ptr(), b.data_ptr(), u.data_ptr(),
                              colors.data_ptr(), frozen.data_ptr(), clampv.data_ptr(),
                              beta.data_ptr(), out.data_ptr(), B, H, W, 4, bf16, stream)
                else:
                    code = fn(s.data_ptr(), plan.offsets.data_ptr(), plan.entry.data_ptr(),
                              plan.w.data_ptr(), u.data_ptr(), beta.data_ptr(),
                              plan.frozen.data_ptr(), plan.clamp.data_ptr(), out.data_ptr(),
                              B, H, W, 4, plan.frozen.numel(), plan.threads, bf16, stream)
                if code:
                    raise RuntimeError(f"lattice variant {label}: CUDA error {code}")
            out.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            differ = (out != want) & ~band
            v = label.split("_", 1)[1]
            if v not in LATTICE_INEXACT and bool(differ.any()):
                raise AssertionError(f"lattice variant {label} ({row['dtype']}): "
                                     f"{int(differ.sum())} spins differ from the plain version")
            row[label] = {"ms": chip_smoke.time_ms(torch, launch), "exact": not bool(differ.any())}
        print(json.dumps(row), flush=True)
        del s, u, out, want, band

    # the large lattices, through the wrapper: the route the plan gives them
    for B, H, W in LATTICE_LARGE:
        s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, H, W)).astype(np.float32), device=dev)
        w = torch.as_tensor(rng.normal(0.0, 0.5, (8, H, W)).astype(np.float32), device=dev)
        b = torch.as_tensor(rng.normal(0.0, 0.3, (H, W)).astype(np.float32), device=dev)
        u = torch.rand((4, B, H, W), device=dev)
        colors_b = king_color_masks(H, W, device=dev)
        frozen_b = torch.zeros((H, W), dtype=torch.bool, device=dev)
        colors, frozen, clampv = colors_b.float(), frozen_b.float(), torch.ones((H, W), device=dev)
        beta = torch.full((B,), 1.7, dtype=torch.float32, device=dev)
        plan = lattice_gibbs.lattice_plan(w, b, colors, frozen, clampv)
        args = (s, w, b, u, colors, frozen, clampv, beta)
        read = chip_smoke.counters()[1]
        got = lattice_gibbs.lattice_gibbs_sweep(*args, plan=plan)
        taken = {k: n for k, n in read().items() if k in ("lattice_gibbs_sweep",
                                                          "lattice_gibbs_generic")}
        want = ops.lattice_gibbs_sweep(*args, mode="reference")
        band = chip_smoke.phase_band(torch, lambda x: ref.lattice_fields_ref(x, w, b), s, u,
                                     colors_b, frozen_b, beta, chip_smoke.P_BAND)
        bad = int(((got != want) & ~band).sum())
        if taken != {"lattice_gibbs_sweep": 0, "lattice_gibbs_generic": 1} or bad:
            raise AssertionError(f"lattice {(B, H, W)}: launched {taken}, {bad} spins differ")
        print(json.dumps({"kernel": "lattice_gibbs", "dtype": "float32", "B": B, "H": H, "W": W,
                          "longest_list": max(plan.counts), "route": "lattice_gibbs_generic",
                          "ms": chip_smoke.time_ms(torch, lambda: lattice_gibbs.lattice_gibbs_sweep(
                              *args, plan=plan))}), flush=True)
        del s, u, got, want, band


# (n, events): the ctmc_sparse shape at two lengths, then wider graphs, where
# a rebuild's O(n) pass grows and the repair's O(log n) paths barely do
# the serving calls: full width, random weights from seed 0; a prefill of one
# 12-token prompt, a decode step of 4 slots at position 64 of a 128-row cache;
# a vlm as chip_smoke.py serves it: its image patches before the prompt, a
# cache of chip_smoke.serve_max_len rows (384); whisper from N(0, 0.02) frames
SERVE_ARCHS = ("phi4-mini-3p8b", "olmoe-1b-7b", "internvl2-2b", "recurrentgemma-9b",
               "xlstm-125m", "whisper-medium")
SERVE_PROMPT, SERVE_SLOTS, SERVE_POS, SERVE_CALLS = 12, 4, 64, 5
CTMC_TREE_CASES = ((16384, 5000), (16384, 20000), (65536, 2000), (262144, 2000))
CTMC_TREE_SIZES = sorted({n for n, _ in CTMC_TREE_CASES})


def ablate_ctmc_tree(torch, np, chip_smoke, dev) -> None:
    import dataclasses

    from repro_torch.core import event_tree, problems
    from repro_torch.core.sampler_api import CTMC, _make_run

    @dataclasses.dataclass(frozen=True)
    class RebuildCTMC(CTMC):
        """The CTMC that never carries its tree: a fresh build every event."""

        def carries_tree(self, problem) -> bool:
            return False

    repair_ = event_tree.repair_

    def delta_repair_(tree, idx, rates):
        """The JAX package's repair, in place: leaf deltas added along the
        root paths, one scatter-add a slot. A padded slot aliases site i
        (slot 0), so masking the slots equal to slot 0 is the degree mask."""
        live = torch.ones_like(idx, dtype=torch.bool)
        live[:, 1:] = idx[:, 1:] != idx[:, :1]
        delta = torch.where(live, rates - event_tree.leaves_at(tree, idx), 0.0)
        m = tree.shape[-1] // 2
        paths = (m + idx)[..., None] >> torch.arange(event_tree.depth(tree) + 1, device=dev)
        for j in range(idx.shape[-1]):
            tree.scatter_add_(-1, paths[:, j], delta[:, j, None].expand(paths[:, j].shape))
        return tree

    c = chip_smoke.CTMC_MAIN
    beta = torch.full((c["n_chains"],), c["sparse_beta"], dtype=torch.float32, device=dev)
    variants = (("port_repair", CTMC(), repair_), ("jax_delta_repair", CTMC(), delta_repair_),
                ("rebuild_every_event", RebuildCTMC(), repair_))
    graphs = {n: problems.random_3regular_maxcut(n, 0, device=dev) for n in CTMC_TREE_SIZES}
    for n, events in CTMC_TREE_CASES:
        mc = graphs[n]
        for name, kernel, repair in variants:
            event_tree.repair_ = repair
            try:
                make = _make_run(mc, kernel, 0, n_steps=events, n_chains=c["n_chains"],
                                 schedule=c["sparse_beta"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                make()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                event_tree.repair_ = repair_
            st = make.final_state
            if (st.aux.tree_beta is None) != (name == "rebuild_every_event"):
                raise AssertionError(f"ctmc_tree {name}: carried {st.aux.tree_beta is not None}")
            rates = kernel.rates(mc, st.s, st.aux.h, beta)
            fresh = event_tree.total(event_tree.build(rates))
            out = {"ablation": "ctmc_tree", "variant": name, "n_events": events,
                   "n_chains": c["n_chains"], "n": mc.n, "beta": c["sparse_beta"],
                   "us_per_event": wall / events * 1e6, "total_median": float(fresh.median())}
            if name != "rebuild_every_event":  # a rebuilt tree is the last draw's, pre-flip
                root = event_tree.total(st.aux.tree)
                out.update(
                    root_max_rel_err=float(((root - fresh).abs() / fresh).max()),
                    root_median_rel_err=float(((root - fresh).abs() / fresh).median()),
                    leaf_max_abs_err=float((event_tree.leaves(st.aux.tree, mc.n) - rates)
                                           .abs().max()))
            print(json.dumps(out), flush=True)


def ablate_faults(torch, np, chip_smoke, dev) -> None:
    from repro_torch.core import problems
    from repro_torch.core.ising import king_color_masks
    from repro_torch.kernels import lattice_gibbs, sparse_gather, tau_leap

    def turns(base, variant) -> tuple:
        """(base ms, variant ms): base, variant, variant, base, each a
        CUDA-event median; the mean of each kernel's two."""
        t = [chip_smoke.time_ms(torch, f) for f in (base, variant, variant, base)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    rng = np.random.default_rng(0)
    B, N = chip_smoke.TIME_SHAPE
    s = torch.as_tensor(rng.choice([-1.0, 1.0], (B, N)).astype(np.float32), device=dev)
    J = torch.as_tensor(rng.integers(-127, 128, (N, N)).astype(np.int8), device=dev)
    b = torch.as_tensor(rng.normal(0.0, 0.2, N).astype(np.float32), device=dev)
    rows = b + 0.1 * torch.randn((B, N), device=dev)
    u = torch.rand((B, N), device=dev)
    beta = torch.full((B,), 1.7, device=dev)
    scale = torch.tensor(1.0 / 127.0, device=dev)
    dt = torch.tensor(0.1, device=dev)
    base, var = turns(lambda: tau_leap.tau_leap_step(s, J, b, scale, u, dt, beta),
                      lambda: tau_leap.tau_leap_step(s, J, rows, scale, u, dt, beta))
    print(json.dumps({"ablation": "faults", "kernel": "tau_leap_step", "shape": [B, N],
                      "base_ms": base, "bias_rows_ms": var}), flush=True)

    cal = problems.cal_problem(device=dev)
    H, W = cal.shape
    B = chip_smoke.LATTICE_MAIN["n_chains"]
    s = torch.where(torch.rand((B, H, W), device=dev) < 0.5, 1.0, -1.0)
    u = torch.rand((4, B, H, W), device=dev)
    beta = torch.full((B,), 1.7, device=dev)
    colors = king_color_masks(H, W, device=dev).float()
    frozen, clampv = cal.frozen_mask.float(), cal.frozen_values
    rows = cal.b + 0.1 * torch.randn((B, H, W), device=dev)
    keep = torch.rand((B, H, W), device=dev) >= 0.1
    plan = lattice_gibbs.lattice_plan(cal.w, cal.b, colors, frozen, clampv)
    args = (s, cal.w, cal.b, u, colors, frozen, clampv, beta)
    for route, p in (("plan", plan), ("generic", plan._replace(independent=False))):
        out = {"ablation": "faults", "kernel": f"lattice_gibbs_{route}", "shape": [B, H, W]}
        for label, kw in (("bias_rows", dict(bias_rows=rows)), ("keep", dict(keep=keep)),
                          ("both", dict(bias_rows=rows, keep=keep))):
            base, var = turns(lambda: lattice_gibbs.lattice_gibbs_sweep(*args, plan=p),
                              lambda: lattice_gibbs.lattice_gibbs_sweep(*args, plan=p, **kw))
            out[f"base_ms_{label}"], out[f"{label}_ms"] = base, var
        print(json.dumps(out), flush=True)

    mc = problems.random_3regular_maxcut(chip_smoke.SPARSE_MAIN["n"], 0, device=dev)
    B, n = chip_smoke.SPARSE_MAIN["n_chains"], mc.n
    masks = mc.color_masks.float()
    s = torch.where(torch.rand((B, n), device=dev) < 0.5, 1.0, -1.0)
    u = torch.rand((masks.shape[0], B, n), device=dev)
    beta = torch.full((B,), 1.7, device=dev)
    rows = mc.b + 0.1 * torch.randn((B, n), device=dev)
    keep = torch.rand((B, n), device=dev) >= 0.1
    plan = sparse_gather.colour_plan(mc.nbr_idx, mc.nbr_w, mc.b, masks)
    args = (s, mc.nbr_idx, mc.nbr_w, mc.b, u, masks, beta)
    out = {"ablation": "faults", "kernel": "colored_gibbs_sweep", "shape": [B, n]}
    for label, kw in (("bias_rows", dict(bias_rows=rows)), ("keep", dict(keep=keep)),
                      ("both", dict(bias_rows=rows, keep=keep))):
        base, var = turns(lambda: sparse_gather.colored_gibbs_sweep(*args, plan=plan),
                          lambda: sparse_gather.colored_gibbs_sweep(*args, plan=plan, **kw))
        out[f"base_ms_{label}"], out[f"{label}_ms"] = base, var
    print(json.dumps(out), flush=True)


def ablate_serve(torch, np, chip_smoke, dev) -> None:
    """Where a serving call's time goes at full width (module docstring)."""
    import statistics
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import model

    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        params = model.init_params(cfg, 0, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT), generator=gen, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_SLOTS,), generator=gen, device=dev)
        max_len = chip_smoke.serve_max_len(cfg)
        extras = {}
        if cfg.family == "vlm":
            extras["patch_embeds"] = 0.02 * torch.randn((1, cfg.n_patches, cfg.d_model),
                                                        generator=gen, device=dev)
        if cfg.family == "audio":
            extras["frames"] = 0.02 * torch.randn((1, cfg.encoder_seq, cfg.d_model),
                                                  generator=gen, device=dev)
        caches = model.init_caches(cfg, SERVE_SLOTS, max_len, dev)
        calls = {"prefill": lambda: params.prefill(
                     prompt, model.init_caches(cfg, 1, max_len, dev), **extras),
                 "decode": lambda: params.decode_step(tokens, SERVE_POS, caches)}
        for name, fn in calls.items():
            walls = []
            for _ in range(23):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            # device time from the profiler's kernels: a call's ~2000-2800
            # launches overflow the launch queue, so a sleep kernel cannot
            # hold the device while the host queues them
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(SERVE_CALLS):
                    fn()
                torch.cuda.synchronize()
            avgs = prof.key_averages()
            kernels = [a for a in avgs if a.device_type == DeviceType.CUDA]
            host_ops = [a for a in avgs if a.device_type == DeviceType.CPU and a.key.startswith("aten::")]
            wall = statistics.median(walls[3:])
            device_ms = sum(a.self_device_time_total for a in kernels) / SERVE_CALLS / 1e3
            chip_smoke.emit({
                "part": "serve", "arch": arch, "call": name,
                "shape": {"prefill": [1, SERVE_PROMPT], "decode": [SERVE_SLOTS, SERVE_POS]}[name],
                "patches": cfg.n_patches if "patch_embeds" in extras else 0,
                "frames": cfg.encoder_seq if "frames" in extras else 0, "max_len": max_len,
                "wall_ms": wall, "wall_ms_all": walls, "device_ms": device_ms,
                "idle_share": 1.0 - device_ms / wall,
                "launches": sum(a.count for a in kernels) / SERVE_CALLS,
                "aten_ops": sum(a.count for a in host_ops) / SERVE_CALLS,
                "top_kernels_us": [[a.key[:90], a.self_device_time_total / SERVE_CALLS,
                                    a.count / SERVE_CALLS]
                                   for a in sorted(kernels, key=lambda a: a.self_device_time_total,
                                                   reverse=True)[:12]],
                "top_host_ops_us": [[a.key, a.self_cpu_time_total / SERVE_CALLS,
                                     a.count / SERVE_CALLS]
                                    for a in sorted(host_ops, key=lambda a: a.self_cpu_time_total,
                                                    reverse=True)[:12]]})
        del params, caches, calls, extras
        torch.cuda.empty_cache()


def ablate_train(torch, np, chip_smoke, dev) -> None:
    """Where a full-width train step's time goes (module docstring)."""
    import dataclasses
    import statistics
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig, init_state

    f = chip_smoke.TRAIN_FULL
    base = get_config(f["arch"])
    pipe = TokenPipeline(DataConfig(vocab_size=base.vocab_size, seq_len=f["seq"],
                                    global_batch=f["batch"]), dev)
    ocfg = adamw.AdamWConfig(lr=3e-3)
    state = init_state(base, TrainConfig(), 0, dev)
    m = state.params
    params = dict(m.named_parameters())
    decay = convert.decay_mask(base, params)
    opt = state.opt

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for remat in ("dots", "full", "none"):
        m.cfg = dataclasses.replace(base, remat=remat)
        fwd_bwd, opt_ms = [], []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(5):
            batch = pipe.global_batch(i)

            def grads():
                loss, _ = m.train_forward(batch)
                return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

            g, ms = timed(grads)
            (opt, _), ms2 = timed(lambda: adamw.update(g, opt, params, ocfg, 0.1, decay=decay))
            del g
            fwd_bwd.append(ms)
            opt_ms.append(ms2)
        chip_smoke.emit({"part": "train", "arch": f["arch"], "remat": remat,
                         "batch": f["batch"], "seq": f["seq"],
                         "forward_backward_ms": statistics.median(fwd_bwd[2:]),
                         "optimizer_ms": statistics.median(opt_ms[2:]),
                         "forward_backward_ms_all": fwd_bwd, "optimizer_ms_all": opt_ms,
                         "peak_bytes": torch.cuda.max_memory_allocated(dev)})
    m.cfg = base
    batch = pipe.global_batch(9)

    def step():
        loss, _ = m.train_forward(batch)
        g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        return adamw.update(g, opt, params, ocfg, 0.1, decay=decay)

    _, wall = timed(step)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(step)
    kernels = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    device_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    chip_smoke.emit({
        "part": "train", "arch": f["arch"], "remat": base.remat, "profiled_step_wall_ms": wall,
        "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall,
        "launches": sum(a.count for a in kernels),
        "top_kernels_ms": [[a.key[:90], a.self_device_time_total / 1e3, a.count]
                           for a in sorted(kernels, key=lambda a: a.self_device_time_total,
                                           reverse=True)[:15]]})
    del state, m, params, opt
    torch.cuda.empty_cache()


def ablate_shard(torch, np, chip_smoke, dev) -> None:
    """The (1, 1) sharded train step against the unsharded one (module
    docstring)."""
    import collections
    import statistics
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.train_step import TrainConfig

    f = chip_smoke.TRAIN_FULL
    cfg = get_config(f["arch"])
    tcfg = TrainConfig(total_steps=100, warmup_steps=2)
    cuda = dev.type == "cuda"  # the CPU only in a rehearsal, on gloo

    def run(steps, mesh):
        out = train.train(cfg, tcfg, steps=steps, batch=f["batch"], seq=f["seq"], device=dev,
                          mesh=mesh)
        del out["state"]
        if cuda:
            torch.cuda.empty_cache()
        return out

    def profiled(steps, mesh):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run(steps, mesh)
        kern = collections.Counter()
        aten = collections.Counter()
        host = collections.Counter()
        for a in prof.key_averages():
            if a.device_type == DeviceType.CUDA:
                kern["n"] += a.count
                kern["us"] += a.self_device_time_total
            elif a.device_type == DeviceType.CPU:
                host[a.key[:80]] += a.self_cpu_time_total
                if a.key.startswith("aten::"):
                    aten["n"] += a.count
        return out, kern, aten, host

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev if cuda else None)
        try:
            mesh = make_test_mesh((1, 1), ("data", "model"), dev.type)
            for name, m in (("unsharded", None), ("mesh_1x1", mesh)):
                timed = run(5, m)
                # one step's profile: a 3-step run less a 1-step run, halved
                # (each run's state init and first step cancel)
                one, k1, a1, h1 = profiled(1, m)
                three, k3, a3, h3 = profiled(3, m)
                wall = sum(three["step_ms"][1:]) / 2
                device_ms = (k3["us"] - k1["us"]) / 2e3
                host = {key: (h3[key] - h1[key]) / 2e3 for key in h3}
                chip_smoke.emit({
                    "part": "shard", "run": name, "arch": f["arch"], "batch": f["batch"],
                    "seq": f["seq"], "rules": timed["rules"],
                    "step_ms": statistics.median(timed["step_ms"][2:]),
                    "step_ms_all": timed["step_ms"], "profiled_step_wall_ms": wall,
                    "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall,
                    "launches": (k3["n"] - k1["n"]) / 2, "aten_ops": (a3["n"] - a1["n"]) / 2,
                    "top_cpu_self_ms": sorted(host.items(), key=lambda kv: -kv[1])[:12]})
        finally:
            dist.destroy_process_group()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_ablate.py: no CUDA device", file=sys.stderr)
        return 2
    known = ["int8", "sparse", "lattice", "ctmc_tree", "faults", "serve", "train", "shard"]
    parts = sys.argv[1:] or known
    if not set(parts) <= set(known):
        print(f"chip_ablate.py: unknown parts {parts}; use {', '.join(known[:-1])} and/or "
              f"{known[-1]}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    dev = torch.device("cuda", 0)
    if "int8" in parts:
        ablate_int8(torch, np, chip_smoke, dev)
    if "sparse" in parts:
        ablate_sparse(torch, np, chip_smoke, dev)
    if "lattice" in parts:
        ablate_lattice(torch, np, chip_smoke, dev)
    if "ctmc_tree" in parts:
        ablate_ctmc_tree(torch, np, chip_smoke, dev)
    if "faults" in parts:
        ablate_faults(torch, np, chip_smoke, dev)
    if "serve" in parts:
        ablate_serve(torch, np, chip_smoke, dev)
    if "train" in parts:
        ablate_train(torch, np, chip_smoke, dev)
    if "shard" in parts:
        ablate_shard(torch, np, chip_smoke, dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
