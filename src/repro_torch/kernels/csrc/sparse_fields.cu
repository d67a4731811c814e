// sparse_fields: h = gather(s, nbr_idx) . nbr_w + b over the padded
// neighbour lists. Replaces the TPU kernel
// repro/kernels/sparse_gather.py::sparse_fields. Memory-bound: at
// (256, 16384), D = 3 it must move about 34 MB, 10 us at 3.35 TB/s (see
// kernels/sparse_gather.py).
//
// s: (B, n) f32 (any values), nbr_idx: (n, D) int32, nbr_w: (n, D) f32,
// b: (n,) f32, out: (B, n) f32. Two kernels, chosen by the wrapper from n
// and named apart in its launch counts:
//
//   staged<R> (rows of up to 58112 sites): a block copies R whole rows of s
//     into shared memory (R * 4n bytes) with coalesced 16-byte loads, then
//     walks every site: one thread loads the site's D slots of nbr_idx and
//     nbr_w and its b once (two sites at a time, the loads of both in
//     flight together), gathers from the R staged rows and writes the R
//     outputs coalesced. The tables are read
//     B/R times instead of B times, and the random gathers hit shared
//     memory instead of costing a 32-byte sector of L1/L2 for every 4 bytes.
//   global (longer rows): one thread per (row, site), gathering from the
//     row through the cache (the design of the first port).
#include <cuda_runtime.h>

#include <cstdint>

#include "sparse_gather.cuh"

namespace {

constexpr int kUnroll = 2;  // sites a thread walks at once, their loads issued together

template <int R>
__global__ void __launch_bounds__(1024)
sparse_fields_staged(const float* __restrict__ s, const int* __restrict__ idx,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, int B, int n, int D) {
  extern __shared__ __align__(16) float rows[];  // [R][n]
  const int T = blockDim.x, t = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, B - row0);  // the last block may hold fewer rows
  const float* src = s + static_cast<size_t>(row0) * n;
  const int total = nr * n;  // the block's rows are contiguous in s
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    float4* r4 = reinterpret_cast<float4*>(rows);
    sparse_gather::stream_in(reinterpret_cast<const float4*>(src), total >> 2, t, T,
                             [&](int q, float4 v) { r4[q] = v; });
  } else {
    sparse_gather::stream_in(src, total, t, T, [&](int q, float v) { rows[q] = v; });
  }
  __syncthreads();

  for (int i0 = t; i0 < n; i0 += kUnroll * T) {
    int site[kUnroll];  // a missing site repeats i0: the same value is written twice
    float acc[kUnroll][R];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      site[q] = i0 + q * T < n ? i0 + q * T : i0;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[q][r] = 0.0f;
    }
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const size_t e = static_cast<size_t>(site[q]) * D + k;
        sparse_gather::add_slot<R>(acc[q], rows, static_cast<size_t>(n), __ldg(idx + e),
                                   __ldg(w + e), n);
      }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const float bias = __ldg(b + site[q]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) out[static_cast<size_t>(row0 + r) * n + site[q]] = __fadd_rn(acc[q][r], bias);
    }
  }
}

constexpr int kGlobalThreads = 256;

__global__ void __launch_bounds__(kGlobalThreads)
sparse_fields_global(const float* __restrict__ s, const int* __restrict__ idx,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, long long total, int n, int D) {
  const long long t = static_cast<long long>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (t >= total) return;
  const long long r = t / n;
  const int i = static_cast<int>(t - r * n);
  out[t] = sparse_gather::field(s + r * n, idx, w, b, i, n, D);
}

template <int R>
cudaError_t launch_staged(const float* s, const int* idx, const float* w, const float* b,
                          float* out, int B, int n, int D, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(R) * n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_fields_staged<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sparse_fields_staged<R><<<(B + R - 1) / R, threads, smem, stream>>>(s, idx, w, b, out,
                                                                              B, n, D);
  return cudaGetLastError();
}

}  // namespace

// rows = 0: the global kernel (threads ignored); rows = 1..3: staged<rows>
// with `threads` threads a block. Returns cudaGetLastError() after the
// launch (or the attribute call's error); 1 (cudaErrorInvalidValue) for
// any other rows. The caller has checked that rows * 4n bytes fit.
extern "C" int sparse_fields_launch(const void* s_, const void* idx_, const void* w_,
                                    const void* b_, void* out_, int B, int n, int D, int rows,
                                    int threads, void* stream_) {
  const auto* s = static_cast<const float*>(s_);
  const auto* idx = static_cast<const int*>(idx_);
  const auto* w = static_cast<const float*>(w_);
  const auto* b = static_cast<const float*>(b_);
  auto* out = static_cast<float*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  switch (rows) {
    case 0: {
      const long long total = static_cast<long long>(B) * n;
      const long long blocks = (total + kGlobalThreads - 1) / kGlobalThreads;
      sparse_fields_global<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, stream>>>(
          s, idx, w, b, out, total, n, D);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return static_cast<int>(launch_staged<1>(s, idx, w, b, out, B, n, D, threads, stream));
    case 2: return static_cast<int>(launch_staged<2>(s, idx, w, b, out, B, n, D, threads, stream));
    case 3: return static_cast<int>(launch_staged<3>(s, idx, w, b, out, B, n, D, threads, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
