// sparse_fields: h = gather(s, nbr_idx) . nbr_w + b over the padded
// neighbour lists, one thread per (row, site). Replaces the TPU kernel
// repro/kernels/sparse_gather.py::sparse_fields. Memory-bound: at
// (256, 16384), D = 3 it must move about 34 MB, 10 us at 3.35 TB/s (see
// kernels/sparse_gather.py).
//
// s: (B, n) f32, nbr_idx: (n, D) int32, nbr_w: (n, D) f32, b: (n,) f32,
// out: (B, n) f32. Neighbouring threads take neighbouring sites of one row,
// so their table reads are coalesced; the spins they gather are random
// reads of one row (64 KB at n = 16384), served from L1/L2.
#include "sparse_gather.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparse_fields_kernel(const float* __restrict__ s, const int* __restrict__ idx,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, long long total, int n, int D) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long r = t / n;
  const int i = static_cast<int>(t - r * n);
  out[t] = sparse_gather::field(s + r * n, idx, w, b, i, n, D);
}

}  // namespace

extern "C" int sparse_fields_launch(const void* s, const void* idx, const void* w,
                                    const void* b, void* out, int B, int n, int D,
                                    void* stream) {
  const long long total = static_cast<long long>(B) * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  sparse_fields_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(out),
      total, n, D);
  return static_cast<int>(cudaGetLastError());
}
