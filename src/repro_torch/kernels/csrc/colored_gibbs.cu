// colored_gibbs_sweep: one chromatic Gibbs sweep over the C colour classes
// of a sparse graph, all chains as the B rows of one launch. Replaces the
// TPU kernel repro/kernels/sparse_gather.py::colored_gibbs_sweep.
// Memory-bound: at (256, 16384), D = 3, C = 4 it must move about 51 MB,
// 15 us at 3.35 TB/s (see kernels/sparse_gather.py).
//
// For each colour c in order, at every site i with masks[c][i] > 0.5, from
// the state before the phase:
//   h_i  = the in-order slot sum of sparse_gather.cuh
//   s[i] = u[c][r][i] < sigma(-2 * (beta_r * h_i)) ? +1 : -1
//
// s: (B, n) f32 +-1, nbr_idx: (n, D) int32, nbr_w: (n, D) f32, b: (n,),
// u: (C, B, n), masks: (C, n) f32 {0,1}, beta: (B,), out: (B, n) f32
// (never aliasing s).
//
// Design: one block per chain (row) holds the row's n spins in shared
// memory as int8 +-1, in two buffers (2n bytes: 32 KB at n = 16384): each
// phase reads one and writes every site of the other, then one barrier,
// then the buffers swap. So every field of a phase sees the state before
// the phase for any masks, as in JAX. The tables (nbr_idx, nbr_w, b, masks:
// 0.7 MB at n = 16384, D = 3, C = 4) are read by every block through the
// read-only cache and stay in L2.
#include "glauber.cuh"
#include "sparse_gather.cuh"

namespace {

__global__ void __launch_bounds__(1024)
colored_gibbs_kernel(const float* __restrict__ s, const int* __restrict__ idx,
                     const float* __restrict__ w, const float* __restrict__ b,
                     const float* __restrict__ u, const float* __restrict__ masks,
                     const float* __restrict__ beta, float* __restrict__ out, int B, int n,
                     int D, int C) {
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
        const float h = sparse_gather::field(cur, idx, w, b, i, n, D);
        v = uc[i] < glauber::prob_up(br, h) ? 1 : -1;
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

// Returns cudaGetLastError() after the launch (or the attribute call's
// error). The caller has checked that 2 * n bytes fit in one block.
extern "C" int colored_gibbs_launch(const void* s, const void* idx, const void* w,
                                    const void* b, const void* u, const void* masks,
                                    const void* beta, void* out, int B, int n, int D, int C,
                                    void* stream) {
  const size_t smem = 2 * static_cast<size_t>(n);
  cudaError_t err = glauber::allow_smem(colored_gibbs_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  colored_gibbs_kernel<<<B, glauber::threads_for(n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(u), static_cast<const float*>(masks),
      static_cast<const float*>(beta), static_cast<float*>(out), B, n, D, C);
  return static_cast<int>(cudaGetLastError());
}
