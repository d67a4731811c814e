// lattice_gibbs_sweep: one chromatic Gibbs sweep on the king's-move lattice,
// all chains as the B rows of one launch. Replaces the TPU kernel
// repro/kernels/lattice_gibbs.py::lattice_gibbs_sweep. Memory-bound: at
// (4096, 16, 16) it must move about 12.6 MB, 3.8 us at 3.35 TB/s (the
// bound's count and the design's reasons: kernels/lattice_gibbs.py).
//
// For each colour c in order, at every site p of the colour that is not
// frozen (colors[c][p] > 0.5, frozen[p] <= 0.5), from the state before the
// phase:
//   h    = ((0 + w[0][p] s[p+o0]) + w[1][p] s[p+o1]) + ... + w[7][p] s[p+o7]) + b[p]
//   up   = u[c][r][p] < sigma(-2 * (beta_r * h))
//   s[p] = up ? +1 : -1
// then out = frozen ? clamp_value : s. The offsets o_k are KING_OFFSETS in
// order; a neighbour beyond the edge is skipped, which is exact: the JAX
// stencil adds w * 0 = +-0 there to a sum that is never -0.
//
// s: (B, H, W) f32 +-1, w: (8, H, W), b: (H, W), u: (C, B, H, W),
// colors: (C, H, W) f32 {0,1}, frozen and clamp: (H, W) f32, beta: (B,),
// out: (B, H, W) f32 (never aliasing s).
//
// Design: a block holds `cpb` whole chains (one chain when H*W > 1024) in
// shared memory as int8 +-1, in two buffers: each phase reads one and
// writes every site of the other (the proposal or the old spin), then one
// barrier, then the buffers swap. So every field of a phase sees the state
// before the phase for any masks, as in JAX, also for an improper colouring.
// w, b and the masks are read through the read-only cache (8 KB of weights
// at 16x16, L2-resident across blocks).
#include "glauber.cuh"

namespace {

__constant__ int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

__global__ void __launch_bounds__(1024)
lattice_gibbs_kernel(const float* __restrict__ s, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ u,
                     const float* __restrict__ colors, const float* __restrict__ frozen,
                     const float* __restrict__ clampv, const float* __restrict__ beta,
                     float* __restrict__ out, int B, int H, int W, int C, int cpb) {
  extern __shared__ int8_t smem[];
  const int HW = H * W;
  const int r0 = blockIdx.x * cpb;
  const int sites = min(cpb, B - r0) * HW;
  int8_t* cur = smem;
  int8_t* nxt = smem + static_cast<size_t>(cpb) * HW;
  const size_t base = static_cast<size_t>(r0) * HW;

  for (int i = threadIdx.x; i < sites; i += blockDim.x) cur[i] = s[base + i] > 0.0f ? 1 : -1;
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const float* col = colors + static_cast<size_t>(c) * HW;
    const float* uc = u + static_cast<size_t>(c) * B * HW + base;
    for (int i = threadIdx.x; i < sites; i += blockDim.x) {
      const int r = i / HW, p = i - r * HW;
      int8_t v = cur[i];
      if (__ldg(col + p) > 0.5f && __ldg(frozen + p) <= 0.5f) {
        const int y = p / W, x = p - y * W;
        const int8_t* chain = cur + static_cast<size_t>(r) * HW;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int yy = y + kDy[k], xx = x + kDx[k];
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            acc = __fadd_rn(acc, __fmul_rn(__ldg(w + static_cast<size_t>(k) * HW + p),
                                           static_cast<float>(chain[yy * W + xx])));
        }
        const float h = __fadd_rn(acc, __ldg(b + p));
        v = uc[i] < glauber::prob_up(beta[r0 + r], h) ? 1 : -1;
      }
      nxt[i] = v;
    }
    __syncthreads();
    int8_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = threadIdx.x; i < sites; i += blockDim.x) {
    const int p = i % HW;
    out[base + i] = __ldg(frozen + p) > 0.5f ? __ldg(clampv + p) : static_cast<float>(cur[i]);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the attribute call's
// error). The caller has checked that 2 * H * W bytes fit in one block.
extern "C" int lattice_gibbs_launch(const void* s, const void* w, const void* b,
                                    const void* u, const void* colors, const void* frozen,
                                    const void* clampv, const void* beta, void* out, int B,
                                    int H, int W, int C, void* stream) {
  const int HW = H * W;
  int cpb = HW >= 1024 ? 1 : 1024 / HW;
  if (cpb > B) cpb = B;
  const size_t smem = 2 * static_cast<size_t>(cpb) * HW;
  cudaError_t err = glauber::allow_smem(lattice_gibbs_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + cpb - 1) / cpb;
  lattice_gibbs_kernel<<<blocks, glauber::threads_for(static_cast<long long>(cpb) * HW), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(u),
      static_cast<const float*>(colors), static_cast<const float*>(frozen),
      static_cast<const float*>(clampv), static_cast<const float*>(beta),
      static_cast<float*>(out), B, H, W, C, cpb);
  return static_cast<int>(cudaGetLastError());
}
