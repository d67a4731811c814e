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
// s: (B, H, W) +-1, w: (8, H, W), b: (H, W), u: (C, B, H, W),
// colors: (C, H, W) {0,1}, frozen and clamp: (H, W), out: (B, H, W) (never
// aliasing s), all f32 or all bf16; beta: (B,) f32.
//
// In bf16 every add and multiply of the stencil rounds to bf16, as torch
// and XLA compute a bf16 op (in f32, then rounded to nearest even):
//   acc = bf16(acc + bf16(w[k][p] s[p+ok])),  h = bf16(acc + b[p]);
// h is then promoted to f32 for sigma(-2 * (beta_r * h)), and the bf16
// uniform is compared with that f32 p_up.
//
// Design: a block holds `cpb` whole chains (one chain when H*W > 1024) in
// shared memory as int8 +-1, in two buffers: each phase reads one and
// writes every site of the other (the proposal or the old spin), then one
// barrier, then the buffers swap. So every field of a phase sees the state
// before the phase for any masks, as in JAX, also for an improper colouring.
// w, b and the masks are read through the read-only cache (8 KB of weights
// at 16x16, L2-resident across blocks).
#include <cuda_bf16.h>

#include "glauber.cuh"

namespace {

__constant__ int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(1024)
lattice_gibbs_kernel(const T* __restrict__ s, const T* __restrict__ w,
                     const T* __restrict__ b, const T* __restrict__ u,
                     const T* __restrict__ colors, const T* __restrict__ frozen,
                     const T* __restrict__ clampv, const float* __restrict__ beta,
                     T* __restrict__ out, int B, int H, int W, int C, int cpb) {
  extern __shared__ int8_t smem[];
  const int HW = H * W;
  const int r0 = blockIdx.x * cpb;
  const int sites = min(cpb, B - r0) * HW;
  int8_t* cur = smem;
  int8_t* nxt = smem + static_cast<size_t>(cpb) * HW;
  const size_t base = static_cast<size_t>(r0) * HW;

  for (int i = threadIdx.x; i < sites; i += blockDim.x)
    cur[i] = to_f32(s[base + i]) > 0.0f ? 1 : -1;
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const T* col = colors + static_cast<size_t>(c) * HW;
    const T* uc = u + static_cast<size_t>(c) * B * HW + base;
    for (int i = threadIdx.x; i < sites; i += blockDim.x) {
      const int r = i / HW, p = i - r * HW;
      int8_t v = cur[i];
      if (to_f32(__ldg(col + p)) > 0.5f && to_f32(__ldg(frozen + p)) <= 0.5f) {
        const int y = p / W, x = p - y * W;
        const int8_t* chain = cur + static_cast<size_t>(r) * HW;
        T acc = round_to<T>(0.0f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int yy = y + kDy[k], xx = x + kDx[k];
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const T ws = round_to<T>(__fmul_rn(to_f32(__ldg(w + static_cast<size_t>(k) * HW + p)),
                                               static_cast<float>(chain[yy * W + xx])));
            acc = round_to<T>(__fadd_rn(to_f32(acc), to_f32(ws)));
          }
        }
        const T h = round_to<T>(__fadd_rn(to_f32(acc), to_f32(__ldg(b + p))));
        v = to_f32(uc[i]) < glauber::prob_up(beta[r0 + r], to_f32(h)) ? 1 : -1;
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
    out[base + i] = to_f32(__ldg(frozen + p)) > 0.5f ? __ldg(clampv + p)
                                                     : round_to<T>(static_cast<float>(cur[i]));
  }
}

template <typename T>
cudaError_t launch(const void* s, const void* w, const void* b, const void* u,
                   const void* colors, const void* frozen, const void* clampv, const void* beta,
                   void* out, int B, int H, int W, int C, cudaStream_t stream) {
  const int HW = H * W;
  int cpb = HW >= 1024 ? 1 : 1024 / HW;
  if (cpb > B) cpb = B;
  const size_t smem = 2 * static_cast<size_t>(cpb) * HW;
  cudaError_t err = glauber::allow_smem(lattice_gibbs_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + cpb - 1) / cpb;
  lattice_gibbs_kernel<T><<<blocks, glauber::threads_for(static_cast<long long>(cpb) * HW), smem,
                            stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(u), static_cast<const T*>(colors), static_cast<const T*>(frozen),
      static_cast<const T*>(clampv), static_cast<const float*>(beta), static_cast<T*>(out), B, H,
      W, C, cpb);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the attribute call's
// error). bf16 != 0: the seven operands and out are bf16, else f32. The
// caller has checked that 2 * H * W bytes fit in one block.
extern "C" int lattice_gibbs_launch(const void* s, const void* w, const void* b,
                                    const void* u, const void* colors, const void* frozen,
                                    const void* clampv, const void* beta, void* out, int B,
                                    int H, int W, int C, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(s, w, b, u, colors, frozen, clampv, beta, out, B, H, W, C, st)
           : launch<float>(s, w, b, u, colors, frozen, clampv, beta, out, B, H, W, C, st);
  return static_cast<int>(err);
}
