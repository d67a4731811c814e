// ctmc_event: one Gillespie event of every chain of a dense Ising problem,
// the exact continuous-time Glauber dynamic of sampler_api.CTMC on the tree
// draw. Chain c (a block) with spins s_c, incremental fields h_c, energy e_c
// and model time t_c, at inverse temperature beta_c, given its Exp(1) draw
// expo_c and its uniform u_c:
//
//   leaf k  = lambda0 * sigma((2 * (beta_c * h_ck)) * s_ck)   (k < n; 0 up to m)
//   node j  = node 2j + node 2j+1, level by level up to the root (node 1)
//   i       = the inverse-CDF descent from target = u_c * root: at each
//             level go right where target >= the left child's sum, and
//             subtract it; i = min(leaf - m, n - 1)
//   alive   = root > RATE_FLOOR;  dt = expo_c / max(root, RATE_FLOOR)
//   delta   = alive ? -2 s_ci : 0
//   e_c    += delta * h_ci        (h_ci the field before the event)
//   h_ck   += J[i][k] * delta     (every k)
//   s_ci   += delta;   t_c += dt
//
// with m the next power of two >= n, and sigma(x) = 1 / (1 + exp(-x)) as
// torch.sigmoid computes it on the card. Every product, sum and quotient is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc
// contracts nothing into an FMA), in the order CTMC.update's tree path
// (event_tree.build, event_tree.descend, glauber.flip_prob, CTMC._scaled)
// takes them, so s, h, e and t are bit-equal to that path's. A pair sum a + b
// is the same float whichever child comes first, so the levels' order of
// work does not matter. The draws are operands: torch draws them from the
// run's generator, Exp(1) and then the uniform, as CTMC.draw does.
//
// It replaces no TPU kernel: the JAX package runs the CTMC in plain jnp. The
// plain torch event is about a hundred small launches (the rates, 11 pair-sum
// levels, 11 descent steps of four ops each, the row gather, the scatters):
// 209.7 us an event graphed at SK n = 2048 x 256 chains.
//
// Memory-bound: an event must read s and h, write h and read one J row a
// chain, 16 n B bytes (plus the chain's scalars): at (256, 2000) 8.2 MB,
// 2.45 us at 3.35 TB/s. Its arithmetic (an exp and a divide a site, m - 1
// adds) is a small share of that. Being functional (the state the caller
// passed stays as it was), it also writes s, 4 n B bytes more.
//
// Design: a block a chain, its tree in shared memory (2m floats: 16 KB at
// m = 2048), min(512, m / 4) threads. A thread forms the leaves of a quad of
// sites (16-byte loads of s and h where n % 4 == 0 and the rows are
// aligned) and their two levels above in registers; the block sums the
// levels of more than 32 nodes, a __syncthreads each (3 at m = 2048); warp 0
// sums the rest with __syncwarp and lane 0 descends (log2 m reads of shared
// memory). After one more __syncthreads every thread writes its sites of h
// and s from the J row, s and h read again (from the cache). The 16-byte
// route takes 9.12 us at (256, 2000) on an H100 against 9.50 us for the
// scalar one, which every n takes where n % 4 != 0; keeping a thread's quad
// of s and h in registers since the leaves saved 0.06 us, and is not done.
// The tree of m leaves must fit a block's shared memory: m <= 16384
// (128 KB) on sm_90 (the wrapper checks).
//
// s, h: (B, n) f32; e, t, beta, expo, u: (B,) f32; J: (n, n) f32; the four
// outputs as their inputs, distinct from them.
#include <cuda_runtime.h>

#include <cstdint>

#include "glauber.cuh"

namespace {

constexpr float kRateFloor = 1e-30f;  // sampler_api.RATE_FLOOR, as float32
constexpr int kMaxThreads = 512;

// lambda0 * sigma((2 * (beta * h)) * s): glauber.flip_prob of the scaled
// field, then CTMC._scaled (lambda0 * p; x * 1.0f is x).
__device__ __forceinline__ float flip_rate(float beta, float h, float s, float lambda0) {
  const float z = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(beta, h)), s);
  return __fmul_rn(lambda0, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
}

__global__ void __launch_bounds__(kMaxThreads)
ctmc_event_kernel(const float* __restrict__ s, const float* __restrict__ h,
                  const float* __restrict__ e, const float* __restrict__ t,
                  const float* __restrict__ J, const float* __restrict__ beta,
                  const float* __restrict__ expo, const float* __restrict__ u,
                  float* __restrict__ s_out, float* __restrict__ h_out,
                  float* __restrict__ e_out, float* __restrict__ t_out, int n, int m,
                  int vec, float lambda0) {
  extern __shared__ __align__(16) float tree[];  // [2m]: tree[1] the root, tree[m + k] leaf k
  __shared__ int pick;
  __shared__ float pick_delta;
  const int T = blockDim.x, tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const float* sr = s + row;
  const float* hr = h + row;
  const float b = beta[blockIdx.x];

  // leaves, and the two levels above them, a quad of sites a thread
  const int quads = m >= 4 ? m / 4 : 0;
  for (int q = tid; q < quads; q += T) {
    const int k0 = 4 * q;
    float sv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (vec && k0 < n) {
      const float4 s4 = reinterpret_cast<const float4*>(sr)[q];
      const float4 h4 = reinterpret_cast<const float4*>(hr)[q];
      sv[0] = s4.x, sv[1] = s4.y, sv[2] = s4.z, sv[3] = s4.w;
      hv[0] = h4.x, hv[1] = h4.y, hv[2] = h4.z, hv[3] = h4.w;
    } else if (!vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + j < n) sv[j] = sr[k0 + j], hv[j] = hr[k0 + j];
    }
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = k0 + j < n ? flip_rate(b, hv[j], sv[j], lambda0) : 0.0f;
    *reinterpret_cast<float4*>(tree + m + k0) = make_float4(r[0], r[1], r[2], r[3]);
    const float left = __fadd_rn(r[0], r[1]), right = __fadd_rn(r[2], r[3]);
    tree[m / 2 + 2 * q] = left;
    tree[m / 2 + 2 * q + 1] = right;
    tree[m / 4 + q] = __fadd_rn(left, right);
  }
  if (m < 4 && tid == 0) {  // one or two leaves
    for (int k = 0; k < m; ++k) tree[m + k] = k < n ? flip_rate(b, hr[k], sr[k], lambda0) : 0.0f;
    if (m == 2) tree[1] = __fadd_rn(tree[2], tree[3]);
  }
  __syncthreads();

  // the levels of more than 32 nodes: the block, a level at a time
  int width = m / 8;
  for (; width > 32; width >>= 1) {
    for (int j = tid; j < width; j += T)
      tree[width + j] = __fadd_rn(tree[2 * (width + j)], tree[2 * (width + j) + 1]);
    __syncthreads();
  }
  if (tid < 32) {
    // the rest: warp 0
    for (; width >= 1; width >>= 1) {
      if (tid < width) tree[width + tid] = __fadd_rn(tree[2 * (width + tid)],
                                                     tree[2 * (width + tid) + 1]);
      __syncwarp();
    }
    if (tid == 0) {  // the descent and the chain's scalars
      const int c = blockIdx.x;
      const float root = tree[1];
      float target = __fmul_rn(u[c], root);
      int idx = 1;
      for (int level = m; level > 1; level >>= 1) {
        idx *= 2;
        const float left = tree[idx];
        const bool go_right = target >= left;
        const float rest = __fsub_rn(target, left);
        target = go_right ? rest : target;
        idx += go_right;
      }
      const int i = idx - m < n - 1 ? idx - m : n - 1;
      const bool alive = root > kRateFloor;
      const float dt = __fdiv_rn(expo[c], fmaxf(root, kRateFloor));
      const float delta = alive ? __fmul_rn(-2.0f, sr[i]) : 0.0f;
      e_out[c] = __fadd_rn(e[c], __fmul_rn(delta, hr[i]));
      t_out[c] = __fadd_rn(t[c], dt);
      pick = i;
      pick_delta = delta;
    }
  }
  __syncthreads();

  // the fields from J's row i, and s at site i
  const int i = pick;
  const float delta = pick_delta;
  const float* Ji = J + static_cast<size_t>(i) * n;
  if (vec) {
    const int n4 = n / 4;
    for (int q = tid; q < n4; q += T) {
      const float4 s4 = reinterpret_cast<const float4*>(sr)[q];
      const float4 h4 = reinterpret_cast<const float4*>(hr)[q];
      const float4 j4 = __ldg(reinterpret_cast<const float4*>(Ji) + q);
      const float4 hn = make_float4(
          __fadd_rn(h4.x, __fmul_rn(j4.x, delta)), __fadd_rn(h4.y, __fmul_rn(j4.y, delta)),
          __fadd_rn(h4.z, __fmul_rn(j4.z, delta)), __fadd_rn(h4.w, __fmul_rn(j4.w, delta)));
      float sn[4] = {s4.x, s4.y, s4.z, s4.w};
      const int at = i - 4 * q;
      if (at >= 0 && at < 4) sn[at] = __fadd_rn(sn[at], delta);
      reinterpret_cast<float4*>(h_out + row)[q] = hn;
      reinterpret_cast<float4*>(s_out + row)[q] = make_float4(sn[0], sn[1], sn[2], sn[3]);
    }
  } else {
    for (int k = tid; k < n; k += T) {
      h_out[row + k] = __fadd_rn(hr[k], __fmul_rn(__ldg(Ji + k), delta));
      const float sk = sr[k];
      s_out[row + k] = k == i ? __fadd_rn(sk, delta) : sk;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One event of each of the B chains (B >= 1, 1 <= n <= m, m the next power
// of two >= n, 8 m bytes of shared memory within the device's limit).
// Returns cudaGetLastError() after the launch (or the attribute call's
// error); 1 (cudaErrorInvalidValue) for an m that is not n's.
extern "C" int ctmc_event_launch(const void* s, const void* h, const void* e, const void* t,
                                 const void* J, const void* beta, const void* expo,
                                 const void* u, void* s_out, void* h_out, void* e_out,
                                 void* t_out, int B, int n, int m, float lambda0,
                                 void* stream) {
  if (n < 1 || m < n || (m & (m - 1)) != 0 || (m > 1 && m / 2 >= n))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && aligned16(s) && aligned16(h) && aligned16(J) &&
                   aligned16(s_out) && aligned16(h_out);
  const int quads = m / 4;
  const int threads = glauber::threads_for(quads < kMaxThreads ? quads : kMaxThreads);
  const size_t smem = static_cast<size_t>(2) * m * sizeof(float);
  cudaError_t err = glauber::allow_smem(ctmc_event_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctmc_event_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(h), static_cast<const float*>(e),
      static_cast<const float*>(t), static_cast<const float*>(J),
      static_cast<const float*>(beta), static_cast<const float*>(expo),
      static_cast<const float*>(u), static_cast<float*>(s_out), static_cast<float*>(h_out),
      static_cast<float*>(e_out), static_cast<float*>(t_out), n, m, vec ? 1 : 0, lambda0);
  return static_cast<int>(cudaGetLastError());
}
