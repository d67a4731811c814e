// lattice_energy: the energy of each chain of s on the king's-move lattice,
//   E_r = 0.5 * sum_p s_rp ns_rp + sum_p b_p s_rp,
//   ns_rp = ((0 + w[0][p] s_r[p+o0]) + w[1][p] s_r[p+o1]) + ... + w[7][p] s_r[p+o7]
// with the offsets o_k in KING_OFFSETS order and s = 0 beyond the edge, each
// product and each add rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction), as LatticeIsing.neighbor_sum forms it. A neighbour beyond
// the edge adds w * 0 = +-0 there to a sum that is never -0, which leaves it
// as it is; the quad route adds 0 * s instead (the weight masked to 0, the
// neighbour a zero halo or a site of another row), the same on finite
// values. So on finite values every ns_rp, s_rp ns_rp and b_p s_rp is
// bit-equal to LatticeIsing.energy's. The pair sum is halved and the bias
// sum added last, as there. The sums over the sites run in a fixed order (a
// thread's sites in turn, then a shuffle tree, and on the block route the
// warps in turn): no atomics, so the same input gives the same bits in every
// launch and every graph replay. On +-1 states with integer couplings and
// bias every partial sum is an integer below 2^24, and any order gives
// LatticeIsing.energy's number exactly (CAL: +-1 couplings, b = 0).
//
// It replaces no TPU kernel: the JAX LatticeIsing.energy is plain jnp. It
// was added for run()'s first-hit check, which takes the energy of every
// chain after every sweep (about 35 plain torch launches, ~120 us a sweep
// at (4096, 16, 16), against the sweep kernel's ~9 us), and for the start
// state's and the recorded samples' energies.
//
// Memory-bound: it must read s once, 4 R H W bytes, the planes and b once,
// 36 H W, and write 4 R: at (4096, 16, 16) 4.2 MB, 1.25 us at 3.35 TB/s;
// at the samples' (40960, 16, 16) 42 MB, 12.5 us. Its 20 f32 operations a
// site take a small share of that; what a design must spare is the shared
// memory pipe (loads, stores and shuffles: one warp instruction an SM a
// cycle), which held a design that read each neighbour from shared memory
// at twice its bytes' time.
//
// s: (R, H, W) f32 (any finite values), w: (8, H, W) f32, b: (H, W) f32,
// out: (R,) f32. Two kernels, the route passed by the wrapper
// (kernels/lattice_gibbs.py::energy_route):
//
//   lattice_energy_quads (rows of W = 4, 8, ..., 128 sites, n <= 256, s
//     16-byte aligned): a site quad is 4 consecutive sites of a row, and
//     lane l of a warp holds quads l and l + 32 (past n on a lattice of at
//     most 128 sites, where it adds +0 to each sum). A row holds W / 4 quads, a divisor of 32, so a quad's left and
//     right quads in its row are the neighbour lanes'. A block's warps copy
//     the planes (0 beyond the edge) and b into shared memory once; each
//     lane then loads its quads' 8 weights and bias from there, a 16-byte
//     word a plane, and keeps them in registers for every chain it sums. The
//     grid holds one block an SM, of as many warps as give each about
//     kWarpChains chains (16 at most: 8 at 4096 chains, 16 at 40960), and
//     warp i takes chains i, i + all warps, ..., a chain at a time: it loads
//     the next chain into registers (a 16-byte load a quad) before it sums
//     the current one. The warp stores its chain in its slice of shared
//     memory, 256 slots (0 past n) between zero rows above and below; a
//     quad reads the rows above and below as one 16-byte load each and takes
//     the sites left and right of the three rows from the neighbour lanes by
//     six shuffles: 14 pipe cycles a quad where reading each neighbour takes
//     32. The lane's pair and bias sums take a __shfl_xor tree.
//   lattice_energy_block (every other lattice): a block of min(1024, n
//     rounded up to a warp) threads a chain, thread t adding sites t, t + T,
//     ... in turn, each reading its neighbours, weights and bias through the
//     read-only cache; each warp's tree, then the warps in turn.
#include <cstdint>

namespace {

constexpr int kWarps = 16;       // warps of a quad-route block at most, one block an SM
constexpr int kWarpChains = 4;   // chains a quad-route warp sums, where there are enough
constexpr int kQuadGroups = 2;   // a lane's quads: the quad route's n <= 256
constexpr int kMaxWarps = 32;    // warps of a block of 1024 threads
constexpr unsigned kAll = 0xffffffffu;

// KING_OFFSETS: (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1)
__host__ __device__ constexpr int king_dy(int k) { return k < 3 ? -1 : (k < 5 ? 0 : 1); }
__host__ __device__ constexpr int king_dx(int k) {
  return k < 3 ? k - 1 : (k == 3 ? -1 : (k == 4 ? 1 : k - 6));
}

__device__ __forceinline__ bool on_lattice(int y, int x, int k, int H, int W) {
  const int yy = y + king_dy(k), xx = x + king_dx(k);
  return yy >= 0 && yy < H && xx >= 0 && xx < W;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kAll, v, off));
  return v;  // every lane holds the sum, lane 0's the shuffle-down tree's (a + b = b + a)
}

// A quad-route warp's slice of shared memory: a zero row, its 128
// kQuadGroups site slots (0 past n), a zero row.
__host__ __device__ constexpr int warp_floats(int W) { return 128 * kQuadGroups + 2 * W; }

// Shared memory of a quad-route block of `warps` warps: the planes (0
// beyond the edge) and b, then each warp's slice.
__host__ __device__ constexpr size_t quads_smem_floats(int H, int W, int warps) {
  return static_cast<size_t>(9) * H * W + static_cast<size_t>(warps) * warp_floats(W);
}

// Lane `lane`'s quads of chain r (0 where r >= R or the quad is past n).
__device__ __forceinline__ void load_quads(float4 (&v)[kQuadGroups], const float* __restrict__ s,
                                           int r, int R, int n, int lane) {
  const float4* row = reinterpret_cast<const float4*>(s + static_cast<size_t>(r) * n);
#pragma unroll
  for (int g = 0; g < kQuadGroups; ++g) {
    const int q = lane + 32 * g;
    v[g] = r < R && 4 * q < n ? __ldg(row + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// A site past n adds nothing: its weights, bias and state are 0, so each of
// its terms is +-0, and a sum that is never -0 stays as it is (the
// emulation's zero padding).
__global__ void __launch_bounds__(kWarps * 32, 1)
lattice_energy_quads(const float* __restrict__ s, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out, int R, int H, int W) {
  extern __shared__ __align__(16) float smem[];  // [9][n] w and b; [warps][warp_floats(W)]
  const int n = H * W, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  int r = blockIdx.x * warps + warp;
  float4 cur[kQuadGroups];
  load_quads(cur, s, r, R, n, lane);  // in flight while the block stages the planes

  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      smem[k * n + p] = on_lattice(y, x, k, H, W) ? __ldg(w + k * n + p) : 0.0f;
    smem[8 * n + p] = __ldg(b + p);
  }
  float* ch = smem + 9 * n + warp * warp_floats(W) + W;
  for (int q = lane; q < W; q += 32) ch[q - W] = ch[128 * kQuadGroups + q] = 0.0f;
  __syncthreads();

  // a quad's weights of plane k, and its b, are one 16-byte word each
  const auto word = [&](int k, int p0) {
    return p0 < n ? *reinterpret_cast<const float4*>(smem + k * n + p0)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  float wk[kQuadGroups][4][8], bias[kQuadGroups][4];
#pragma unroll
  for (int g = 0; g < kQuadGroups; ++g) {
    const int p0 = 4 * (lane + 32 * g);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = word(k, p0);
      wk[g][0][k] = v.x;
      wk[g][1][k] = v.y;
      wk[g][2][k] = v.z;
      wk[g][3][k] = v.w;
    }
    const float4 v = word(8, p0);
    bias[g][0] = v.x;
    bias[g][1] = v.y;
    bias[g][2] = v.z;
    bias[g][3] = v.w;
  }

  for (; r < R; r += stride) {
    float4 next[kQuadGroups];
    load_quads(next, s, r + stride, R, n, lane);
#pragma unroll
    for (int g = 0; g < kQuadGroups; ++g) reinterpret_cast<float4*>(ch)[lane + 32 * g] = cur[g];
    __syncwarp();
    float pair = 0.0f, field = 0.0f;
#pragma unroll
    for (int g = 0; g < kQuadGroups; ++g) {
      const int p0 = 4 * (lane + 32 * g);
      const float4 U = *reinterpret_cast<const float4*>(ch + p0 - W);
      const float4 C = cur[g];
      const float4 D = *reinterpret_cast<const float4*>(ch + p0 + W);
      // each row's sites x0 - 1 .. x0 + 4 (a lane's left and right sites are
      // beyond the edge where they are not its row's: their weights are 0)
      const float u[6] = {__shfl_up_sync(kAll, U.w, 1), U.x, U.y, U.z, U.w,
                          __shfl_down_sync(kAll, U.x, 1)};
      const float c[6] = {__shfl_up_sync(kAll, C.w, 1), C.x, C.y, C.z, C.w,
                          __shfl_down_sync(kAll, C.x, 1)};
      const float d[6] = {__shfl_up_sync(kAll, D.w, 1), D.x, D.y, D.z, D.w,
                          __shfl_down_sync(kAll, D.x, 1)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float nb[8] = {u[i], u[i + 1], u[i + 2], c[i], c[i + 2], d[i], d[i + 1], d[i + 2]};
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(wk[g][i][k], nb[k]));
        pair = __fadd_rn(pair, __fmul_rn(c[i + 1], acc));
        field = __fadd_rn(field, __fmul_rn(bias[g][i], c[i + 1]));
      }
    }
    pair = warp_sum(pair);
    field = warp_sum(field);
    if (lane == 0) out[r] = __fadd_rn(__fmul_rn(0.5f, pair), field);
    __syncwarp();  // every lane has read the chain before the next one overwrites it
#pragma unroll
    for (int g = 0; g < kQuadGroups; ++g) cur[g] = next[g];
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
lattice_energy_block(const float* __restrict__ s, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out, int H, int W) {
  __shared__ float red[kMaxWarps * 2];
  const int n = H * W, T = blockDim.x, t = threadIdx.x;
  const float* row = s + static_cast<size_t>(blockIdx.x) * n;
  float pair = 0.0f, field = 0.0f;
  for (int p = t; p < n; p += T) {
    const int y = p / W, x = p - y * W;
    const float sp = __ldg(row + p);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float nb = on_lattice(y, x, k, H, W) ? __ldg(row + p + king_dy(k) * W + king_dx(k))
                                                 : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + static_cast<size_t>(k) * n + p), nb));
    }
    pair = __fadd_rn(pair, __fmul_rn(sp, acc));
    field = __fadd_rn(field, __fmul_rn(__ldg(b + p), sp));
  }
  pair = warp_sum(pair);
  field = warp_sum(field);
  const int warp = t >> 5;
  if ((t & 31) == 0) {
    red[2 * warp] = pair;
    red[2 * warp + 1] = field;
  }
  __syncthreads();
  if (t == 0) {
    float P = 0.0f, F = 0.0f;
    for (int q = 0; q < T >> 5; ++q) {
      P = __fadd_rn(P, red[2 * q]);
      F = __fadd_rn(F, red[2 * q + 1]);
    }
    out[blockIdx.x] = __fadd_rn(__fmul_rn(0.5f, P), F);
  }
}

// One block an SM (fewer for few chains) of as many warps as give each warp
// kWarpChains chains, at most kWarps: every warp copies the 9 KB of planes
// into its registers once, which a warp that sums few chains never repays.
cudaError_t launch_quads(const float* s, const float* w, const float* b, float* out, int R,
                         int H, int W, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int per_sm = (R + sms * kWarpChains - 1) / (sms * kWarpChains);
  const int warps = per_sm < 1 ? 1 : (per_sm > kWarps ? kWarps : per_sm);
  const int blocks = (R + warps - 1) / warps;
  const size_t smem = quads_smem_floats(H, W, warps) * 4;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(lattice_energy_quads,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lattice_energy_quads<<<blocks < sms ? blocks : sms, warps * 32, smem, stream>>>(s, w, b, out, R,
                                                                                  H, W);
  return cudaGetLastError();
}

}  // namespace

// The energies of the R chains of s (R >= 1, H W >= 1). quads != 0: the quad
// route, which the caller has checked takes the lattice (W a power of 2
// from 4 to 128, H W <= 256, s 16-byte aligned); else the block route.
// Returns cudaGetLastError() after the launch (or a device query's error);
// 1 (cudaErrorInvalidValue) for the quad route on a lattice it does not take.
extern "C" int lattice_energy_launch(const void* s_, const void* w_, const void* b_, void* out_,
                                     int R, int H, int W, int quads, void* stream_) {
  const auto* s = static_cast<const float*>(s_);
  const auto* w = static_cast<const float*>(w_);
  const auto* b = static_cast<const float*>(b_);
  auto* out = static_cast<float*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const int n = H * W;
  if (quads) {
    const bool width = W >= 4 && W <= 128 && (W & (W - 1)) == 0;
    if (!width || n > 128 * kQuadGroups || (reinterpret_cast<uintptr_t>(s_) & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_quads(s, w, b, out, R, H, W, stream));
  }
  const int threads = n >= kMaxWarps * 32 ? kMaxWarps * 32 : (n + 31) / 32 * 32;
  lattice_energy_block<<<R, threads, 0, stream>>>(s, w, b, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
