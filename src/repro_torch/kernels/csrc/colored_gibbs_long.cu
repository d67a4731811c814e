// colored_gibbs_long: the chromatic Gibbs sweep of colored_gibbs.cu for rows
// too long to hold in one block's shared memory (two int8 copies of a chain,
// 2n bytes, exceed 232,448 bytes: n > 116,224 sites). It replaces the same
// TPU kernel, repro/kernels/sparse_gather.py::colored_gibbs_sweep, and gives
// the same results bit for bit: for each colour c in order, at every site i
// of the colour's list, from the state before the phase,
//   h_i  = the in-order slot sum of sparse_gather.cuh
//   s[i] = u[c][r][i] < sigma(-2 * (beta_r * h_i)) ? +1 : -1.
// It draws nothing itself: the (C, B, n) uniforms are an operand.
//
// It takes a colour plan (sparse_gather.colour_plan) whose classes are
// independent sets: each site in at most one class, no neighbour slot of a
// site in the site's own class (the plan's `independent`, checked once when
// the plan is built; the wrapper refuses any other). Then a phase reads only
// sites it does not write, and each site's spins are written by the thread
// that reads its neighbours, so a phase updates the state in place and still
// sees the state before it.
//
// Memory-bound. At (B, n) = (64, 512000), D = 6, C = 2 (the 3D EA lattice
// at L = 80 under its two parity classes) the work its inputs need is
// 4 (3 B n + 2 n D + n + C n + B) = 423.9 MB, 126.5 us at 3.35 TB/s; its
// 0.59 GFLOP of f32 arithmetic take 8.8 us. With parity classes every
// 32-byte sector of a phase's uniform plane holds a site of the phase, so a
// kernel that reads the uniforms in that layout moves about 555 MB, 165.7 us.
//
// Design: the chains' state lives in an int8 scratch in device memory, site
// major: st[i][r], row i holding site i of every chain, Bp = B rounded up to
// 16 bytes (32.8 MB at that size, within the 50 MB L2; the f32 state is
// 131 MB and a plan of 0.5M entries 32 MB, so neither fits a block). A
// sweep is C + 2 launches on the caller's stream, so the phases are ordered
// by the stream and a CUDA graph captures the sweep with no host sync:
//   pack      st = sign(s), transposed through shared memory a tile of
//             64 sites x 64 chains at a time: s read and st written in
//             whole rows of the tile;
//   phase c   one thread per entry of colour c's list and chunk of 16
//             chains, the chunks of one entry in neighbouring lanes: it
//             loads its plan row (two 16-byte loads of indices and two of
//             weights at D <= 7; the lanes of an entry share them), its 16
//             uniforms (evict-first loads, so the streamed planes do not push
//             st out of L2), then each neighbour's 16 chains in one 16-byte
//             load of st, and writes the site's 16 new spins in one store;
//   unpack    out = float(st), transposed back the same way, out written
//             in whole rows of the tile with evict-first stores.
#include "glauber.cuh"

namespace {

constexpr int kTile = 64;           // sites and chains of a pack or unpack tile
constexpr int kThreads = 256;       // threads of a pack or unpack block: 4 a tile row
constexpr int kPhaseThreads = 256;  // threads of a phase block
constexpr int kChunk = 16;          // chains a phase thread updates: one 16-byte word of st
constexpr int kMaxBlocks = 1 << 30;

__device__ __forceinline__ int8_t spin(float v) { return v > 0.0f ? 1 : -1; }

// Byte q of a 16-byte word as a spin value.
__device__ __forceinline__ float byte_of(const int4& v, int q) {
  const int w = q < 4 ? v.x : q < 8 ? v.y : q < 12 ? v.z : v.w;
  return static_cast<float>(static_cast<int8_t>(w >> (8 * (q & 3))));
}

// st[i][r] = sign(s[r][i]) for the tile of sites blockIdx.x * kTile and
// chains blockIdx.y * kTile; chains B .. Bp - 1 (padding) get +1. `vec`
// when s rows are whole 16-byte groups.
__global__ void __launch_bounds__(kThreads)
colored_gibbs_long_pack(const float* __restrict__ s, int8_t* __restrict__ st, int B, int Bp,
                        int n, bool vec) {
  __shared__ __align__(16) int8_t tile[kTile][kTile + 16];  // [site][chain]
  const int t = threadIdx.x, i0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int row = t >> 2, part = t & 3;  // a chain (or site) and its quarter of the tile
  {
    const int r = c0 + row, i = i0 + 16 * part;
    if (r < B && vec && i + 16 <= n) {
      const float4* src = reinterpret_cast<const float4*>(s + static_cast<size_t>(r) * n + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldcs(src + q);
        tile[16 * part + 4 * q][row] = spin(v.x);
        tile[16 * part + 4 * q + 1][row] = spin(v.y);
        tile[16 * part + 4 * q + 2][row] = spin(v.z);
        tile[16 * part + 4 * q + 3][row] = spin(v.w);
      }
    } else {
      for (int q = 0; q < 16; ++q)
        tile[16 * part + q][row] =
            r < B && i + q < n ? spin(__ldcs(s + static_cast<size_t>(r) * n + i + q)) : 1;
    }
  }
  __syncthreads();
  const int i = i0 + row, c = c0 + 16 * part;
  if (i < n && c < Bp)
    *reinterpret_cast<int4*>(st + static_cast<size_t>(i) * Bp + c) =
        *reinterpret_cast<const int4*>(&tile[row][16 * part]);
}

// out[r][i] = st[i][r] for r < B, tile by tile as in pack; the lanes of a
// warp store neighbouring 16-byte groups of a row of out, so every store
// instruction writes whole sectors.
__global__ void __launch_bounds__(kThreads)
colored_gibbs_long_unpack(const int8_t* __restrict__ st, float* __restrict__ out, int B, int Bp,
                          int n, bool vec) {
  __shared__ __align__(16) int8_t tile[kTile][kTile + 16];  // [site][chain]
  const int t = threadIdx.x, i0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  {
    const int row = t >> 2, part = t & 3;
    const int i = i0 + row, c = c0 + 16 * part;
    if (i < n && c < Bp)
      *reinterpret_cast<int4*>(&tile[row][16 * part]) =
          *reinterpret_cast<const int4*>(st + static_cast<size_t>(i) * Bp + c);
  }
  __syncthreads();
  constexpr int kGroups = kTile / 4;  // 16-byte groups of a tile row of out
#pragma unroll
  for (int q = 0; q < kTile * kGroups / kThreads; ++q) {
    const int f = t + q * kThreads, row = f / kGroups, g = f % kGroups;
    const int r = c0 + row, i = i0 + 4 * g;
    if (r >= B) continue;
    float* dst = out + static_cast<size_t>(r) * n + i;
    if (vec && i + 4 <= n) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(tile[4 * g][row], tile[4 * g + 1][row], tile[4 * g + 2][row],
                         tile[4 * g + 3][row]));
    } else {
      for (int k = 0; k < 4 && i + k < n; ++k)
        __stcs(dst + k, static_cast<float>(tile[4 * g + k][row]));
    }
  }
}

// A plan row: the D neighbour indices and couplings, the site and its bias
// last. kP columns (4 or 8) are held in registers; kP = 0 reads a row of
// any width P through the cache at each use.
template <int kP>
struct Row {
  int idx[kP];
  float w[kP];
  __device__ __forceinline__ Row(const int* tidx, const float* tw, long long j, int) {
#pragma unroll
    for (int q = 0; q < kP / 4; ++q) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(tidx) + j * (kP / 4) + q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(tw) + j * (kP / 4) + q);
      idx[4 * q] = a.x, idx[4 * q + 1] = a.y, idx[4 * q + 2] = a.z, idx[4 * q + 3] = a.w;
      w[4 * q] = b.x, w[4 * q + 1] = b.y, w[4 * q + 2] = b.z, w[4 * q + 3] = b.w;
    }
  }
  __device__ __forceinline__ int site() const { return idx[kP - 1]; }
  __device__ __forceinline__ float bias() const { return w[kP - 1]; }
  __device__ __forceinline__ int index(int k) const { return idx[k]; }
  __device__ __forceinline__ float weight(int k) const { return w[k]; }
};

template <>
struct Row<0> {
  const int* idx;
  const float* w;
  int P;
  __device__ __forceinline__ Row(const int* tidx, const float* tw, long long j, int P_)
      : idx(tidx + j * P_), w(tw + j * P_), P(P_) {}
  __device__ __forceinline__ int site() const { return __ldg(idx + P - 1); }
  __device__ __forceinline__ float bias() const { return __ldg(w + P - 1); }
  __device__ __forceinline__ int index(int k) const { return __ldg(idx + k); }
  __device__ __forceinline__ float weight(int k) const { return __ldg(w + k); }
};

// acc[q] += w * (spin q of site j's 16-byte word of this chunk), q < 16, in
// the slot order the caller walks, one rounded multiply and one rounded add
// as sparse_gather.cuh's add_slot; j outside [0, n) adds nothing.
__device__ __forceinline__ void add_slot16(float (&acc)[kChunk], const int8_t* st, int Bp,
                                           int chunk, int j, float w, int n) {
  if (static_cast<unsigned>(j) >= static_cast<unsigned>(n)) return;
  const int4 v = *reinterpret_cast<const int4*>(st + static_cast<size_t>(j) * Bp + chunk * kChunk);
#pragma unroll
  for (int q = 0; q < kChunk; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(w, byte_of(v, q)));
}

// Phase c: the `count` entries from `beg` of the plan, each with its Bp / 16
// chunks of chains, in place on st. Padding chains (B .. Bp - 1) are
// updated from chain B - 1's uniform and beta and never read back.
template <int kP>
__global__ void __launch_bounds__(kPhaseThreads)
colored_gibbs_long_phase(int8_t* st, const int* __restrict__ tidx, const float* __restrict__ tw,
                         int beg, int count, const float* __restrict__ uc,
                         const float* __restrict__ beta, int B, int Bp, int n, int D, int P) {
  const int chunks = Bp / kChunk;
  const long long items = static_cast<long long>(count) * chunks;
  const long long stride = static_cast<long long>(gridDim.x) * kPhaseThreads;
  for (long long item = static_cast<long long>(blockIdx.x) * kPhaseThreads + threadIdx.x;
       item < items; item += stride) {
    const int e = static_cast<int>(item / chunks), chunk = static_cast<int>(item % chunks);
    const Row<kP> row(tidx, tw, static_cast<long long>(beg) + e, P);
    const int site = row.site();
    float ur[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      ur[q] = __ldcs(uc + static_cast<size_t>(min(chunk * kChunk + q, B - 1)) * n + site);
    float acc[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) acc[q] = 0.0f;
    if constexpr (kP > 0) {
#pragma unroll
      for (int k = 0; k < kP - 1; ++k)
        if (k < D) add_slot16(acc, st, Bp, chunk, row.index(k), row.weight(k), n);
    } else {
      for (int k = 0; k < D; ++k) add_slot16(acc, st, Bp, chunk, row.index(k), row.weight(k), n);
    }
    const float bias = row.bias();
    unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const float br = __ldg(beta + min(chunk * kChunk + q, B - 1));
      const unsigned v = ur[q] < glauber::prob_up(br, __fadd_rn(acc[q], bias)) ? 0x01u : 0xffu;
      word[q >> 2] |= v << (8 * (q & 3));
    }
    *reinterpret_cast<uint4*>(st + static_cast<size_t>(site) * Bp + chunk * kChunk) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

template <int kP>
cudaError_t launch_phases(int8_t* st, const int* offsets, const int* tidx, const float* tw,
                          const float* u, const float* beta, int B, int Bp, int n, int D, int P,
                          int C, cudaStream_t stream) {
  for (int c = 0; c < C; ++c) {
    const int beg = offsets[c], count = offsets[c + 1] - offsets[c];
    if (count == 0) continue;
    const long long items = static_cast<long long>(count) * (Bp / kChunk);
    const long long want = (items + kPhaseThreads - 1) / kPhaseThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    colored_gibbs_long_phase<kP><<<blocks, kPhaseThreads, 0, stream>>>(
        st, tidx, tw, beg, count, u + static_cast<size_t>(c) * B * n, beta, B, Bp, n, D, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// One sweep: pack, the C phases, unpack, on `stream`. `offsets` is the
// plan's (C + 1) list offsets on the HOST (the plan's counts, summed);
// st an (n, Bp) int8 scratch, Bp = B rounded up to a multiple of 16,
// 16-byte aligned. Returns the first cudaGetLastError() that is not
// cudaSuccess. The caller has checked that the plan's classes are
// independent sets and that P % 4 == 0, P > D.
extern "C" int colored_gibbs_long_launch(const void* s_, void* st_, void* out_, const void* tidx_,
                                         const void* tw_, const void* u_, const void* beta_,
                                         const int* offsets, int B, int n, int D, int P, int C,
                                         void* stream_) {
  const auto* s = static_cast<const float*>(s_);
  auto* st = static_cast<int8_t*>(st_);
  auto* out = static_cast<float*>(out_);
  const auto* tidx = static_cast<const int*>(tidx_);
  const auto* tw = static_cast<const float*>(tw_);
  const auto* u = static_cast<const float*>(u_);
  const auto* beta = static_cast<const float*>(beta_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const int Bp = (B + kChunk - 1) / kChunk * kChunk;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const dim3 tiles((n + kTile - 1) / kTile, (Bp + kTile - 1) / kTile);
  colored_gibbs_long_pack<<<tiles, kThreads, 0, stream>>>(s, st, B, Bp, n, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = P == 8   ? launch_phases<8>(st, offsets, tidx, tw, u, beta, B, Bp, n, D, P, C, stream)
        : P == 4 ? launch_phases<4>(st, offsets, tidx, tw, u, beta, B, Bp, n, D, P, C, stream)
                 : launch_phases<0>(st, offsets, tidx, tw, u, beta, B, Bp, n, D, P, C, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  colored_gibbs_long_unpack<<<tiles, kThreads, 0, stream>>>(st, out, B, Bp, n, vec);
  return static_cast<int>(cudaGetLastError());
}
