// Shared int8 field mainloop for the dense kernels (sm_90a).
//
// acc[r][i] = sum_k s[r][k] * J[i][k], int8 operands, exact int32 sums.
//
// Both operands are read row-major as they lie in memory: a row of s (one
// chain) and a row of J (one output site) are each contiguous along k, a
// "TN" product, which is what the int8 tensor-core MMA takes. J is NOT
// assumed symmetric: output site i reads row i of J.
//
// A block owns a BM x BN tile of outputs (chains x sites) and walks k in
// BK-wide shared-memory tiles. Four warps split the tile 2 x 2; each warp
// issues mma.sync.m16n8k32 (s8 x s8 -> s32) over its 32 x 32 sub-tile.
// Ragged B, N and k edges are masked by zero-filling shared memory, so no
// operand is padded in device memory (N = 5 and k % 4 != 0 included).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace int8_field {

constexpr int BM = 64;        // chains (rows of s) per block
constexpr int BN = 64;        // output sites (rows of J) per block
constexpr int BK = 64;        // k per shared-memory tile
constexpr int LDS = BK + 16;  // smem row stride in bytes: 20 words, so the
                              // 8 rows x 4 words of a fragment read hit 32
                              // distinct banks
constexpr int THREADS = 128;  // 4 warps, 2 x 2, each a 32 x 32 sub-tile

// Per-thread accumulators: [m16 tile][n8 tile][fragment register].
struct Acc {
  int c[2][4][4];
};

__device__ __forceinline__ int8_t to_i8(int8_t v) { return v; }
// float spins (+-1) convert as JAX's astype(int8): truncation toward zero.
__device__ __forceinline__ int8_t to_i8(float v) {
  return static_cast<int8_t>(__float2int_rz(v));
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         (static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24);
}

// Element-wise tile load: any K, any alignment. Rows >= nrows and columns
// >= K are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile_scalar(int8_t* smem, const T* g, int nrows,
                                                 int K, int row0, int k0) {
  for (int idx = threadIdx.x; idx < 64 * BK; idx += THREADS) {
    const int r = idx / BK, c = idx % BK;
    const int gr = row0 + r, gc = k0 + c;
    int8_t v = 0;
    if (gr < nrows && gc < K) v = to_i8(g[static_cast<size_t>(gr) * K + gc]);
    smem[r * LDS + c] = v;
  }
}

// Vector tile loads: int8 rows in 16-byte chunks (needs K % 16 == 0 and a
// 16-byte aligned base), float rows in float4 chunks packed to one int8
// word (needs K % 4 == 0 and a 16-byte aligned base). A chunk lies either
// wholly inside or wholly outside the K edge.
__device__ __forceinline__ void load_tile_vec(int8_t* smem, const int8_t* g, int nrows,
                                              int K, int row0, int k0) {
  constexpr int CHUNKS = BK / 16;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 16;
    const int gr = row0 + r, gc = k0 + c;
    int4 v = make_int4(0, 0, 0, 0);
    if (gr < nrows && gc < K)
      v = *reinterpret_cast<const int4*>(g + static_cast<size_t>(gr) * K + gc);
    *reinterpret_cast<int4*>(smem + r * LDS + c) = v;
  }
}

__device__ __forceinline__ void load_tile_vec(int8_t* smem, const float* g, int nrows,
                                              int K, int row0, int k0) {
  constexpr int CHUNKS = BK / 4;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 4;
    const int gr = row0 + r, gc = k0 + c;
    uint32_t w = 0;
    if (gr < nrows && gc < K) {
      const float4 v = *reinterpret_cast<const float4*>(g + static_cast<size_t>(gr) * K + gc);
      w = pack4(to_i8(v.x), to_i8(v.y), to_i8(v.z), to_i8(v.w));
    }
    *reinterpret_cast<uint32_t*>(smem + r * LDS + c) = w;
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The mainloop: s is (B, K) of T (int8 or float +-1), J is (N, K) int8.
// The block's output tile starts at chain row0 and site col0. vec_s/vec_j
// select the vector loads (decided on the host, uniform over the grid).
template <typename T>
__device__ __forceinline__ void mainloop(Acc& acc, const T* __restrict__ s,
                                         const int8_t* __restrict__ J, int B, int N, int K,
                                         int row0, int col0, bool vec_s, bool vec_j) {
  __shared__ __align__(16) int8_t sA[BM * LDS];
  __shared__ __align__(16) int8_t sB[BN * LDS];

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc.c[mi][ni][q] = 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane >> 2, t = lane & 3;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec_s) load_tile_vec(sA, s, B, K, row0, k0);
    else load_tile_scalar(sA, s, B, K, row0, k0);
    if (vec_j) load_tile_vec(sB, J, N, K, col0, k0);
    else load_tile_scalar(sB, J, N, K, col0, k0);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      // A fragment (16 x 32, row-major): a0/a2 row g, a1/a3 row g+8; a0/a1
      // hold k = t*4..t*4+3, a2/a3 hold k = 16+t*4..16+t*4+3.
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = sA + (wm + mi * 16 + g) * LDS + ks + t * 4;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * LDS);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * LDS + 16);
      }
      // B fragment (32 x 8, column n = g): b0 holds k = t*4.., b1 k = 16+t*4..
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = sB + (wn + ni * 8 + g) * LDS + ks + t * 4;
        const uint32_t b0 = lds32(p), b1 = lds32(p + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_s8(acc.c[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);
      }
    }
    __syncthreads();
  }
}

// Calls f(row, col, acc) for every in-range output this thread holds.
// Accumulator fragment: c0/c1 row g, cols t*2, t*2+1; c2/c3 row g+8.
template <typename F>
__device__ __forceinline__ void for_each_output(const Acc& acc, int B, int N, int row0,
                                                int col0, F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = row0 + wm + mi * 16 + g + (q >> 1) * 8;
        const int c = col0 + wn + ni * 8 + t * 2 + (q & 1);
        if (r < B && c < N) f(r, c, acc.c[mi][ni][q]);
      }
}

inline dim3 grid_for(int B, int N) { return dim3((N + BN - 1) / BN, (B + BM - 1) / BM); }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace int8_field
