// Shared int8 field mainloop for the dense kernels (sm_90a).
//
// acc[r][i] = sum_k s[r][k] * J[i][k], int8 operands, exact int32 sums.
//
// Both operands are read row-major as they lie in memory: a row of s (one
// chain) and a row of J (one output site) are each contiguous along k, a
// "TN" product, which is what the int8 tensor-core MMA takes. J is NOT
// assumed symmetric: output site i reads row i of J.
//
// Design, for a product of a few hundred chains against an N x N J (at
// B = 256, N = 2048 the work is 1 us of int8 tensor-core time against 3 us
// of device-memory traffic, so what counts is keeping loads in flight and
// the bytes each block pulls from L2 few):
//  - A block owns a BM x BN = 64 x 64 tile of outputs (chains x sites) and
//    one half of k: the two halves are the two blocks of a thread-block
//    cluster (split-K), so (256, 2048) launches 256 blocks on 132 SMs,
//    and each reads 64 rows of s and 64 of J over K / 2.
//  - It walks its k range in BK = 128 byte tiles through a ring of
//    STAGES = 4 shared-memory stages filled with cp.async (16 bytes a copy,
//    cp.async.wait_group): while the MMAs run on one tile, the next three
//    are in flight. Rows past B or N and k past K are zero-filled by the
//    copy (a source size of 0), so no operand is padded in device memory.
//  - Eight warps, 2 x 2 over the tile and 2 over the k of each tile, each
//    a 32 x 32 tile over 64 of the 128 k, issue mma.sync.m16n8k32 (s8 x s8
//    -> s32); the two k halves are summed through shared memory. mma.sync,
//    not wgmma: at these shapes the kernel is bound by bytes and latency,
//    not by MMA rate. The 32 x 32 warp tile reads 2 KB of fragments from
//    shared memory per 8 MMAs (a 16 x 32 one 1.5 KB per 4).
//  - Each block leaves its int32 tile in shared memory; after a cluster
//    barrier, block z of the pair sums rows 32 z .. 32 z + 31 of both
//    tiles in rank order (its partner's through distributed shared memory:
//    int32 sums, exact) and runs the epilogue on them, the 32 lanes of a
//    warp on 32 consecutive columns of one row, so its device reads and
//    writes are coalesced 128-byte rows.
// An operand whose rows are not 16-byte aligned (K % 16 != 0, or a base
// off 16 bytes) takes a scalar path: its tile is loaded byte by byte, with
// ordinary loads and stores, into the same ring.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace int8_field {

constexpr int BM = 64;        // chains (rows of s) per block
constexpr int BN = 64;        // output sites (rows of J) per block
constexpr int BK = 128;       // k per shared-memory tile
constexpr int LDS = BK + 16;  // smem row stride in bytes: 36 words, so the
                              // 8 rows x 4 words of a fragment read hit 32
                              // distinct banks
constexpr int STAGES = 4;
constexpr int SPLIT_K = 2;    // blocks of a cluster, one k range each (gridDim.z)
constexpr int THREADS = 256;  // 8 warps: WARPS_M x WARPS_N x WARPS_K
constexpr int WARPS_M = 2, WARPS_N = 2, WARPS_K = 2;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's 32 x 32 tile
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 73,728: dynamic shared memory
constexpr int TILE_LD = BN + 1;                   // int32 output tile row stride
// The outputs a thread finishes: column threadIdx.x % BN of rows
// OUT_ROW0 + threadIdx.x / BN + OUT_ROW_STEP * i, i < OUT_ITEMS.
constexpr int OUT_ROWS = BM / SPLIT_K;
constexpr int OUT_ROW_STEP = THREADS / BN;
constexpr int OUT_ITEMS = OUT_ROWS / OUT_ROW_STEP;
static_assert(WARPS_M * WARPS_N * WARPS_K * 32 == THREADS, "eight warps");
static_assert(BM * TILE_LD * 4 <= SMEM_BYTES, "the output tile reuses the ring");
static_assert(THREADS % BN == 0 && OUT_ROWS % OUT_ROW_STEP == 0, "whole output rows");

// Per-thread accumulators: [m16 tile][n8 tile][fragment register].
struct Acc {
  int c[WM / 16][WN / 8][4];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk `chunk` (16 bytes, k0 + 16 * (chunk % 8) on) of row `row0 + chunk /
// 8` of an int8 operand with `nrows` rows of K live bytes, row stride ld,
// into a row-major tile at `dst` (stride LDS).
__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* __restrict__ g, int ld,
                                           int nrows, int K, int row0, int k0, int chunk,
                                           bool vec) {
  const int r = chunk / (BK / 16), c = (chunk % (BK / 16)) * 16;
  const int gr = row0 + r, gc = k0 + c;
  int8_t* d = dst + r * LDS + c;
  if (vec) {  // ld % 16 == 0: a chunk that starts below K ends within the row
    const bool valid = gr < nrows && gc < K;
    cp_async16(smem_u32(d), valid ? g + static_cast<size_t>(gr) * ld + gc : g, valid);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
    if (gr < nrows) {
      const int8_t* src = g + static_cast<size_t>(gr) * ld;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (gc + e < K) w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[gc + e]))
                                    << (8 * (e % 4));
    }
    *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Both tiles of k tile kt into ring stage `stage`: 64 rows of s and 64 of J,
// 8 chunks each, four chunks a thread.
__device__ __forceinline__ void load_stage(uint8_t* smem, int stage, int kt,
                                           const int8_t* __restrict__ s, int ld_s,
                                           const int8_t* __restrict__ J, int B, int N, int K,
                                           int row0, int col0, bool vec_s, bool vec_j) {
  int8_t* sA = reinterpret_cast<int8_t*>(smem + stage * STAGE_BYTES);
  int8_t* sB = sA + BM * LDS;
  constexpr int A_CHUNKS = BM * BK / 16, B_CHUNKS = BN * BK / 16;
#pragma unroll
  for (int idx = threadIdx.x; idx < A_CHUNKS + B_CHUNKS; idx += THREADS) {
    if (idx < A_CHUNKS) load_chunk(sA, s, ld_s, B, K, row0, kt * BK, idx, vec_s);
    else load_chunk(sB, J, K, N, K, col0, kt * BK, idx - A_CHUNKS, vec_j);
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

// The mainloop: s is (B, K) int8 with row stride ld_s, J is (N, K) int8.
// The block's output tile starts at chain row0 and site col0; it sums the
// k tiles of range blockIdx.z of SPLIT_K. vec_s/vec_j select the cp.async
// loads (decided on the host, uniform over the grid). On return the
// block's partial int32 tile lies in `smem` as tile[r * TILE_LD + c]
// (r < BM, c < BN), and every block of the cluster has got that far.
__device__ __forceinline__ void mainloop(uint8_t* smem, const int8_t* __restrict__ s, int ld_s,
                                         const int8_t* __restrict__ J, int B, int N, int K,
                                         int row0, int col0, bool vec_s, bool vec_j) {
  Acc acc;
#pragma unroll
  for (int mi = 0; mi < WM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < WN / 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc.c[mi][ni][q] = 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % WARPS_M) * WM, wn = (warp / WARPS_M % WARPS_N) * WN;
  const int kh = warp / (WARPS_M * WARPS_N);  // which k part of every tile
  const int g = lane >> 2, t = lane & 3;
  const int all_tiles = (K + BK - 1) / BK, per_split = (all_tiles + SPLIT_K - 1) / SPLIT_K;
  const int kt0 = blockIdx.z * per_split;
  const int k_tiles = max(0, min(all_tiles, kt0 + per_split) - kt0);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < k_tiles)
      load_stage(smem, st, kt0 + st, s, ld_s, J, B, N, K, row0, col0, vec_s, vec_j);
    cp_async_commit();
  }
  for (int i = 0; i < k_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage (i - 1) % STAGES is free
    const int next = i + STAGES - 1;
    if (next < k_tiles)
      load_stage(smem, next % STAGES, kt0 + next, s, ld_s, J, B, N, K, row0, col0, vec_s,
                 vec_j);
    cp_async_commit();

    const int8_t* sA = reinterpret_cast<const int8_t*>(smem + (i % STAGES) * STAGE_BYTES);
    const int8_t* sB = sA + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK / WARPS_K; ks += 32) {
      const int k = kh * (BK / WARPS_K) + ks;
      // A fragment (16 x 32, row-major): a0/a2 row g, a1/a3 row g+8; a0/a1
      // hold k = t*4..t*4+3, a2/a3 hold k = 16+t*4..16+t*4+3.
      uint32_t a[WM / 16][4];
#pragma unroll
      for (int mi = 0; mi < WM / 16; ++mi) {
        const int8_t* p = sA + (wm + mi * 16 + g) * LDS + k + t * 4;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * LDS);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * LDS + 16);
      }
      // B fragment (32 x 8, column n = g): b0 holds k = t*4.., b1 k = 16+t*4..
#pragma unroll
      for (int ni = 0; ni < WN / 8; ++ni) {
        const int8_t* pb = sB + (wn + ni * 8 + g) * LDS + k + t * 4;
        const uint32_t b0 = lds32(pb), b1 = lds32(pb + 16);
#pragma unroll
        for (int mi = 0; mi < WM / 16; ++mi)
          mma_s8(acc.c[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the output tile

  // Accumulator fragment: c0/c1 row g, cols t*2, t*2+1; c2/c3 row g+8. The
  // warps of k part WARPS_K - 1 store their sums, the others add theirs in
  // turn (int32: exact, in a fixed order).
  int* tile = reinterpret_cast<int*>(smem);
  for (int part = WARPS_K - 1; part >= 0; --part) {
    if (kh == part) {
#pragma unroll
      for (int mi = 0; mi < WM / 16; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN / 8; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            int* e = tile + (wm + mi * 16 + g + (q >> 1) * 8) * TILE_LD + wn + ni * 8 + t * 2 +
                     (q & 1);
            *e = part == WARPS_K - 1 ? acc.c[mi][ni][q] : *e + acc.c[mi][ni][q];
          }
    }
    __syncthreads();
  }
  cooperative_groups::this_cluster().sync();  // every partial tile is complete
}

// This thread's outputs (see OUT_ITEMS): their int32 sums over the k ranges
// of every block of the cluster, gathered from the blocks' tiles (the
// others' through distributed shared memory) in rank order. Block z of the
// cluster finishes rows OUT_ROWS z .. OUT_ROWS (z + 1) - 1 of the tile, the
// lanes of a warp 32 consecutive columns of one row, so the epilogue's
// device reads and writes are coalesced 128-byte rows. Ends with a cluster
// barrier, so no block leaves while another reads its tile.
__device__ __forceinline__ void gather_outputs(uint8_t* smem, int (&acc)[OUT_ITEMS]) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int* own = reinterpret_cast<const int*>(smem);
  const int first = (blockIdx.z * OUT_ROWS + threadIdx.x / BN) * TILE_LD + threadIdx.x % BN;
#pragma unroll
  for (int i = 0; i < OUT_ITEMS; ++i) acc[i] = 0;
#pragma unroll
  for (int rank = 0; rank < SPLIT_K; ++rank) {
    const int* tile = cluster.map_shared_rank(own, rank);
#pragma unroll
    for (int i = 0; i < OUT_ITEMS; ++i) acc[i] += tile[first + i * OUT_ROW_STEP * TILE_LD];
  }
  cluster.sync();
}

// Row (in the tile) of this thread's output i, and its column.
__device__ __forceinline__ int out_row(int i) {
  return blockIdx.z * OUT_ROWS + threadIdx.x / BN + i * OUT_ROW_STEP;
}
__device__ __forceinline__ int out_col() { return threadIdx.x % BN; }

// Grid of a launch: (site tiles, chain tiles, SPLIT_K); the kernels are
// declared with __cluster_dims__(1, 1, SPLIT_K).
inline dim3 grid_for(int B, int N) {
  return dim3((N + BN - 1) / BN, (B + BM - 1) / BM, SPLIT_K);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace int8_field
