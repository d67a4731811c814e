// sparse_energy: the energy of each row of s over a padded neighbour list,
//   E_r = 0.5 * sum_i s_ri h_ri + sum_i b_i s_ri,
//   h_ri = ((0 + w[i][0] s_r[idx[i][0]]) + ... + w[i][D-1] s_r[idx[i][D-1]])
// each h summed over the slots in order with one rounded multiply and one
// rounded add a slot (sparse_gather.cuh), so every h_ri, s_ri h_ri and
// b_i s_ri is bit-equal to SparseIsing.energy's. The pair sum is halved and
// the bias sum added last, as there. The sums over the sites run in a fixed
// order (a thread's sites in turn, a shuffle tree in each warp, the warps in
// turn, and for the long rows the tiles in turn): no atomics, so the same
// input gives the same bits in every call and every graph replay. On +-1
// states with integer couplings every partial sum is an integer below 2^24,
// and any order gives SparseIsing.energy's number exactly.
//
// It replaces no TPU kernel: the JAX SparseIsing.energy is plain jnp. It was
// added for run()'s first-hit check, which takes the energy of every chain
// after every sweep (a chain of torch gathers took 232 us a sweep at
// (256, 16384), D = 3, against the sweep kernel's 43), and for its recorded
// energies.
//
// Memory-bound: it must read s once and the tables once, 4 (B n + n (2 D +
// 1)) bytes, and write 4 B: at (256, 16384), D = 3, 17.2 MB, 5.1 us at
// 3.35 TB/s; at (320, 512000), D = 6, 682 MB, 203.6 us. Its 2 D + 4 f32
// operations a site and row take under a tenth of that.
//
// s: (B, n) f32 (any values), nbr_idx: (n, D) int32, nbr_w: (n, D) f32,
// b: (n,) f32, out: (B,) f32. Two routes, chosen by the wrapper from n and
// counted apart (kernels/sparse_gather.py::energy_kernel):
//
//   sparse_energy_rows<R> (rows of up to 58112 sites): a block copies R
//     whole rows of s into shared memory with 16-byte loads, as
//     sparse_fields' staged kernel does, then walks the sites, loading each
//     site's table entry once for the R rows and gathering from shared
//     memory; it sums its rows' energies itself: one launch.
//   sparse_energy_tile + sparse_energy_sum (longer rows, which no block
//     holds): a block takes a tile of kTile sites of kTileRows rows, copies
//     the tile of each row into shared memory with 16-byte loads, and
//     gathers a neighbour from there when it lies in the tile, else from
//     device memory through the cache (on the 3D lattice the +-1 and +-L
//     neighbours mostly lie in the tile, the +-L^2 ones in tiles that other
//     blocks read at the same time). Each block writes each row's pair and
//     bias sums of its tile; the second launch sums each row's tiles in
//     order. The table entry of a site is read once for kTileRows rows.
//
//   sparse_energy_samples (per-sample couplings: nbr_w (S, n, D), the rows
//     sample-major, row r of the whole batch taking sample r /
//     rows_per_sample's): a block a row, each site's slots gathered from
//     the row in device memory through the cache, at any n, and summed as
//     sparse_energy_rows<1> sums a row (the same threads, the same order):
//     one launch. It is run()'s energy of a batch of disorder samples, two
//     launches a job on ea3d32.samples against 200 sweeps, so its loads are
//     left plain.
//
// What holds them back (PERF.md): at (256, 16384) the staged kernel's
// copy-in alone takes 8.5 us and its walk alone 17.9 us; bank-conflict-free
// gathers take 3.5 us off the walk and earlier table loads nothing, which
// leaves the tables every block of two rows reads through L2 (59 MB in
// all); a block of two 64-KB rows is one block an SM, so one block's
// copy-in does not overlap another's walk. The long-row pair gathers the
// neighbours outside its tile (+-L^2 on the lattice) through L2.
#include <cstdint>

#include "glauber.cuh"
#include "sparse_gather.cuh"

namespace {

constexpr int kUnroll = 2;           // sites a staged thread walks at once
constexpr int kSlots = 4;            // slots of a tile site whose table entries load at once
constexpr int kMaxWarps = 32;        // warps of a block of 1024 threads
constexpr int kTile = 1024;          // sites of a long-row tile
constexpr int kTileThreads = 256;    // threads of a tile block: 4 sites each
constexpr int kTileRows = 16;        // rows a tile block holds
constexpr int kSumThreads = 256;     // threads of a sum block: a warp a row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;  // lane 0 holds the warp's sum
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Slots k0 .. k0 + K - 1 of site i's table entry, all loads issued before
// any is used, so a tile site waits on its table once for K slots (at
// (320, 512000), D = 6, 0.846 ms against 1.111 ms loading a slot at a time;
// the staged kernel's walk gains nothing from it); a slot past D gets index
// -1 and weight 0, which are skipped.
template <int K>
__device__ __forceinline__ void load_slots(const int* __restrict__ idx,
                                           const float* __restrict__ w, int i, int D, int k0,
                                           int (&j)[K], float (&wk)[K]) {
  const size_t e = static_cast<size_t>(i) * D + k0;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const bool live = k0 + kk < D;
    j[kk] = live ? __ldg(idx + e + kk) : -1;
    wk[kk] = live ? __ldg(w + e + kk) : 0.0f;
  }
}

// Adds site i's pair and bias terms of the R rows, with h from `acc`.
template <int R>
__device__ __forceinline__ void add_site(float (&pair)[R], float (&field)[R],
                                         const float (&acc)[R], const float* rows, size_t stride,
                                         int li, float bias) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float si = rows[r * stride + li];
    pair[r] = __fadd_rn(pair[r], __fmul_rn(si, acc[r]));
    field[r] = __fadd_rn(field[r], __fmul_rn(bias, si));
  }
}

// Sums pair[r] and field[r] over the block's threads: each warp by its
// shuffle tree, then thread v < 2R over the warps in turn; red holds
// kMaxWarps * 2R floats. Returns, in thread v, pair (v < R) or field
// (R <= v < 2R) of row v % R; in other threads 0.
template <int R>
__device__ __forceinline__ float block_sums(const float (&pair)[R], const float (&field)[R],
                                            float* red) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, warps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float p = warp_sum(pair[r]), f = warp_sum(field[r]);
    if (lane == 0) {
      red[warp * 2 * R + r] = p;
      red[warp * 2 * R + R + r] = f;
    }
  }
  __syncthreads();
  float v = 0.0f;
  if (t < 2 * R)
    for (int q = 0; q < warps; ++q) v = __fadd_rn(v, red[q * 2 * R + t]);
  return v;
}

template <int R>
__global__ void __launch_bounds__(1024)
sparse_energy_rows(const float* __restrict__ s, const int* __restrict__ idx,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float* __restrict__ out, int B, int n, int D) {
  extern __shared__ __align__(16) float rows[];  // [R][n]; then the warps' sums
  const int T = blockDim.x, t = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, B - row0);  // the last block may hold fewer rows
  const float* src = s + static_cast<size_t>(row0) * n;
  const int total = nr * n;  // the block's rows are contiguous in s
  if ((n & 3) == 0 && aligned16(src)) {
    float4* r4 = reinterpret_cast<float4*>(rows);
    sparse_gather::stream_in(reinterpret_cast<const float4*>(src), total >> 2, t, T,
                             [&](int q, float4 v) { r4[q] = v; });
  } else {
    sparse_gather::stream_in(src, total, t, T, [&](int q, float v) { rows[q] = v; });
  }
  __syncthreads();

  // rows r >= nr are never staged: their sums are computed and dropped
  float pair[R], field[R];
#pragma unroll
  for (int r = 0; r < R; ++r) pair[r] = field[r] = 0.0f;
  for (int i0 = t; i0 < n; i0 += kUnroll * T) {
    int site[kUnroll];  // a missing site repeats i0 and is not added
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
    for (int q = 0; q < kUnroll; ++q)
      if (i0 + q * T < n)
        add_site<R>(pair, field, acc[q], rows, static_cast<size_t>(n), site[q],
                    __ldg(b + site[q]));
  }
  __syncthreads();  // every thread is done with the rows: their memory takes the warps' sums
  const float v = block_sums<R>(pair, field, rows);
  // thread r < nr combines its row's two sums, which threads r and R + r hold
  __syncthreads();
  if (t < 2 * R) rows[t] = v;
  __syncthreads();
  if (t < nr) out[row0 + t] = __fadd_rn(__fmul_rn(0.5f, rows[t]), rows[R + t]);
}

// One row a block: row blockIdx.x of the launch, whose couplings are those
// of sample (first + blockIdx.x) / rows_per_sample, n D floats apart.
__global__ void __launch_bounds__(1024)
sparse_energy_samples(const float* __restrict__ s, const int* __restrict__ idx,
                      const float* __restrict__ w, const float* __restrict__ b,
                      float* __restrict__ out, int n, int D, int rows_per_sample, int first) {
  __shared__ float red[kMaxWarps * 2];
  const int T = blockDim.x, t = threadIdx.x;
  const float* row = s + static_cast<size_t>(blockIdx.x) * n;
  const float* ws =
      w + static_cast<size_t>((first + static_cast<int>(blockIdx.x)) / rows_per_sample) * n * D;
  float pair[1] = {0.0f}, field[1] = {0.0f};
  for (int i0 = t; i0 < n; i0 += kUnroll * T) {
    int site[kUnroll];  // a missing site repeats i0 and is not added
    float acc[kUnroll][1];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      site[q] = i0 + q * T < n ? i0 + q * T : i0;
      acc[q][0] = 0.0f;
    }
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const size_t e = static_cast<size_t>(site[q]) * D + k;
        sparse_gather::add_slot<1>(acc[q], row, 0, __ldg(idx + e), __ldg(ws + e), n);
      }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (i0 + q * T < n) add_site<1>(pair, field, acc[q], row, 0, site[q], __ldg(b + site[q]));
  }
  const float v = block_sums<1>(pair, field, red);
  // thread 0 holds the pair sum, thread 1 the bias sum
  __syncthreads();
  if (t < 2) red[t] = v;
  __syncthreads();
  if (t == 0) out[blockIdx.x] = __fadd_rn(__fmul_rn(0.5f, red[0]), red[1]);
}

// part[r][tile] = (pair, field) sums of rows row0 .. row0 + nr - 1 over the
// tile's sites. Thread t walks sites t, t + 256, t + 512, t + 768 of the
// tile in turn.
__global__ void __launch_bounds__(kTileThreads)
sparse_energy_tile(const float* __restrict__ s, const int* __restrict__ idx,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float2* __restrict__ part, int B, int n, int D, int tiles, bool vec) {
  extern __shared__ __align__(16) float seg[];  // [kTileRows][kTile]: the rows' tiles
  __shared__ float red[kTileThreads / 32 * 2 * kTileRows];
  const int t = threadIdx.x, tile = blockIdx.x;
  const int i0 = tile * kTile, row0 = blockIdx.y * kTileRows;
  const int nr = min(kTileRows, B - row0), ns = min(kTile, n - i0);
  const float* base = s + static_cast<size_t>(row0) * n;
  if (vec) {  // n % 4 == 0 and s 16-byte aligned: so is every row's tile
    constexpr int kGroups = kTile / 4;
    for (int g = t; g < nr * kGroups; g += kTileThreads) {
      const int r = g / kGroups, q = 4 * (g % kGroups);
      if (q < ns)
        *reinterpret_cast<float4*>(seg + r * kTile + q) =
            __ldg(reinterpret_cast<const float4*>(base + static_cast<size_t>(r) * n + i0 + q));
    }
  } else {
    for (int g = t; g < nr * kTile; g += kTileThreads) {
      const int r = g / kTile, q = g % kTile;
      if (q < ns) seg[g] = __ldg(base + static_cast<size_t>(r) * n + i0 + q);
    }
  }
  __syncthreads();

  float pair[kTileRows], field[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) pair[r] = field[r] = 0.0f;
#pragma unroll 1
  for (int li = t; li < ns; li += kTileThreads) {
    const int i = i0 + li;
    const float bias = __ldg(b + i);
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += kSlots) {
      int j[kSlots];
      float wk[kSlots];
      load_slots(idx, w, i, D, k0, j, wk);
#pragma unroll
      for (int kk = 0; kk < kSlots; ++kk) {
        if (static_cast<unsigned>(j[kk]) >= static_cast<unsigned>(n)) continue;  // adds nothing
        const int lj = j[kk] - i0;
        if (static_cast<unsigned>(lj) < static_cast<unsigned>(ns)) {
#pragma unroll
          for (int r = 0; r < kTileRows; ++r)
            acc[r] = __fadd_rn(acc[r], __fmul_rn(wk[kk], seg[r * kTile + lj]));
        } else {
          const float* col = base + j[kk];
#pragma unroll
          for (int r = 0; r < kTileRows; ++r)
            if (r < nr)
              acc[r] = __fadd_rn(acc[r],
                                 __fmul_rn(wk[kk], __ldg(col + static_cast<size_t>(r) * n)));
        }
      }
    }
    add_site<kTileRows>(pair, field, acc, seg, kTile, li, bias);
  }
  const float v = block_sums<kTileRows>(pair, field, red);
  if (t < 2 * kTileRows && t % kTileRows < nr) {
    const size_t at = static_cast<size_t>(row0 + t % kTileRows) * tiles + tile;
    reinterpret_cast<float*>(part + at)[t / kTileRows] = v;
  }
}

// out[r] = 0.5 * (sum of row r's tile pair sums) + (sum of its field sums):
// a warp a row, lane l adding tiles l, l + 32, ... in turn, then its
// shuffle tree.
__global__ void __launch_bounds__(kSumThreads)
sparse_energy_sum(const float2* __restrict__ part, float* __restrict__ out, int B, int tiles) {
  const int r = blockIdx.x * (kSumThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= B) return;  // the whole warp
  const float2* p = part + static_cast<size_t>(r) * tiles;
  float pair = 0.0f, field = 0.0f;
  for (int q = lane; q < tiles; q += 32) {
    const float2 v = p[q];
    pair = __fadd_rn(pair, v.x);
    field = __fadd_rn(field, v.y);
  }
  pair = warp_sum(pair);
  field = warp_sum(field);
  if (lane == 0) out[r] = __fadd_rn(__fmul_rn(0.5f, pair), field);
}

template <int R>
cudaError_t launch_rows(const float* s, const int* idx, const float* w, const float* b,
                        float* out, int B, int n, int D, int threads, cudaStream_t stream) {
  // the rows, or the warps' sums where they are larger (n < 64)
  const size_t smem = static_cast<size_t>(R) * (n > 2 * kMaxWarps ? n : 2 * kMaxWarps) * 4;
  const cudaError_t err = glauber::allow_smem(sparse_energy_rows<R>, smem);
  if (err != cudaSuccess) return err;
  sparse_energy_rows<R><<<(B + R - 1) / R, threads, smem, stream>>>(s, idx, w, b, out, B, n, D);
  return cudaGetLastError();
}

cudaError_t launch_long(const float* s, const int* idx, const float* w, const float* b,
                        float2* part, float* out, int B, int n, int D, int tiles,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTileRows) * kTile * 4;
  cudaError_t err = glauber::allow_smem(sparse_energy_tile, smem);
  if (err != cudaSuccess) return err;
  const bool vec = (n & 3) == 0 && aligned16(s);
  const dim3 grid(tiles, (B + kTileRows - 1) / kTileRows);
  sparse_energy_tile<<<grid, kTileThreads, smem, stream>>>(s, idx, w, b, part, B, n, D, tiles,
                                                           vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kRowsPerBlock = kSumThreads / 32;
  sparse_energy_sum<<<(B + kRowsPerBlock - 1) / kRowsPerBlock, kSumThreads, 0, stream>>>(
      part, out, B, tiles);
  return cudaGetLastError();
}

}  // namespace

// rows = 1..3: sparse_energy_rows<rows> with `threads` threads a block (a
// multiple of 32, at most 1024), `part` unused; the caller has checked
// that rows * 4n bytes fit a block. rows = 0: the long-row kernels, `part`
// a (B, tiles, 2) f32 scratch with tiles = ceil(n / 1024), `threads`
// unused. Returns cudaGetLastError() after the launches (or the attribute
// call's error); 1 (cudaErrorInvalidValue) for any other rows or tiles.
extern "C" int sparse_energy_launch(const void* s_, const void* idx_, const void* w_,
                                    const void* b_, void* part_, void* out_, int B, int n, int D,
                                    int rows, int threads, int tiles, void* stream_) {
  const auto* s = static_cast<const float*>(s_);
  const auto* idx = static_cast<const int*>(idx_);
  const auto* w = static_cast<const float*>(w_);
  const auto* b = static_cast<const float*>(b_);
  auto* out = static_cast<float*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  switch (rows) {
    case 0:
      if (tiles != (n + kTile - 1) / kTile) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(
          launch_long(s, idx, w, b, static_cast<float2*>(part_), out, B, n, D, tiles, stream));
    case 1: return static_cast<int>(launch_rows<1>(s, idx, w, b, out, B, n, D, threads, stream));
    case 2: return static_cast<int>(launch_rows<2>(s, idx, w, b, out, B, n, D, threads, stream));
    case 3: return static_cast<int>(launch_rows<3>(s, idx, w, b, out, B, n, D, threads, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The per-sample energy of the B rows of s: `threads` threads a block (a
// multiple of 32, at most 1024), row r taking sample (first + r) /
// rows_per_sample's couplings from w (S, n, D). Returns cudaGetLastError()
// after the launch; 1 (cudaErrorInvalidValue) for rows_per_sample < 1.
extern "C" int sparse_energy_samples_launch(const void* s, const void* idx, const void* w,
                                            const void* b, void* out, int B, int n, int D,
                                            int threads, int rows_per_sample, int first,
                                            void* stream) {
  if (rows_per_sample < 1) return static_cast<int>(cudaErrorInvalidValue);
  sparse_energy_samples<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), n, D, rows_per_sample, first);
  return static_cast<int>(cudaGetLastError());
}
