// flash_attention: online-softmax attention over aligned (BH, S, d) heads,
// scale 1/sqrt(d), optional causal mask, optionally banded to a sliding
// window, and a key-length bound kv_len. Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel).
//
// For each head and query row i, over the keys j in tiles, in f32:
//   s_j   = (q_i . k_j) * scale, or -1e30 where causal and j > i, or where
//           window > 0 and j <= i - window (the band i - window < j <= i),
//           or where j >= kv_len (keys padded past the sequence's end)
//   m'    = max(m, max_j s_j);  p_j = exp(s_j - m');  alpha = exp(m - m')
//   l     = alpha * l + sum_j p_j;  acc = alpha * acc + sum_j p_j v_j
//   out_i = acc / max(l, 1e-30), cast to q's dtype
// with m = -1e30, l = 0, acc = 0 at the start. The causal mask is aligned
// at the top left: query i sees keys 0..i, also when Sq != Sk. A key tile
// that lies wholly above the diagonal is skipped, which is exact: every
// score in it is -1e30, so it would add p = 0 and give alpha = 1 (the
// first tile always holds key 0, so m is a real score by then). With a
// window a block starts at the first key tile that meets its rows' band,
// and the tiles before it are skipped as exactly. A row may then see no key
// of its first tile (its band starts in a later one): while a row's max is
// still -1e30 its p are taken as 0, not exp(0), so nothing is added that
// alpha would have to clear, and its diagonal always lies in the band, so
// no row ends without a key. The caller asks Sq <= Sk with a window.
// A block walks only the ceil(kv_len / tile) key tiles that hold a key below
// kv_len, which is as exact: the tiles wholly past it would add p = 0. Only
// the last tile walked can hold masked keys; key 0 is always below kv_len
// (1 <= kv_len <= Sk), so no row ends without a key. The caller takes
// kv_len < Sk without the causal mask only (a causal call's padding is
// already hidden by the diagonal).
//
// q: (BH, Sq, d), k and v: (BH, Sk, d), out: (BH, Sq, d), all f32 or all
// bf16, contiguous, 16-byte aligned; Sq and Sk multiples of 128 (as the
// TPU kernel asks); d a multiple of 8, at most 256.
//
// What bounds it on the H100: at the phi4-mini prefill shape (24 heads,
// S = 4096, d = 128, causal, bf16) it must read q, k, v and write out,
// 101 MB (30 us at 3.35 TB/s), and do 103 GFLOP (104 us at the 989 TFLOP/s
// of bf16 tensor cores): operations bound it.
//
// Two kernels, chosen by dtype in the launcher (no other route):
//
// bf16: flash_bf16_kernel, on the tensor cores. A block of three
//   warpgroups holds 128 query rows of one head. Warpgroup 0 is the
//   producer: one thread loads the q tile once and the k and v tiles of
//   each key tile with TMA into a ring of two stages (an mbarrier per stage
//   for "full", one for "empty"), and the warpgroup gives up registers
//   (setmaxnreg) to the two consumer warpgroups, 64 query rows each.
//   A consumer computes S = q k^T with wgmma (m64nBNk16, both operands
//   K-major in shared memory, 128-byte swizzle), the online softmax in f32
//   registers (a row's scores lie in one quad of lanes: max and sum are
//   two shuffles), and O += P v with wgmma from registers: the f32 p is
//   split into three bf16 parts, P_hi = bf16(p), P_mid = bf16(p - P_hi) and
//   P_lo = bf16(p - P_hi - P_mid), packed straight from the S accumulator
//   (whose m64 layout is the A fragment's); the three products, v the
//   MN-major B operand (transpose bit), go into the f32 O accumulator.
//   Rounding p to one bf16 puts outputs at S = 4096 many bf16 ulps from
//   the f32 result; two parts (p to 2^-18) still more than one ulp at the
//   first rows of a head, where a few large terms cancel to an output near
//   zero; three parts hold p to 2^-26 and the outputs within the rounding's
//   half ulp, at 2x the counted FLOPs (tests/test_torch_flash_attention.py
//   emulates the three schemes). d is padded to DP, the next multiple of 64: TMA boxes are 64 columns wide and fill the columns at
//   or past d with zeros, which add nothing to the scores; those output
//   columns are never stored. Key tiles are 128 keys for DP <= 128 and 64
//   above, so the q tile and two stages fit: 160 KB at d = 128, 192 KB at
//   d = 256. The tensor maps are encoded on the host per call, through the
//   driver entry point cudaGetDriverEntryPoint returns (nothing linked).
//
// f32: flash_f32_kernel, on the CUDA cores in f32 FMAs (67 TFLOP/s at most),
//   which keeps f32 inputs within 2e-5 of the f32 oracle, where a TF32 or
//   bf16 tensor-core product would not. A block of 256 threads holds 64
//   query rows of one head in shared memory and walks key tiles of 64, each
//   staged in shared memory. Thread (ty, tx) of the 16 x 16 grid owns rows
//   ty + 16 i and keys tx + 16 j (i, j < 4): its 4 x 4 scores take two
//   16-byte shared loads per 16 FMAs. A row's 16 owners are one half-warp,
//   so its max and sum are shuffle reductions. The p tile goes through
//   shared memory to the P.V product, where the thread owns the same rows
//   and the columns 4 tx + 64 c. Row strides of d + 4 floats (d / 4 + 1
//   odd) keep the 16-byte loads free of bank conflicts. At d = 256 the q, k
//   and v tiles and the p tile take 212 KB of the 227 KB a block may have.
//
// Both run the longest causal rows first. Under a band every block past the
// first window / 64 (f32) or window / 128 (bf16) query rows walks the same
// number of key tiles, so the order then matters only for those first ones.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "wgmma_tma.cuh"

namespace {

// -- f32: CUDA cores -----------------------------------------------------------

constexpr int kRows = 64;       // query rows of a block, and keys of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPStride = 68;    // p tile: p[row ty + 16 i][key j] at j * 68 + 4 ty + i
constexpr float kNegInf = -1e30f;

// Rows [0, 64) of a (64, d) f32 slice into a (64, d + 4) tile, 16 bytes a
// thread and load.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* __restrict__ dst,
                                          int d, int stride) {
  const int per_row = d / 4;
  for (int c = threadIdx.x; c < kRows * per_row; c += kThreads) {
    const int r = c / per_row, col = (c - r * per_row) * 4;
    *reinterpret_cast<float4*>(dst + r * stride + col) =
        __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * d + col));
  }
}

// DMAX: d rounded up to 64, 128 or 256; a thread keeps 4 x DMAX / 16
// accumulators.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                           int d, int causal, int window, int kv_len) {
  extern __shared__ float4 smem4[];
  const int stride = d + 4;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * stride;
  float* vs = ks + kRows * stride;
  float* ps = vs + kRows * stride;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal rows first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  constexpr int NC = DMAX / 64;

  load_tile(q + (static_cast<size_t>(bh) * Sq + q0) * d, qs, d, stride);

  float acc[4][NC][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  int t_begin = 0, n_tiles = (kv_len + kRows - 1) / kRows;  // the tiles below kv_len
  if (causal) {
    n_tiles = min(n_tiles, q0 / kRows + 1);
    if (window > 0) t_begin = max(0, q0 - window + 1) / kRows;  // the band's first tile
  }
  for (int t = t_begin; t < n_tiles; ++t) {
    const int k0 = t * kRows;
    __syncthreads();  // the previous tile's k, v and p are consumed
    const size_t off = (static_cast<size_t>(bh) * Sk + k0) * d;
    load_tile(k + off, ks, d, stride);
    load_tile(v + off, vs, d, stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int dd = 0; dd < d; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * stride + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * stride + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = fmaf(qv[i].x, kv[j].x, s[i][j]);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          s[i][j] = fmaf(qv[i].w, kv[j].w, x);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        const int key = k0 + tx + 16 * j;
        if ((causal && (key > row || (window > 0 && key <= row - window))) || key >= kv_len)
          x = kNegInf;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float mn = fmaxf(m[i], mc);
      const float shift = mn == kNegInf ? 0.0f : mn;  // no key of the band yet: p = 0
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - shift);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - mn);
      l[i] = alpha * l[i] + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * kPStride + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int j = 0; j < kRows; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ps + j * kPStride + 4 * ty);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * tx + 64 * c;
        if (col < d) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * stride + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c][0] = fmaf(pr[i], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pr[i], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pr[i], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pr[i], vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (static_cast<size_t>(bh) * Sq + q0 + ty + 16 * i) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < d)
        *reinterpret_cast<float4*>(o + col) =
            make_float4(acc[i][c][0] / den, acc[i][c][1] / den, acc[i][c][2] / den,
                        acc[i][c][3] / den);
    }
  }
}


cudaError_t launch_f32(const float* q, const float* k, const float* v, float* out, int BH,
                       int Sq, int Sk, int d, int causal, int window, int kv_len,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kRows * static_cast<size_t>(d + 4) + kRows * kPStride);
  auto kernel = d <= 64 ? flash_f32_kernel<64> : d <= 128 ? flash_f32_kernel<128>
                                                          : flash_f32_kernel<256>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(Sq / kRows, BH), kThreads, smem, stream>>>(q, k, v, out, Sq, Sk, d, causal,
                                                           window, kv_len);
  return cudaGetLastError();
}

// -- bf16: tensor cores (wgmma), TMA, a two-stage ring ------------------------

constexpr int kBlockQ = 128;         // query rows of a block: two consumer warpgroups
constexpr int kStages = 2;
constexpr int kBf16Threads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kPanel = 64;           // bf16 columns of a 128-byte swizzled panel

template <int DP>
struct Bf16Tile {
  static constexpr int BN = DP <= 128 ? 128 : 64;      // keys per tile
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kQBytes = kBlockQ * DP * 2;     // kPanels panels of kBlockQ x 128 B
  static constexpr int kKVBytes = BN * DP * 2;         // kPanels panels of BN x 128 B
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // + 1024 so the tiles can start on a 1024-byte boundary
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

// The m64nN f32 accumulator of a warpgroup: register i of thread t (warp
// w = t / 32, lane l) holds row 16 w + l / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (l % 4) + (i % 2).
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int DP>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                  int Sq, int Sk, int d, int causal, int window, int kv_len,
                  float scale_log2) {
  using T = Bf16Tile<DP>;
  constexpr int BN = T::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t k_smem = base + T::kQBytes;                        // + stage * kKVBytes
  const uint32_t v_smem = base + T::kQBytes + kStages * T::kKVBytes;
  const uint32_t q_bar = base + T::kBarOffset;
  const uint32_t full_bar = q_bar + 8;                             // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // the longest causal rows first
  int t_begin = 0, n_tiles = (kv_len + BN - 1) / BN;  // the tiles below kv_len
  if (causal) {
    n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / BN + 1);
    if (window > 0) t_begin = max(0, q0 - window + 1) / BN;  // the band's first tile
  }
  // the ring's stage and phase count the tiles walked (i), from t_begin
  const int n_walk = n_tiles - t_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_bar + 8 * s, 1);
      hopper::mbar_init(empty_bar + 8 * s, 2 * 128);  // every consumer thread arrives
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load; the warpgroup keeps 40 registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_bar, T::kQBytes);
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p)
        hopper::tma_load_2d(q_smem + p * kBlockQ * 128, &tq, p * kPanel, bh * Sq + q0, q_bar);
      for (int i = 0; i < n_walk; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hopper::mbar_wait(empty_bar + 8 * s, ((i / kStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(full_bar + 8 * s, 2 * T::kKVBytes);
        const int row = bh * Sk + (t_begin + i) * BN;
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p) {
          const uint32_t off = s * T::kKVBytes + p * BN * 128;
          hopper::tma_load_2d(k_smem + off, &tk, p * kPanel, row, full_bar + 8 * s);
          hopper::tma_load_2d(v_smem + off, &tv, p * kPanel, row, full_bar + 8 * s);
        }
      }
    }
  } else {
    // Consumer warpgroup c: query rows q0 + 64 c .. q0 + 64 c + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int wg_row0 = q0 + 64 * c;
    const int row0 = wg_row0 + 16 * warp + lane / 4;  // and row0 + 8
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const uint32_t q_wg = q_smem + 64 * c * 128;

    hopper::mbar_wait(q_bar, 0);
    for (int it = 0; it < n_walk; ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(full_bar + 8 * s, (it / kStages) & 1);
      const uint32_t k_tile = k_smem + s * T::kKVBytes, v_tile = v_smem + s * T::kKVBytes;

      // S = q k^T over DP / 16 steps of k16.
      float sc[BN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t panel = kk / 4, step = (kk % 4) * 32;
        const uint64_t da = hopper::desc_sw128(q_wg + panel * kBlockQ * 128 + step, 16, 1024);
        const uint64_t db = hopper::desc_sw128(k_tile + panel * BN * 128 + step, 16, 1024);
        hopper::wgmma_ss<BN>(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(sc);

      // Online softmax on the raw scores, exp2 with the scale folded in.
      const int k0 = (t_begin + it) * BN;
      // the diagonal crosses the tile, or the band's lower edge does, or kv_len
      const bool lower = window > 0 && k0 <= wg_row0 + 63 - window;
      if ((causal && k0 + BN - 1 > wg_row0) || lower || k0 + BN > kv_len) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + acc_col(i, lane), row = row0 + 8 * ((i / 2) % 2);
          if ((causal && (key > row || (window > 0 && key <= row - window))) || key >= kv_len)
            sc[i] = kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f((m[h] - mn) * scale_log2);
        // no key of the band yet: p = exp2(-1e30 * scale_log2) = 0
        neg_m[h] = mn == kNegInf ? 0.0f : -mn * scale_log2;
        m[h] = mn;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i / 2) % 2;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, neg_m[h]));
        sum[h] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = fmaf(alpha[h], l[h], sum[h]);  // quad partial sums
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // p = P_hi + P_mid + P_lo, three bf16 parts, as m64k16 A fragments:
      // chunk kk covers keys 16 kk .. 16 kk + 15, the accumulator's column
      // blocks 2 kk and 2 kk + 1. p - P_hi and p - P_hi - P_mid are exact
      // in f32, so the parts hold p to 2^-26 of itself.
      uint32_t p_part[3][BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = (2 * kk + j / 2) * 4 + (j % 2) * 2;
          float2 rest = make_float2(sc[i], sc[i + 1]);
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            const __nv_bfloat162 b16 = __floats2bfloat162_rn(rest.x, rest.y);
            const float2 hf = __bfloat1622float2(b16);
            p_part[part][kk][j] = bf16x2_bits(b16);
            rest = make_float2(rest.x - hf.x, rest.y - hf.y);
          }
        }

      // O += (P_hi + P_mid + P_lo) v: three products into the f32 O
      // accumulator; v rows 16 kk .. 16 kk + 15 start 2048 bytes apart.
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(v_tile + kk * 2048, BN * 128, 1024);
#pragma unroll
        for (int part = 0; part < 3; ++part) hopper::wgmma_rs<DP>(o, p_part[part][kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(o);
      hopper::mbar_arrive(empty_bar + 8 * s);  // this thread is done with the stage
    }

    float den[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      den[h] = fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int col = acc_col(i, lane), h = (i / 2) % 2;
      if (col < d) {
        const size_t row = static_cast<size_t>(bh) * Sq + row0 + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(out + row * d + col) =
            __floats2bfloat162_rn(o[i] / den[h], o[i + 1] / den[h]);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library links nothing beyond the CUDA runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (rows, d) bf16 row-major tensor map with (box_rows, 64)-element boxes
// in 128-byte swizzle; columns past d read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int d, long long rows, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {kPanel, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_bf16_dp(const void* q, const void* k, const void* v, void* out, int BH,
                           int Sq, int Sk, int d, int causal, int window, int kv_len,
                           cudaStream_t stream) {
  using T = Bf16Tile<DP>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d, static_cast<long long>(BH) * Sq, kBlockQ) ||
      !make_map(&tk, k, d, static_cast<long long>(BH) * Sk, T::BN) ||
      !make_map(&tv, v, d, static_cast<long long>(BH) * Sk, T::BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_bf16_kernel<DP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(d)));
  kernel<<<dim3(Sq / kBlockQ, BH), kBf16Threads, T::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, d, causal, window, kv_len,
      scale_log2);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int Sq,
                        int Sk, int d, int causal, int window, int kv_len, cudaStream_t stream) {
  if (d <= 64)
    return launch_bf16_dp<64>(q, k, v, out, BH, Sq, Sk, d, causal, window, kv_len, stream);
  if (d <= 128)
    return launch_bf16_dp<128>(q, k, v, out, BH, Sq, Sk, d, causal, window, kv_len, stream);
  if (d <= 192)
    return launch_bf16_dp<192>(q, k, v, out, BH, Sq, Sk, d, causal, window, kv_len, stream);
  return launch_bf16_dp<256>(q, k, v, out, BH, Sq, Sk, d, causal, window, kv_len, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the error of the set-up:
// cudaErrorInvalidValue when a tensor map cannot be encoded). bf16 != 0:
// all four tensors are bf16 and go to flash_bf16_kernel, else f32 to
// flash_f32_kernel. window > 0 bands the causal mask (causal != 0 and
// Sq <= Sk). Keys at or past kv_len are masked (1 <= kv_len <= Sk; below Sk
// only with causal == 0). The caller has checked the shapes, alignment, the
// window, kv_len and 1 <= BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int BH, int Sq, int Sk, int d, int causal, int window,
                                      int kv_len, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_bf16(q, k, v, out, BH, Sq, Sk, d, causal, window, kv_len, st)
           : launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(out), BH, Sq, Sk, d,
                        causal, window, kv_len, st);
  return static_cast<int>(err);
}
