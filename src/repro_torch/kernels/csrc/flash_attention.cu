// flash_attention: online-softmax attention over aligned (BH, S, d) heads,
// scale 1/sqrt(d), optional causal mask. Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel).
//
// For each head and query row i, over the keys j in tiles of 64, in f32:
//   s_j   = (q_i . k_j) * scale, or -1e30 where causal and j > i
//   m'    = max(m, max_j s_j);  p_j = exp(s_j - m');  alpha = exp(m - m')
//   l     = alpha * l + sum_j p_j;  acc = alpha * acc + sum_j p_j v_j
//   out_i = acc / max(l, 1e-30), cast to q's dtype
// with m = -1e30, l = 0, acc = 0 at the start. The causal mask is aligned
// at the top left: query i sees keys 0..i, also when Sq != Sk. A key tile
// that lies wholly above the diagonal is skipped, which is exact: every
// score in it is -1e30, so it would add p = 0 and give alpha = 1 (the
// first tile always holds key 0, so m is a real score by then).
//
// q: (BH, Sq, d), k and v: (BH, Sk, d), out: (BH, Sq, d), all f32 or all
// bf16, contiguous, 16-byte aligned; Sq and Sk multiples of 64 (the
// wrapper asks for 128, as the TPU kernel does); d a multiple of 8, at
// most 256.
//
// What bounds it on the H100: at the phi4-mini prefill shape (24 heads,
// S = 4096, d = 128, causal, bf16) it must read q, k, v and write out,
// 101 MB (30 us at 3.35 TB/s), and do 103 GFLOP (104 us at the 989 TFLOP/s
// of bf16 tensor cores): operations bound it. This first version runs on
// the CUDA cores in f32 FMAs, so its ceiling is the 67 TFLOP/s fp32 rate:
// about 1.5 ms there. Tensor cores (wgmma), TMA and a pipeline are later
// work.
//
// Design: a block of 256 threads holds 64 query rows of one head in shared
// memory as f32 and walks the key tiles, each staged in shared memory as
// f32 (so both dtypes share one inner loop). Thread (ty, tx) of the 16 x 16
// grid owns rows ty + 16 i and keys tx + 16 j (i, j < 4): its 4 x 4 scores
// take two 16-byte shared loads per 16 FMAs. A row's 16 owners are one
// half-warp, so its max and sum are shuffle reductions. The p tile goes
// through shared memory to the P.V product, where the thread owns the same
// rows and the columns 4 tx + 64 c. Row strides of d + 4 floats (d / 4 + 1
// odd) keep the 16-byte loads free of bank conflicts. Blocks run the
// longest causal rows first. At d = 256 the q, k and v tiles and the p
// tile take 212 KB of the 227 KB a block may have.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;       // query rows of a block, and keys of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPStride = 68;    // p tile: p[row ty + 16 i][key j] at j * 68 + 4 ty + i
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store_out(float* o, float4 x) {
  *reinterpret_cast<float4*>(o) = x;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, float4 x) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(o);
  h[0] = __floats2bfloat162_rn(x.x, x.y);
  h[1] = __floats2bfloat162_rn(x.z, x.w);
}

// Rows [0, 64) of a (64, d) slice of f32 or bf16 into a (64, d + 4) f32
// tile, 16 bytes a thread and load.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* __restrict__ dst,
                                          int d, int stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = d / kVec;
  for (int c = threadIdx.x; c < kRows * per_row; c += kThreads) {
    const int r = c / per_row, col = (c - r * per_row) * kVec;
    const uint4 raw =
        __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * d + col));
    float* out = dst + r * stride + col;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(out) = raw;
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
      store_out(out, make_float4(a.x, a.y, b.x, b.y));
      store_out(out + 4, make_float4(e.x, e.y, f.x, f.y));
    }
  }
}

// DMAX: d rounded up to 64, 128 or 256; a thread keeps 4 x DMAX / 16
// accumulators.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int d,
                       int causal) {
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

  int n_tiles = Sk / kRows;
  if (causal) n_tiles = min(n_tiles, q0 / kRows + 1);
  for (int t = 0; t < n_tiles; ++t) {
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
        if (causal && k0 + tx + 16 * j > row) x = kNegInf;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float mn = fmaxf(m[i], mc);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
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
      store_out(ps + (tx + 16 * j) * kPStride + 4 * ty,
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
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
    T* o = out + (static_cast<size_t>(bh) * Sq + q0 + ty + 16 * i) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < d)
        store_out(o + col, make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                                       acc[i][c][2] / den, acc[i][c][3] / den));
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq,
                   int Sk, int d, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kRows * static_cast<size_t>(d + 4) + kRows * kPStride);
  auto kernel = flash_attention_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(Sq / kRows, BH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, d, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_d(const void* q, const void* k, const void* v, void* out, int BH, int Sq,
                         int Sk, int d, int causal, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, out, BH, Sq, Sk, d, causal, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, out, BH, Sq, Sk, d, causal, stream);
  return launch<T, 256>(q, k, v, out, BH, Sq, Sk, d, causal, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the attribute call's
// error). bf16 != 0: all four tensors are bf16, else f32. The caller has
// checked the shapes, alignment and 1 <= BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int BH, int Sq, int Sk, int d, int causal, int bf16,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_for_d<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, d, causal, st)
           : launch_for_d<float>(q, k, v, out, BH, Sq, Sk, d, causal, st);
  return static_cast<int>(err);
}
