// tau_leap_step: one fused dense tau-leap step of the PASS asynchronous
// model, all chains as the B rows of one launch.
//
//   acc  = int8(s) @ J^T                      (exact int32)
//   h    = f32(f32(acc) * f32(beta_r * scale)) + f32(beta_r * b_j)
//   rate = sigma((2 h) s)
//   p    = 1 - expf((-dt) * rate)
//   out  = u < p ? -s : s
//
// s: (B, N) f32 +-1, J: (N, N) int8, b: (N,) f32, scale: () f32, beta: (B,)
// f32, u: (B, N) f32, dt: () f32, out: (B, N) f32, s8: (B, ld) int8
// scratch, ld >= N a multiple of 16. Device scalars are read through
// pointers so the host never synchronises. Every multiply and add is
// written with the _rn intrinsics so nvcc cannot contract them into an
// FMA: each row rounds as a B = 1 JAX call with that row's beta folded into
// scale and b. out must not alias s: every block reads all of s while
// other blocks write.
//
// Two launches on the caller's stream, from one C launcher:
//  1. pack_spins converts the f32 spins to int8 once per step, as JAX's
//     astype(int8) does (truncation toward zero), into s8, zeroing the
//     padding columns N .. ld - 1. Every row of s8 starts on 16 bytes, so
//     the mainloop reads s in 16-byte cp.async copies at any N, and each
//     spin is converted once, not once per column block.
//  2. tau_leap_kernel runs the int8 mainloop (int8_field.cuh: 64 x 64
//     output tiles, split over k between the two blocks of a cluster, a
//     4-stage cp.async ring, 8 warps) and the epilogue above on the summed
//     int32 sums, each warp on 32 consecutive columns of a row: the reads of
//     s and u and the write of the new s are coalesced, and those reads are
//     issued before the mainloop, which hides their latency. It is a
//     programmatic dependent launch, so its blocks start while the packing
//     grid drains and wait for it only before the mainloop.
//
// The fault variant (kRowBias, entry point tau_leap_faults_launch): b is
// (B, N), the whole per-row bias b + eta, read per output with the loads of
// s and u, and the field is f32(f32(acc) * f32(beta_r * scale)) +
// f32(beta_r * b[r][j]); everything else is the base kernel.
#include "int8_field.cuh"

namespace {

constexpr int kPackThreads = 256;

// A spin as JAX's astype(int8) converts it (truncation toward zero), as a byte.
__device__ __forceinline__ uint32_t spin_byte(float v) {
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rz(v)));
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return spin_byte(a) | spin_byte(b) << 8 | spin_byte(c) << 16 | spin_byte(d) << 24;
}

// One thread per 4 bytes of s8: row r, columns 4w .. 4w + 3 (0 past N).
__global__ void __launch_bounds__(kPackThreads)
pack_spins_kernel(const float* __restrict__ s, int8_t* __restrict__ s8, int B, int N, int ld,
                  bool vec) {
  const int words = ld / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * words) return;
  const int r = static_cast<int>(idx / words), c = static_cast<int>(idx % words) * 4;
  const float* row = s + static_cast<size_t>(r) * N;
  uint32_t w;
  if (vec && c < N) {  // N % 4 == 0: the four columns are all live
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    w = pack4(v.x, v.y, v.z, v.w);
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < N ? row[c + e] : 0.0f;
    w = pack4(v[0], v[1], v[2], v[3]);
  }
  *reinterpret_cast<uint32_t*>(s8 + static_cast<size_t>(r) * ld + c) = w;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // s8 written
}

template <bool kRowBias>
__global__ void __cluster_dims__(1, 1, int8_field::SPLIT_K)
__launch_bounds__(int8_field::THREADS)
tau_leap_kernel(const float* __restrict__ s, const int8_t* __restrict__ s8, int ld,
                const int8_t* __restrict__ J, const float* __restrict__ b,
                const float* __restrict__ scale, const float* __restrict__ beta,
                const float* __restrict__ u, const float* __restrict__ dt,
                float* __restrict__ out, int B, int N, bool vec_j) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row0 = blockIdx.y * int8_field::BM, col0 = blockIdx.x * int8_field::BN;
  // The epilogue's inputs do not depend on the product: their loads are
  // issued before the mainloop, so their latency hides behind it.
  const int c = col0 + int8_field::out_col();
  float sv[int8_field::OUT_ITEMS], uv[int8_field::OUT_ITEMS], br[int8_field::OUT_ITEMS];
  float bv[kRowBias ? int8_field::OUT_ITEMS : 1];  // the per-row bias of each output
#pragma unroll
  for (int i = 0; i < int8_field::OUT_ITEMS; ++i) {
    const int r = row0 + int8_field::out_row(i);
    const bool live = r < B && c < N;
    const size_t at = static_cast<size_t>(r) * N + c;
    sv[i] = live ? s[at] : 0.0f;
    uv[i] = live ? u[at] : 0.0f;
    br[i] = live ? beta[r] : 0.0f;
    if constexpr (kRowBias) bv[i] = live ? b[at] : 0.0f;
  }
  const float bc = !kRowBias && c < N ? b[c] : 0.0f;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // pack_spins is done
  int8_field::mainloop(smem, s8, ld, J, B, N, N, row0, col0, true, vec_j);
  int acc[int8_field::OUT_ITEMS];
  int8_field::gather_outputs(smem, acc);
  if (c >= N) return;
  const float sc = *scale, neg_dt = -*dt;
#pragma unroll
  for (int i = 0; i < int8_field::OUT_ITEMS; ++i) {
    const int r = row0 + int8_field::out_row(i);
    if (r >= B) continue;
    const float bias = kRowBias ? bv[kRowBias ? i : 0] : bc;
    const float h = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), __fmul_rn(br[i], sc)),
                              __fmul_rn(br[i], bias));
    const float x = __fmul_rn(__fmul_rn(2.0f, h), sv[i]);
    const float rate = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
    const float p = __fsub_rn(1.0f, expf(__fmul_rn(neg_dt, rate)));
    out[static_cast<size_t>(r) * N + c] = uv[i] < p ? -sv[i] : sv[i];
  }
}

// Both launches of one step; kRowBias picks the product-and-flip kernel.
template <bool kRowBias>
int launch_step(const void* s, void* s8, const void* J, const void* b, const void* scale,
                const void* beta, const void* u, const void* dt, void* out, int B, int N, int ld,
                void* stream) {
  if (ld < N || ld % 16 != 0 || !int8_field::aligned16(s8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long words = static_cast<long long>(B) * (ld / 4);
  pack_spins_kernel<<<static_cast<unsigned>((words + kPackThreads - 1) / kPackThreads),
                      kPackThreads, 0, st>>>(
      static_cast<const float*>(s), static_cast<int8_t*>(s8), B, N, ld,
      N % 4 == 0 && int8_field::aligned16(s));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_j = N % 16 == 0 && int8_field::aligned16(J);
  const cudaError_t smem_err =
      cudaFuncSetAttribute(tau_leap_kernel<kRowBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int8_field::SMEM_BYTES);
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  // A programmatic dependent launch: its blocks may start once every
  // packing block has written its part of s8, before that grid retires,
  // and read s, u and beta; they wait (griddepcontrol.wait) for the grid's
  // completion only before the mainloop reads s8.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = int8_field::grid_for(B, N);
  config.blockDim = dim3(int8_field::THREADS);
  config.dynamicSmemBytes = int8_field::SMEM_BYTES;
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launch_err = cudaLaunchKernelEx(
      &config, tau_leap_kernel<kRowBias>, static_cast<const float*>(s),
      static_cast<const int8_t*>(s8), ld, static_cast<const int8_t*>(J),
      static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(beta), static_cast<const float*>(u),
      static_cast<const float*>(dt), static_cast<float*>(out), B, N, vec_j);
  if (launch_err != cudaSuccess) return static_cast<int>(launch_err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s8: (B, ld) int8 scratch, ld >= N a multiple of 16, on a 16-byte aligned
// base (the wrapper allocates it). b: (N,). Returns cudaGetLastError() after
// the second launch, or the first error (cudaErrorInvalidValue for a bad ld).
extern "C" int tau_leap_launch(const void* s, void* s8, const void* J, const void* b,
                               const void* scale, const void* beta, const void* u,
                               const void* dt, void* out, int B, int N, int ld,
                               void* stream) {
  return launch_step<false>(s, s8, J, b, scale, beta, u, dt, out, B, N, ld, stream);
}

// The fault variant: as tau_leap_launch with b (B, N), one bias row a chain.
extern "C" int tau_leap_faults_launch(const void* s, void* s8, const void* J, const void* b,
                                      const void* scale, const void* beta, const void* u,
                                      const void* dt, void* out, int B, int N, int ld,
                                      void* stream) {
  return launch_step<true>(s, s8, J, b, scale, beta, u, dt, out, B, N, ld, stream);
}
