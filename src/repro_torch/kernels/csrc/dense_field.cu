// dense_field: h = (s @ J^T) * scale + b with int8 operands and exact int32
// accumulation (the chip's int8-weight x binary-activation synapse).
//
// s: (B, N) int8 +-1, J: (N, N) int8 codes, b: (N,) f32, scale: () f32 on
// the device, out: (B, N) f32. The epilogue rounds as the JAX kernel does:
// f32(f32(acc) * scale) + b, with no FMA contraction. The product runs on
// the int8 mainloop of int8_field.cuh (64 x 64 output tiles split over k
// between the two blocks of a cluster, a 4-stage cp.async ring, 8 warps);
// s and J take 16-byte copies when N % 16 == 0 and the scalar path
// otherwise. The epilogue writes coalesced rows.
#include "int8_field.cuh"

namespace {

__global__ void __cluster_dims__(1, 1, int8_field::SPLIT_K)
__launch_bounds__(int8_field::THREADS)
dense_field_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ J,
                   const float* __restrict__ b, const float* __restrict__ scale,
                   float* __restrict__ out, int B, int N, bool vec_s, bool vec_j) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row0 = blockIdx.y * int8_field::BM, col0 = blockIdx.x * int8_field::BN;
  int8_field::mainloop(smem, s, N, J, B, N, N, row0, col0, vec_s, vec_j);
  int acc[int8_field::OUT_ITEMS];
  int8_field::gather_outputs(smem, acc);
  const int c = col0 + int8_field::out_col();
  if (c >= N) return;
  const float sc = *scale, bc = b[c];
#pragma unroll
  for (int i = 0; i < int8_field::OUT_ITEMS; ++i) {
    const int r = row0 + int8_field::out_row(i);
    if (r < B)
      out[static_cast<size_t>(r) * N + c] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), sc), bc);
  }
}

}  // namespace

extern "C" int dense_field_launch(const void* s, const void* J, const void* b,
                                  const void* scale, void* out, int B, int N,
                                  void* stream) {
  const bool vec = N % 16 == 0;
  const bool vec_s = vec && int8_field::aligned16(s);
  const bool vec_j = vec && int8_field::aligned16(J);
  const cudaError_t smem_err = cudaFuncSetAttribute(
      dense_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int8_field::SMEM_BYTES);
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  dense_field_kernel<<<int8_field::grid_for(B, N), int8_field::THREADS,
                       int8_field::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(J),
      static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<float*>(out), B, N, vec_s, vec_j);
  return static_cast<int>(cudaGetLastError());
}
