// dense_field: h = (s @ J^T) * scale + b with int8 operands and exact int32
// accumulation (the chip's int8-weight x binary-activation synapse).
//
// s: (B, N) int8 +-1, J: (N, N) int8 codes, b: (N,) f32, scale: () f32 on
// the device, out: (B, N) f32. The epilogue rounds as the JAX kernel does:
// f32(f32(acc) * scale) + b, with no FMA contraction.
#include "int8_field.cuh"

namespace {

__global__ void __launch_bounds__(int8_field::THREADS)
dense_field_kernel(const int8_t* __restrict__ s, const int8_t* __restrict__ J,
                   const float* __restrict__ b, const float* __restrict__ scale,
                   float* __restrict__ out, int B, int N, bool vec_s, bool vec_j) {
  const int row0 = blockIdx.y * int8_field::BM, col0 = blockIdx.x * int8_field::BN;
  int8_field::Acc acc;
  int8_field::mainloop(acc, s, J, B, N, N, row0, col0, vec_s, vec_j);
  const float sc = *scale;
  int8_field::for_each_output(acc, B, N, row0, col0, [&](int r, int c, int a) {
    out[static_cast<size_t>(r) * N + c] =
        __fadd_rn(__fmul_rn(__int2float_rn(a), sc), b[c]);
  });
}

}  // namespace

extern "C" int dense_field_launch(const void* s, const void* J, const void* b,
                                  const void* scale, void* out, int B, int N,
                                  void* stream) {
  const bool vec = N % 16 == 0;
  const bool vec_s = vec && int8_field::aligned16(s);
  const bool vec_j = vec && int8_field::aligned16(J);
  dense_field_kernel<<<int8_field::grid_for(B, N), int8_field::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(J),
      static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<float*>(out), B, N, vec_s, vec_j);
  return static_cast<int>(cudaGetLastError());
}
