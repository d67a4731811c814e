// tau_leap_step: one fused dense tau-leap step of the PASS asynchronous
// model, all chains as the B rows of one launch.
//
//   acc  = int8(s) @ J^T                      (exact int32)
//   h    = f32(f32(acc) * f32(beta_r * scale)) + f32(beta_r * b_j)
//   rate = sigma((2 h) s)
//   p    = 1 - expf((-dt) * rate)
//   out  = u < p ? -s : s
//
// s: (B, N) f32 +-1 (converted to int8 while its tile is loaded), J: (N, N)
// int8, b: (N,) f32, scale: () f32, beta: (B,) f32, u: (B, N) f32, dt: ()
// f32, out: (B, N) f32. Device scalars are read through pointers so the host
// never synchronises. Every multiply and add is written with the _rn
// intrinsics so nvcc cannot contract them into an FMA: each row rounds as a
// B = 1 JAX call with that row's beta folded into scale and b. out must not
// alias s: every block reads all of s while other blocks write.
#include "int8_field.cuh"

namespace {

__global__ void __launch_bounds__(int8_field::THREADS)
tau_leap_kernel(const float* __restrict__ s, const int8_t* __restrict__ J,
                const float* __restrict__ b, const float* __restrict__ scale,
                const float* __restrict__ beta, const float* __restrict__ u,
                const float* __restrict__ dt, float* __restrict__ out, int B, int N,
                bool vec_s, bool vec_j) {
  const int row0 = blockIdx.y * int8_field::BM, col0 = blockIdx.x * int8_field::BN;
  int8_field::Acc acc;
  int8_field::mainloop(acc, s, J, B, N, N, row0, col0, vec_s, vec_j);
  const float sc = *scale, neg_dt = -*dt;
  int8_field::for_each_output(acc, B, N, row0, col0, [&](int r, int c, int a) {
    const size_t i = static_cast<size_t>(r) * N + c;
    const float br = beta[r];
    const float h = __fadd_rn(__fmul_rn(__int2float_rn(a), __fmul_rn(br, sc)),
                              __fmul_rn(br, b[c]));
    const float sv = s[i];
    const float x = __fmul_rn(__fmul_rn(2.0f, h), sv);
    const float rate = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
    const float p = __fsub_rn(1.0f, expf(__fmul_rn(neg_dt, rate)));
    out[i] = u[i] < p ? -sv : sv;
  });
}

}  // namespace

extern "C" int tau_leap_launch(const void* s, const void* J, const void* b,
                               const void* scale, const void* beta, const void* u,
                               const void* dt, void* out, int B, int N, void* stream) {
  const bool vec_s = N % 4 == 0 && int8_field::aligned16(s);
  const bool vec_j = N % 16 == 0 && int8_field::aligned16(J);
  tau_leap_kernel<<<int8_field::grid_for(B, N), int8_field::THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int8_t*>(J),
      static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(beta), static_cast<const float*>(u),
      static_cast<const float*>(dt), static_cast<float*>(out), B, N, vec_s, vec_j);
  return static_cast<int>(cudaGetLastError());
}
