// Shared pieces of the chromatic Gibbs sweeps (lattice_gibbs.cu,
// colored_gibbs.cu): the Glauber conditional and the launch-time set-up of
// a block's dynamic shared memory (sparse_energy.cu's too).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace glauber {

// P(s = +1 | h) at inverse temperature beta: sigma(-2 * (beta * h)), in the
// JAX multiply order, with sigma(x) = 1 / (1 + exp(-x)) as torch.sigmoid
// computes it on the card. The _rn intrinsics keep nvcc from contracting
// anything into an FMA.
__device__ __forceinline__ float prob_up(float beta, float h) {
  const float x = __fmul_rn(-2.0f, __fmul_rn(beta, h));
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// A block that asks for more than the default 48 KB of dynamic shared
// memory must be allowed it first, or its launch is refused.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int threads_for(long long sites) {
  const long long t = (sites + 31) / 32 * 32;
  return static_cast<int>(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

}  // namespace glauber
