// The padded neighbour-list gather shared by sparse_fields.cu and
// colored_gibbs.cu.
//
//   h_i = ((0 + w[i][0] s[idx[i][0]]) + ... + w[i][D-1] s[idx[i][D-1]]) + b_i
//
// summed over the slots in order with one rounded multiply and one rounded
// add each (no FMA), as ref.sparse_fields_ref sums them. Padded slots point
// at the site itself with weight 0, so no degree mask is needed. An index
// outside [0, n) adds nothing instead of reading out of bounds
// (SparseIsing's constructors never make one; `validate` rejects it).
#pragma once

#include <cstdint>

namespace sparse_gather {

template <typename Spin>
__device__ __forceinline__ float field(const Spin* __restrict__ s, const int* __restrict__ idx,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b, int i, int n, int D) {
  const size_t row = static_cast<size_t>(i) * D;
  float acc = 0.0f;
  for (int k = 0; k < D; ++k) {
    const int j = __ldg(idx + row + k);
    if (static_cast<unsigned>(j) < static_cast<unsigned>(n))
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + row + k), static_cast<float>(s[j])));
  }
  return __fadd_rn(acc, __ldg(b + i));
}

}  // namespace sparse_gather
