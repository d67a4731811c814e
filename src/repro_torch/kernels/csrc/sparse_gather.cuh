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
//
// `add_slot` applies one slot to R rows at once: the staged fields kernel
// loads a site's table entry once and shares it across the R rows a block
// holds (the sweep holds one chain a block: R = 1).
#pragma once

#include <cstdint>

namespace sparse_gather {

// acc[r] += w * rows[r * stride + j] for the R rows, in the slot order the
// caller walks; j outside [0, n) adds nothing.
template <int R, typename Spin>
__device__ __forceinline__ void add_slot(float (&acc)[R], const Spin* rows, size_t stride, int j,
                                         float w, int n) {
  if (static_cast<unsigned>(j) >= static_cast<unsigned>(n)) return;
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc[r] = __fadd_rn(acc[r], __fmul_rn(w, static_cast<float>(rows[r * stride + j])));
}

// Calls f(q, src[q]) for q = t, t + T, ... below `count`: a block of T
// threads streams `count` elements in, each thread with four loads in
// flight before it uses one.
template <typename V, typename F>
__device__ __forceinline__ void stream_in(const V* __restrict__ src, int count, int t, int T,
                                          F f) {
  int q = t;
  for (; q + 3 * T < count; q += 4 * T) {
    const V a0 = __ldg(src + q), a1 = __ldg(src + q + T);
    const V a2 = __ldg(src + q + 2 * T), a3 = __ldg(src + q + 3 * T);
    f(q, a0);
    f(q + T, a1);
    f(q + 2 * T, a2);
    f(q + 3 * T, a3);
  }
  for (; q < count; q += T) f(q, __ldg(src + q));
}

// The field of site i of one row `s`, read through the cache: the kernel
// for rows too long to stage in shared memory.
__device__ __forceinline__ float field(const float* __restrict__ s, const int* __restrict__ idx,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b, int i, int n, int D) {
  const size_t row = static_cast<size_t>(i) * D;
  float acc[1] = {0.0f};
  for (int k = 0; k < D; ++k) add_slot<1>(acc, s, 0, __ldg(idx + row + k), __ldg(w + row + k), n);
  return __fadd_rn(acc[0], __ldg(b + i));
}

}  // namespace sparse_gather
