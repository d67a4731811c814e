// colored_gibbs_sweep: one chromatic Gibbs sweep over the C colour classes
// of a sparse graph, all chains as the B rows of one launch. Replaces the
// TPU kernel repro/kernels/sparse_gather.py::colored_gibbs_sweep.
// Memory-bound: at (256, 16384), D = 3, C = 4 it must move about 51 MB,
// 15 us at 3.35 TB/s, counting only the uniforms of the updated sites; the
// (C, B, n) layout of the uniforms spreads those over 45 MB of 32-byte
// sectors, so about 79 MB, 24 us, is the floor of any kernel that reads
// them in that layout (see kernels/sparse_gather.py).
//
// For each colour c in order, at every site i with masks[c][i] > 0.5, from
// the state before the phase:
//   h_i  = the in-order slot sum of sparse_gather.cuh
//   s[i] = u[c][r][i] < sigma(-2 * (beta_r * h_i)) ? +1 : -1
//
// The masks come as a colour plan (sparse_gather.colour_plan): for colour
// c, the entries offsets[c] .. offsets[c+1]-1, one per site of the colour
// in ascending order, each a row of P int32 (the D neighbour indices, pads,
// the site last) and a row of P f32 (the D couplings, pads, b_i last), P a
// multiple of 4 > D. So a phase reads contiguous table rows, one 16-byte
// load of each at D <= 3, and never the masks.
//
// s: (B, n) f32 +-1, u: (C, B, n), beta: (B,), out: (B, n) f32 (never
// aliasing s).
//
// Design: a block holds one chain (row) in shared memory as int8 +-1, in
// two buffers (2n bytes: 32 KB at n = 16384; two blocks of 1024 threads an
// SM). Phase c: each thread takes entries of the colour's list, two at a
// time; it loads both entries, then their uniforms u[c][r][site] (they
// depend on the site, not the spins), then gathers their fields from
// `cur`, and writes the new spins to `nxt`; barrier; the same entries copy
// `nxt` back to `cur`; barrier. A phase touches only its own sites, and
// every field of a phase sees the state before it, for any masks. What
// holds it back (chip_ablate.py, PERF.md): the uniforms' scattered sectors
// come from device memory while nothing else overlaps them, and the row's
// load and store bracket the phases.
//
// The per-sample variant (colored_gibbs_samples_kernel; entry point
// colored_gibbs_samples_launch): disorder samples' couplings over one
// neighbour table, the plan's weights (S, L, P), one sample's after another.
// The B rows are sample-major: block r sweeps row r with the weights of
// sample r / rows_per_sample, and everything else as above. Consecutive
// blocks, a sample's replicas, read the same 1 MB of weights (at L = 32,
// P = 8) at about the same time, so they share it through L2. Plan rows of
// P = 8 (the 3D lattice's D = 6) load as two 16-byte vectors each, an entry
// a thread at once (Entry8): at (512, 32768), S = 128, 0.19 ms a sweep
// against 0.39 ms with the one-table kernel's scalar loads of Entry<false>
// (chip_smoke.py's timing_samples; PERF.md).
//
// The fault variant (kFaults; entry point colored_gibbs_faults_launch)
// takes two more operands, each optional (a null pointer): bias, (B, n)
// f32, the whole per-row b + eta, read with the uniforms in place of the
// plan's b_i and added last as b_i is; keep, (B, n) uint8: where 0 the
// phase writes the old spin to `nxt`, so the copy back leaves it as it was
// (the JAX call with masks & keep).
#include "glauber.cuh"
#include "sparse_gather.cuh"

namespace {

// A site's table entry: its index, its bias and its D slots (at most 3 and
// held in registers when kPacked, P = 4).
template <bool kPacked>
struct Entry;

template <>
struct Entry<true> {
  int4 idx;
  float4 w;
  Entry() = default;
  __device__ __forceinline__ Entry(const int* tidx, const float* tw, int j, int) {
    idx = __ldg(reinterpret_cast<const int4*>(tidx) + j);
    w = __ldg(reinterpret_cast<const float4*>(tw) + j);
  }
  __device__ __forceinline__ int site() const { return idx.w; }
  __device__ __forceinline__ float bias() const { return w.w; }
  __device__ __forceinline__ float field(const int8_t* cur, int n, int D) const {
    const int ix[3] = {idx.x, idx.y, idx.z};
    const float wx[3] = {w.x, w.y, w.z};
    float acc[1] = {0.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k < D) sparse_gather::add_slot<1>(acc, cur, 0, ix[k], wx[k], n);
    return acc[0];
  }
};

template <>
struct Entry<false> {
  const int* idx;
  const float* w;
  int P;
  Entry() = default;
  __device__ __forceinline__ Entry(const int* tidx, const float* tw, int j, int P_)
      : idx(tidx + static_cast<size_t>(j) * P_), w(tw + static_cast<size_t>(j) * P_), P(P_) {}
  __device__ __forceinline__ int site() const { return __ldg(idx + P - 1); }
  __device__ __forceinline__ float bias() const { return __ldg(w + P - 1); }
  __device__ __forceinline__ float field(const int8_t* cur, int n, int D) const {
    float acc[1] = {0.0f};
    for (int k = 0; k < D; ++k)
      sparse_gather::add_slot<1>(acc, cur, 0, __ldg(idx + k), __ldg(w + k), n);
    return acc[0];
  }
};

// The entry of a plan of P = 8 columns (4 <= D <= 7), for the per-sample
// kernel: two 16-byte loads of indices and two of weights, held in
// registers. At kUnroll = 1 it keeps to the 32 registers without spills;
// at ea3d32.samples' shape it halves the sweep against Entry<false>.
struct Entry8 {
  int4 i0, i1;
  float4 w0, w1;
  Entry8() = default;
  __device__ __forceinline__ Entry8(const int* tidx, const float* tw, int j, int) {
    i0 = __ldg(reinterpret_cast<const int4*>(tidx) + 2 * j);
    i1 = __ldg(reinterpret_cast<const int4*>(tidx) + 2 * j + 1);
    w0 = __ldg(reinterpret_cast<const float4*>(tw) + 2 * j);
    w1 = __ldg(reinterpret_cast<const float4*>(tw) + 2 * j + 1);
  }
  __device__ __forceinline__ int site() const { return i1.w; }
  __device__ __forceinline__ float bias() const { return w1.w; }
  __device__ __forceinline__ float field(const int8_t* cur, int n, int D) const {
    const int ix[7] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z};
    const float wx[7] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z};
    float acc[1] = {0.0f};
#pragma unroll
    for (int k = 0; k < 7; ++k)
      if (k < D) sparse_gather::add_slot<1>(acc, cur, 0, ix[k], wx[k], n);
    return acc[0];
  }
};

// Entries a thread walks at once, their loads issued together (the
// one-table kernel's; the per-sample kernel walks Entry8 one at a time).
constexpr int kUnrollOneTable = 2;

__device__ __forceinline__ int8_t spin(float v) { return v > 0.0f ? 1 : -1; }

// The sweep of row blockIdx.x, its plan's weights at `tw`: entries of type
// E, kUnroll at once.
template <class E, int kUnroll, bool kFaults>
__device__ __forceinline__ void sweep_row(const float* __restrict__ s,
                                          const int* __restrict__ offsets,
                                          const int* __restrict__ tidx,
                                          const float* __restrict__ tw,
                                          const float* __restrict__ u,
                                          const float* __restrict__ beta,
                                          float* __restrict__ out, int B, int n, int D, int P,
                                          int C, const float* __restrict__ rbias,
                                          const uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* cur = smem;      // [n]
  int8_t* nxt = smem + n;  // [n]
  const int T = blockDim.x, t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const float br = __ldg(beta + blockIdx.x);
  // rows of whole 16-byte groups: s and out move 16 bytes a thread
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  if (vec) {
    char4* c4 = reinterpret_cast<char4*>(cur);
    sparse_gather::stream_in(reinterpret_cast<const float4*>(s + base), n >> 2, t, T,
                             [&](int q, float4 v) {
                               c4[q] = make_char4(spin(v.x), spin(v.y), spin(v.z), spin(v.w));
                             });
  } else {
    sparse_gather::stream_in(s + base, n, t, T, [&](int q, float v) { cur[q] = spin(v); });
  }
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const int beg = __ldg(offsets + c), end = __ldg(offsets + c + 1);
    const float* uc = u + static_cast<size_t>(c) * B * n;
    for (int j0 = beg + t; j0 < end; j0 += kUnroll * T) {
      E e[kUnroll];
      int site[kUnroll];
      float ur[kUnroll], h[kUnroll], bias[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)  // a missing entry repeats j0: the same spin is written twice
        e[q] = E(tidx, tw, j0 + q * T < end ? j0 + q * T : j0, P);
      bool kept[kFaults ? kUnroll : 1];  // the update is dropped: the old spin stays
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        site[q] = e[q].site();
        bias[q] = e[q].bias();
        ur[q] = __ldg(uc + base + site[q]);
        if constexpr (kFaults) {
          if (rbias) bias[q] = __ldg(rbias + base + site[q]);
          kept[q] = keep && __ldg(keep + base + site[q]) == 0;
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) h[q] = e[q].field(cur, n, D);
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int8_t v = ur[q] < glauber::prob_up(br, __fadd_rn(h[q], bias[q])) ? 1 : -1;
        if constexpr (kFaults) nxt[site[q]] = kept[q] ? cur[site[q]] : v;
        else nxt[site[q]] = v;
      }
    }
    __syncthreads();
    for (int j0 = beg + t; j0 < end; j0 += kUnroll * T) {
      int site[kUnroll];  // each entry's site, the last column of its row
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int j = j0 + q * T < end ? j0 + q * T : j0;
        site[q] = __ldg(tidx + static_cast<size_t>(j) * P + P - 1);
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) cur[site[q]] = nxt[site[q]];
    }
    __syncthreads();
  }

  if (vec) {
    const char4* c4 = reinterpret_cast<const char4*>(cur);
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int q = t; q < (n >> 2); q += T) {
      const char4 v = c4[q];
      o4[q] = make_float4(v.x, v.y, v.z, v.w);
    }
  } else {
    for (int i = t; i < n; i += T) out[base + i] = static_cast<float>(cur[i]);
  }
}

// Two 1024-thread blocks an SM: ptxas keeps the kernel to 32 registers.
template <bool kPacked, bool kFaults>
__global__ void __launch_bounds__(1024, 2)
colored_gibbs_kernel(const float* __restrict__ s, const int* __restrict__ offsets,
                     const int* __restrict__ tidx, const float* __restrict__ tw,
                     const float* __restrict__ u, const float* __restrict__ beta,
                     float* __restrict__ out, int B, int n, int D, int P, int C,
                     const float* __restrict__ rbias, const uint8_t* __restrict__ keep) {
  sweep_row<Entry<kPacked>, kUnrollOneTable, kFaults>(s, offsets, tidx, tw, u, beta, out, B, n, D,
                                                      P, C, rbias, keep);
}

// The per-sample sweep: row r takes sample r / rows_per_sample's weights,
// `wstride` (= L P) floats apart.
template <class E, int kUnroll>
__global__ void __launch_bounds__(1024, 2)
colored_gibbs_samples_kernel(const float* __restrict__ s, const int* __restrict__ offsets,
                             const int* __restrict__ tidx, const float* __restrict__ tw,
                             const float* __restrict__ u, const float* __restrict__ beta,
                             float* __restrict__ out, int B, int n, int D, int P, int C,
                             int rows_per_sample, size_t wstride) {
  const size_t sample = static_cast<size_t>(blockIdx.x / rows_per_sample);
  sweep_row<E, kUnroll, false>(s, offsets, tidx, tw + sample * wstride, u, beta, out, B, n, D, P,
                               C, nullptr, nullptr);
}

template <class E, int kUnroll>
cudaError_t launch_samples(const float* s, const int* offsets, const int* tidx, const float* tw,
                           const float* u, const float* beta, float* out, int B, int n, int D,
                           int P, int C, int threads, int rows_per_sample, int wstride,
                           cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(n);
  const cudaError_t err = glauber::allow_smem(colored_gibbs_samples_kernel<E, kUnroll>, smem);
  if (err != cudaSuccess) return err;
  colored_gibbs_samples_kernel<E, kUnroll><<<B, threads, smem, stream>>>(
      s, offsets, tidx, tw, u, beta, out, B, n, D, P, C, rows_per_sample,
      static_cast<size_t>(wstride));
  return cudaGetLastError();
}

template <bool kPacked, bool kFaults>
cudaError_t launch(const float* s, const int* offsets, const int* tidx, const float* tw,
                   const float* u, const float* beta, float* out, int B, int n, int D, int P,
                   int C, int threads, cudaStream_t stream, const float* rbias,
                   const uint8_t* keep) {
  const size_t smem = 2 * static_cast<size_t>(n);
  const cudaError_t err = glauber::allow_smem(colored_gibbs_kernel<kPacked, kFaults>, smem);
  if (err != cudaSuccess) return err;
  colored_gibbs_kernel<kPacked, kFaults><<<B, threads, smem, stream>>>(
      s, offsets, tidx, tw, u, beta, out, B, n, D, P, C, rbias, keep);
  return cudaGetLastError();
}

template <bool kFaults>
int launch_sweep(const void* s_, const void* offsets_, const void* tidx_, const void* tw_,
                 const void* u_, const void* beta_, void* out_, const void* rbias_,
                 const void* keep_, int B, int n, int D, int P, int C, int threads,
                 void* stream_) {
  const auto* s = static_cast<const float*>(s_);
  const auto* offsets = static_cast<const int*>(offsets_);
  const auto* tidx = static_cast<const int*>(tidx_);
  const auto* tw = static_cast<const float*>(tw_);
  const auto* u = static_cast<const float*>(u_);
  const auto* beta = static_cast<const float*>(beta_);
  auto* out = static_cast<float*>(out_);
  const auto* rbias = static_cast<const float*>(rbias_);
  const auto* keep = static_cast<const uint8_t*>(keep_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const cudaError_t err =
      P == 4 ? launch<true, kFaults>(s, offsets, tidx, tw, u, beta, out, B, n, D, P, C, threads,
                                     stream, rbias, keep)
             : launch<false, kFaults>(s, offsets, tidx, tw, u, beta, out, B, n, D, P, C, threads,
                                      stream, rbias, keep);
  return static_cast<int>(err);
}

}  // namespace

// One block of `threads` threads a chain. Returns cudaGetLastError() after
// the launch (or the attribute call's error). The caller has checked that
// 2n bytes fit in one block and that the plan has P % 4 == 0, P > D.
extern "C" int colored_gibbs_launch(const void* s, const void* offsets, const void* tidx,
                                    const void* tw, const void* u, const void* beta, void* out,
                                    int B, int n, int D, int P, int C, int threads,
                                    void* stream) {
  return launch_sweep<false>(s, offsets, tidx, tw, u, beta, out, nullptr, nullptr, B, n, D, P, C,
                             threads, stream);
}

// The fault variant: as colored_gibbs_launch with a (B, n) f32 bias and a
// (B, n) uint8 keep mask, either null when absent.
extern "C" int colored_gibbs_faults_launch(const void* s, const void* offsets, const void* tidx,
                                           const void* tw, const void* u, const void* beta,
                                           void* out, const void* bias, const void* keep, int B,
                                           int n, int D, int P, int C, int threads,
                                           void* stream) {
  return launch_sweep<true>(s, offsets, tidx, tw, u, beta, out, bias, keep, B, n, D, P, C,
                            threads, stream);
}

// The per-sample sweep: as colored_gibbs_launch over a plan whose weights are
// (S, L, P), `wstride` = L P floats a sample, block r taking sample
// r / rows_per_sample's (rows_per_sample = B / S >= 1).
extern "C" int colored_gibbs_samples_launch(const void* s, const void* offsets, const void* tidx,
                                            const void* tw, const void* u, const void* beta,
                                            void* out, int B, int n, int D, int P, int C,
                                            int threads, int rows_per_sample, int wstride,
                                            void* stream_) {
  if (rows_per_sample < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s_ = static_cast<const float*>(s);
  const auto* off = static_cast<const int*>(offsets);
  const auto* idx = static_cast<const int*>(tidx);
  const auto* w = static_cast<const float*>(tw);
  const auto* u_ = static_cast<const float*>(u);
  const auto* beta_ = static_cast<const float*>(beta);
  auto* out_ = static_cast<float*>(out);
  const auto stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;
  if (P == 4)
    err = launch_samples<Entry<true>, kUnrollOneTable>(s_, off, idx, w, u_, beta_, out_, B, n, D, P,
                                                       C, threads, rows_per_sample, wstride, stream);
  else if (P == 8)
    err = launch_samples<Entry8, 1>(s_, off, idx, w, u_, beta_, out_, B, n, D, P, C, threads,
                                    rows_per_sample, wstride, stream);
  else
    err = launch_samples<Entry<false>, kUnrollOneTable>(s_, off, idx, w, u_, beta_, out_, B, n, D,
                                                        P, C, threads, rows_per_sample, wstride,
                                                        stream);
  return static_cast<int>(err);
}
