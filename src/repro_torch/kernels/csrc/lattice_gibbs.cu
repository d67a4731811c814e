// lattice_gibbs_sweep: one chromatic Gibbs sweep on the king's-move lattice,
// all chains as the B rows of one launch. Replaces the TPU kernel
// repro/kernels/lattice_gibbs.py::lattice_gibbs_sweep. Memory-bound: at
// (4096, 16, 16) it must move about 12.6 MB, 3.8 us at 3.35 TB/s; a colour's
// uniforms touch every 32-byte sector of half the lattice rows, so about
// 16.8 MB, 5.0 us, is the floor of any kernel that reads them in the
// (C, B, H, W) layout (the counts: kernels/lattice_gibbs.py).
//
// For each colour c in order, at every site p of the colour that is not
// frozen, from the state before the phase:
//   h    = ((0 + w[0][p] s[p+o0]) + w[1][p] s[p+o1]) + ... + w[7][p] s[p+o7]) + b[p]
//   up   = u[c][r][p] < sigma(-2 * (beta_r * h))
//   s[p] = up ? +1 : -1
// then out = frozen ? clamp_value : s. The offsets o_k are KING_OFFSETS in
// order; a neighbour beyond the edge is skipped, which is exact: the JAX
// stencil adds w * 0 = +-0 there to a sum that is never -0.
//
// In bf16 every add and multiply of the stencil rounds to bf16, as torch
// and XLA compute a bf16 op (in f32, then rounded to nearest even):
//   acc = bf16(acc + bf16(w[k][p] s[p+ok])),  h = bf16(acc + b[p]);
// h is then promoted to f32 for sigma(-2 * (beta_r * h)), and the bf16
// uniform is compared with that f32 p_up.
//
// Two kernels, chosen by the wrapper from the lattice plan
// (kernels/lattice_gibbs.py::lattice_plan), never as a fallback:
//
// lattice_gibbs_plan — when every colour's list of updated sites is an
//   independent set of the king graph (the king colouring, the CAL path),
//   there are at most 4 colours and no list is longer than 1024. A site's
//   field then never reads a site of its own phase, so the block updates its
//   one chain in place: one int8 buffer in shared memory, no copy pass. The
//   plan lists, per colour, the updated sites in ascending order, each as
//   (site << 8 | edge bits) and a row of 12 f32 (the 8 weights, 0 for a
//   neighbour beyond the edge, b, three pads: three 16-byte loads). Thread t
//   owns entry t of every list (at 16x16 one 2x2 cell a thread, 64 threads a
//   block): it loads its C entries and their uniforms before the chain, so
//   the C device-memory trips of the uniforms overlap with each other and
//   with the chain's load; each phase then reads its weights (L1-resident:
//   12 KB at 16x16) and 8 neighbours from shared memory, writes its own site
//   and ends in one barrier. The sweep is bound by instructions issued
//   (about 1M site updates), so the stencil has no edge test and no
//   multiply: a zero weight beyond the edge (the chain sits between two
//   halos of shared memory) and a sign flip for w * s. Frozen sites keep
//   their input spin through the phases; at the end they are marked 0 in
//   shared memory and written with the plan's clamp values, and every other
//   site is written from shared memory.
//
// lattice_gibbs_generic — any other masks, more colours or longer lists
//   (lattices above 64x64; the first port's design): a block holds `cpb`
//   whole chains in two int8 buffers; each phase reads one and writes every
//   site of the other (the proposal or the old spin), then one barrier, then
//   the buffers swap. So every field of a phase sees the
//   state before the phase for any masks, as in JAX. w, b and the masks
//   are read through the read-only cache.
//
// s: (B, H, W) +-1, u: (C, B, H, W), out: (B, H, W) (never aliasing s), all
// f32 or all bf16 with the generic kernel's w (8, H, W), b, frozen and
// clamp (H, W) and colors (C, H, W) {0,1}; beta: (B,) f32.
//
// The fault variants (kFaults, f32 only; entry points
// lattice_gibbs_faults_launch and lattice_gibbs_generic_faults_launch) take
// two more operands, each optional (a null pointer):
//   bias: (B, H, W) f32, the whole per-row bias b + eta, read in place of
//         b[p] and added last as b is: h = acc + bias[r][p];
//   keep: (B, H, W) uint8; where 0 the site keeps its spin in every phase
//         (the JAX call with colors & keep).
// The plan kernel loads a thread's bias and keep entries with its uniforms,
// before the chain, and simply does not write a kept site; the generic
// kernel copies the kept site's old spin to the other buffer, as it does
// for every site outside the phase's colour.
#include <cuda_bf16.h>

#include <cstdint>

#include "glauber.cuh"

namespace {

__constant__ int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// -- the plan kernel -----------------------------------------------------------

// Colours whose entry a thread holds in registers from the start: the king
// colouring's four.
constexpr int kMaxColours = 4;
constexpr int kNoEntry = -1;  // entry codes are site << 8 | edges >= 0

__device__ __forceinline__ int8_t spin(float v) { return v > 0.0f ? 1 : -1; }

// Four consecutive spins of s as one load: 16 bytes of f32, 8 of bf16.
__device__ __forceinline__ char4 load_spins4(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return make_char4(spin(v.x), spin(v.y), spin(v.z), spin(v.w));
}
__device__ __forceinline__ char4 load_spins4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_char4(spin(__uint_as_float(v.x << 16)), spin(__uint_as_float(v.x & 0xFFFF0000u)),
                    spin(__uint_as_float(v.y << 16)), spin(__uint_as_float(v.y & 0xFFFF0000u)));
}

// Four +-1 spins stored as one 16-byte (f32) or 8-byte (bf16) write.
__device__ __forceinline__ void store_spins4(float* p, char4 v) {
  *reinterpret_cast<float4*>(p) = make_float4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ unsigned bf16_bits(int8_t v) { return v > 0 ? 0x3F80u : 0xBF80u; }
__device__ __forceinline__ void store_spins4(__nv_bfloat16* p, char4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v.x) | bf16_bits(v.y) << 16,
                                            bf16_bits(v.z) | bf16_bits(v.w) << 16);
}

// Bytes of shared memory before and after the chains, so that a site's
// neighbour beyond the lattice's edge reads some byte of the block's
// allocation (its weight is 0 in the plan); a multiple of 16, so the chains
// stay 16-byte aligned.
__host__ __device__ __forceinline__ int halo_bytes(int W) { return (W + 1 + 15) & ~15; }

// w * s for s = +-1 held as int8: w with its sign flipped where s < 0,
// which is the rounded product exactly (and +-0 for a zero weight).
__device__ __forceinline__ float times_spin(float w, int8_t s) {
  return __int_as_float(__float_as_int(w) ^ (static_cast<int>(s) & static_cast<int>(0x80000000)));
}

// The new spin of plan entry j (code = site << 8 | edges) of the chain `ch`
// in shared memory, from its uniform and the row's beta. The plan's weight
// of a neighbour beyond the edge is 0: adding w * s = +-0 there leaves the
// sum as skipping it does (the sum is never -0).
// kRowBias: `row_bias` (the fault variant's b + eta) in place of the plan's b.
template <typename T, bool kRowBias = false>
__device__ __forceinline__ int8_t update(const int8_t* ch, int code, const float* __restrict__ pw,
                                         int j, int W, float uv, float br, float row_bias = 0.0f) {
  const float4* row = reinterpret_cast<const float4*>(pw) + 3 * static_cast<size_t>(j);
  const float4 w0 = __ldg(row), w1 = __ldg(row + 1);
  const float bias = kRowBias ? row_bias : __ldg(row + 2).x;
  const float wk[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int8_t* c = ch + (code >> 8);
  const int8_t nb[8] = {c[-W - 1], c[-W], c[-W + 1], c[-1], c[1], c[W - 1], c[W], c[W + 1]};
  T acc = round_to<T>(0.0f);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = round_to<T>(__fadd_rn(to_f32(acc), times_spin(wk[k], nb[k])));
  const T h = round_to<T>(__fadd_rn(to_f32(acc), bias));
  return uv < glauber::prob_up(br, to_f32(h)) ? 1 : -1;
}

// Two 1024-thread blocks an SM in the bounds: ptxas keeps the kernel to 32
// registers, so 32 blocks of 64 threads fill an SM (the 4096 CAL chains in
// one wave).
template <typename T, bool kFaults>
__global__ void __launch_bounds__(1024, 2)
lattice_gibbs_plan(const T* __restrict__ s, const int* __restrict__ offsets,
                   const int* __restrict__ entry, const float* __restrict__ pw,
                   const T* __restrict__ u, const float* __restrict__ beta,
                   const int* __restrict__ fsite, const float* __restrict__ fval,
                   T* __restrict__ out, int B, int H, int W, int C, int F,
                   const float* __restrict__ bias, const uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) int8_t smem[];  // halo, [H * W], halo
  const int HW = H * W, t = threadIdx.x, T_ = blockDim.x, r = blockIdx.x;
  int8_t* ch = smem + halo_bytes(W);
  const float br = __ldg(beta + r);
  const size_t base = static_cast<size_t>(r) * HW, plane = static_cast<size_t>(B) * HW;
  const T* ur = u + base;

  // This thread's entry of each colour and its uniform, before the chain.
  int code[kMaxColours];
  float uv[kMaxColours];
#pragma unroll
  for (int c = 0; c < kMaxColours; ++c) {
    code[c] = kNoEntry;
    if (c < C) {
      const int j = __ldg(offsets + c) + t;
      if (j < __ldg(offsets + c + 1)) code[c] = __ldg(entry + j);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxColours; ++c)
    uv[c] = code[c] != kNoEntry ? to_f32(__ldg(ur + c * plane + (code[c] >> 8))) : 0.0f;
  // The fault variant's entries: each site's b + eta (the plan's b without
  // one) and whether its update survives.
  float bv[kFaults ? kMaxColours : 1];
  unsigned kept = 0;  // bit c: entry c keeps its spin (its keep byte is 0)
  if constexpr (kFaults) {
#pragma unroll
    for (int c = 0; c < kMaxColours; ++c) {
      const int p = code[c] >> 8;
      const bool live = code[c] != kNoEntry;
      bv[c] = !live ? 0.0f
              : bias ? __ldg(bias + base + p)
                     : __ldg(pw + 12 * static_cast<size_t>(__ldg(offsets + c) + t) + 8);
      kept |= static_cast<unsigned>(live && keep && __ldg(keep + base + p) == 0) << c;
    }
  }

  // The chain into shared memory as int8 +-1.
  const bool vec = (HW & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(s) & (4 * sizeof(T) - 1)) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & (4 * sizeof(T) - 1)) == 0;
  if (vec) {
    char4* c4 = reinterpret_cast<char4*>(ch);
#pragma unroll 4
    for (int q = t; q < (HW >> 2); q += T_) c4[q] = load_spins4(s + base + 4 * static_cast<size_t>(q));
  } else {
#pragma unroll 4
    for (int i = t; i < HW; i += T_) ch[i] = spin(to_f32(s[base + i]));
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < kMaxColours; ++c) {
    if (c >= C) break;
    if constexpr (kFaults) {
      if (code[c] != kNoEntry && !(kept >> c & 1u))
        ch[code[c] >> 8] =
            update<T, true>(ch, code[c], pw, __ldg(offsets + c) + t, W, uv[c], br, bv[c]);
    } else {
      if (code[c] != kNoEntry)
        ch[code[c] >> 8] = update<T>(ch, code[c], pw, __ldg(offsets + c) + t, W, uv[c], br);
    }
    __syncthreads();
  }

  // Frozen sites: their clamp values, and a 0 in shared memory that keeps
  // the pass below off them.
  if (F > 0) {
    for (int f = t; f < F; f += T_) {
      const int p = __ldg(fsite + f);
      ch[p] = 0;
      out[base + p] = round_to<T>(__ldg(fval + f));
    }
    __syncthreads();
  }
  if (vec) {
    const char4* c4 = reinterpret_cast<const char4*>(ch);
    for (int q = t; q < (HW >> 2); q += T_) {
      const char4 v = c4[q];
      T* o = out + base + 4 * static_cast<size_t>(q);
      if (v.x && v.y && v.z && v.w) {
        store_spins4(o, v);
      } else {
        if (v.x) o[0] = round_to<T>(v.x);
        if (v.y) o[1] = round_to<T>(v.y);
        if (v.z) o[2] = round_to<T>(v.z);
        if (v.w) o[3] = round_to<T>(v.w);
      }
    }
  } else {
    for (int i = t; i < HW; i += T_)
      if (ch[i]) out[base + i] = round_to<T>(ch[i]);
  }
}

// -- the generic kernel --------------------------------------------------------

template <typename T, bool kFaults>
__global__ void __launch_bounds__(1024)
lattice_gibbs_generic(const T* __restrict__ s, const T* __restrict__ w,
                     const T* __restrict__ b, const T* __restrict__ u,
                     const T* __restrict__ colors, const T* __restrict__ frozen,
                     const T* __restrict__ clampv, const float* __restrict__ beta,
                     T* __restrict__ out, int B, int H, int W, int C, int cpb,
                     const float* __restrict__ bias, const uint8_t* __restrict__ keep) {
  extern __shared__ int8_t smem[];
  const int HW = H * W;
  const int r0 = blockIdx.x * cpb;
  const int sites = min(cpb, B - r0) * HW;
  int8_t* cur = smem;
  int8_t* nxt = smem + static_cast<size_t>(cpb) * HW;
  const size_t base = static_cast<size_t>(r0) * HW;

  for (int i = threadIdx.x; i < sites; i += blockDim.x)
    cur[i] = to_f32(s[base + i]) > 0.0f ? 1 : -1;
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const T* col = colors + static_cast<size_t>(c) * HW;
    const T* uc = u + static_cast<size_t>(c) * B * HW + base;
    for (int i = threadIdx.x; i < sites; i += blockDim.x) {
      const int r = i / HW, p = i - r * HW;
      int8_t v = cur[i];
      bool upd = to_f32(__ldg(col + p)) > 0.5f && to_f32(__ldg(frozen + p)) <= 0.5f;
      if constexpr (kFaults) upd = upd && !(keep && __ldg(keep + base + i) == 0);
      if (upd) {
        const int y = p / W, x = p - y * W;
        const int8_t* chain = cur + static_cast<size_t>(r) * HW;
        T acc = round_to<T>(0.0f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int yy = y + kDy[k], xx = x + kDx[k];
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const T ws = round_to<T>(__fmul_rn(to_f32(__ldg(w + static_cast<size_t>(k) * HW + p)),
                                               static_cast<float>(chain[yy * W + xx])));
            acc = round_to<T>(__fadd_rn(to_f32(acc), to_f32(ws)));
          }
        }
        float bp = to_f32(__ldg(b + p));
        if constexpr (kFaults) bp = bias ? __ldg(bias + base + i) : bp;
        const T h = round_to<T>(__fadd_rn(to_f32(acc), bp));
        v = to_f32(uc[i]) < glauber::prob_up(beta[r0 + r], to_f32(h)) ? 1 : -1;
      }
      nxt[i] = v;
    }
    __syncthreads();
    int8_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = threadIdx.x; i < sites; i += blockDim.x) {
    const int p = i % HW;
    out[base + i] = to_f32(__ldg(frozen + p)) > 0.5f ? __ldg(clampv + p)
                                                     : round_to<T>(static_cast<float>(cur[i]));
  }
}

template <typename T, bool kFaults = false>
cudaError_t launch_generic(const void* s, const void* w, const void* b, const void* u,
                   const void* colors, const void* frozen, const void* clampv, const void* beta,
                   void* out, int B, int H, int W, int C, cudaStream_t stream,
                   const void* bias = nullptr, const void* keep = nullptr) {
  const int HW = H * W;
  int cpb = HW >= 1024 ? 1 : 1024 / HW;
  if (cpb > B) cpb = B;
  const size_t smem = 2 * static_cast<size_t>(cpb) * HW;
  cudaError_t err = glauber::allow_smem(lattice_gibbs_generic<T, kFaults>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + cpb - 1) / cpb;
  lattice_gibbs_generic<T, kFaults><<<blocks, glauber::threads_for(static_cast<long long>(cpb) * HW),
                                      smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(u), static_cast<const T*>(colors), static_cast<const T*>(frozen),
      static_cast<const T*>(clampv), static_cast<const float*>(beta), static_cast<T*>(out), B, H,
      W, C, cpb, static_cast<const float*>(bias), static_cast<const uint8_t*>(keep));
  return cudaGetLastError();
}


template <typename T, bool kFaults = false>
cudaError_t launch_plan(const void* s, const void* offsets, const void* entry, const void* pw,
                        const void* u, const void* beta, const void* fsite, const void* fval,
                        void* out, int B, int H, int W, int C, int F, int threads,
                        cudaStream_t stream, const void* bias = nullptr,
                        const void* keep = nullptr) {
  const size_t smem = static_cast<size_t>(H) * W + 2 * halo_bytes(W);
  const cudaError_t err = glauber::allow_smem(lattice_gibbs_plan<T, kFaults>, smem);
  if (err != cudaSuccess) return err;
  lattice_gibbs_plan<T, kFaults><<<B, threads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const int*>(offsets), static_cast<const int*>(entry),
      static_cast<const float*>(pw), static_cast<const T*>(u), static_cast<const float*>(beta),
      static_cast<const int*>(fsite), static_cast<const float*>(fval), static_cast<T*>(out), B, H,
      W, C, F, static_cast<const float*>(bias), static_cast<const uint8_t*>(keep));
  return cudaGetLastError();
}

}  // namespace

// The generic kernel. Returns cudaGetLastError() after the launch (or the
// attribute call's error). bf16 != 0: the seven operands and out are bf16,
// else f32. The caller has checked that 2 * H * W bytes fit in one block.
extern "C" int lattice_gibbs_generic_launch(const void* s, const void* w, const void* b,
                                    const void* u, const void* colors, const void* frozen,
                                    const void* clampv, const void* beta, void* out, int B,
                                    int H, int W, int C, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_generic<__nv_bfloat16>(s, w, b, u, colors, frozen, clampv, beta, out, B, H, W,
                                         C, st)
         : launch_generic<float>(s, w, b, u, colors, frozen, clampv, beta, out, B, H, W, C, st);
  return static_cast<int>(err);
}

// The plan kernel: one chain a block of `threads` threads. Returns
// cudaGetLastError() after the launch (or the attribute call's error).
// bf16 != 0: s, u and out are bf16, else f32. The caller has checked that
// the plan's lists are independent sets, that C <= 4, that no list is
// longer than `threads` <= 1024, and that H * W bytes and the halos fit in
// one block.
extern "C" int lattice_gibbs_launch(const void* s, const void* offsets, const void* entry,
                                    const void* pw, const void* u, const void* beta,
                                    const void* fsite, const void* fval, void* out, int B, int H,
                                    int W, int C, int F, int threads, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_plan<__nv_bfloat16>(s, offsets, entry, pw, u, beta, fsite, fval, out, B, H, W,
                                        C, F, threads, st)
           : launch_plan<float>(s, offsets, entry, pw, u, beta, fsite, fval, out, B, H, W, C, F,
                                threads, st);
  return static_cast<int>(err);
}

// The fault variant of the generic kernel, f32 only: as
// lattice_gibbs_generic_launch with a (B, H, W) f32 bias and a (B, H, W)
// uint8 keep mask, either null when absent.
extern "C" int lattice_gibbs_generic_faults_launch(const void* s, const void* w, const void* b,
                                                   const void* u, const void* colors,
                                                   const void* frozen, const void* clampv,
                                                   const void* beta, void* out, const void* bias,
                                                   const void* keep, int B, int H, int W, int C,
                                                   void* stream) {
  return static_cast<int>(launch_generic<float, true>(s, w, b, u, colors, frozen, clampv, beta,
                                                      out, B, H, W, C,
                                                      static_cast<cudaStream_t>(stream), bias,
                                                      keep));
}

// The fault variant of the plan kernel, f32 only: as lattice_gibbs_launch
// with a (B, H, W) f32 bias and a (B, H, W) uint8 keep mask, either null
// when absent.
extern "C" int lattice_gibbs_faults_launch(const void* s, const void* offsets, const void* entry,
                                           const void* pw, const void* u, const void* beta,
                                           const void* fsite, const void* fval, void* out,
                                           const void* bias, const void* keep, int B, int H,
                                           int W, int C, int F, int threads, void* stream) {
  return static_cast<int>(launch_plan<float, true>(s, offsets, entry, pw, u, beta, fsite, fval,
                                                   out, B, H, W, C, F, threads,
                                                   static_cast<cudaStream_t>(stream), bias,
                                                   keep));
}
