// Row reductions shared by the two decode kernels, dndm_update.cu and
// decode_scores.cu, for Hopper (sm_90a).
//
// Each (b, n) row of the (B, N, K) logits is reduced to its first argmax
// of sel = a (+ gumbel), where a = f32(logit) / temperature + mask, and,
// for decode_scores, to an online logsumexp of a.  Both kernels are bound
// by bytes: every logit and Gumbel value is read once.  Two regimes,
// chosen by K alone in each kernel's C launcher:
//
//  * K < kBlockMinK: one warp per row, lanes striding over K with scalar
//    loads.  At the paper's K = 28 a row is one warp iteration and the
//    kernel takes the launch floor (about 3 us on an H100); nothing
//    larger would be faster there.
//  * K >= kBlockMinK: one block of kBlockThreads threads per row with
//    16-byte streaming loads.  At (4, 256, 32000) that is 1024 blocks,
//    under one wave.  Each thread holds kUnroll vectors of logits and of
//    Gumbel noise in flight (a float4 of f32 logits, or a uint4 of 8 bf16
//    logits with two float4 of noise): with 8 blocks of 128 threads on an
//    SM about 128 KB of loads are in flight per SM, where HBM at 3.35 TB/s
//    and about 1 us of latency needs some 25 KB (Little's law over 132
//    SMs).  The one-warp-per-row design before it kept about 8 KB in
//    flight per SM and reached a third of the bytes bound.
//
// Alignment is the kernel's: a row starts at row * K elements, which is
// not 16-byte aligned for odd K, for bf16 at K = 28, or for a view with an
// element offset.  The elements before the logits row's first 16-byte
// boundary (the head, at most 7) and after its last whole vector (the
// tail) are read with scalar loads.  The Gumbel row and the mask may sit
// at another phase of 16 bytes than the logits (the mask in most rows at
// odd K, the noise only for an offset view): their vectors are then cut
// out of one more aligned float4 load, the phase uniform over the row.
// Logits and noise are streamed (ld.global.cs: read once); the (K,) mask
// is read through the read-only cache, where all rows find it.
//
// Ties go to the lowest index in both regimes.  A thread's indices
// increase (its head element, then vectors j, j + T, j + 2T, ..., then its
// tail element), so a strict > keeps its lowest; every merge across
// threads (warp shuffles, then one partial per warp through shared
// memory) compares (value descending, index ascending).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rowsel {

// K from which a row gets a block: the smallest K of the regime sweep
// (chip_smoke.py --measure-decode, NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// §6) at which the block regime took less device time than the warp
// regime for both kernels at 1024 and 2048 rows (at K = 256 the warp
// regime was still faster at 2048 rows, at K = 512 no longer).
constexpr int kBlockMinK = 512;
constexpr int kBlockThreads = 128;  // block regime: threads per row
constexpr int kUnroll = 4;          // vectors in flight per thread
constexpr int kWarpsPerBlock = 8;   // warp regime: rows per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a = f32(logit) / temperature + mask, each step IEEE round-to-nearest
// (no fast math), in the op order of the plain version's adjust_logits.
__device__ __forceinline__ float adjust(float logit, float mask, bool scale,
                                        float temperature) {
  if (scale) logit = __fdiv_rn(logit, temperature);
  return __fadd_rn(logit, mask);
}

// ---------------------------------------------------------------------
// Accumulators: a partial reduction of some elements of a row.

// First argmax of sel.  An empty partial is (-inf, 0): it loses every
// merge with a finite value, and a row of only -inf gives index 0, the
// first maximum.
struct Argmax {
  float best;
  int idx;

  __device__ __forceinline__ void init() {
    best = -INFINITY;
    idx = 0;
  }
  // Elements come in increasing k within a thread.
  __device__ __forceinline__ void push(float sel, float, int k) {
    if (sel > best) {
      best = sel;
      idx = k;
    }
  }
  __device__ __forceinline__ void merge(const Argmax& o) {
    if (o.best > best || (o.best == best && o.idx < idx)) {
      best = o.best;
      idx = o.idx;
    }
  }
  __device__ __forceinline__ Argmax shfl_down(int off) const {
    Argmax o;
    o.best = __shfl_down_sync(0xffffffffu, best, off);
    o.idx = __shfl_down_sync(0xffffffffu, idx, off);
    return o;
  }
};

// First argmax of sel with the noise-free a at it, and the logsumexp of a
// as (m, s): m the largest a seen, s = sum exp(a - m).
struct ArgmaxLse {
  float best;
  int idx;
  float best_a;
  float m;
  float s;

  __device__ __forceinline__ void init() {
    best = -INFINITY;
    idx = 0;
    best_a = -INFINITY;
    m = -INFINITY;
    s = 0.0f;
  }
  // One expf per element: a new maximum rescales the sum, any other
  // element adds its term.  a = -inf adds nothing (and exp(-inf - -inf)
  // would be NaN).  The sum runs in another order than the plain
  // version's sum(exp(a - max a)): per thread along its elements, then
  // over the merge tree, so scores agree to a few ulps of s, not bitwise.
  __device__ __forceinline__ void push(float sel, float a, int k) {
    if (sel > best) {
      best = sel;
      idx = k;
      best_a = a;
    }
    if (a == -INFINITY) return;
    if (a > m) {
      s = __fadd_rn(__fmul_rn(s, expf(m - a)), 1.0f);
      m = a;
    } else {
      s = __fadd_rn(s, expf(a - m));
    }
  }
  // Merge the logsumexp partial (m2, s2):
  //   m' = max(m, m2),  s' = s exp(m - m') + s2 exp(m2 - m').
  // A side that holds nothing (-inf, 0) is skipped instead of merged.
  __device__ __forceinline__ void merge(const ArgmaxLse& o) {
    if (o.best > best || (o.best == best && o.idx < idx)) {
      best = o.best;
      idx = o.idx;
      best_a = o.best_a;
    }
    if (o.m == -INFINITY) return;
    if (m == -INFINITY) {
      m = o.m;
      s = o.s;
      return;
    }
    const float mn = fmaxf(m, o.m);
    s = __fadd_rn(__fmul_rn(s, expf(m - mn)), __fmul_rn(o.s, expf(o.m - mn)));
    m = mn;
  }
  __device__ __forceinline__ ArgmaxLse shfl_down(int off) const {
    ArgmaxLse o;
    o.best = __shfl_down_sync(0xffffffffu, best, off);
    o.idx = __shfl_down_sync(0xffffffffu, idx, off);
    o.best_a = __shfl_down_sync(0xffffffffu, best_a, off);
    o.m = __shfl_down_sync(0xffffffffu, m, off);
    o.s = __shfl_down_sync(0xffffffffu, s, off);
    return o;
  }
};

template <class Acc>
__device__ __forceinline__ void warp_reduce(Acc& acc) {
  for (int off = 16; off > 0; off >>= 1) acc.merge(acc.shfl_down(off));
}

// One scalar element of a row.
template <typename T, class Acc>
__device__ __forceinline__ void push_scalar(Acc& acc, const T* lrow,
                                            const float* grow,
                                            const float* mask, int k,
                                            bool scale, float temperature) {
  const float a = adjust(to_float(__ldcs(lrow + k)), __ldg(mask + k), scale,
                         temperature);
  acc.push(grow != nullptr ? __fadd_rn(a, __ldcs(grow + k)) : a, a, k);
}

// ---------------------------------------------------------------------
// Warp regime: one warp per row, lanes striding over K.  The row's
// result ends in lane 0.
template <typename T, class Acc>
__device__ __forceinline__ void warp_row(Acc& acc, const T* lrow,
                                         const float* grow,
                                         const float* mask, int K,
                                         float temperature) {
  const bool scale = temperature != 1.0f;
  acc.init();
  for (int k = threadIdx.x % 32; k < K; k += 32)
    push_scalar(acc, lrow, grow, mask, k, scale, temperature);
  warp_reduce(acc);
}

// ---------------------------------------------------------------------
// Block regime.

// 16 bytes of logits: 4 f32 or 8 bf16 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* out) {
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* out) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the top half of the f32 with the same bits: exact
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// How the Gumbel row lies against the logits row's 16-byte vectors.  The
// aligned case has its own instantiation: with f32 logits at (4, 256,
// 32000) the shifted code at phase 0 took 25-30% more device time
// (chip_smoke.py --measure-decode, its noise-phase check; PERF.md §6).
enum Noise { kNoNoise = 0, kNoiseAligned = 1, kNoiseShifted = 2 };

// Aligned float4 loads that cover N f32 values starting `phase` elements
// past a 16-byte boundary: N / 4 of them, one more if phase != 0 (that
// one holds at least one of the N values, so it lies inside the tensor).
template <int N, bool kStream>
__device__ __forceinline__ void load_f32(const float* p, int phase,
                                         float4 (&raw)[N / 4 + 1]) {
  const float4* a = reinterpret_cast<const float4*>(p - phase);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    raw[i] = kStream ? __ldcs(a + i) : __ldg(a + i);
  raw[N / 4] = phase == 0   ? make_float4(0.f, 0.f, 0.f, 0.f)
               : kStream    ? __ldcs(a + N / 4)
                            : __ldg(a + N / 4);
}

// out[i] = the (phase + i)-th value of raw, phase uniform: static
// register indices and selects, no local memory.
template <int N>
__device__ __forceinline__ void select_f32(const float4 (&raw)[N / 4 + 1],
                                           int phase, float (&out)[N]) {
  float v[N + 4];
#pragma unroll
  for (int i = 0; i <= N / 4; ++i) {
    v[4 * i] = raw[i].x;
    v[4 * i + 1] = raw[i].y;
    v[4 * i + 2] = raw[i].z;
    v[4 * i + 3] = raw[i].w;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = phase == 0 ? v[i]
             : phase == 1 ? v[i + 1]
             : phase == 2 ? v[i + 2]
                          : v[i + 3];
}

// Thread tid's partial of one row: its head element (k = tid < head),
// then vectors tid, tid + T, tid + 2T, ... (kUnroll of them loaded before
// any is used), then its tail element.  head is the count of elements
// before the logits row's first 16-byte boundary.
template <typename T, int kNoise, class Acc>
__device__ __forceinline__ void block_row_partial(Acc& acc, const T* lrow,
                                                  const float* grow,
                                                  const float* mask, int K,
                                                  float temperature) {
  constexpr int V = Vec<T>::kElems;
  const int tid = threadIdx.x;
  const bool scale = temperature != 1.0f;
  const int head = min(
      K, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(lrow) & 15)) &
                           15) / sizeof(T)));
  const int nvec = (K - head) / V;
  const int tail = head + nvec * V;
  // phases of the Gumbel row and the mask at the first vector; every
  // vector is V elements (a multiple of 4) later, so they hold row-wide
  // (0 at compile time unless the noise is shifted)
  const int gphase =
      kNoise != kNoiseShifted
          ? 0
          : static_cast<int>(
                (reinterpret_cast<uintptr_t>(grow + head) >> 2) & 3);
  const int mphase =
      static_cast<int>((reinterpret_cast<uintptr_t>(mask + head) >> 2) & 3);
  const float* gnoise = kNoise == kNoNoise ? nullptr : grow;

  acc.init();
  if (tid < head)
    push_scalar(acc, lrow, gnoise, mask, tid, scale, temperature);
  for (int base = 0; base < nvec; base += kBlockThreads * kUnroll) {
    typename Vec<T>::Raw lraw[kUnroll];
    float4 graw[kUnroll][V / 4 + 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + tid + u * kBlockThreads;
      if (v < nvec) {
        const int k0 = head + v * V;
        lraw[u] = Vec<T>::load(lrow + k0);
        if (kNoise != kNoNoise) load_f32<V, true>(grow + k0, gphase, graw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + tid + u * kBlockThreads;
      if (v < nvec) {
        const int k0 = head + v * V;
        float l[V], mk[V], g[V];
        Vec<T>::unpack(lraw[u], l);
        float4 mraw[V / 4 + 1];
        load_f32<V, false>(mask + k0, mphase, mraw);
        select_f32<V>(mraw, mphase, mk);
        if (kNoise != kNoNoise) select_f32<V>(graw[u], gphase, g);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float a = adjust(l[i], mk[i], scale, temperature);
          acc.push(kNoise != kNoNoise ? __fadd_rn(a, g[i]) : a, a, k0 + i);
        }
      }
    }
  }
  if (tail + tid < K)
    push_scalar(acc, lrow, gnoise, mask, tail + tid, scale, temperature);
}

// The row's result in thread 0 of the block.
template <typename T, int kNoise, class Acc>
__device__ __forceinline__ void block_row(Acc& acc, const T* lrow,
                                          const float* grow,
                                          const float* mask, int K,
                                          float temperature) {
  __shared__ Acc partial[kBlockThreads / 32];
  block_row_partial<T, kNoise>(acc, lrow, grow, mask, K, temperature);
  warp_reduce(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    // the merge is lexicographic, so the tree's order cannot move a tie
    if (lane < kBlockThreads / 32)
      acc = partial[lane];
    else
      acc.init();
    warp_reduce(acc);
  }
}

// The Noise case of a launch: whether the Gumbel row lies at the same
// 16-byte phase as the logits row at the logits' first boundary.  The
// relative phase is the same for every row (rows advance by K elements in
// both), so row 0 decides.
template <typename T>
inline int noise_case(const void* logits, const void* gumbel) {
  if (gumbel == nullptr) return kNoNoise;
  const uintptr_t l = reinterpret_cast<uintptr_t>(logits);
  const uintptr_t head = ((16 - (l & 15)) & 15) / sizeof(T);
  const uintptr_t g = reinterpret_cast<uintptr_t>(gumbel) + 4 * head;
  return (g & 15) == 0 ? kNoiseAligned : kNoiseShifted;
}

}  // namespace rowsel
