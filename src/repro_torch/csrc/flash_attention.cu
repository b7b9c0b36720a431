// Flash attention (online softmax) for Hopper, sm_90a, on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py: _flash_kernel (launcher flash_attention_kernel).  Same
// function, for self-attention over one sequence length S:
//
//   s   = q k^T / sqrt(hd) + bias,   bias = 0 where the key is visible,
//                                    -1e9 where causal/window hides it
//   out = softmax(s) v               running m, l and acc in f32;
//                                    l clamped at 1e-30; out in q's dtype
//
// Differences from the TPU kernel, both exact: the mask is built in the
// kernel from (causal, window) with the additive -1e9 of
// repro/models/attention.py:_mask_bias instead of being read from a
// (B, S, S) bias in device memory; and keys past S never enter the sum,
// so nothing is padded.  q, k, v are read in the model's (B, S, heads,
// hd) layout through strides (no transposes); grouped-query attention
// reads kv head h / (H / KV), so repeated kv heads are never built.
//
// What bounds it: operations.  Per (b, h) it does 4 S^2 hd flops against
// 4 S hd elements moved; at the text8 shape (B, S, H, hd) = (8, 256, 12,
// 64) that is 1.61 GFLOP against 25.2 MB.  Both products run on the
// tensor cores as mma.sync m16n8k8 TF32 with the 3xTF32 split (tf32.cuh),
// which keeps f32 accuracy at a third of the TF32 rate: 1.61 GFLOP at
// 495 / 3 TFLOP/s is 0.0098 ms, above the 0.0075 ms the bytes take at
// 3.35 TB/s.  (Scalar f32 FMAs on the CUDA cores would be bound at 67
// TFLOP/s, 0.024 ms.)
//
// Design: one block of 4 warps per (b, h, 64 query rows), each warp owning
// 16 rows.  q stays in registers as f32 and is split per k-step.  64-key
// tiles of k and v are double-buffered in shared memory by cp.async
// (16-byte copies; bf16 is converted to f32 as it is staged), rows padded
// to hd + 4 floats so that every fragment load is free of bank conflicts.
// The online softmax runs on the accumulator fragments in registers, in
// base 2 (scores times log2 e, then exp2); the row max joins a quad's 4
// threads with two shuffles, and each thread
// keeps a partial row sum that the quad joins once at the end.  P feeds
// P v straight from its accumulator layout: within each 8-key step the
// k index is permuted (k index t <-> key 2t, t + 4 <-> key 2t + 1), which
// turns the C fragment of s into the A fragment of P with no shuffles, and
// v's B fragment is read with the same permutation.  bf16 inputs are
// exact in TF32, so q k^T takes one pass and P v two.
#include <math.h>

#include "tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e9f;         // additive mask, as in _mask_bias
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of the (B, S, heads) axes; hd is 1
  long long b, s, h;
};

template <int HD>
constexpr int smem_bytes() {  // two buffers of a k tile and a v tile
  return 2 * 2 * kBlockK * (HD + 4) * static_cast<int>(sizeof(float));
}

// One 64-key tile of k and v (keys k0 .. k0 + 63) into shared memory as
// f32; keys past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* ks, float* vs,
                                           const T* __restrict__ kb,
                                           const T* __restrict__ vb,
                                           long long kss, long long vss,
                                           int k0, int S, int tid) {
  constexpr int kPitch = HD + 4;
  if constexpr (sizeof(T) == 4) {
    constexpr int kRow = HD / 4;  // 16-byte chunks per row
    for (int c = tid; c < kBlockK * kRow; c += kThreads) {
      const int j = c / kRow, d = (c % kRow) * 4;
      const bool ok = k0 + j < S;
      const long long r = ok ? k0 + j : 0;
      tc::cp_async16(ks + j * kPitch + d, kb + r * kss + d, ok);
      tc::cp_async16(vs + j * kPitch + d, vb + r * vss + d, ok);
    }
  } else {
    constexpr int kRow = HD / 8;  // 8 bf16 per 16-byte load
    for (int c = tid; c < kBlockK * kRow; c += kThreads) {
      const int j = c / kRow, d = (c % kRow) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (k0 + j < S) {
        const long long r = k0 + j;
        kr = *reinterpret_cast<const uint4*>(kb + r * kss + d);
        vr = *reinterpret_cast<const uint4*>(vb + r * vss + d);
      }
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kr);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vr);
      float kf[8], vf[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(k2[i]);
        const float2 b = __bfloat1622float2(v2[i]);
        kf[2 * i] = a.x;
        kf[2 * i + 1] = a.y;
        vf[2 * i] = b.x;
        vf[2 * i + 1] = b.y;
      }
      float4* kd = reinterpret_cast<float4*>(ks + j * kPitch + d);
      float4* vd = reinterpret_cast<float4*>(vs + j * kPitch + d);
      kd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      kd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
  }
}

// Up to hd 64 three blocks fit an SM's shared memory; asking for three
// caps the registers at 168 a thread so that they fit as well.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KV, Strides qs, Strides ks_, Strides vs_,
                       Strides os, int causal, int window, float scale) {
  constexpr int kPitch = HD + 4;
  constexpr int kTile = kBlockK * kPitch;  // floats of one k or v tile
  constexpr int kD = HD / 8;               // k-steps of q k^T, n-tiles of P v
  constexpr int kN = kBlockK / 8;          // n-tiles of q k^T, k-steps of P v
  constexpr bool kF32 = sizeof(T) == 4;    // bf16 operands are exact in TF32
  extern __shared__ __align__(16) float smem[];  // [2][k tile, v tile]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's two query rows, g and g + 8 of its warp's 16
  const int r0 = static_cast<int>(blockIdx.x) * kBlockQ + (tid / 32) * 16 + g;
  const int row[2] = {r0, r0 + 8};

  const T* kb = k + b * ks_.b + kvh * ks_.h;
  const T* vb = v + b * vs_.b + kvh * vs_.h;
  // scores in base 2 (times log2 e), so that exp2(s2 - m2) = exp(s - m)
  const float scale2 = scale * kLog2e, neg2 = kNeg * kLog2e;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  stage_tile<T, HD>(smem, smem + kTile, kb, vb, ks_.s, vs_.s, 0, S, tid);
  tc::cp_async_commit();

  // q as the A fragments of every k-step, f32 (rows past S are zeros)
  float qf[kD][4];
  {
    const T* qb = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row[r] < S;
      const T* qp = qb + static_cast<long long>(ok ? row[r] : 0) * qs.s;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        qf[d][r] = ok ? tc::to_float(qp[8 * d + t]) : 0.f;
        qf[d][r + 2] = ok ? tc::to_float(qp[8 * d + t + 4]) : 0.f;
      }
    }
  }

  float acc[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      float* nk = smem + ((tile + 1) & 1) * 2 * kTile;
      stage_tile<T, HD>(nk, nk + kTile, kb, vb, ks_.s, vs_.s,
                        (tile + 1) * kBlockK, S, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const float* ks = smem + (tile & 1) * 2 * kTile;
    const float* vs = ks + kTile;

    // ---- s = q k^T for the 64 keys of the tile ----
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      tc::Frag<4> a;
      if constexpr (kF32) a.set(qf[d]); else a.set_exact(qf[d]);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float* kp = ks + (8 * n + g) * kPitch + 8 * d + t;
        const float kv[2] = {kp[0], kp[4]};
        tc::Frag<2> bf;
        if constexpr (kF32) bf.set(kv); else bf.set_exact(kv);
        tc::mma3<kF32, kF32>(s[n], a, bf);
      }
    }

    // ---- mask, then the online softmax on the fragments ----
    const int k0 = tile * kBlockK;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int kj = k0 + 8 * n + 2 * t + (e & 1);
        float sv = -INFINITY;  // keys past S never enter the sum
        if (kj < S) {
          const int diff = row[r] - kj;
          bool ok = true;
          if (causal) ok = diff >= 0;
          if (window > 0)
            ok = ok && (causal ? diff < window : abs(diff) < window);
          sv = s[n][e] * scale2 + (ok ? 0.f : neg2);
        }
        s[n][e] = sv;
        tmax[r] = fmaxf(tmax[r], sv);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      // every tile holds a key < S, so the new max is finite and the
      // first tile's alpha is exp(-inf) = 0
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // ---- acc += P v, 8 keys per k-step in the permuted order ----
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[n][e] - m[e / 2]);
        l[e / 2] += p[e];
      }
      // C fragment (g,2t) (g,2t+1) (g+8,2t) (g+8,2t+1) as the A fragment
      // (g,t) (g+8,t) (g,t+4) (g+8,t+4) under k index t <-> key 2t
      const float pa[4] = {p[0], p[2], p[1], p[3]};
      tc::Frag<4> a;
      a.set(pa);
      const float* vp = vs + (8 * n + 2 * t) * kPitch + g;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const float vv[2] = {vp[8 * d], vp[kPitch + 8 * d]};
        tc::Frag<2> bf;
        if constexpr (kF32) bf.set(vv); else bf.set_exact(vv);
        tc::mma3<true, kF32>(acc[d], a, bf);
      }
    }
    __syncthreads();  // the tile's buffer may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* op = o + b * os.b + static_cast<long long>(row[r]) * os.s + h * os.h;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      op[8 * d + 2 * t] = tc::from_float<T>(acc[d][2 * r] / denom);
      op[8 * d + 2 * t + 1] = tc::from_float<T>(acc[d][2 * r + 1] / denom);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, Strides qs, Strides ks, Strides vs,
              Strides os, int causal, int window, float scale,
              cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  constexpr int kSmem = smem_bytes<HD>();
  if (kSmem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_attention_kernel<T, HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, qs, ks, vs, os,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh, long long vsb,
           long long vss, long long vsh, long long osb, long long oss,
           long long osh, int causal, int window, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, B, S, H, KV, qs, ks, vs, os, causal,
                              window, scale, st);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, S, H, KV, qs, ks, vs, os, causal,
                              window, scale, st);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, H, KV, qs, ks, vs, os, causal,
                              window, scale, st);
    case 80:  // zamba2-2.7b: 2560 / 32 heads; 10 k-steps of 8
      return launch_hd<T, 80>(q, k, v, o, B, S, H, KV, qs, ks, vs, os, causal,
                              window, scale, st);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, H, KV, qs, ks, vs, os,
                               causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/flash_attention/
// ops.py.  q, o: (B, S, H, hd); k, v: (B, S, KV, hd); strides in elements
// for the first three axes, the last axis contiguous; k and v 16-byte
// aligned with strides that keep every row so (the wrapper checks).
// Returns the CUDA error code of the launch (0 on success).
#define FLASH_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      int B, int S, int H, int KV, int hd, long long qsb,    \
                      long long qss, long long qsh, long long ksb,           \
                      long long kss, long long ksh, long long vsb,           \
                      long long vss, long long vsh, long long osb,           \
                      long long oss, long long osh, int causal, int window,  \
                      float scale, void* stream) {                           \
    return launch<T>(q, k, v, o, B, S, H, KV, hd, qsb, qss, qsh, ksb, kss,   \
                     ksh, vsb, vss, vsh, osb, oss, osh, causal, window,      \
                     scale, stream);                                         \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
