// Flash attention (online softmax) for Hopper, sm_90a, on the tensor cores,
// and its decode form (flash_decode, at the end of the file).
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

namespace {

// ---------------------------------------------------------------------
// Decode form: one query row per (b, h) over a ring-buffer KV cache, split
// over the cache's slots.
//
// Replaces _flash_kernel (src/repro/kernels/flash_attention/kernel.py:26)
// as repro/models/attention.py:163-187 calls it (decode_step with
// attn_impl="pallas"): Sq = 1, Sk = L, and an additive (B, 1, L) bias of
// the ring buffer.  Here that bias is computed in the kernel, not read:
// slot i of a ring of ring_len slots holds position pos - back, back =
// (pos mod ring_len - i) mod ring_len, and gets -1e9 where that position
// is negative (back > pos) or, with a window, where back >= window.  The
// kernel is given the slots slot0 .. slot0 + L - 1 of the ring: all of
// them (slot0 = 0, ring_len = L) for a whole cache, one rank's share
// where ranks shard the slots.  f32 (m, l, acc), l clamped at 1e-30, the
// output in q's dtype.  Grouped-query attention: the G = H / KV query
// heads of kv head h / G share its keys and values.
//
// What bounds it: bytes.  Each key and value row of the cache must be
// read once per step, 8 hd bytes in f32, for 4 G hd flops: at G <= 8 at
// most 4 flops per byte, against the card's f32 ridge of 67 / 3.35 = 20
// flops per byte, so the CUDA cores keep up and no tensor core is needed.
// At (B, L, H, KV, hd) = (2, 4096, 32, 8, 128) the caches are 67.1 MB,
// 0.020 ms at 3.35 TB/s; one layer of tinyllama-1.1b's long_500k step
// (1, 524288, 32, 4, 64) reads 1.07 GB, 0.32 ms.
//
// Design.  Pass 1 runs a grid of (chunk of slots) x (b, kv head, group of
// at most 8 of its query heads): many blocks per (b, kv head), so a long
// cache spreads over every SM, and one block computes every query head of
// its kv head, so each key and value row leaves device memory once per
// step.  A block of 4 warps walks its chunk in 64-slot tiles of k and v,
// staged in shared memory by 16-byte cp.async three deep, so the copies
// of the next two tiles overlap the arithmetic on this one (bf16 is
// staged as it is and widened when read).  Scores: thread (j, part) takes
// slot j of the tile against 4 query heads, q pre-scaled by scale log2 e
// in shared memory and read as broadcasts; the tile's max per head joins
// within a warp by a transposed butterfly (4 values over 32 lanes in 6
// shuffles) and across the two warps of a part in shared memory.  The
// online softmax runs in base 2 (exp2); every thread keeps the running
// max of each head, so the per-thread partial sums l join only at the
// end.  P v: thread (slice, subset) owns 16 bytes of hd for every head of
// the group and the slots subset, subset + n, ... of each tile, reading
// the 8 heads' p of a slot as two broadcast 16-byte loads; the subsets'
// sums join once, at the end.  Each block writes its chunk's (m, l,
// acc[hd]) to an f32 workspace, or the output itself when there is one
// chunk (one launch).  The wrapper sets the chunk (ops.py: decode_chunk)
// so that the chunks of all (b, kv head) pairs fill the card's resident
// blocks once: of 0.5 to 4 waves, one wave was fastest (chip_smoke.py
// --measure-flash-decode).  Pass 2 joins the chunks for each (b, h):
// M = max m_c, l = sum exp(m_c - M) l_c, out = sum exp(m_c - M) acc_c /
// max(l, 1e-30).  A chunk whose slots are all masked holds m ~ -1e9 and drops
// out (exp(-1e9 - M) = 0), as masked keys do in the reference's softmax.
// The partials entry returns the joined (m, l, acc) unnormalised, m in
// natural-log units, for a softmax completed over ranks that shard the
// slots (launch/spmd.py).

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecTile = 64;              // slots per shared-memory tile
constexpr int kDecGroup = 8;              // query heads per block, at most
constexpr int kDecHalf = kDecGroup / 2;   // heads per thread in the scores
constexpr int kDecStages = 3;             // cp.async pipeline depth
constexpr int kJoinThreads = 256;  // pass 2
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kDecThreads == 2 * kDecTile, "thread (j, part) per score");
static_assert(kDecHalf == 4, "the butterfly joins 4 heads");

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;         // (B, 1, H, hd) in T; null: write the partials
  float* pm;       // (B, H, C) partial max, natural-log units
  float* pl;       // (B, H, C) partial sum
  float* pacc;     // (B, H, C, hd) partial weighted values
  int L, H, KV, G, gs, ng;  // ng groups of gs query heads per kv head
  long long qsb, qsh;
  Strides ks, vs;
  long long osb, osh;
  int pos, window, ring_len, slot0, chunk, C;
  float scale2;    // scale * log2 e
};

template <typename T, int HD>
struct DecodeShape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPitch = HD + kVec;  // row pitch: no bank conflicts
  static constexpr int kSlices = HD / kVec;  // 16-byte slices of a row
  static constexpr int kSubs = kDecThreads / kSlices;  // P v slot subsets
  static constexpr int kStage = 2 * kDecTile * kPitch;  // k and v, elements
  static constexpr int kStageBytes =
      kDecStages * kStage * static_cast<int>(sizeof(T));
  static constexpr int kRedBytes = kSubs * kDecGroup * HD * 4;
  static constexpr int kBig =
      kStageBytes > kRedBytes ? kStageBytes : kRedBytes;
  // q (group x HD), p (tile x group), warp maxima and sums, m
  static constexpr int kBytes =
      kBig + 4 * (kDecGroup * HD + kDecTile * kDecGroup +
                  2 * kDecWarps * kDecGroup + kDecGroup);
  static_assert(HD % kVec == 0 && kSubs >= 1, "head dim");
};

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
template <int N>
__device__ __forceinline__ void load_q(const float* p, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    f[i] = v.x;
    f[i + 1] = v.y;
    f[i + 2] = v.z;
    f[i + 3] = v.w;
  }
}

// Slots r0 .. r0 + 63 of k and v into a stage; slots >= r1 zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void decode_stage(T* ks, T* vs,
                                             const T* __restrict__ kb,
                                             const T* __restrict__ vb,
                                             long long kss, long long vss,
                                             int r0, int r1, int tid) {
  using S = DecodeShape<T, HD>;
  for (int c = tid; c < kDecTile * S::kSlices; c += kDecThreads) {
    const int j = c / S::kSlices, e = (c % S::kSlices) * S::kVec;
    const bool ok = r0 + j < r1;
    const long long r = ok ? r0 + j : r0;
    tc::cp_async16(ks + j * S::kPitch + e, kb + r * kss + e, ok);
    tc::cp_async16(vs + j * S::kPitch + e, vb + r * vss + e, ok);
  }
}

// Within a warp whose lanes hold x[0..3] of 4 heads, the max (kMax) or
// sum over the 32 lanes of each head, by a transposed butterfly (each
// step hands half of the values still held to the partner lane): after
// it, lane 8 i holds head i, returned in ``head`` = lane / 8.
template <bool kMax>
__device__ __forceinline__ float warp_join4(const float (&x)[4], int lane,
                                            int& head) {
  const auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : a + b; };
  const bool hi = lane & 16, hi2 = lane & 8;
  const float a0 = op(hi ? x[2] : x[0],
                      __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[2], 16));
  const float a1 = op(hi ? x[3] : x[1],
                      __shfl_xor_sync(0xffffffffu, hi ? x[1] : x[3], 16));
  float y = op(hi2 ? a1 : a0,
               __shfl_xor_sync(0xffffffffu, hi2 ? a0 : a1, 8));
  y = op(y, __shfl_xor_sync(0xffffffffu, y, 4));
  y = op(y, __shfl_xor_sync(0xffffffffu, y, 2));
  y = op(y, __shfl_xor_sync(0xffffffffu, y, 1));
  head = (hi ? 2 : 0) + (hi2 ? 1 : 0);
  return y;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(DecodeArgs a) {
  using S = DecodeShape<T, HD>;
  constexpr int V = S::kVec;
  extern __shared__ __align__(16) unsigned char dsmem[];
  T* stages = reinterpret_cast<T*>(dsmem);
  float* red = reinterpret_cast<float*>(dsmem);  // after the last tile
  float* q_s = reinterpret_cast<float*>(dsmem + S::kBig);  // [group][HD]
  float* p_s = q_s + kDecGroup * HD;             // [tile][group]
  float* wmax = p_s + kDecTile * kDecGroup;      // [warp][group]
  float* wsum = wmax + kDecWarps * kDecGroup;    // [warp][group]
  float* m_s = wsum + kDecWarps * kDecGroup;     // [group]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = blockIdx.x;
  const int sub = blockIdx.y % a.ng;
  const int bk = blockIdx.y / a.ng;
  const int kvh = bk % a.KV, b = bk / a.KV;
  const int h0 = kvh * a.G + sub * a.gs;
  const int gn = min(a.gs, a.G - sub * a.gs);  // heads of this block
  const int r0 = c * a.chunk;
  const int r1 = min(a.L, r0 + a.chunk);
  const int n_tiles = (r1 - r0 + kDecTile - 1) / kDecTile;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < n_tiles) {
      T* st = stages + s * S::kStage;
      decode_stage<T, HD>(st, st + kDecTile * S::kPitch, kb, vb, a.ks.s,
                          a.vs.s, r0 + s * kDecTile, r1, tid);
    }
    tc::cp_async_commit();
  }
  {  // the group's q rows times scale log2 e; rows past gn are zeros
    const T* qb = static_cast<const T*>(a.q) + b * a.qsb;
    for (int i = tid; i < kDecGroup * HD; i += kDecThreads) {
      const int g = i / HD, d = i % HD;
      q_s[i] = g < gn ? tc::to_float(qb[(h0 + g) * a.qsh + d]) * a.scale2
                      : 0.f;
    }
  }

  // scores: slot j of each tile against heads 4 part .. 4 part + 3
  const int j = tid % kDecTile;
  const int part = tid / kDecTile;            // warps 0-1: 0, warps 2-3: 1
  const bool qk_on = part * kDecHalf < gn;    // warp-uniform
  // P v: 16-byte slice of hd and slot subset
  const int slice = tid % S::kSlices;
  const int ksub = tid / S::kSlices;
  const bool pv_on = ksub < S::kSubs;
  const float neg2 = kNeg * kLog2e;
  const int pslot = a.pos % a.ring_len;

  float m[kDecGroup], l[kDecHalf], acc[kDecGroup][V];
#pragma unroll
  for (int g = 0; g < kDecGroup; ++g) {
    m[g] = -INFINITY;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kDecHalf; ++i) l[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<kDecStages - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread; tile t - 1's buffer is free
    {
      const int tn = t + kDecStages - 1;
      if (tn < n_tiles) {
        T* st = stages + (tn % kDecStages) * S::kStage;
        decode_stage<T, HD>(st, st + kDecTile * S::kPitch, kb, vb, a.ks.s,
                            a.vs.s, r0 + tn * kDecTile, r1, tid);
      }
      tc::cp_async_commit();
    }
    const T* ks = stages + (t % kDecStages) * S::kStage;
    const T* vs = ks + kDecTile * S::kPitch;

    // ---- scores of slot j, base 2, with the ring's bias ----
    float s[kDecHalf][2];
#pragma unroll
    for (int i = 0; i < kDecHalf; ++i) s[i][0] = s[i][1] = 0.f;
    if (qk_on) {
      const T* kp = ks + j * S::kPitch;
      const float* qp = q_s + part * kDecHalf * HD;
#pragma unroll
      for (int d = 0; d < HD; d += V) {
        float kf[V];
        load_vec(kp + d, kf);
#pragma unroll
        for (int i = 0; i < kDecHalf; ++i) {
          float qf[V];
          load_q(qp + i * HD + d, qf);
#pragma unroll
          for (int e = 0; e < V; ++e)
            s[i][e & 1] = fmaf(qf[e], kf[e], s[i][e & 1]);
        }
      }
    }
    const int row = r0 + t * kDecTile + j;  // index in the given slots
    float sv[kDecHalf];
    {
      int back = pslot - (a.slot0 + row);   // slot0 + row < ring_len
      if (back < 0) back += a.ring_len;
      const bool ok = back <= a.pos && (a.window <= 0 || back < a.window);
#pragma unroll
      for (int i = 0; i < kDecHalf; ++i)  // slots past the chunk never count
        sv[i] = row < r1 ? (s[i][0] + s[i][1]) + (ok ? 0.f : neg2)
                         : -INFINITY;
    }
    {
      int head;
      const float x = warp_join4<true>(sv, lane, head);
      if ((lane & 7) == 0) wmax[warp * kDecGroup + part * kDecHalf + head] = x;
    }
    __syncthreads();

    // ---- the online softmax: every thread updates every head's max ----
    float alpha[kDecGroup];
#pragma unroll
    for (int g = 0; g < kDecGroup; ++g) {
      const int w0 = (g / kDecHalf) * 2;  // the two warps of g's part
      // each tile holds a slot < r1, so the max is finite and the first
      // tile's alpha is exp2(-inf) = 0
      const float m_new = fmaxf(m[g], fmaxf(wmax[w0 * kDecGroup + g],
                                            wmax[(w0 + 1) * kDecGroup + g]));
      alpha[g] = exp2f(m[g] - m_new);
      m[g] = m_new;
    }
    {
      float p[kDecHalf];
#pragma unroll
      for (int i = 0; i < kDecHalf; ++i) {
        const float mi = part ? m[kDecHalf + i] : m[i];
        const float ai = part ? alpha[kDecHalf + i] : alpha[i];
        p[i] = exp2f(sv[i] - mi);
        l[i] = fmaf(l[i], ai, p[i]);
      }
      *reinterpret_cast<float4*>(p_s + j * kDecGroup + part * kDecHalf) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // ---- acc = alpha acc + P v over the tile (slots past the chunk
    // have p = 0 and zero-filled v) ----
    if (pv_on) {
#pragma unroll
      for (int g = 0; g < kDecGroup; ++g)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] *= alpha[g];
#pragma unroll 2
      for (int jj = ksub; jj < kDecTile; jj += S::kSubs) {
        float vf[V];
        load_vec(vs + jj * S::kPitch + slice * V, vf);
        float pj[kDecGroup];
        load_q(p_s + jj * kDecGroup, pj);
#pragma unroll
        for (int g = 0; g < kDecGroup; ++g) {
          if (g < gn) {
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[g][e] = fmaf(pj[g], vf[e], acc[g][e]);
          }
        }
      }
    }
  }

  tc::cp_async_wait<0>();
  __syncthreads();  // the stages are free: red reuses them
  {
    int head;
    const float x = warp_join4<false>(l, lane, head);
    if ((lane & 7) == 0) wsum[warp * kDecGroup + part * kDecHalf + head] = x;
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < kDecGroup; ++g) m_s[g] = m[g];
  }
  if (pv_on) {
#pragma unroll
    for (int g = 0; g < kDecGroup; ++g) {
      if (g < gn) {
        float* rp = red + (ksub * kDecGroup + g) * HD + slice * V;
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(rp + e) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                          acc[g][e + 3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * HD; i += kDecThreads) {
    const int g = i / HD, d = i % HD;
    float num = 0.f;
#pragma unroll 4
    for (int u = 0; u < S::kSubs; ++u)
      num += red[(u * kDecGroup + g) * HD + d];
    const int w0 = (g / kDecHalf) * 2;
    const float den =
        wsum[w0 * kDecGroup + g] + wsum[(w0 + 1) * kDecGroup + g];
    const int h = h0 + g;
    if (a.o) {
      static_cast<T*>(a.o)[b * a.osb + h * a.osh + d] =
          tc::from_float<T>(num / fmaxf(den, 1e-30f));
    } else {
      const long long pi = (static_cast<long long>(b) * a.H + h) * a.C + c;
      a.pacc[pi * HD + d] = num;
      if (d == 0) {
        a.pm[pi] = m_s[g] * kLn2;
        a.pl[pi] = den;
      }
    }
  }
}

// Pass 2: the C chunks' partials of one (b, h) joined; into o (normalised,
// in T) or, with o null, into (jm, jl, jacc) unnormalised.  The block's
// threads take the chunks apart: the max by a block reduction, then
// thread (u, d) sums dim d over chunks u, u + n, ... (n = threads / hd),
// and the n subsets join in shared memory.
template <typename T>
__global__ void __launch_bounds__(kJoinThreads)
flash_decode_join(DecodeArgs a, int hd, float* __restrict__ jm,
                  float* __restrict__ jl, float* __restrict__ jacc) {
  __shared__ float num_s[kJoinThreads], den_s[kJoinThreads];
  __shared__ float max_s[kJoinThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* pm = a.pm + bh * a.C;
  const float* pl = a.pl + bh * a.C;
  const float* pacc = a.pacc + bh * a.C * hd;
  float x = -INFINITY;
  for (int c = tid; c < a.C; c += kJoinThreads) x = fmaxf(x, pm[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (tid % 32 == 0) max_s[tid / 32] = x;
  __syncthreads();
  float M = max_s[0];
#pragma unroll
  for (int w = 1; w < kJoinThreads / 32; ++w) M = fmaxf(M, max_s[w]);
  const int n = kJoinThreads / hd;  // hd <= 128: at least 2 subsets
  const int u = tid / hd, d = tid % hd;
  float num = 0.f, den = 0.f;
  if (u < n) {
#pragma unroll 4
    for (int c = u; c < a.C; c += n) {
      const float f = expf(pm[c] - M);  // 0 for an all-masked chunk
      num = fmaf(f, pacc[static_cast<long long>(c) * hd + d], num);
      den = fmaf(f, pl[c], den);
    }
  }
  num_s[tid] = num;
  den_s[tid] = den;
  __syncthreads();
  if (tid < hd) {
    for (int v = 1; v < n; ++v) {
      num += num_s[v * hd + tid];
      den += den_s[v * hd + tid];
    }
    if (a.o) {
      static_cast<T*>(a.o)[b * a.osb + h * a.osh + tid] =
          tc::from_float<T>(num / fmaxf(den, 1e-30f));
    } else {
      jacc[bh * hd + tid] = num;
      if (tid == 0) {
        jm[bh] = M;
        jl[bh] = den;
      }
    }
  }
}

// Pass 1 into o (C = 1) or the workspace, then pass 2 where C > 1.  With
// partial set, the result is (jm, jl, jacc): pass 1 writes it itself when
// C = 1.  ws holds 2 B H C + B H C hd floats when C > 1.
template <typename T, int HD>
int launch_decode_hd(DecodeArgs a, int B, bool partial, float* jm,
                     float* jl, float* jacc, float* ws, cudaStream_t st) {
  using S = DecodeShape<T, HD>;
  if (S::kBytes > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  DecodeArgs p = a;
  if (a.C == 1) {
    if (partial) {
      p.o = nullptr;
      p.pm = jm;
      p.pl = jl;
      p.pacc = jacc;
    }
  } else {
    const long long n = static_cast<long long>(B) * a.H * a.C;
    p.o = nullptr;
    p.pm = ws;
    p.pl = ws + n;
    p.pacc = ws + 2 * n;
  }
  const dim3 grid(a.C, B * a.KV * a.ng);
  flash_decode_kernel<T, HD><<<grid, kDecThreads, S::kBytes, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.C == 1) return static_cast<int>(err);
  p.o = partial ? nullptr : a.o;
  flash_decode_join<T><<<dim3(a.H, B), kJoinThreads, 0, st>>>(p, HD, jm, jl,
                                                             jacc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* jm, float* jl, float* jacc, float* ws, int B,
                  int L, int H, int KV, int hd, long long qsb, long long qsh,
                  long long ksb, long long kss, long long ksh, long long vsb,
                  long long vss, long long vsh, long long osb, long long osh,
                  int pos, int window, int ring_len, int slot0, int chunk,
                  float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (L <= 0 || pos < 0 || KV <= 0 || H % KV != 0 || chunk <= 0 ||
      slot0 < 0 || ring_len < L || slot0 > ring_len - L)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool partial = o == nullptr;
  const int C = (L + chunk - 1) / chunk;
  if ((C > 1 && ws == nullptr) || (partial && !(jm && jl && jacc)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.pm = a.pl = a.pacc = nullptr;
  a.L = L;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.ng = (a.G + kDecGroup - 1) / kDecGroup;
  a.gs = (a.G + a.ng - 1) / a.ng;
  a.qsb = qsb;
  a.qsh = qsh;
  a.ks = Strides{ksb, kss, ksh};
  a.vs = Strides{vsb, vss, vsh};
  a.osb = osb;
  a.osh = osh;
  a.pos = pos;
  a.window = window;
  a.ring_len = ring_len;
  a.slot0 = slot0;
  a.chunk = chunk;
  a.C = C;
  a.scale2 = scale * kLog2e;
  if (static_cast<long long>(B) * KV * a.ng > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define DECODE_HD(N) \
  case N:            \
    return launch_decode_hd<T, N>(a, B, partial, jm, jl, jacc, ws, st);
    DECODE_HD(16)
    DECODE_HD(32)
    DECODE_HD(64)
    DECODE_HD(80)
    DECODE_HD(128)
#undef DECODE_HD
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

// q, o: (B, 1, H, hd) with strides (b, h); k, v: (B, L, KV, hd) with
// strides (b, s, h); the last axis contiguous, k and v 16-byte aligned with
// strides that keep every row so (the wrapper checks).  pos >= 0 is the
// query's position, window 0 for none; chunk the slots of a pass-1 block
// (ops.py: decode_splits); ws an f32 workspace of 2 B H C + B H C hd
// floats, C = ceil(L / chunk), unused (may be null) when C = 1.  Returns
// the first launch error's CUDA code (0 on success).
#define DECODE_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,  \
                      float* ws, int B, int L, int H, int KV, int hd,        \
                      long long qsb, long long qsh, long long ksb,           \
                      long long kss, long long ksh, long long vsb,           \
                      long long vss, long long vsh, long long osb,           \
                      long long osh, int pos, int window, int chunk,         \
                      float scale, void* stream) {                           \
    if (o == nullptr) return static_cast<int>(cudaErrorInvalidValue);        \
    return launch_decode<T>(q, k, v, o, nullptr, nullptr, nullptr, ws, B, L, \
                            H, KV, hd, qsb, qsh, ksb, kss, ksh, vsb, vss,    \
                            vsh, osb, osh, pos, window, L, 0, chunk, scale,  \
                            stream);                                         \
  }

DECODE_ENTRY(flash_decode_f32, float)
DECODE_ENTRY(flash_decode_bf16, __nv_bfloat16)

// The partial form: k, v hold slots slot0 .. slot0 + L - 1 of a ring of
// ring_len slots; m, l: (B, 1, H) and acc: (B, 1, H, hd), f32, contiguous,
// the softmax's max (natural-log units), sum and weighted values over
// those slots, unnormalised.
#define PARTIALS_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, float* m, \
                      float* l, float* acc, float* ws, int B, int L, int H,  \
                      int KV, int hd, long long qsb, long long qsh,          \
                      long long ksb, long long kss, long long ksh,           \
                      long long vsb, long long vss, long long vsh, int pos,  \
                      int window, int ring_len, int slot0, int chunk,        \
                      float scale, void* stream) {                           \
    return launch_decode<T>(q, k, v, nullptr, m, l, acc, ws, B, L, H, KV,    \
                            hd, qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, 0,   \
                            0, pos, window, ring_len, slot0, chunk, scale,   \
                            stream);                                         \
  }

PARTIALS_ENTRY(flash_decode_partials_f32, float)
PARTIALS_ENTRY(flash_decode_partials_bf16, __nv_bfloat16)
