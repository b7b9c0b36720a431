// Flash attention (online softmax) for Hopper, sm_90a, on the CUDA cores.
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
// What bounds it: operations.  Per (b, h) it does 4 S^2 hd f32 flops
// against 4 S hd elements moved; at the serving shape (B, H, S, hd) =
// (8, 12, 256, 64) that is 1.6 GFLOP against 25 MB, so the f32 rate of
// the CUDA cores (67 TFLOP/s, no tensor cores: the products stay f32, as
// in the reference) is the bound, not the 3.35 TB/s of memory.  The
// design keeps every operand of the inner products on chip: one block
// per (b, h, 64 query rows), four threads per query row, each holding a
// quarter of the row's q and f32 accumulator in registers; 64-key tiles
// of k and v staged in shared memory as f32 (read as broadcasts, no bank
// conflicts; 2 x 64 x hd x 4 bytes, dynamic, 64 KB at hd = 128); the
// four partial dot products joined by two shuffles.  A simple first
// version: no tensor cores, no asynchronous copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr int kThreadsPerRow = 4;  // threads sharing one query row
constexpr int kThreads = kBlockQ * kThreadsPerRow;
constexpr float kNeg = -1e9f;      // additive mask, as in _mask_bias

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {  // element strides of the (B, S, heads) axes; hd is 1
  long long b, s, h;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KV, Strides qs, Strides ks_, Strides vs_,
                       Strides os, int causal, int window, float scale) {
  constexpr int kCols = HD / kThreadsPerRow;  // columns per thread
  extern __shared__ float smem[];  // k tile, then v tile: [kBlockK][HD]
  float(*ks)[HD] = reinterpret_cast<float(*)[HD]>(smem);
  float(*vs)[HD] = reinterpret_cast<float(*)[HD]>(smem + kBlockK * HD);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;  // owns columns part + 4 i
  const int qi = blockIdx.x * kBlockQ + tid / kThreadsPerRow;
  const bool row_ok = qi < S;
  const int qrow = row_ok ? qi : S - 1;  // ragged rows compute, never store

  float qreg[kCols], acc[kCols];
  const T* qp = q + b * qs.b + static_cast<long long>(qrow) * qs.s + h * qs.h;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    qreg[i] = to_float(qp[part + kThreadsPerRow * i]);
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const T* kb = k + b * ks_.b + kvh * ks_.h;
  const T* vb = v + b * vs_.b + kvh * vs_.h;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int j = e / HD;
      const int d = e % HD;
      const int kj = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (kj < S) {
        kval = to_float(kb[static_cast<long long>(kj) * ks_.s + d]);
        vval = to_float(vb[static_cast<long long>(kj) * vs_.s + d]);
      }
      ks[j][d] = kval;
      vs[j][d] = vval;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        dot = fmaf(qreg[i], ks[j][part + kThreadsPerRow * i], dot);
      // (p0 + p1) + (p2 + p3) in every one of the four threads: the
      // same bits everywhere, so the row statistics agree.
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kj = k0 + j;
      float sj = -INFINITY;  // keys past S never enter the sum
      if (kj < S) {
        const int diff = qrow - kj;
        bool ok = true;
        if (causal) ok = diff >= 0;
        if (window > 0) ok = ok && (causal ? diff < window : abs(diff) < window);
        sj = dot * scale + (ok ? 0.f : kNeg);
      }
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    // Every tile holds at least one key < S, so m_new is finite and the
    // first tile's alpha is exp(-inf) = 0.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        acc[i] = fmaf(p, vs[j][part + kThreadsPerRow * i], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + b * os.b + static_cast<long long>(qi) * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      op[part + kThreadsPerRow * i] = from_float<T>(acc[i] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, Strides qs, Strides ks, Strides vs,
              Strides os, int causal, int window, float scale,
              cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  constexpr int kSmem = 2 * kBlockK * HD * sizeof(float);
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
    case 80:  // zamba2-2.7b: 2560 / 32 heads; 20 columns per thread
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
// for the first three axes, the last axis contiguous.  Returns the CUDA
// error code of the launch (0 on success).
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
