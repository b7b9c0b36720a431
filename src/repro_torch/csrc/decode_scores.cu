// Streaming (token, score) decode for Hopper, sm_90a: the decode of the
// confidence-ranked samplers (DNDM-K, DNDM-C, RDM-k, Mask-Predict, DDIM).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_scores/kernel.py:
// _decode_scores_kernel (launcher decode_scores_kernel).  Same function:
//
//   a     = f32(logits) / temperature + mask                 per (b, n, k)
//   sel   = a (+ gumbel)
//   tok   = argmax_k sel           (ties go to the lowest index)
//   score = a[tok] - (m + log s),  m = max_k a,  s = sum_k exp(a - m)
//
// The score is the log-probability of the chosen token under the
// noise-free adjusted logits: the key the samplers rank positions on.
//
// Tokens: the op order (cast, /temperature, +mask, +gumbel) is that of
// repro_torch/kernels/dndm_update/ref.py:adjust_logits, every step is an
// IEEE round-to-nearest operation (__fdiv_rn, __fadd_rn; the build does
// not use --use_fast_math), and the argmax keeps the lowest index among
// equal values, so tokens are bitwise those of the plain version
// (repro_torch/kernels/decode_scores/ref.py).  Scores: (m, s) is an online
// logsumexp, so s is summed in another order than the plain version's
// sum(exp(a - m)); scores agree to a few ulps, not bitwise.  expf and logf
// are the accurate library functions, not __expf/__logf.
//
// What bounds it: bytes.  Each logit (and Gumbel value) is read once; at
// the ranked serving path's shape (B, N, K) = (8, 128, 28) with Gumbel
// noise that is about 0.24 MB, under 0.1 us at 3.35 TB/s, so on the
// serving path the kernel is bound by its launch.  The design therefore
// does the least per byte, as dndm_update.cu does: one warp per (b, n)
// row, lanes striding over K with coalesced loads (K = 28 is one warp
// iteration), per-lane registers for (sel max, argmax, a at the argmax)
// and an online (m, s), and one shuffle reduction across the warp.  Any K
// is handled in-kernel; nothing is padded and no (B, N, K) log-softmax
// reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Merge the logsumexp partial (m2, s2) into (m, s):
//   m' = max(m, m2),  s' = s exp(m - m') + s2 exp(m2 - m').
// A side that holds nothing (a lane past K when K < 32, or only -inf
// logits) is (-inf, 0), and exp(-inf - (-inf)) is NaN: such a side is
// skipped instead of merged.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = __fadd_rn(__fmul_rn(s, expf(m - mn)), __fmul_rn(s2, expf(m2 - mn)));
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_scores_kernel(const T* __restrict__ logits,
                     const float* __restrict__ gumbel,
                     const float* __restrict__ mask, int* __restrict__ tok,
                     float* __restrict__ score, long long rows, int K,
                     float temperature) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp: one warp, one row

  const T* lrow = logits + row * K;
  const float* grow = gumbel != nullptr ? gumbel + row * K : nullptr;
  const bool scale = temperature != 1.0f;

  // Lane-local selection: k increases, and only a strictly larger value
  // replaces the running max, so each lane keeps its lowest index.
  float best = -INFINITY;
  int best_idx = 0;
  float best_a = -INFINITY;  // noise-free a at the running argmax
  float m = -INFINITY;       // online logsumexp over a
  float s = 0.0f;
  for (int k = lane; k < K; k += 32) {
    float a = to_float(lrow[k]);
    if (scale) a = __fdiv_rn(a, temperature);
    a = __fadd_rn(a, mask[k]);
    const float v = grow != nullptr ? __fadd_rn(a, grow[k]) : a;
    if (v > best) {
      best = v;
      best_idx = k;
      best_a = a;
    }
    lse_merge(m, s, a, 1.0f);
  }
  // Warp reduction: the larger selection value wins, equal values go to
  // the lower index (the first maximum, as argmax defines it); the
  // logsumexp partials merge.
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_idx, off);
    const float oa = __shfl_down_sync(0xffffffffu, best_a, off);
    const float om = __shfl_down_sync(0xffffffffu, m, off);
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    if (ob > best || (ob == best && oi < best_idx)) {
      best = ob;
      best_idx = oi;
      best_a = oa;
    }
    lse_merge(m, s, om, os);
  }
  if (lane == 0) {
    tok[row] = best_idx;
    score[row] = __fsub_rn(best_a, __fadd_rn(m, logf(s)));
  }
}

template <typename T>
int launch(const void* logits, const void* gumbel, const void* mask,
           void* tok, void* score, long long rows, int K, float temperature,
           void* stream) {
  if (rows == 0) return 0;
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((rows + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  decode_scores_kernel<T>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(logits), static_cast<const float*>(gumbel),
          static_cast<const float*>(mask), static_cast<int*>(tok),
          static_cast<float*>(score), rows, K, temperature);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/decode_scores/ops.py.
// Pointers are device pointers; gumbel may be null.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int decode_scores_f32(const void* logits, const void* gumbel,
                                 const void* mask, void* tok, void* score,
                                 long long rows, int K, float temperature,
                                 void* stream) {
  return launch<float>(logits, gumbel, mask, tok, score, rows, K,
                       temperature, stream);
}

extern "C" int decode_scores_bf16(const void* logits, const void* gumbel,
                                  const void* mask, void* tok, void* score,
                                  long long rows, int K, float temperature,
                                  void* stream) {
  return launch<__nv_bfloat16>(logits, gumbel, mask, tok, score, rows, K,
                               temperature, stream);
}
