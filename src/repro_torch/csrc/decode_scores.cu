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
// (repro_torch/kernels/decode_scores/ref.py) and of dndm_update.cu.
// Scores: (m, s) is an online logsumexp with one expf per element
// (rowsel::ArgmaxLse), summed per thread and then over the merge tree, in
// another order than the plain version's sum(exp(a - m)); scores agree to
// a few ulps, not bitwise.  expf and logf are the accurate library
// functions, not __expf/__logf.
//
// What bounds it: bytes.  Each logit (and Gumbel value) is read once and
// no (B, N, K) log-softmax reaches device memory.  The row reduction is
// row_select.cuh's, in its two regimes: a warp per row below
// rowsel::kBlockMinK (the ranked path's K = 28, where the launch is the
// cost), a block per row with 16-byte streaming loads from it (a
// 32000-entry vocabulary, where HBM is).  Any K is handled in the kernel
// and nothing is padded.
#include "row_select.cuh"

namespace {

__device__ __forceinline__ void write_row(const rowsel::ArgmaxLse& acc,
                                          int* tok, float* score,
                                          long long row) {
  tok[row] = acc.idx;
  score[row] = __fsub_rn(acc.best_a, __fadd_rn(acc.m, logf(acc.s)));
}

template <typename T>
__global__ void __launch_bounds__(rowsel::kWarpsPerBlock * 32)
decode_scores_warp_kernel(const T* __restrict__ logits,
                          const float* __restrict__ gumbel,
                          const float* __restrict__ mask,
                          int* __restrict__ tok, float* __restrict__ score,
                          long long rows, int K, float temperature) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            rowsel::kWarpsPerBlock +
                        threadIdx.x / 32;
  if (row >= rows) return;  // uniform across the warp: one warp, one row
  rowsel::ArgmaxLse acc;
  rowsel::warp_row(acc, logits + row * K,
                   gumbel != nullptr ? gumbel + row * K : nullptr, mask, K,
                   temperature);
  if (threadIdx.x % 32 == 0) write_row(acc, tok, score, row);
}

template <typename T, int kNoise>
__global__ void __launch_bounds__(rowsel::kBlockThreads)
decode_scores_block_kernel(const T* __restrict__ logits,
                           const float* __restrict__ gumbel,
                           const float* __restrict__ mask,
                           int* __restrict__ tok, float* __restrict__ score,
                           int K, float temperature) {
  const long long row = blockIdx.x;
  rowsel::ArgmaxLse acc;
  rowsel::block_row<T, kNoise>(acc, logits + row * K,
                               gumbel != nullptr ? gumbel + row * K : nullptr,
                               mask, K, temperature);
  if (threadIdx.x == 0) write_row(acc, tok, score, row);
}

template <typename T>
int launch(const void* logits_, const void* gumbel_, const void* mask_,
           void* tok_, void* score_, long long rows, int K,
           float temperature, void* stream_) {
  if (rows == 0) return 0;
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* logits = static_cast<const T*>(logits_);
  const float* gumbel = static_cast<const float*>(gumbel_);
  const float* mask = static_cast<const float*>(mask_);
  int* tok = static_cast<int*>(tok_);
  float* score = static_cast<float*>(score_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (K < rowsel::kBlockMinK) {
    const unsigned grid = static_cast<unsigned>(
        (rows + rowsel::kWarpsPerBlock - 1) / rowsel::kWarpsPerBlock);
    decode_scores_warp_kernel<T>
        <<<grid, rowsel::kWarpsPerBlock * 32, 0, stream>>>(
            logits, gumbel, mask, tok, score, rows, K, temperature);
  } else {
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(rows);
    switch (rowsel::noise_case<T>(logits_, gumbel_)) {
      case rowsel::kNoNoise:
        decode_scores_block_kernel<T, rowsel::kNoNoise>
            <<<grid, rowsel::kBlockThreads, 0, stream>>>(
                logits, gumbel, mask, tok, score, K, temperature);
        break;
      case rowsel::kNoiseAligned:
        decode_scores_block_kernel<T, rowsel::kNoiseAligned>
            <<<grid, rowsel::kBlockThreads, 0, stream>>>(
                logits, gumbel, mask, tok, score, K, temperature);
        break;
      default:
        decode_scores_block_kernel<T, rowsel::kNoiseShifted>
            <<<grid, rowsel::kBlockThreads, 0, stream>>>(
                logits, gumbel, mask, tok, score, K, temperature);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/decode_scores/ops.py,
// one entry point per logits dtype.  Pointers are device pointers; gumbel
// may be null.  Returns the CUDA error code of the launch (0 on success).
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
