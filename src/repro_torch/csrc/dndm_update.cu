// Fused DNDM decode-update (select x0_hat, then the eq. (9) token update)
// for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dndm_update/kernel.py:
// _dndm_kernel (launcher dndm_update_kernel).  Same function:
//
//   a      = f32(logits) / temperature + mask (+ gumbel)      per (b, n, k)
//   x0_hat = argmax_k a          (ties go to the lowest index)
//   out    = where(tau == t, x0_hat, x)     version 1 (Algorithm 1)
//            where(tau >= t, x0_hat, x)     version 2 (Algorithm 3)
//
// The op order (cast, /temperature, +mask, +gumbel) is that of
// repro_torch/kernels/dndm_update/ref.py:adjust_logits, and every step is
// an IEEE round-to-nearest operation (__fdiv_rn, __fadd_rn; the build
// does not use --use_fast_math), so the tokens are bitwise those of the
// plain version.
//
// What bounds it: bytes.  Each logit (and Gumbel value) is read once and
// used for one comparison, and the (B, N, K) adjusted logits never reach
// device memory.  The row reduction is row_select.cuh's, in its two
// regimes: a warp per row below rowsel::kBlockMinK (the paper's K = 28,
// where the launch is the cost), a block per row with 16-byte streaming
// loads from it (zamba2's K = 32000, where HBM is).  Any K is handled in
// the kernel and nothing is padded.
#include "row_select.cuh"

namespace {

__device__ __forceinline__ void write_row(const rowsel::Argmax& acc,
                                          const int* x, const int* tau,
                                          int* out, long long row, int t,
                                          int version) {
  const int tv = tau[row];
  const bool reveal = version == 1 ? (tv == t) : (tv >= t);
  out[row] = reveal ? acc.idx : x[row];
}

template <typename T>
__global__ void __launch_bounds__(rowsel::kWarpsPerBlock * 32)
dndm_update_warp_kernel(const T* __restrict__ logits,
                        const float* __restrict__ gumbel,
                        const float* __restrict__ mask,
                        const int* __restrict__ x,
                        const int* __restrict__ tau, int* __restrict__ out,
                        long long rows, int K, int t, int version,
                        float temperature) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            rowsel::kWarpsPerBlock +
                        threadIdx.x / 32;
  if (row >= rows) return;  // uniform across the warp: one warp, one row
  rowsel::Argmax acc;
  rowsel::warp_row(acc, logits + row * K,
                   gumbel != nullptr ? gumbel + row * K : nullptr, mask, K,
                   temperature);
  if (threadIdx.x % 32 == 0) write_row(acc, x, tau, out, row, t, version);
}

template <typename T, int kNoise>
__global__ void __launch_bounds__(rowsel::kBlockThreads)
dndm_update_block_kernel(const T* __restrict__ logits,
                         const float* __restrict__ gumbel,
                         const float* __restrict__ mask,
                         const int* __restrict__ x,
                         const int* __restrict__ tau, int* __restrict__ out,
                         int K, int t, int version, float temperature) {
  const long long row = blockIdx.x;
  rowsel::Argmax acc;
  rowsel::block_row<T, kNoise>(acc, logits + row * K,
                               gumbel != nullptr ? gumbel + row * K : nullptr,
                               mask, K, temperature);
  if (threadIdx.x == 0) write_row(acc, x, tau, out, row, t, version);
}

template <typename T>
int launch(const void* logits_, const void* gumbel_, const void* mask_,
           const void* x_, const void* tau_, void* out_, long long rows,
           int K, int t, int version, float temperature, void* stream_) {
  if (rows == 0) return 0;
  if (K <= 0 || (version != 1 && version != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* logits = static_cast<const T*>(logits_);
  const float* gumbel = static_cast<const float*>(gumbel_);
  const float* mask = static_cast<const float*>(mask_);
  const int* x = static_cast<const int*>(x_);
  const int* tau = static_cast<const int*>(tau_);
  int* out = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (K < rowsel::kBlockMinK) {
    const unsigned grid = static_cast<unsigned>(
        (rows + rowsel::kWarpsPerBlock - 1) / rowsel::kWarpsPerBlock);
    dndm_update_warp_kernel<T>
        <<<grid, rowsel::kWarpsPerBlock * 32, 0, stream>>>(
            logits, gumbel, mask, x, tau, out, rows, K, t, version,
            temperature);
  } else {
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(rows);
    switch (rowsel::noise_case<T>(logits_, gumbel_)) {
      case rowsel::kNoNoise:
        dndm_update_block_kernel<T, rowsel::kNoNoise>
            <<<grid, rowsel::kBlockThreads, 0, stream>>>(
                logits, gumbel, mask, x, tau, out, K, t, version, temperature);
        break;
      case rowsel::kNoiseAligned:
        dndm_update_block_kernel<T, rowsel::kNoiseAligned>
            <<<grid, rowsel::kBlockThreads, 0, stream>>>(
                logits, gumbel, mask, x, tau, out, K, t, version, temperature);
        break;
      default:
        dndm_update_block_kernel<T, rowsel::kNoiseShifted>
            <<<grid, rowsel::kBlockThreads, 0, stream>>>(
                logits, gumbel, mask, x, tau, out, K, t, version, temperature);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/dndm_update/ops.py,
// one entry point per logits dtype.  Pointers are device pointers; gumbel
// may be null.  Returns the CUDA error code of the launch (0 on success).
extern "C" int dndm_update_f32(const void* logits, const void* gumbel,
                               const void* mask, const void* x,
                               const void* tau, void* out, long long rows,
                               int K, int t, int version, float temperature,
                               void* stream) {
  return launch<float>(logits, gumbel, mask, x, tau, out, rows, K, t,
                       version, temperature, stream);
}

extern "C" int dndm_update_bf16(const void* logits, const void* gumbel,
                                const void* mask, const void* x,
                                const void* tau, void* out, long long rows,
                                int K, int t, int version, float temperature,
                                void* stream) {
  return launch<__nv_bfloat16>(logits, gumbel, mask, x, tau, out, rows, K, t,
                               version, temperature, stream);
}
