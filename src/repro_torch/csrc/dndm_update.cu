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
// used for one comparison; at the serving shape (B, N, K) = (8, 256, 28)
// with Gumbel noise that is about 0.46 MB, a fraction of a microsecond
// at 3.35 TB/s, so on the main path the kernel is bound by its launch.
// The design therefore does the least per byte: one warp per (b, n) row,
// lanes striding over K with coalesced loads (K = 28 is one warp
// iteration), a register (max, argmax) per lane, and a shuffle reduction
// across the warp.  Any K is handled in-kernel; nothing is padded, and
// the (B, N, K) adjusted logits never reach device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dndm_update_kernel(const T* __restrict__ logits,
                   const float* __restrict__ gumbel,
                   const float* __restrict__ mask,
                   const int* __restrict__ x, const int* __restrict__ tau,
                   int* __restrict__ out, long long rows, int K, int t,
                   int version, float temperature) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp: one warp, one row

  const T* lrow = logits + row * K;
  const float* grow = gumbel != nullptr ? gumbel + row * K : nullptr;
  const bool scale = temperature != 1.0f;

  // Lane-local (max, argmax): k increases, and only a strictly larger
  // value replaces the running max, so each lane keeps its lowest index.
  float best = -INFINITY;
  int best_idx = 0;
  for (int k = lane; k < K; k += 32) {
    float a = to_float(lrow[k]);
    if (scale) a = __fdiv_rn(a, temperature);
    a = __fadd_rn(a, mask[k]);
    if (grow != nullptr) a = __fadd_rn(a, grow[k]);
    if (a > best) {
      best = a;
      best_idx = k;
    }
  }
  // Warp reduction: the larger value wins, equal values go to the lower
  // index — the first maximum, as argmax defines it.
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_idx, off);
    if (ob > best || (ob == best && oi < best_idx)) {
      best = ob;
      best_idx = oi;
    }
  }
  if (lane == 0) {
    const int tv = tau[row];
    const bool reveal = version == 1 ? (tv == t) : (tv >= t);
    out[row] = reveal ? best_idx : x[row];
  }
}

template <typename T>
int launch(const void* logits, const void* gumbel, const void* mask,
           const void* x, const void* tau, void* out, long long rows, int K,
           int t, int version, float temperature, void* stream) {
  if (rows == 0) return 0;
  if (K <= 0 || (version != 1 && version != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((rows + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  dndm_update_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), static_cast<const float*>(gumbel),
      static_cast<const float*>(mask), static_cast<const int*>(x),
      static_cast<const int*>(tau), static_cast<int*>(out), rows, K, t,
      version, temperature);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/dndm_update/ops.py.
// Pointers are device pointers; gumbel may be null.  Returns the CUDA
// error code of the launch (0 on success).
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
