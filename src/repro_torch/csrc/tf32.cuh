// Building blocks shared by the tensor-core kernels (flash_attention.cu,
// ssd_scan.cu, dense_gemm.cu): the 3xTF32 split, mma.sync m16n8k8 in
// TF32, cp.async.
//
// 3xTF32.  A TF32 operand keeps 10 of f32's 23 mantissa bits, which is
// not enough for the port's f32 bars (one TF32 pass misses them at
// attention and at the SSD scan; tests/test_torch_tf32.py).  Each f32
// operand is split into big = tf32(a) and small = a - big, and
//   a b ~ big_a big_b + big_a small_b + small_a big_b,
// with the small products accumulated first, as CUTLASS's
// OpMultiplyAddFastF32 does.  The dropped small_a small_b term is below
// f32's own rounding.  big is rounded to nearest, ties away from zero
// (cvt.rna), with integer operations so that the CPU emulation in
// tests/test_torch_tf32.py reproduces it bit for bit; small goes to the
// tensor cores as it is, which read a TF32 operand's top 19 bits (so
// small is truncated there; a, big + small agree to 2^-21 relative).
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)   b1 (t + 4, g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

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

// f32 -> tf32 bits, round to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b on the tensor cores, TF32 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A or B fragment as big and small halves.
template <int R>
struct Frag {
  uint32_t big[R], small[R];
  __device__ __forceinline__ void set(const float (&v)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) split(v[i], big[i], small[i]);
  }
  // operands that are exact in TF32 (bf16 inputs): small is 0
  __device__ __forceinline__ void set_exact(const float (&v)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      big[i] = __float_as_uint(v[i]);
      small[i] = 0u;
    }
  }
};

// d += a b in 3xTF32; kA / kB false where that operand is exact in TF32
// (its small half is 0 and its product is skipped)
template <bool kA = true, bool kB = true>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  if (kA) mma(d, a.small, b.big);
  if (kB) mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
// 4-byte asynchronous copy global -> shared; zero-fills when !pred
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
