// Dense f32 matrix product for Hopper, sm_90a, on the tensor cores:
// C (M x N) = A (M x K) B (K x N), the model's dense products x @ W.
//
// Replaces no TPU kernel: the JAX package leaves its dense products to
// XLA.  It was added because they take four fifths of the card's time in
// every served model, and PyTorch's f32 GEMM (TF32 off) runs them on the
// CUDA cores, near their 67 TFLOP/s.  One TF32 pass would be below the
// f32 bar the configurations state, so every product here is three TF32
// tensor-core products with f32 accumulation (3xTF32, the split of
// tf32.cuh: small_a big_b + big_a small_b + big_a big_b, small products
// first), as flash_attention.cu and ssd_scan.cu compute.
//
// A is row-major with row stride lda (the activations, "x").  B is the
// weight as the port stores it, (d_in, d_out) row-major ("N-major", row
// stride ldb), or its transposed view (the tied head's embed.T:
// "K-major", B^T row-major with row stride ldb).  C is contiguous.
//
// What bounds it: operations.  At the served shapes (M = 8192 for text8,
// 1024 for zamba2; K, N 768-32000) the product does 300-3000 operations a
// byte, far above the card's balance: the bound is 2 M N K at a third of
// the 495 TFLOP/s TF32 rate.  The design:
//   * wgmma, Hopper's warpgroup product, runs at twice mma.sync's TF32
//     rate.  Its TF32 operands must be K-major in shared memory, or the
//     left one in registers.  The weight is N-major, so the kernel
//     computes C^T = W^T x^T: W^T is the left operand, read from a plain
//     f32 tile into registers and split there, and x^T, K-major as x is
//     stored, the right one.  No copy of the weight is transposed;
//   * a block of 2 warpgroups computes 128 features x 128 tokens, each
//     warpgroup 64 x 128 by wgmma m64n128k8;
//   * K advances 32 at a time through a 4-stage ring in shared memory
//     filled by 16-byte cp.async copies (so rows start on 16-byte
//     boundaries, as every served operand's do; models/layers.py's dense
//     gives other operands to PyTorch's product): per stage the x tile in
//     wgmma's 128-byte swizzled layout (one 128-byte row a token), and
//     the W tile with a row pitch that makes the fragment loads free of
//     bank conflicts.  Once landed, the x tile is split in place into its
//     big half, the small half beside it, while the previous tile's
//     products run;
//   * the tensor cores add into their accumulator rounding toward zero, so
//     a sum carried through all of K drifts by a bias of about half an ulp
//     each step: 3e-4 of unit outputs at K = 10240 on an H100, where a
//     plain f32 GEMM is 2e-6 off, and the served logits' limits would not
//     hold.  So the products of each pair of K tiles (24 wgmma) go to a
//     fresh accumulator, which is then added to the running sum on the
//     CUDA cores, rounded to nearest;
//   * ragged M, N and K (no tile multiples; K and an N-major N multiples
//     of 4) are masked inside: copies past an edge fill zeros and stores
//     past it are skipped;
//   * a block needs 200 KB of shared memory and 240 registers a thread, so
//     one runs per SM.  Where the grid has too few tiles to fill the 132
//     SMs evenly (zamba2's N = 2560 products: 160 tiles), the wrapper
//     splits K in up to 4 parts by a fixed rule of the shape
//     (ops.split_k): each part writes its own f32 slice and a second
//     kernel sums the slices in a fixed order, so the result does not
//     depend on timing.
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kBM = 128;  // tokens of a block: wgmma's N
constexpr int kBN = 128;  // features of a block: 2 warpgroups x 64
constexpr int kBK = 32;   // K a stage holds: one 128-byte row of f32
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kPitchN = kBN + 8;  // W rows along N (N-major): 136 floats
constexpr int kPitchK = kBK + 4;  // W rows along K (K-major): 36 floats

// A stage: x big (swizzled, 128 rows of 128 bytes), x small (the same
// layout), the W tile; stages on 1024-byte boundaries (the swizzle's
// period), so the dynamic shared memory is aligned by hand.
template <bool kWKMajor>
struct Smem {
  static constexpr int kX = kBM * kBK * 4;
  static constexpr int kW = (kWKMajor ? kBN * kPitchK : kBK * kPitchN) * 4;
  static constexpr int kStage = ((2 * kX + kW + 1023) / 1024) * 1024;
  static constexpr int kBytes = kStages * kStage + 1024;
};
static_assert(Smem<true>::kBytes <= 227 * 1024, "a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// K-major operand, 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// An empty asm that claims to read and write x: the compiler keeps x in its
// register, unread and unchanged, up to this point (the registers that an
// asynchronous wgmma reads or writes, until its wait).
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d (64 x 128 f32, wgmma's accumulator layout) (+)= a (64 x 8, registers)
// . b (8 x 128, K-major in shared memory)
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The x tile (kBM tokens x kBK of K) of a row-major operand g (row stride
// ld) into s, a token a 128-byte row, its 16-byte chunk c stored at chunk
// c ^ (row % 8): wgmma's 128-byte swizzle.  What lies past M or kend is
// filled with zeros.
__device__ __forceinline__ void load_x(char* s, const float* g, long long ld,
                                       int m0, int M, int k0, int kend,
                                       int tid) {
#pragma unroll
  for (int i = 0; i < kBM * 8 / kThreads; ++i) {
    const int q = tid + i * kThreads;
    const int r = q >> 3, c = q & 7;
    const bool ok = m0 + r < M && k0 + 4 * c < kend;
    tc::cp_async16(s + r * 128 + ((c ^ (r & 7)) << 4),
                   ok ? g + (long long)(m0 + r) * ld + k0 + 4 * c : g, ok);
  }
}

// The W tile (kBK of K x kBN features) into s: K rows of pitch kPitchN
// (N-major W), or feature rows of pitch kPitchK (K-major W).  What lies past
// N or kend is filled with zeros.
template <bool kWKMajor>
__device__ __forceinline__ void load_w(float* s, const float* g, long long ld,
                                       int n0, int N, int k0, int kend,
                                       int tid) {
  if (kWKMajor) {  // W^T rows (N x K)
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 3, col = (q & 7) * 4;
      const bool ok = n0 + r < N && k0 + col < kend;
      tc::cp_async16(s + r * kPitchK + col,
                     ok ? g + (long long)(n0 + r) * ld + k0 + col : g, ok);
    }
  } else {  // W rows (K x N)
#pragma unroll
    for (int i = 0; i < kBK * (kBN / 4) / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / (kBN / 4), col = (q % (kBN / 4)) * 4;
      const bool ok = k0 + r < kend && n0 + col < N;
      tc::cp_async16(s + r * kPitchN + col,
                     ok ? g + (long long)(k0 + r) * ld + n0 + col : g, ok);
    }
  }
}

__device__ __forceinline__ void store_one(float* C, int r, int c, float x,
                                          int M, int N) {
  if (r < M && c < N) C[(long long)r * N + c] = x;
}

template <bool kWKMajor>
__global__ void __launch_bounds__(kThreads, 1)
    dense_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K,
                      long long lda, long long ldb, int k_part) {
  extern __shared__ __align__(16) char smem_raw[];
  using L = Smem<kWKMajor>;
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wq = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_part;
  const int kend = min(K, kbeg + k_part);
  const int ktiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  float* out = C + (long long)blockIdx.z * M * N;

  auto load = [&](int stage, int kt) {
    char* st = smem + stage * L::kStage;
    const int k0 = kbeg + kt * kBK;
    load_x(st, A, lda, m0, M, k0, kend, tid);
    load_w<kWKMajor>(reinterpret_cast<float*>(st + 2 * L::kX), B, ldb,
                           n0, N, k0, kend, tid);
  };

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    tc::cp_async_commit();
  }
  const int nb = wg * 64 + wq * 16;  // this warp's 16 features
  // the x tile of a landed stage to its big (in place) and small halves
  auto convert = [&](int stage) {
    char* st = smem + stage * L::kStage;
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {
      const int off = (tid + i * kThreads) * 16;
      uint4* pb = reinterpret_cast<uint4*>(st + off);
      uint4* ps = reinterpret_cast<uint4*>(st + L::kX + off);
      const float4 v = *reinterpret_cast<const float4*>(pb);
      uint4 b, s;
      tc::split(v.x, b.x, s.x);
      tc::split(v.y, b.y, s.y);
      tc::split(v.z, b.z, s.z);
      tc::split(v.w, b.w, s.w);
      *pb = b;
      *ps = s;
    }
    // make the generic stores visible to wgmma's (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  if (ktiles > 0) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    convert(0);
    __syncthreads();
  }
  // this warp's W^T fragments (16 features x 8 of K) for the 4 slices of
  // the tile in stage `stage`
  auto frags = [&](tc::Frag<4> (&af)[4], int stage) {
    const float* sw =
        reinterpret_cast<const float*>(smem + stage * L::kStage + 2 * L::kX);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[4];
      if (kWKMajor) {
        uint32_t r[4];
        ldsm_x4(r, sw + (nb + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitchK +
                       kk * 8 + (lane >> 4) * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = __uint_as_float(r[q]);
      } else {
        v[0] = sw[(kk * 8 + t) * kPitchN + nb + g];
        v[1] = sw[(kk * 8 + t) * kPitchN + nb + g + 8];
        v[2] = sw[(kk * 8 + t + 4) * kPitchN + nb + g];
        v[3] = sw[(kk * 8 + t + 4) * kPitchN + nb + g + 8];
      }
      af[kk].set(v);
    }
  };
  // d (+)= the warpgroup's 64 features x the 128 tokens over the tile in
  // `stage`, small products first, as tc::mma3
  auto multiply = [&](const tc::Frag<4> (&af)[4], int stage, bool fresh) {
    const uint32_t xb = smem_u32(smem + stage * L::kStage), xs = xb + L::kX;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_128(d, af[kk].small, desc_sw128(xb + kk * 32), kk > 0 || !fresh);
      wgmma_128(d, af[kk].big, desc_sw128(xs + kk * 32), 1);
      wgmma_128(d, af[kk].big, desc_sw128(xb + kk * 32), 1);
    }
    wg_commit();
  };
  // while tile kt's products run: tile kt + 1 lands and is split, and tile
  // kt + S - 1 starts loading into the stage of tile kt - 1, whose
  // products are done
  auto prepare = [&](int kt) {
    tc::cp_async_wait<kStages - 3>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next % kStages, next);
    tc::cp_async_commit();
    convert((kt + 1) % kStages);
  };
  // tiles in pairs: d sums the 24 products of a pair on the tensor cores
  // and is then added to acc on the CUDA cores (the promotion)
  for (int kt = 0; kt < ktiles; kt += 2) {
    tc::Frag<4> a0[4], a1[4];
    frags(a0, kt % kStages);
    multiply(a0, kt % kStages, true);
    if (kt + 1 < ktiles) {
      prepare(kt);
      __syncthreads();  // tile kt + 1 split and visible
      frags(a1, (kt + 1) % kStages);
      multiply(a1, (kt + 1) % kStages, false);
      if (kt + 2 < ktiles) {
        wg_wait<1>();     // tile kt's products are done: its stage is free
        prepare(kt + 1);
      }
    }
    wg_wait<0>();
    // the fragments and d are in use until the products are done; these
    // empty asm statements keep the compiler from reusing or reading the
    // registers before the wait
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        keep(a0[kk].big[q]);
        keep(a0[kk].small[q]);
        keep(a1[kk].big[q]);
        keep(a1[kk].small[q]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      keep(d[i]);
      acc[i] += d[i];
    }
    __syncthreads();  // the split tile kt + 2 is visible; stages are free
  }
  // acc[4j + e]: feature nb + g (+8 for e >= 2), token 8j + 2t (+1 for odd e)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + 8 * j + 2 * t, n = n0 + nb + g;
    store_one(out, m, n, acc[4 * j], M, N);
    store_one(out, m + 1, n, acc[4 * j + 1], M, N);
    store_one(out, m, n + 8, acc[4 * j + 2], M, N);
    store_one(out, m + 1, n + 8, acc[4 * j + 3], M, N);
  }
}

// C[i] = sum over z = 0 .. parts - 1, in that order, of W[z n + i].
__global__ void dense_gemm_sum_kernel(const float* __restrict__ W,
                                      float* __restrict__ C, long long n,
                                      int parts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n % 4 == 0) {
    const long long n4 = n / 4;
    const float4* w = reinterpret_cast<const float4*>(W);
    float4* c = reinterpret_cast<float4*>(C);
    for (long long i = first; i < n4; i += stride) {
      float4 s = w[i];
      for (int z = 1; z < parts; ++z) {
        const float4 v = w[z * n4 + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      c[i] = s;
    }
    return;
  }
  for (long long i = first; i < n; i += stride) {
    float s = W[i];
    for (int z = 1; z < parts; ++z) s += W[z * n + i];
    C[i] = s;
  }
}

// The kernel's shared memory above the default 48 KB is allowed once per
// instantiation and device: the attribute holds for the process, and
// setting it on every launch cost host time in each product.
template <bool kWKMajor>
int launch_gemm(const float* A, const float* B, float* C, int M, int N,
                int K, long long lda, long long ldb, int parts,
                cudaStream_t stream) {
  using L = Smem<kWKMajor>;
  constexpr int kDevices = 64;
  static bool allowed[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(dense_gemm_kernel<kWKMajor>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = true;
  }
  const int k_part = (((K + kBK - 1) / kBK + parts - 1) / parts) * kBK;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, parts);
  dense_gemm_kernel<kWKMajor><<<grid, kThreads, L::kBytes, stream>>>(
      A, B, C, M, N, K, lda, ldb, k_part);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/dense_gemm/ops.py.
// A: M x K f32, row stride lda, unit column stride.  B: K x N f32; b_kmajor
// 0: row stride ldb, unit column stride; 1: B^T (N x K) has row stride ldb
// and unit column stride.  C: contiguous M x N f32.  Every copy moves 16
// bytes, so A and B start on 16-byte boundaries, lda, ldb and K are
// multiples of 4, and so is N where B is N-major (the wrapper refuses
// anything else).  parts > 1: work is contiguous f32 scratch of
// parts x M x N, which the K parts fill and the sum pass reads.  Returns
// the CUDA error code of the launches (0 on success).
extern "C" int dense_gemm_f32(const float* A, const float* B, float* C,
                              float* work, int M, int N, int K,
                              long long lda, long long ldb, int b_kmajor,
                              int parts, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 0 || parts < 1 || (parts > 1 && !work) ||
      (N + kBN - 1) / kBN > 65535 || parts > 65535 || !aligned16(A) ||
      !aligned16(B) || lda % 4 || ldb % 4 || K % 4 || (!b_kmajor && N % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* out = parts > 1 ? work : C;
  const int err =
      b_kmajor
          ? launch_gemm<true>(A, B, out, M, N, K, lda, ldb, parts, cs)
          : launch_gemm<false>(A, B, out, M, N, K, lda, ldb, parts, cs);
  if (err || parts == 1) return err;
  const long long n = (long long)M * N;
  const long long items = n % 4 == 0 ? n / 4 : n;
  const long long want = (items + 255) / 256;
  const long long blocks = want < 132LL * 8 ? want : 132LL * 8;
  dense_gemm_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, cs>>>(
      work, C, n, parts);
  return static_cast<int>(cudaGetLastError());
}
