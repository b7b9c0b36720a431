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
//   * an output tile is 128 features x 128 tokens, each of two consumer
//     warpgroups 64 x 128 by wgmma m64n128k8;
//   * warp specialisation: a third, producer warpgroup (its registers
//     lowered by setmaxnreg, the consumers' raised) moves the operands.
//     One of its threads issues TMA loads, 32 of K a stage, into a ring of
//     4 stages: the x tile in wgmma's 128-byte swizzle (a token a 128-byte
//     row), the W tile in 128-byte swizzled boxes (N-major: 4 boxes of 32
//     features x 32 of K; K-major: one box, a feature a row).  TMA fills
//     zeros past M, N and K.  Its other 3 warps split each landed x tile
//     into its big half (in place) and its small half (beside it), then
//     mark the stage full.  A consumer waits on the stage's full barrier,
//     loads its W fragments, issues its 12 wgmma and, once they are done,
//     releases the stage on its empty barrier: no block-wide barrier in
//     the K loop;
//   * which features a consumer thread's fragment rows hold is chosen so
//     that its fragment loads are free of bank conflicts in the swizzled W
//     tile, and so that row g + 8 holds the feature next to row g's: the
//     epilogue stores both as one 8-byte pair;
//   * the two consumers take turns on the tensor cores (two named
//     barriers): one issues a K tile's products while the other waits for
//     its own, loads the next fragments and promotes, so one set of
//     fragments a warpgroup suffices and the tensor cores see no gap;
//   * the tensor cores add into their accumulator rounding toward zero, so
//     a sum carried through all of K drifts by a bias of about half an ulp
//     each step: 3e-4 of unit outputs at K = 10240 on an H100, where a
//     plain f32 GEMM is 2e-6 off, and the served logits' limits would not
//     hold.  So the products of each pair of K tiles (24 wgmma) go to a
//     fresh accumulator, which is then added to the running sum on the
//     CUDA cores, rounded to nearest, in K order;
//   * persistent: the grid is min(tiles x K parts, SMs), one block an SM
//     (197,728 bytes of shared memory), and each block walks its tiles in a
//     fixed order while the producer loads the next tile's stages during
//     the last one's epilogue.  Where the tiles fill the SMs unevenly (zamba2's
//     N = 2560 products: 160 tiles), the wrapper splits K into parts by a
//     fixed rule of the shape (ops.split_k): each part writes its own f32
//     slice and a second kernel sums the slices in a fixed order.  Every
//     output element is computed by one block in one fixed order, so the
//     result does not depend on timing.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "tf32.cuh"

namespace {

constexpr int kBM = 128;  // tokens of a tile: wgmma's N
constexpr int kBN = 128;  // features of a tile: 2 consumer warpgroups x 64
constexpr int kBK = 32;   // K a stage holds: one 128-byte row of f32
constexpr int kStages = 4;
constexpr int kThreads = 384;      // the producer warpgroup, 2 consumers
constexpr int kSplitThreads = 96;  // producer warps 0-2; warp 3 loads
constexpr int kTile = kBM * kBK * 4;  // bytes of an x tile and a W tile
// a stage: x big (swizzled), x small (the same layout), the W tile; on
// 1024-byte boundaries (the swizzle's period), so the dynamic shared
// memory is aligned by hand; the stages' barriers follow them
constexpr int kStage = 3 * kTile;
constexpr int kSmemBytes = kStages * kStage + 3 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
static_assert(kBN * kBK * 4 == kTile, "a W tile is an x tile's size");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// mbarriers: a stage's loaded (TMA bytes), full (split) and empty (used)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
// a 2-D box of `map` at (c0 innermost, c1) into shared memory at dst; its
// bytes complete on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// the consumers' turns: named barriers 1 and 2, their 256 threads
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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

// The block's walk: tile `item` (tokens fastest, then features, then K
// parts) and the K tiles of its part.
struct Tile {
  int m0, n0, kbeg, ktiles;
  long long part;
};
__device__ __forceinline__ Tile tile_of(long long item, int tiles_m,
                                        int tiles_n, int K, int k_part) {
  Tile t;
  const long long rest = item / tiles_m;
  t.m0 = static_cast<int>(item % tiles_m) * kBM;
  t.n0 = static_cast<int>(rest % tiles_n) * kBN;
  t.part = rest / tiles_n;
  const long long kbeg = t.part * k_part;
  const long long kend = min((long long)K, kbeg + k_part);
  t.kbeg = static_cast<int>(kbeg);
  t.ktiles = kend > kbeg ? static_cast<int>((kend - kbeg + kBK - 1) / kBK) : 0;
  return t;
}

// The feature (within the tile) of fragment row g (0-7) of consumer warp q
// (0-7); row g + 8 holds the feature next to it, f ^ 1.  The loads of a
// fragment register by a warp hit 32 distinct banks: N-major, element (k,
// n) of a 32-feature box lies at 128 k + 16 ((n / 4) ^ (k % 8)) + 4 (n % 4)
// bytes, and the 8 rows' features cover each n % 4 twice, with n / 4 of
// the two differing in bit 2; K-major, a feature is a 128-byte row whose
// 16-byte chunks are swizzled by f % 8, and the 8 rows of an ldmatrix
// cover f % 8 once each.
template <bool kWKMajor>
__device__ __forceinline__ int row_feature(int q, int g) {
  return kWKMajor ? 16 * q + g + 8 * (g & 1)
                  : 32 * (q >> 1) + 8 * (q & 1) + (g & 3) + 4 * (g & 1) +
                        16 * (g >> 2);
}

__device__ __forceinline__ void store_pair(float* C, int m, int n, float lo,
                                           float hi, int M, int N, bool pairs) {
  if (m >= M) return;
  float* p = C + (long long)m * N + n;
  if (pairs && n < N) {  // N even: n + 1 < N too, p 8-byte aligned
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
    return;
  }
  if (n < N) p[0] = lo;
  if (n + 1 < N) p[1] = hi;
}

template <bool kWKMajor>
__global__ void __launch_bounds__(kThreads, 1)
    dense_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      float* __restrict__ C, int M, int N, int K, int k_part,
                      int tiles_m, int tiles_n, long long items) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + kStages * kStage;
  auto loaded = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(full(s), kSplitThreads);
      mbar_init(empty(s), 8);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if ((tid >> 5) == 3) {  // the loads: tile j of the walk into stage j % S
      if (lane != 0) return;
      int j = 0;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const Tile t = tile_of(item, tiles_m, tiles_n, K, k_part);
        for (int kt = 0; kt < t.ktiles; ++kt, ++j) {
          const int s = j % kStages;
          if (j >= kStages) mbar_wait(empty(s), (j / kStages - 1) & 1);
          mbar_expect_tx(loaded(s), 2 * kTile);
          const uint32_t st = base + s * kStage;
          const int k0 = t.kbeg + kt * kBK;
          tma_load(st, &xmap, loaded(s), k0, t.m0);
          if (kWKMajor) {
            tma_load(st + 2 * kTile, &wmap, loaded(s), k0, t.n0);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              tma_load(st + 2 * kTile + b * (kTile / 4), &wmap, loaded(s),
                       t.n0 + 32 * b, k0);
          }
        }
      }
      return;
    }
    // the split: each landed x tile to its big (in place) and small halves
    int tiles = 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x)
      tiles += tile_of(item, tiles_m, tiles_n, K, k_part).ktiles;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(loaded(s), (j / kStages) & 1);
      char* st = smem + s * kStage;
      for (int off = tid * 16; off < kTile; off += kSplitThreads * 16) {
        uint4* pb = reinterpret_cast<uint4*>(st + off);
        uint4* ps = reinterpret_cast<uint4*>(st + kTile + off);
        const float4 v = *reinterpret_cast<const float4*>(pb);
        uint4 b, sm;
        tc::split(v.x, b.x, sm.x);
        tc::split(v.y, b.y, sm.y);
        tc::split(v.z, b.z, sm.z);
        tc::split(v.w, b.w, sm.w);
        *pb = b;
        *ps = sm;
      }
      // the generic stores visible to wgmma's (async proxy) reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full(s));
    }
    return;
  }

  // the consumers: warpgroup c computes features 64 c .. 64 c + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, q = (tid >> 5) - 4;
  const int g = lane >> 2, t = lane & 3;
  const int fr = row_feature<kWKMajor>(q, g);
  // this thread's fragment offsets within a stage's W tile, in floats, for
  // K slice 0: N-major, rows k = t and t + 4 of its box, features fr and
  // fr ^ 1 (slice kk adds 8 rows, 256 floats); K-major, the ldmatrix row
  // this lane gives (feature f, a row of fragment matrix lane / 8), whose
  // 16-byte chunks are swizzled by f % 8
  int wo[4];
  int f7 = 0;
  if (kWKMajor) {
    const int f = row_feature<true>(q, lane & 7) ^ ((lane >> 3) & 1);
    wo[0] = f * 32;
    f7 = f & 7;
  } else {
    const int box = fr >> 5, n = fr & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = t + 4 * h;
      const int row = box * (kBK * 32) + k * 32 + (((n >> 2) ^ k) << 2);
      wo[2 * h] = row + (n & 3);
      wo[2 * h + 1] = row + ((n & 3) ^ 1);
    }
  }
  auto frags = [&](tc::Frag<4> (&af)[4], int s) {
    const float* sw =
        reinterpret_cast<const float*>(smem + s * kStage + 2 * kTile);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[4];
      if (kWKMajor) {
        uint32_t r[4];
        ldsm_x4(r, smem_u32(sw + wo[0] +
                            (((2 * kk + (lane >> 4)) ^ f7) << 2)));
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(r[i]);
      } else {
        // a0 (row g, k t), a1 (row g + 8, k t), a2 (g, t + 4), a3
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = sw[kk * 256 + wo[i]];
      }
      af[kk].set(v);
    }
  };
  // d (+)= the warpgroup's 64 features x the 128 tokens over the tile in
  // stage s, small products first, as tc::mma3
  float d[64];
  auto multiply = [&](const tc::Frag<4> (&af)[4], int s, bool fresh) {
    const uint32_t xb = base + s * kStage, xs = xb + kTile;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_128(d, af[kk].small, desc_sw128(xb + kk * 32), kk > 0 || !fresh);
      wgmma_128(d, af[kk].big, desc_sw128(xs + kk * 32), 1);
      wgmma_128(d, af[kk].big, desc_sw128(xb + kk * 32), 1);
    }
    wg_commit();
  };
  const bool pairs = N % 2 == 0;
  int j = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const Tile tl = tile_of(item, tiles_m, tiles_n, K, k_part);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < tl.ktiles; ++kt, ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      mbar_wait(loaded(s), ph);  // the W tile's bytes
      mbar_wait(full(s), ph);    // the x tile split
      tc::Frag<4> af[4];
      frags(af, s);
      // turns: consumer 0 issues tile j once consumer 1 has issued tile
      // j - 1, consumer 1 once consumer 0 has issued tile j
      if (c == 1)
        turn_wait(2);
      else if (j > 0)
        turn_wait(1);
      multiply(af, s, (kt & 1) == 0);
      turn_pass(c == 0 ? 2 : 1);
      wg_wait<0>();
      // the fragments and d are in use until the products are done; these
      // empty asm statements keep the compiler from reusing or reading the
      // registers before the wait
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          keep(af[kk].big[i]);
          keep(af[kk].small[i]);
        }
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(d[i]);
      if (lane == 0) mbar_arrive(empty(s));
      // the promotion, after each pair of K tiles and the part's last tile
      if ((kt & 1) || kt + 1 == tl.ktiles) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
      }
    }
    // acc[4i + e]: feature fr (fr ^ 1 for e >= 2), token 8 i + 2 t (+1 for
    // odd e); an odd fr is the pair's upper feature
    float* out = C + tl.part * M * N;
    const bool odd = g & 1;
    const int n = tl.n0 + (fr & ~1);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = tl.m0 + 8 * i + 2 * t;
      store_pair(out, m, n, odd ? acc[4 * i + 2] : acc[4 * i],
                 odd ? acc[4 * i] : acc[4 * i + 2], M, N, pairs);
      store_pair(out, m + 1, n, odd ? acc[4 * i + 3] : acc[4 * i + 1],
                 odd ? acc[4 * i + 1] : acc[4 * i + 3], M, N, pairs);
    }
  }
  // consumer 1 passed the turn after its last tile: take it
  if (c == 0 && j > 0) turn_wait(1);
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

// cuTensorMapEncodeTiled, a driver function, reached through the runtime:
// the library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A row-major f32 matrix (rows x cols, row stride ld, all in elements) as
// TMA reads it: boxes of 32 columns (128 bytes) x box_rows rows, 128-byte
// swizzle, zeros past its edges.  A map depends on nothing else, so maps
// are kept by those five numbers: the weights' maps (and the activations',
// whose buffers the allocator hands out again) are encoded once.
struct MapKey {
  uintptr_t ptr;
  long long rows, cols, ld;
  int box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && ld == o.ld &&
           box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr;
    for (uint64_t v : {(uint64_t)k.rows, (uint64_t)k.cols, (uint64_t)k.ld,
                       (uint64_t)k.box_rows})
      h = (h ^ v) * 0x100000001b3ULL;
    return static_cast<size_t>(h ^ (h >> 29));
  }
};
constexpr size_t kMapsKept = 4096;

int tensor_map(CUtensorMap* out, const float* ptr, long long rows,
               long long cols, long long ld, int box_rows) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{reinterpret_cast<uintptr_t>(ptr), rows, cols, ld, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = maps.find(key);
  if (hit != maps.end()) {
    *out = hit->second;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (maps.size() >= kMapsKept) maps.clear();
  maps.emplace(key, *out);
  return 0;
}

// The kernel's shared memory above the default 48 KB is allowed once per
// instantiation and device: the attribute holds for the process, and
// setting it on every launch cost host time in each product.
constexpr int kDevices = 64;

template <bool kWKMajor>
int launch_gemm(const float* A, const float* B, float* C, int M, int N,
                int K, long long lda, long long ldb, int parts, int sms,
                cudaStream_t stream) {
  static bool allowed[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(dense_gemm_kernel<kWKMajor>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = true;
  }
  CUtensorMap xmap, wmap;
  int rc = tensor_map(&xmap, A, M, K, lda, kBM);
  if (!rc)
    rc = kWKMajor ? tensor_map(&wmap, B, N, K, ldb, kBN)
                  : tensor_map(&wmap, B, K, N, ldb, kBK);
  if (rc) return rc;
  const int k_part = (((K + kBK - 1) / kBK + parts - 1) / parts) * kBK;
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const long long items = (long long)tiles_m * tiles_n * parts;
  const int grid = static_cast<int>(items < sms ? items : sms);
  dense_gemm_kernel<kWKMajor><<<grid, kThreads, kSmemBytes, stream>>>(
      xmap, wmap, C, M, N, K, k_part, tiles_m, tiles_n, items);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/dense_gemm/ops.py.
// A: M x K f32, row stride lda, unit column stride.  B: K x N f32; b_kmajor
// 0: row stride ldb, unit column stride; 1: B^T (N x K) has row stride ldb
// and unit column stride.  C: contiguous M x N f32.  TMA reads rows that
// start on 16-byte boundaries at 16-byte strides, so A and B start on
// 16-byte boundaries and lda and ldb are multiples of 4; K, and N where B
// is N-major, are multiples of 4 too, the terms the wrapper routes by
// (anything else is refused, as it is there).  parts > 1: work is
// contiguous f32 scratch of parts x M x N, which the K parts fill and the
// sum pass reads.  sms: the device's SM count, the persistent grid's
// most blocks.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int dense_gemm_f32(const float* A, const float* B, float* C,
                              float* work, int M, int N, int K,
                              long long lda, long long ldb, int b_kmajor,
                              int parts, int sms, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 0 || parts < 1 || sms < 1 ||
      (parts > 1 && !work) || !aligned16(A) || !aligned16(B) || lda % 4 ||
      ldb % 4 || K % 4 || (!b_kmajor && N % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (K == 0)  // an empty sum: TMA takes no dimension of 0
    return static_cast<int>(
        cudaMemsetAsync(C, 0, sizeof(float) * (size_t)M * N, cs));
  float* out = parts > 1 ? work : C;
  const int err =
      b_kmajor
          ? launch_gemm<true>(A, B, out, M, N, K, lda, ldb, parts, sms, cs)
          : launch_gemm<false>(A, B, out, M, N, K, lda, ldb, parts, sms, cs);
  if (err || parts == 1) return err;
  const long long n = (long long)M * N;
  const long long items = n % 4 == 0 ? n / 4 : n;
  const long long want = (items + 255) / 256;
  const long long blocks = want < sms * 8LL ? want : sms * 8LL;
  dense_gemm_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, cs>>>(
      work, C, n, parts);
  return static_cast<int>(cudaGetLastError());
}
