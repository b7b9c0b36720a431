// Mamba-2 SSD chunked scan for Hopper, sm_90a, on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:
// _ssd_kernel (launcher ssd_scan_kernel).  Same function, per batch row b
// and head h, over chunks of L = min(chunk, S) positions:
//
//   cs_i  = sum_{j <= i} dt_j A                   (inclusive, within a chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//           + exp(cs_i) C_i . S_c                 (S_c: state entering chunk c)
//   S_c+1 = exp(cs_L) S_c + s_c,   s_c = sum_j exp(cs_L - cs_j) dt_j B_j x_j^T
//
// with the (N, P) states in f32.  x (B,S,H,P), dt (B,S,H), B and C (B,S,N)
// shared across heads, A (H,) f32 < 0; y (B,S,H,P) in x's dtype.
//
// The TPU kernel walks the chunks of one (b, h) in grid order and carries
// the state in VMEM.  GPU blocks run in no order, so here the SSD
// decomposition of the Mamba-2 paper runs as three kernels, launched
// back to back on one stream by one C call:
//   1. ssd_state_kernel, two kinds of blocks side by side: per (b, chunk
//      < last, group of heads) each chunk's own contribution s_c = (B^T w)
//      x (N x L . L x P, w_j = exp(cs_L - cs_j) dt_j) and cs_L; per (b,
//      chunk, 16-row strip) that strip of C B^T (lower triangle), once for
//      all heads; both into f32 scratch;
//   2. ssd_carry_kernel, per (b, h), only when there are 3 chunks or more:
//      the short sequential pass S_c+1 = exp(cs_L) S_c + s_c, in place
//      (with 2 chunks the state entering chunk 1 is s_0 itself);
//   3. ssd_output_kernel, per (b, chunk, pair of heads), 16 warps, 8 per
//      head: y = M x + (exp(cs) C) S_c with M = C B^T o exp(cs_i - cs_j)
//      o dt_j formed as its fragments are loaded (L x L . L x P, lower
//      triangle only: tiles wholly above the diagonal are skipped and no
//      entry above it is exponentiated, so nothing overflows).
// Every product runs on the tensor cores as mma.sync m16n8k8 TF32 with the
// 3xTF32 split (tf32.cuh), which keeps the f32 bars that one TF32 pass
// misses.  The chunk's cumsum is a warp scan.  Tiles are staged in
// shared memory as f32 by cp.async (bf16 converted as it is loaded), with
// row pitches that make every fragment load free of bank conflicts;
// L, N and P are padded to multiples of 16 with zeros, which add nothing,
// and positions past S load zeros and are never stored.  x, B and C are
// read through strides (views of one projection in the model).
//
// What bounds it: bytes.  At the zamba2 shape (B, H, S, P, N, L) = (4, 80,
// 256, 64, 64, 128) the scan must read x, dt, B, C and write y, 42.8 MB,
// 0.0128 ms at 3.35 TB/s; its 1.36 GFLOP (C B^T once per (b, chunk), M x
// on the lower triangle, C S and the state update where they are needed)
// take 0.0083 ms at a third of the 495 TFLOP/s TF32 rate.  The scratch
// adds 5.8 MB written and read (mostly in L2).  What holds it back is
// neither: the output pass needs 213 KB of shared memory (C, C B^T and
// two heads' x and S), so one block of 16 warps runs per SM, and the
// fragment work around each mma (loads, splits, the exps of M) is
// latency-bound at that occupancy.
#include <math.h>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;     // the state and carry passes
constexpr int kWarps = kThreads / 32;
constexpr int kOutThreads = 512;  // the output pass: two groups of 8 warps,
constexpr int kGroupWarps = 8;    // each on its own head
constexpr int kMaxDim = 128;   // L, N and P each at most this
constexpr int kMaxSmem = 232448;
constexpr int kFill = 2 * 132;  // blocks for two waves over an H100's SMs

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }
// Row pitches (floats) that keep fragment loads free of bank conflicts:
// an operand read at [g][t] (A, row-major) needs pitch = 4 mod 8; one
// read at [t][g] (B with k along rows) needs pitch = 8 mod 32.
__host__ __device__ constexpr int pitch_a(int v) { return v + ((4 - v) & 7); }
__host__ __device__ constexpr int pitch_b(int v) { return v + ((8 - v) & 31); }

struct Strides {  // element strides; the last axis of x, B, C, y is 1
  long long xb, xs, xh, db, ds, dh, bb, bs, cb, cs, yb, ys, yh;
};

struct Dims {  // padded sizes and pitches, the same on host and device
  int Lp, Np, Pp;
  __host__ __device__ Dims(int L, int N, int P)
      : Lp(round16(L)), Np(round16(N)), Pp(round16(P)) {}
};

// rows_pad x cols_pad floats at dst (row pitch `pitch`) from a (valid x
// cols) tile of src with row stride rs; the rest are zeros.  f32 goes by
// 16-byte cp.async (cols % 4 == 0, rows 16-byte aligned: the wrapper
// checks), bf16 by element.  The caller commits, waits and syncs.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const T* __restrict__ src, long long rs,
                                      int valid, int rows_pad, int cols,
                                      int cols_pad) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    const int c4 = cols / 4;
    for (int e = tid; e < rows_pad * c4; e += blockDim.x) {
      const int r = e / c4, c = (e - r * c4) * 4;
      const bool ok = r < valid;
      tc::cp_async16(dst + r * pitch + c, src + (ok ? r : 0) * rs + c, ok);
    }
  } else {
    for (int e = tid; e < rows_pad * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      dst[r * pitch + c] = r < valid ? tc::to_float(src[r * rs + c]) : 0.f;
    }
  }
  const int pad = cols_pad - cols;
  for (int e = tid; e < rows_pad * pad; e += blockDim.x)
    dst[(e / pad) * pitch + cols + e % pad] = 0.f;
}

// dt of one head over the chunk (zeros past `valid`; f32 by 4-byte
// cp.async), then one warp writes the inclusive cumsum of dt a as a warp
// scan (each lane owns 4 entries).  The caller waits and syncs between the
// two.
template <typename T>
__device__ __forceinline__ void stage_dt(float* dts, const T* __restrict__ dt,
                                         long long ds, int valid, int Lp) {
  for (int j = threadIdx.x; j < Lp; j += blockDim.x) {
    if constexpr (sizeof(T) == 4)
      tc::cp_async4(dts + j, dt + (j < valid ? j : 0) * ds, j < valid);
    else
      dts[j] = j < valid ? tc::to_float(dt[j * ds]) : 0.f;
  }
}
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* css,
                                             float a, int Lp) {
  const int lane = threadIdx.x % 32;
  float v[4], run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * lane + i;
    run += j < Lp ? dts[j] * a : 0.f;
    v[i] = run;
  }
  float tot = run;  // inclusive scan of the lanes' totals
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += y;
  }
  float before = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * lane + i;
    if (j < Lp) css[j] = before + v[i];
  }
}

// ---------------------------------------------------------------------
// 1. chunk states, s_c[n][p] = sum_j B_j[n] w_j x_j[p] for c < last chunk,
//    and every chunk's C B^T (lower triangle), shared by all heads
// ---------------------------------------------------------------------
struct StateLayout {
  int ldb, ldx, bt, x, dt, cs, w, total;  // offsets in floats
  __host__ __device__ StateLayout(const Dims& d) {
    ldb = pitch_b(d.Np);  // B as [j][n], read at [t][g] as A = B^T
    ldx = pitch_b(d.Pp);  // x as [j][p], read at [t][g] as B
    bt = 0;
    x = bt + d.Lp * ldb;
    dt = x + d.Lp * ldx;
    cs = dt + d.Lp;
    w = cs + d.Lp;
    total = w + d.Lp;
  }
};

// Rows r0 .. r0 + 15 of one chunk's C B^T (L x N . N x L), columns up to
// r0 + 15, into cb (B, nc, Lp, Lp) f32.
template <typename T>
__device__ __forceinline__ void cb_strip(float* smem, const T* __restrict__ Bm,
                                         const T* __restrict__ Cm,
                                         float* __restrict__ cb, const Dims& dm,
                                         const Strides& st, int b, int c,
                                         int r0, int S, int N, int L) {
  const int ldc = pitch_a(dm.Np);  // C and B as [i][n]: read at [g][t]
  float* cms = smem;               // C rows r0 .. r0 + 15
  float* bms = smem + 16 * ldc;    // B rows 0 .. r0 + 15
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int c_valid = max(0, valid - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  stage(cms, ldc, Cm + b * st.cb + (s0 + (c_valid ? r0 : 0)) * st.cs, st.cs,
        c_valid, 16, N, dm.Np);
  stage(bms, ldc, Bm + b * st.bb + s0 * st.bs, st.bs, valid, r0 + 16, N,
        dm.Np);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  float* out = cb + ((static_cast<long long>(b) * gridDim.x + c) * dm.Lp + r0)
                        * dm.Lp;
  for (int n0 = 8 * warp; n0 < r0 + 16; n0 += 8 * kWarps) {
    float acc[4] = {};
    for (int k0 = 0; k0 < dm.Np; k0 += 8) {
      const float* cp = cms + g * ldc + k0 + t;
      const float av[4] = {cp[0], cp[8 * ldc], cp[4], cp[8 * ldc + 4]};
      const float* bp = bms + (n0 + g) * ldc + k0 + t;
      const float bv[2] = {bp[0], bp[4]};
      tc::Frag<4> af;
      af.set(av);
      tc::Frag<2> bf;
      bf.set(bv);
      tc::mma3(acc, af, bf);
    }
    *reinterpret_cast<float2*>(out + g * dm.Lp + n0 + 2 * t) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(out + (g + 8) * dm.Lp + n0 + 2 * t) =
        make_float2(acc[2], acc[3]);
  }
}

// grid (nc, head groups + Lp / 16, B): blocks y < head groups compute the
// states of chunk c < nc - 1 for their heads (those of the last chunk
// exit), the others one 16-row strip of chunk c's C B^T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ states,
                 float* __restrict__ cs_last, float* __restrict__ cb, int S,
                 int H, int P, int N, int L, int G, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const Dims dm(L, N, P);
  const int c = blockIdx.x, n_states = gridDim.x - 1;  // chunks 0 .. nc - 2
  const int b = blockIdx.z;
  const int n_groups = (H + G - 1) / G;
  if (static_cast<int>(blockIdx.y) >= n_groups) {
    cb_strip(smem, Bm, Cm, cb, dm, st, b, c, 16 * (blockIdx.y - n_groups), S,
             N, L);
    return;
  }
  if (c >= n_states) return;
  const StateLayout lay(dm);
  float* bts = smem + lay.bt;
  float* xs = smem + lay.x;
  float* dts = smem + lay.dt;
  float* css = smem + lay.cs;
  float* ws = smem + lay.w;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  stage(bts, lay.ldb, Bm + b * st.bb + s0 * st.bs, st.bs, valid, dm.Lp, N,
        dm.Np);
  const int h0 = static_cast<int>(blockIdx.y) * G;
  for (int h = h0; h < min(H, h0 + G); ++h) {
    const float a = A[h];
    stage(xs, lay.ldx, x + b * st.xb + s0 * st.xs + h * st.xh, st.xs, valid,
          dm.Lp, P, dm.Pp);
    stage_dt(dts, dt + b * st.db + s0 * st.ds + h * st.dh, st.ds, valid,
             dm.Lp);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) chunk_cumsum(dts, css, a, dm.Lp);
    __syncthreads();
    const float last = css[L - 1];
    for (int j = threadIdx.x; j < dm.Lp; j += kThreads)
      ws[j] = expf(last - css[j]) * dts[j];
    if (threadIdx.x == 0) cs_last[(b * n_states + c) * H + h] = last;
    __syncthreads();

    // (N x P) = (B^T w)(N x L) . x (L x P); tiles of 16 rows x 32 columns
    const int n_strips = dm.Np / 16, n_cb = (dm.Pp + 31) / 32;
    float* out = states + ((static_cast<long long>(b) * n_states + c) * H + h)
                              * N * P;
    for (int u = warp; u < n_strips * n_cb; u += kWarps) {
      const int r0 = (u / n_cb) * 16, p0 = (u % n_cb) * 32;
      const int nq = min(4, (dm.Pp - p0) / 8);
      float acc[4][4] = {};
      for (int k0 = 0; k0 < dm.Lp; k0 += 8) {
        const float av[4] = {
            bts[(k0 + t) * lay.ldb + r0 + g] * ws[k0 + t],
            bts[(k0 + t) * lay.ldb + r0 + g + 8] * ws[k0 + t],
            bts[(k0 + t + 4) * lay.ldb + r0 + g] * ws[k0 + t + 4],
            bts[(k0 + t + 4) * lay.ldb + r0 + g + 8] * ws[k0 + t + 4]};
        tc::Frag<4> af;
        af.set(av);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= nq) break;
          const float* xp = xs + (k0 + t) * lay.ldx + p0 + 8 * q + g;
          const float bv[2] = {xp[0], xp[4 * lay.ldx]};
          tc::Frag<2> bf;
          bf.set(bv);
          tc::mma3(acc[q], af, bf);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nq) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = r0 + g + 8 * (e / 2), p = p0 + 8 * q + 2 * t + (e & 1);
          if (n < N && p < P) out[n * P + p] = acc[q][e];
        }
      }
    }
    __syncthreads();  // x, dt, w are restaged for the next head
  }
}

// ---------------------------------------------------------------------
// 2. carry: states[i] <- S_i+1 = exp(cs_L(i)) S_i + s_i, S_1 = s_0
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_carry_kernel(float* __restrict__ states, const float* __restrict__ cs_last,
                 int n_states, int H, int NP) {
  const int h = blockIdx.x, b = blockIdx.y;
  for (int e = threadIdx.x; e < NP; e += kThreads) {
    float* p = states + (static_cast<long long>(b) * n_states * H + h) * NP + e;
    float run = p[0];
    for (int i = 1; i < n_states; ++i) {
      float* pi = p + static_cast<long long>(i) * H * NP;
      run = run * expf(cs_last[(b * n_states + i) * H + h]) + *pi;
      *pi = run;
    }
  }
}

// ---------------------------------------------------------------------
// 3. output: y = (C B^T o decay o dt) x + (exp(cs) C) S_c
// ---------------------------------------------------------------------
// Shared memory: C, C B^T (from pass 1) and two buffers of one head's x,
// entering state S, dt and cs.
struct OutLayout {
  int ldc, ldcb, ldx, c, cb, buf[2], head, x, s, dt, cs, total;
  __host__ __device__ OutLayout(const Dims& d) {
    ldc = pitch_a(d.Np);   // C and B as [i][n]: read at [g][t]
    ldcb = pitch_a(d.Lp);  // C B^T as [i][j]: read at [g][t]
    ldx = pitch_b(d.Pp);   // x [j][p] and S [n][p]: read at [t][g]
    x = 0;                 // offsets within a head buffer
    s = x + d.Lp * ldx;
    dt = s + d.Np * ldx;
    cs = dt + d.Lp;
    head = cs + d.Lp;
    c = 0;
    cb = c + d.Lp * ldc;
    buf[0] = cb + d.Lp * ldcb;
    buf[1] = buf[0] + head;
    total = buf[1] + head;
  }
};

// One head's x, entering state (chunks c > 0) and dt into a head buffer.
template <typename T>
__device__ __forceinline__ void stage_head(float* hb, const OutLayout& lay,
                                           const Dims& dm, const T* x,
                                           const T* dt, const float* states,
                                           const Strides& st, int b, int c,
                                           int h, int H, int N, int P, int L,
                                           int n_states, int valid) {
  const int s0 = c * L;
  stage(hb + lay.x, lay.ldx, x + b * st.xb + s0 * st.xs + h * st.xh, st.xs,
        valid, dm.Lp, P, dm.Pp);
  if (c > 0)  // the state entering this chunk, from passes 1 and 2
    stage(hb + lay.s, lay.ldx,
          states + ((static_cast<long long>(b) * n_states + c - 1) * H + h)
                       * N * P,
          static_cast<long long>(P), N, dm.Np, P, dm.Pp);
  stage_dt(hb + lay.dt, dt + b * st.db + s0 * st.ds + h * st.dh, st.ds, valid,
           dm.Lp);
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Cm,
                  const float* __restrict__ states,
                  const float* __restrict__ cb, T* __restrict__ y, int S,
                  int H, int P, int N, int L, int G, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const Dims dm(L, N, P);
  const OutLayout lay(dm);
  float* cms = smem + lay.c;
  float* cbs = smem + lay.cb;
  const int c = blockIdx.x, n_states = gridDim.x - 1;
  const int b = blockIdx.z;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / kGroupWarps, gw = warp % kGroupWarps;
  const int n_strips = dm.Lp / 16;
  const int h0 = static_cast<int>(blockIdx.y) * G;
  const int n_heads = min(H, h0 + G) - h0;

  stage(cms, lay.ldc, Cm + b * st.cb + s0 * st.cs, st.cs, valid, dm.Lp, N,
        dm.Np);
  {  // C B^T: row i of strip i / 16 up to the strip's last column
    const float* cbg = cb + (static_cast<long long>(b) * gridDim.x + c)
                                * dm.Lp * dm.Lp;
    for (int i = warp; i < dm.Lp; i += kOutThreads / 32)
      for (int q = 4 * lane; q < (i / 16 + 1) * 16; q += 128)
        tc::cp_async16(cbs + i * lay.ldcb + q, cbg + i * dm.Lp + q, true);
  }
  stage_head(smem + lay.buf[0], lay, dm, x, dt, states, st, b, c, h0, H, N, P,
             L, n_states, valid);
  if (n_heads > 1)
    stage_head(smem + lay.buf[1], lay, dm, x, dt, states, st, b, c, h0 + 1, H,
               N, P, L, n_states, valid);
  tc::cp_async_commit();

  // Heads go in pairs, head 2k + grp of the block to group grp; every
  // thread takes part in every barrier.
  for (int i0h = 0; i0h < n_heads; i0h += 2) {
    if (i0h > 0) {
      stage_head(smem + lay.buf[0], lay, dm, x, dt, states, st, b, c,
                 h0 + i0h, H, N, P, L, n_states, valid);
      if (i0h + 1 < n_heads)
        stage_head(smem + lay.buf[1], lay, dm, x, dt, states, st, b, c,
                   h0 + i0h + 1, H, N, P, L, n_states, valid);
      tc::cp_async_commit();
    }
    tc::cp_async_wait<0>();
    __syncthreads();
    const int h = h0 + i0h + grp;
    const bool active = i0h + grp < n_heads;
    float* hb = smem + (grp ? lay.buf[1] : lay.buf[0]);
    const float* xs = hb + lay.x;
    const float* ss = hb + lay.s;
    const float* dts = hb + lay.dt;
    float* css = hb + lay.cs;
    if (active && gw == 0) chunk_cumsum(dts, css, A[h], dm.Lp);
    __syncthreads();

    // tiles of 16 rows x 32 columns of y over the group's 8 warps; odd
    // column blocks take the strips in reverse, so that warp w's strips w
    // and n - 1 - w share the triangle's work evenly
    const int n_cb = (dm.Pp + 31) / 32;
    T* yb = y + b * st.yb + h * st.yh;
    for (int u = gw; active && u < n_strips * n_cb; u += kGroupWarps) {
      const int cb = u / n_strips, rr = u % n_strips;
      const int r0 = 16 * ((cb & 1) ? n_strips - 1 - rr : rr);
      const int p0 = 32 * cb;
      const int nq = min(4, (dm.Pp - p0) / 8);
      const int i0 = r0 + g, i1 = i0 + 8;
      const float cs0 = css[i0], cs1 = css[i1];
      float acc[4][4] = {};
      // M x over j <= i: k-steps up to the strip's last row
      for (int k0 = 0; k0 < r0 + 16; k0 += 8) {
        const int j0 = k0 + t, j1 = j0 + 4;
        const float* cbp = cbs + i0 * lay.ldcb;
        const float* cbq = cbs + i1 * lay.ldcb;
        const float d0 = dts[j0], d1 = dts[j1];
        const float e0 = css[j0], e1 = css[j1];
        const float av[4] = {
            j0 <= i0 ? cbp[j0] * expf(cs0 - e0) * d0 : 0.f,
            j0 <= i1 ? cbq[j0] * expf(cs1 - e0) * d0 : 0.f,
            j1 <= i0 ? cbp[j1] * expf(cs0 - e1) * d1 : 0.f,
            j1 <= i1 ? cbq[j1] * expf(cs1 - e1) * d1 : 0.f};
        tc::Frag<4> af;
        af.set(av);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= nq) break;
          const float* xp = xs + j0 * lay.ldx + p0 + 8 * q + g;
          const float bv[2] = {xp[0], xp[4 * lay.ldx]};
          tc::Frag<2> bf;
          bf.set(bv);
          tc::mma3(acc[q], af, bf);
        }
      }
      // (exp(cs) C) S_c: the state entering the chunk
      if (c > 0) {
        const float g0 = expf(cs0), g1 = expf(cs1);
        for (int k0 = 0; k0 < dm.Np; k0 += 8) {
          const float* cp = cms + i0 * lay.ldc + k0 + t;
          const float av[4] = {cp[0] * g0, cp[8 * lay.ldc] * g1, cp[4] * g0,
                               cp[8 * lay.ldc + 4] * g1};
          tc::Frag<4> af;
          af.set(av);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= nq) break;
            const float* sp = ss + (k0 + t) * lay.ldx + p0 + 8 * q + g;
            const float bv[2] = {sp[0], sp[4 * lay.ldx]};
            tc::Frag<2> bf;
            bf.set(bv);
            tc::mma3(acc[q], af, bf);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nq) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e < 2 ? i0 : i1), p = p0 + 8 * q + 2 * t + (e & 1);
          if (i < valid && p < P)
            yb[static_cast<long long>(s0 + i) * st.ys + p] =
                tc::from_float<T>(acc[q][e]);
        }
      }
    }
    __syncthreads();  // the buffers take the next pair of heads
  }
}

template <typename K>
int opt_in(K kernel, int smem) {  // above 48 KB only by opting in
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

int heads_per_block(int blocks_per_head, int H) {
  return max(1, min(H, blocks_per_head * H / kFill));
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* states, void* cs_last, void* cb,
           int B, int S, int H, int P, int N, int L, const Strides& st,
           void* stream) {
  if (B == 0 || S == 0 || H == 0 || P == 0) return 0;
  if (L <= 0 || L > kMaxDim || N <= 0 || N > kMaxDim || P > kMaxDim ||
      N % 4 || P % 4 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm(L, N, P);
  const int smem1 = max(StateLayout(dm).total, (dm.Lp + 16) * pitch_a(dm.Np))
                    * static_cast<int>(sizeof(float));
  const int smem3 = OutLayout(dm).total * static_cast<int>(sizeof(float));
  if (smem1 > kMaxSmem || smem3 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int nc = (S + L - 1) / L;
  int err;
  {
    const int G = heads_per_block(B * max(nc - 1, 1), H);
    if ((err = opt_in(ssd_state_kernel<T>, smem1))) return err;
    ssd_state_kernel<T><<<dim3(nc, (H + G - 1) / G + dm.Lp / 16, B),
                          kThreads, smem1, cs>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<float*>(states),
        static_cast<float*>(cs_last), static_cast<float*>(cb), S, H, P, N, L,
        G, st);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (nc > 2) {
    ssd_carry_kernel<<<dim3(H, B), kThreads, 0, cs>>>(
        static_cast<float*>(states), static_cast<const float*>(cs_last),
        nc - 1, H, N * P);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  const int G = heads_per_block(B * nc, H);
  if ((err = opt_in(ssd_output_kernel<T>, smem3))) return err;
  ssd_output_kernel<T><<<dim3(nc, (H + G - 1) / G, B), kOutThreads, smem3,
                         cs>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Cm),
      static_cast<const float*>(states), static_cast<const float*>(cb),
      static_cast<T*>(y), S, H, P, N, L, G, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/ssd_scan/ops.py.
// x, y: (B, S, H, P); dt: (B, S, H); A: (H,) f32; Bm, Cm: (B, S, N).
// Strides in elements: x, dt and y for their first three axes, Bm and Cm
// for their first two; the last axis of x, y, Bm and Cm is contiguous, and
// for f32 every row of x, Bm and Cm starts on a 16-byte boundary.
// states: f32 scratch of (B, nc - 1, H, N, P) and cs_last of (B, nc - 1,
// H), nc = ceil(S / L) (unused when nc = 1); cb: f32 scratch of (B, nc,
// Lp, Lp), Lp = L rounded up to a multiple of 16; states and cb start on
// 16-byte boundaries.  L is the chunk length,
// min(chunk, S); N and P are multiples of 4.  Returns the CUDA error code
// of the launches (0 on success).
#define SSD_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* x, const void* dt, const void* A,          \
                      const void* Bm, const void* Cm, void* y, void* states, \
                      void* cs_last, void* cb, int B, int S, int H, int P,   \
                      int N, int L, long long xsb, long long xss,            \
                      long long xsh, long long dsb, long long dss,           \
                      long long dsh, long long bsb, long long bss,           \
                      long long csb, long long css, long long ysb,           \
                      long long yss, long long ysh, void* stream) {          \
    const Strides st{xsb, xss, xsh, dsb, dss, dsh, bsb,                      \
                     bss, csb, css, ysb, yss, ysh};                          \
    return launch<T>(x, dt, A, Bm, Cm, y, states, cs_last, cb, B, S, H, P,   \
                     N, L, st, stream);                                      \
  }

SSD_ENTRY(ssd_scan_f32, float)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
