// Mamba-2 SSD chunked scan for Hopper, sm_90a, on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:
// _ssd_kernel (launcher ssd_scan_kernel).  Same function, per batch row b
// and head h, over chunks of L = min(chunk, S) positions:
//
//   cs_i  = sum_{j <= i} dt_j A                   (inclusive, within a chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//           + exp(cs_i) C_i . S                   (S: state entering the chunk)
//   S    <- exp(cs_L) S + sum_j exp(cs_L - cs_j) dt_j B_j x_j^T
//
// with the (N, P) state S in f32 across the whole sequence.  x (B,S,H,P),
// dt (B,S,H), B and C (B,S,N) shared across heads, A (H,) f32 < 0; y
// (B,S,H,P) in x's dtype.  All arithmetic is f32 (expf, no fast math).
//
// Differences from the TPU kernel, none of them in the result:
//  - The TPU grid (B, H, chunks) runs the chunks in order and carries S
//    in VMEM scratch from one grid step to the next.  GPU blocks run in no
//    order, so here one block owns one (b, h) and loops over the chunks
//    itself, with S in shared memory for the whole sequence.
//  - x, dt, B, C and y are read and written in the model's layouts through
//    strides, so the TPU wrapper's transposes are gone.
//  - The ragged tail (S not a multiple of L) is handled in the kernel:
//    positions past S load x = dt = B = C = 0, which adds nothing to y or
//    S (the TPU wrapper pads with zeros to the same effect), and are
//    never stored.
//  - exp(cs_i - cs_j) is positive for j > i and can overflow; the JAX code
//    masks it with `where` after the exp.  Here only j <= i is ever
//    exponentiated (a 0/1 mask would turn inf * 0 into NaN), and the
//    intra-chunk sum stops at the tile's last row, skipping the zero upper
//    triangle (adding an exact 0 changes nothing).
//
// What bounds it: operations.  Per (b, h) and chunk it does about
// 2 L^2 N (C B^T) + 2 L^2 P (M x) + 2 L N P (C S) + 2 L N P (state) f32
// flops, the TPU kernel's count (C B^T is recomputed per head), against
// (L P + L + 2 L N) elements read and L P written.  At the serving shape
// (B, H, S, P, N, L) = (4, 80, 256, 64, 64, 128) that is 4.0 GFLOP against
// 42.8 MB: 0.060 ms at the f32 rate of the CUDA cores (67 TFLOP/s) and
// 0.013 ms at 3.35 TB/s, so the f32 rate is the bound.  The design keeps
// every operand of the three products in shared memory as f32: x (L x P),
// B transposed (N x L), C (L x N), the masked matrix M (L x L), the state
// (N x P), dt, cs and the state weights; 181,760 bytes at the serving
// shape, so one 256-thread block per SM.  Each thread computes 4 x 4
// output tiles of each product in registers, reading its B-side operand
// as float4 rows (conflict-free) and its A-side operand as broadcasts.
// A simple first version: C B^T is not shared across heads, and there are
// no tensor cores, no TMA and no parallel chunk-state pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 128;  // L, N and P each at most this
constexpr int kMaxSmem = 232448;

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

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared-memory layout, in floats.  The float4-read arrays (x, B^T, S)
// come first, each with a row length that is a multiple of 4, so their
// rows are 16-byte aligned.
struct Layout {
  int ldx, ldb, lds;  // row lengths of x (L x ldx), B^T (N x ldb), S (N x lds)
  int x, bt, st, c, m, dt, cs, w, total;
  __host__ __device__ Layout(int L, int N, int P) {
    ldx = round4(P);
    ldb = round4(L);
    lds = round4(P);
    x = 0;
    bt = x + L * ldx;
    st = bt + N * ldb;
    c = st + N * lds;  // C (L x N)
    m = c + L * N;     // M (L x L)
    dt = m + L * L;
    cs = dt + L;
    w = cs + L;
    total = w + L;
  }
};

struct Strides {  // element strides; the last axis of x, B, C, y is 1
  long long xb, xs, xh, db, ds, dh, bb, bs, cb, cs, yb, ys, yh;
};

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int S, int P,
                int N, int L, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(L, N, P);
  float* xs = smem + lay.x;    // x_j[p]          (L x ldx)
  float* bts = smem + lay.bt;  // B_j[n] at [n][j] (N x ldb)
  float* ss = smem + lay.st;   // state S[n][p]   (N x lds), f32 throughout
  float* cms = smem + lay.c;   // C_i[n]          (L x N)
  float* ms = smem + lay.m;    // M[i][j]         (L x L)
  float* dts = smem + lay.dt;  // dt_j
  float* css = smem + lay.cs;  // cs_j
  float* ws = smem + lay.w;    // exp(cs_L - cs_j) dt_j

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[h];
  const T* xb = x + b * st.xb + h * st.xh;
  const T* db = dt + b * st.db + h * st.dh;
  const T* bb = Bm + b * st.bb;
  const T* cb = Cm + b * st.cb;
  T* yb = y + b * st.yb + h * st.yh;

  for (int e = tid; e < N * lay.lds; e += kThreads) ss[e] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int s0 = chunk * L;
    __syncthreads();  // the previous chunk is done with every array

    // ---- stage the chunk as f32; positions past S are zeros ----
    for (int e = tid; e < L * P; e += kThreads) {
      const int j = e / P, p = e - j * P, s = s0 + j;
      xs[j * lay.ldx + p] =
          s < S ? to_float(xb[static_cast<long long>(s) * st.xs + p]) : 0.f;
    }
    for (int e = tid; e < L * N; e += kThreads) {
      const int j = e / N, n = e - j * N, s = s0 + j;
      float bv = 0.f, cv = 0.f;
      if (s < S) {
        bv = to_float(bb[static_cast<long long>(s) * st.bs + n]);
        cv = to_float(cb[static_cast<long long>(s) * st.cs + n]);
      }
      bts[n * lay.ldb + j] = bv;
      cms[j * N + n] = cv;
    }
    for (int j = tid; j < L; j += kThreads) {
      const int s = s0 + j;
      dts[j] = s < S ? to_float(db[static_cast<long long>(s) * st.ds]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt a, in sequence order
      float run = 0.f;
      for (int j = 0; j < L; ++j) {
        run += dts[j] * a;
        css[j] = run;
      }
    }
    __syncthreads();
    const float cs_last = css[L - 1];
    for (int j = tid; j < L; j += kThreads)
      ws[j] = expf(cs_last - css[j]) * dts[j];

    // ---- M[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0 ----
    {
      const int nq = (L + 3) / 4;
      for (int t = tid; t < nq * nq; t += kThreads) {
        const int i0 = (t / nq) * 4, j0 = (t % nq) * 4;
        float acc[4][4] = {};
        if (j0 <= i0 + 3) {  // a tile wholly above the diagonal stays 0
          int ro[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) ro[r] = min(i0 + r, L - 1) * N;
          for (int n = 0; n < N; ++n) {
            const float4 bv =
                *reinterpret_cast<const float4*>(bts + n * lay.ldb + j0);
#pragma unroll
            for (int r = 0; r < 4; ++r) fma4(acc[r], cms[ro[r] + n], bv);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r;
          if (i >= L) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + q;
            if (j < L)
              ms[i * L + j] =
                  j <= i ? acc[r][q] * expf(css[i] - css[j]) * dts[j] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // ---- y_i = sum_{j <= i} M[i][j] x_j + (C_i . S) exp(cs_i) ----
    {
      const int nq = (P + 3) / 4, nr = (L + 3) / 4;
      for (int t = tid; t < nr * nq; t += kThreads) {
        const int i0 = (t / nq) * 4, p0 = (t % nq) * 4;
        int ri[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ri[r] = min(i0 + r, L - 1);
        float intra[4][4] = {}, inter[4][4] = {};
        const int j_end = min(i0 + 4, L);  // M is 0 past the tile's last row
        for (int j = 0; j < j_end; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + j * lay.ldx + p0);
#pragma unroll
          for (int r = 0; r < 4; ++r) fma4(intra[r], ms[ri[r] * L + j], xv);
        }
        for (int n = 0; n < N; ++n) {
          const float4 sv =
              *reinterpret_cast<const float4*>(ss + n * lay.lds + p0);
#pragma unroll
          for (int r = 0; r < 4; ++r) fma4(inter[r], cms[ri[r] * N + n], sv);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r;
          if (i >= L || s0 + i >= S) break;
          const float dec = expf(css[i]);
          T* yp = yb + static_cast<long long>(s0 + i) * st.ys;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + q;
            if (p < P) yp[p] = from_float<T>(intra[r][q] + inter[r][q] * dec);
          }
        }
      }
    }
    __syncthreads();  // every y tile has read the old state

    // ---- S <- exp(cs_L) S + sum_j w_j B_j x_j^T ----
    {
      const float dec = expf(cs_last);
      const int nq = (P + 3) / 4, nr = (N + 3) / 4;
      for (int t = tid; t < nr * nq; t += kThreads) {
        const int n0 = (t / nq) * 4, p0 = (t % nq) * 4;
        int rn[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rn[r] = min(n0 + r, N - 1) * lay.ldb;
        float acc[4][4] = {};
        for (int j = 0; j < L; ++j) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + j * lay.ldx + p0);
          const float wj = ws[j];
#pragma unroll
          for (int r = 0; r < 4; ++r) fma4(acc[r], bts[rn[r] + j] * wj, xv);
        }
        // each thread reads and writes only its own tile of S
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = n0 + r;
          if (n >= N) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + q;
            float& sv = ss[n * lay.lds + p];
            if (p < P) sv = sv * dec + acc[r][q];
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int H, int P, int N, int L,
           const Strides& st, void* stream) {
  if (B == 0 || S == 0 || H == 0 || P == 0) return 0;
  if (L <= 0 || L > kMaxDim || N <= 0 || N > kMaxDim || P > kMaxDim ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Layout(L, N, P).total * static_cast<int>(sizeof(float));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, P, N, L, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by repro_torch/kernels/ssd_scan/ops.py.
// x, y: (B, S, H, P); dt: (B, S, H); A: (H,) f32; Bm, Cm: (B, S, N).
// Strides in elements: x, dt and y for their first three axes, Bm and Cm
// for their first two; the last axis of x, y, Bm and Cm is contiguous.
// L is the chunk length, min(chunk, S).  Returns the CUDA error code of
// the launch (0 on success).
#define SSD_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* x, const void* dt, const void* A,          \
                      const void* Bm, const void* Cm, void* y, int B, int S, \
                      int H, int P, int N, int L, long long xsb,             \
                      long long xss, long long xsh, long long dsb,           \
                      long long dss, long long dsh, long long bsb,           \
                      long long bss, long long csb, long long css,           \
                      long long ysb, long long yss, long long ysh,           \
                      void* stream) {                                        \
    const Strides st{xsb, xss, xsh, dsb, dss, dsh, bsb,                      \
                     bss, csb, css, ysb, yss, ysh};                          \
    return launch<T>(x, dt, A, Bm, Cm, y, B, S, H, P, N, L, st, stream);     \
  }

SSD_ENTRY(ssd_scan_f32, float)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
