// Batched small dense Cholesky factorisation and solve for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels `_chol_kernel` and `_solve_kernel` of the
// JAX package (ops/pallas_linalg.py, entered through `batched_cholesky`
// and `batched_cho_solve`).  The MPC interior-point method factors one
// n x n Schur matrix (n = 60 for the H = 30 MPC) and solves two
// right-hand sides per iteration for every QP of the batch; its
// active-set polish factors a 60 x 60 and a 64 x 64 matrix and solves
// 65 right-hand sides at once.
//
// What bounds them on this card.  By the roofline (3.35 TB/s, 67 TFLOP/s
// in float32) the main path's shapes are bound by bytes: factoring
// [768, 60, 60] moves 22.1 MB, 0.0066 ms (its 55 MFLOP are 0.0008 ms);
// a solve with one right-hand side moves 11.4 MB, 0.0034 ms; with 65
// right-hand sides 35.0 MB, 0.0105 ms (359 MFLOP, 0.0054 ms).  What a
// kernel really waits for is neither: it is the chain of n dependent
// column steps of one matrix, the latency of its copies from device
// memory, and the instructions issued around each useful FMA.  So the
// design keeps the chain short, the copies in flight together, and the
// issue count near the FMA count:
//
//  * A matrix belongs to one warp (a block holds several), so a column
//    step synchronises with `__syncwarp()` or a shuffle, never with a
//    block-wide barrier, and 768 matrices are one wave on 132 SMs.
//  * The loops over rows and columns have compile-time bounds (the
//    kernels are templates on n, instantiated for the main path's 60 and
//    64 and once more, with a run-time n <= 64 inside the unrolled
//    loops, for every other size), so there is no index arithmetic at
//    run time and rows live in registers.
//  * One reciprocal a column (`rsqrtf` in the factorisation, `1 / L[j][j]`
//    taken before the chain starts in the solves), then multiplies.
//  * Only the lower triangle is read; 16-byte loads and stores where a
//    row is 16-byte aligned (n = 60 and 64 on an aligned pointer); every
//    copy from device memory issues all of a thread's loads before the
//    first use, and the factor goes out through shared memory in whole
//    512-byte runs.
//
// Reached on an NVIDIA H100 80GB HBM3 at 700 W, [768, 60, 60], as a CUDA
// graph of launches (experiments/linalg_bench.py): factorisation
// 0.0107 ms, 62% of its bound; solve 0.0054 ms at k = 1 (63%) and
// 0.0355 ms at k = 65 (29%).
//
// The TPU kernels' batch-last [n, n, B] layout (128 instances on the
// vector lanes) is not carried over: here the batch is the grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxN = 64;
constexpr int kStageLoads = 16;

// Copies the lower triangle of an n x n matrix from device memory into
// shared-memory rows of stride ld, for any n, one float at a time;
// `threads` threads take part.  Each has kStageLoads loads in flight
// before its first store: a loop of load, store, load would wait for
// device memory once a pass.
__device__ __forceinline__ void stage_lower(const float* __restrict__ lg,
                                            float* ls, int n, int ld, int tid,
                                            int threads) {
  for (int base = 0; base < n * n; base += threads * kStageLoads) {
    float v[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * threads + tid;
      const int i = idx / n;
      if (idx < n * n && idx - i * n <= i) v[u] = lg[idx];
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int idx = base + u * threads + tid;
      const int i = idx / n;
      if (idx < n * n && idx - i * n <= i) ls[i * ld + idx - i * n] = v[u];
    }
  }
}

// ---------------------------------------------------------------------
// Factorisation: one warp a matrix, rows in registers.
//
// Lane l owns rows l and l + 32: a0 holds columns 0..31 of row l, a1
// columns 0..63 of row l + 32 (96 registers).  Right-looking: at column j
// the pivot comes by shuffle from its owner, every lane scales its two
// entries of the column by rsqrt(pivot) and leaves them in a 64-float
// buffer of shared memory (two buffers in turn, so one `__syncwarp()` a
// column), then subtracts l[r][j] * l[c][j] from the rest of its rows,
// reading l[c][j] back as 16-byte broadcasts.  The update runs over the
// whole rest of the row, not only up to the diagonal: the entries above
// the diagonal are never read by anything else and go out as zeros,
// and leaving out the test saves one instruction an FMA.
//
// A pivot that is not positive makes the whole matrix NaN, as the plain
// version does; the other matrices of the batch are not touched by it.
// ---------------------------------------------------------------------

constexpr int kCholWarps = 2;  // 2 x 64 x 68 floats: 34 KB, below 48 KB

// Row stride of the factor's image in shared memory: 16-byte rows that
// 8 lanes write without bank conflicts (n = 60: 60; n = 64: 68), or odd.
template <int N, bool kExact>
__host__ __device__ constexpr int chol_ld(int n) {
  return kExact ? (N % 8 == 4 ? N : N + 4) : (n | 1);
}

template <int N, bool kExact>
__global__ void __launch_bounds__(kCholWarps * 32)
cholesky_kernel(const float* __restrict__ S, float* __restrict__ L, int batch,
                int n_rt) {
  __shared__ __align__(16) float colbuf[kCholWarps][2][kMaxN];
  extern __shared__ __align__(16) float smem[];
  const int n = kExact ? N : n_rt;
  const int ld = chol_ld<N, kExact>(n);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mat = blockIdx.x * kCholWarps + warp;
  if (mat >= batch) return;  // a whole warp; nothing below is block-wide
  const float* __restrict__ s = S + static_cast<size_t>(mat) * n * n;
  float* __restrict__ l = L + static_cast<size_t>(mat) * n * n;
  const int r0 = lane;
  const int r1 = lane + 32;

  float a0[32];
  float a1[kMaxN];
#pragma unroll
  for (int c = 0; c < 32; ++c) a0[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxN; ++c) a1[c] = 0.f;

  if constexpr (kExact) {
    const float4* __restrict__ s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (r0 < N && 4 * q <= r0) {
        const float4 v = s4[(r0 * N) / 4 + q];
        a0[4 * q] = v.x; a0[4 * q + 1] = v.y;
        a0[4 * q + 2] = v.z; a0[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      if (r1 < N && 4 * q <= r1) {
        const float4 v = s4[(r1 * N) / 4 + q];
        a1[4 * q] = v.x; a1[4 * q + 1] = v.y;
        a1[4 * q + 2] = v.z; a1[4 * q + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (r0 < n && c <= r0) a0[c] = s[r0 * n + c];
#pragma unroll
    for (int c = 0; c < kMaxN; ++c)
      if (r1 < n && c <= r1) a1[c] = s[r1 * n + c];
  }

  bool bad = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!kExact && j >= n) break;
    const float pivot = __shfl_sync(kFullMask, j < 32 ? a0[j] : a1[j], j & 31);
    bad |= !(pivot > 0.f);
    const float inv = rsqrtf(pivot);
    float* cb = colbuf[warp][j & 1];
    float l0 = 0.f;
    if (j < 32) {
      l0 = a0[j] * inv;
      a0[j] = l0;
      cb[r0] = l0;
    }
    const float l1 = a1[j] * inv;
    a1[j] = l1;
    cb[r1] = l1;
    __syncwarp();
    const float4* cb4 = reinterpret_cast<const float4*>(cb);
#pragma unroll
    for (int q = (j + 1) / 4; q < N / 4; ++q) {
      const float4 v = cb4[q];
      const float col[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e;
        if (c > j) {
          if (c < 32) a0[c] = fmaf(-l0, col[e], a0[c]);
          a1[c] = fmaf(-l1, col[e], a1[c]);
        }
      }
    }
  }

  // The factor goes out through shared memory, so that the warp stores
  // whole 512-byte runs: a lane that stored its own rows would write
  // half sectors, 240 bytes apart.
  const float nanv = __int_as_float(0x7fc00000);
  float* ws = smem + warp * n * ld;
  if constexpr (kExact) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      float out0[4], out1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e;
        out0[e] = bad ? nanv : ((c < 32 && c <= r0) ? a0[c < 32 ? c : 0] : 0.f);
        out1[e] = bad ? nanv : (c <= r1 ? a1[c] : 0.f);
      }
      *reinterpret_cast<float4*>(ws + r0 * ld + 4 * q) =
          make_float4(out0[0], out0[1], out0[2], out0[3]);
      if (r1 < N)
        *reinterpret_cast<float4*>(ws + r1 * ld + 4 * q) =
            make_float4(out1[0], out1[1], out1[2], out1[3]);
    }
    __syncwarp();
    float4* __restrict__ l4 = reinterpret_cast<float4*>(l);
#pragma unroll 4
    for (int q = lane; q < N * N / 4; q += 32) {
      const int i = q / (N / 4);
      l4[q] = *reinterpret_cast<const float4*>(ws + i * ld +
                                               4 * (q - i * (N / 4)));
    }
  } else {
#pragma unroll
    for (int c = 0; c < kMaxN; ++c) {
      if (c >= n) break;
      if (r0 < n)
        ws[r0 * ld + c] =
            bad ? nanv : ((c < 32 && c <= r0) ? a0[c < 32 ? c : 0] : 0.f);
      if (r1 < n) ws[r1 * ld + c] = bad ? nanv : (c <= r1 ? a1[c] : 0.f);
    }
    __syncwarp();
    for (int idx = lane; idx < n * n; idx += 32) {
      const int i = idx / n;
      l[idx] = ws[i * ld + idx - i * n];
    }
  }
}

// ---------------------------------------------------------------------
// Solve, few right-hand sides: one warp a matrix.
//
// The warp copies the lower triangle of L into shared memory (row stride
// n | 1, odd, so that a column is read without bank conflicts).  Lane l
// owns x[l] and x[l + 32] in registers.  The forward substitution walks
// the columns: x[j] comes by shuffle from its owner, every lane below
// subtracts L[r][j] x[j].  The backward substitution does the same with
// the rows of L as the columns of L'.  Both keep x scaled by 1 / L[r][r],
// taken once before the chain, and multiply the entry of L by it off the
// chain, so a step of the chain is one shuffle and one FMA.  Several
// right-hand sides are walked one after the other.
// ---------------------------------------------------------------------

constexpr int kSolveWarps = 2;  // 2 x 64 x 65 floats: 33 KB, below 48 KB

template <int N, bool kExact>
__global__ void __launch_bounds__(kSolveWarps * 32)
cho_solve_warp_kernel(const float* __restrict__ L, const float* __restrict__ R,
                      float* __restrict__ X, int batch, int n_rt, int k) {
  extern __shared__ __align__(16) float smem[];
  const int n = kExact ? N : n_rt;
  const int ld = n | 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mat = blockIdx.x * kSolveWarps + warp;
  if (mat >= batch) return;  // a whole warp; nothing below is block-wide
  float* ls = smem + warp * n * ld;
  const float* __restrict__ lg = L + static_cast<size_t>(mat) * n * n;
  if constexpr (kExact) {
    // A fixed trip count, fully unrolled, so that all of a lane's loads
    // are in flight together (with a trip count that depends on the
    // lane, as n = 60 gives, the copy took 2.6 us longer than at n = 64).
    const float4* __restrict__ lg4 = reinterpret_cast<const float4*>(lg);
#pragma unroll
    for (int it = 0; it < (N * N / 4 + 31) / 32; ++it) {
      const int q = it * 32 + lane;
      const int i = (4 * q) / N;
      const int c = 4 * q - i * N;
      if (q < N * N / 4 && c <= i) {
        const float4 v = lg4[q];
        float* d = ls + i * ld + c;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
    }
  } else {
    stage_lower(lg, ls, n, ld, lane, 32);
  }
  __syncwarp();

  const int r0 = lane;
  const int r1 = lane + 32;
  const bool ok0 = r0 < n;
  const bool ok1 = r1 < n;
  const float inv0 = ok0 ? 1.f / ls[r0 * ld + r0] : 0.f;
  const float inv1 = ok1 ? 1.f / ls[r1 * ld + r1] : 0.f;
  const size_t rbase = static_cast<size_t>(mat) * n * k;

  for (int c = 0; c < k; ++c) {
    float x0 = ok0 ? R[rbase + static_cast<size_t>(r0) * k + c] * inv0 : 0.f;
    float x1 = ok1 ? R[rbase + static_cast<size_t>(r1) * k + c] * inv1 : 0.f;
    // Forward: L y = r.
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (!kExact && j >= n) break;
      const float yj = __shfl_sync(kFullMask, j < 32 ? x0 : x1, j & 31);
      if (j < 31 && ok0 && r0 > j) x0 = fmaf(-(ls[r0 * ld + j] * inv0), yj, x0);
      if (ok1 && r1 > j) x1 = fmaf(-(ls[r1 * ld + j] * inv1), yj, x1);
    }
    // Backward: L' x = y; column j of L' is row j of L.
    x0 *= inv0;
    x1 *= inv1;
#pragma unroll
    for (int j = N - 1; j >= 0; --j) {
      if (!kExact && j >= n) continue;
      const float xj = __shfl_sync(kFullMask, j < 32 ? x0 : x1, j & 31);
      if (r0 < j) x0 = fmaf(-(ls[j * ld + r0] * inv0), xj, x0);
      if (j > 32 && r1 < j) x1 = fmaf(-(ls[j * ld + r1] * inv1), xj, x1);
    }
    if (ok0) X[rbase + static_cast<size_t>(r0) * k + c] = x0;
    if (ok1) X[rbase + static_cast<size_t>(r1) * k + c] = x1;
  }
}

// ---------------------------------------------------------------------
// Solve, many right-hand sides: one thread a right-hand side.
//
// The right-hand sides are independent, so a thread keeps one column of
// X in registers (n values) and walks both substitutions alone; after
// the block has copied L into shared memory (rows 16-byte aligned) and
// the reciprocals of its diagonal beside it, there is no barrier.  Both
// substitutions read L by rows, as 16-byte broadcasts: the forward one
// as dot products (four partial sums, so the FMAs do not wait for one
// another), the backward one column-oriented.  Thread c reads
// r[i][c]: neighbouring threads, neighbouring addresses.  A block is one
// matrix and as many warps as k fills.
// ---------------------------------------------------------------------

// A 16-byte load from shared memory that is made each time it is
// written.  The backward substitution reads the rows of L that the
// forward one read; as plain loads, ptxas kept the whole triangle from
// the first pass for the second and spilled 8 KB a thread (n = 64: 450
// LDS.128 for the PTX's 930 loads, 255 registers).  A second pass that
// read through an offset unknown to the compiler did not spill either,
// but was slower than this (0.0511 against 0.0420 ms at n = 60, k = 65),
// and so was a limit of 112 registers for a single wave (0.0500 ms).
__device__ __forceinline__ float4 lds128_volatile(const float* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// The first j entries of a row of L, all loads before any use, so that
// their latency is waited for once a row.
template <int N>
__device__ __forceinline__ void load_row(const float* row, int j,
                                         float (&lrow)[N]) {
#pragma unroll
  for (int q = 0; 4 * q < j; ++q) {
    const float4 v = lds128_volatile(row + 4 * q);
    lrow[4 * q] = v.x; lrow[4 * q + 1] = v.y;
    lrow[4 * q + 2] = v.z; lrow[4 * q + 3] = v.w;
  }
}

template <int N, bool kExact>
__global__ void __launch_bounds__(256)
cho_solve_col_kernel(const float* __restrict__ L, const float* __restrict__ R,
                     float* __restrict__ X, int n_rt, int k) {
  extern __shared__ __align__(16) float smem[];
  const int n = kExact ? N : n_rt;
  const int ld = (n + 3) & ~3;
  float* ls = smem;
  float* invd = smem + n * ld;
  const float* __restrict__ lg = L + static_cast<size_t>(blockIdx.x) * n * n;
  if constexpr (kExact) {
    const float4* __restrict__ lg4 = reinterpret_cast<const float4*>(lg);
    float4* ls4 = reinterpret_cast<float4*>(ls);
    // As `stage_lower`, 16 bytes at a time (a loop of load, store, load
    // made this kernel take 0.0167 ms at k <= 32, this one 0.0120 ms).
    for (int base = 0; base < N * N / 4; base += blockDim.x * kStageLoads) {
      float4 v[kStageLoads];
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int q = base + u * blockDim.x + threadIdx.x;
        const int i = (4 * q) / N;
        if (q < N * N / 4 && 4 * q - i * N <= i) v[u] = lg4[q];
      }
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int q = base + u * blockDim.x + threadIdx.x;
        const int i = (4 * q) / N;
        if (q < N * N / 4 && 4 * q - i * N <= i) ls4[q] = v[u];
      }
    }
  } else {
    stage_lower(lg, ls, n, ld, threadIdx.x, blockDim.x);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    invd[i] = 1.f / lg[i * n + i];
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= k) return;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * n * k + c;

  float x[N];
  float lrow[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = (kExact || i < n) ? R[rbase + static_cast<size_t>(i) * k] : 0.f;

  // Forward: x[j] = (r[j] - sum_{c < j} L[j][c] x[c]) / L[j][j].
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!kExact && j >= n) break;
    float acc[4] = {x[j], 0.f, 0.f, 0.f};
    load_row<N>(ls + j * ld, j, lrow);
#pragma unroll
    for (int c = 0; c < j; ++c) acc[c & 3] = fmaf(-lrow[c], x[c], acc[c & 3]);
    x[j] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * invd[j];
  }
  // Backward: x[j] is final, then x[i] -= L[j][i] x[j] for i < j.
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    if (!kExact && j >= n) continue;
    const float xj = x[j] * invd[j];
    x[j] = xj;
    load_row<N>(ls + j * ld, j, lrow);
#pragma unroll
    for (int c = 0; c < j; ++c) x[c] = fmaf(-lrow[c], xj, x[c]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (kExact || i < n) X[rbase + static_cast<size_t>(i) * k] = x[i];
}

// The largest k that goes to the warp-a-matrix kernel; above it a thread
// owns a right-hand side.  Set by the times of experiments/linalg_bench.py,
// which builds this file with the macro at 256 and at 0 to force either
// kernel (ms at [768, 60, 60] and, in brackets, [768, 64, 64]; NVIDIA H100
// 80GB HBM3, 700 W, CUDA graph of launches):
//
//    k     warp a matrix      thread a right-hand side
//    1     0.0054 (0.0054)    0.0112 (0.0121)
//    2     0.0075 (0.0076)    0.0112 (0.0121)
//    3     0.0097 (0.0099)    0.0115 (0.0126)
//    4     0.0119 (0.0120)    0.0115 (0.0124)
//    8     0.0216 (0.0221)    0.0119 (0.0132)
//   16     0.0414 (0.0423)    0.0119 (0.0132)
//   32     0.0849 (0.0886)    0.0121 (0.0134)
//   65     0.1574 (0.1674)    0.0355 (0.0464)
//
// At k = 4 the two tie at n = 60 and 64, and at a run-time n (62) the
// thread kernel is ahead (0.0254 against 0.0297 ms), so 3 is the largest
// k at which the warp kernel wins at every size.
#ifndef DRCVAR_SOLVE_WARP_MAX_K
#define DRCVAR_SOLVE_WARP_MAX_K 3
#endif
constexpr int kSolveWarpMaxK = DRCVAR_SOLVE_WARP_MAX_K;

template <int N, bool kExact>
int launch_cholesky(const float* S, float* L, int batch, int n,
                    cudaStream_t stream) {
  const int blocks = (batch + kCholWarps - 1) / kCholWarps;
  const size_t smem = sizeof(float) * kCholWarps * n * chol_ld<N, kExact>(n);
  cholesky_kernel<N, kExact>
      <<<blocks, kCholWarps * 32, smem, stream>>>(S, L, batch, n);
  return static_cast<int>(cudaGetLastError());
}

template <int N, bool kExact>
int launch_cho_solve(const float* L, const float* R, float* X, int batch,
                     int n, int k, cudaStream_t stream) {
  if (k <= kSolveWarpMaxK) {
    const int blocks = (batch + kSolveWarps - 1) / kSolveWarps;
    const size_t smem = sizeof(float) * kSolveWarps * n * (n | 1);
    cho_solve_warp_kernel<N, kExact>
        <<<blocks, kSolveWarps * 32, smem, stream>>>(L, R, X, batch, n, k);
  } else {
    const int threads = ((k + 31) / 32) * 32;
    const size_t smem = sizeof(float) * (n * ((n + 3) & ~3) + n);
    cho_solve_col_kernel<N, kExact>
        <<<batch, threads, smem, stream>>>(L, R, X, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// The n = 60 and n = 64 kernels load and store 16 bytes at a time.
bool aligned16(const void* a, const void* b = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

}  // namespace

extern "C" int drcvar_batched_cholesky(const void* S, void* L, int batch,
                                       int n, void* stream) {
  const float* s = static_cast<const float*>(S);
  float* l = static_cast<float*>(L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 60 && aligned16(s, l))
    return launch_cholesky<60, true>(s, l, batch, n, st);
  if (n == 64 && aligned16(s, l))
    return launch_cholesky<64, true>(s, l, batch, n, st);
  return launch_cholesky<kMaxN, false>(s, l, batch, n, st);
}

extern "C" int drcvar_batched_cho_solve(const void* L, const void* R, void* X,
                                        int batch, int n, int k,
                                        void* stream) {
  const float* l = static_cast<const float*>(L);
  const float* r = static_cast<const float*>(R);
  float* x = static_cast<float*>(X);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kMaxN || k < 1 || k > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 60 && aligned16(l))
    return launch_cho_solve<60, true>(l, r, x, batch, n, k, st);
  if (n == 64 && aligned16(l))
    return launch_cho_solve<64, true>(l, r, x, batch, n, k, st);
  return launch_cho_solve<kMaxN, false>(l, r, x, batch, n, k, st);
}

// The threshold between the two solve kernels, for the callers that
// report which one ran.
extern "C" int drcvar_cho_solve_warp_max_k() { return kSolveWarpMaxK; }
