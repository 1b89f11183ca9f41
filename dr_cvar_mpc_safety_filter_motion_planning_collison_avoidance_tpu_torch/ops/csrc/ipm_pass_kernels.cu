// The structured IPM's pass for Hopper (sm_90a): three kernels around
// kernels 2 and 3.
//
// Replaces no Pallas kernel: the JAX package leaves the pass (the body of
// the while_loop in ops/qp_ipm_structured.py) to XLA's fusion.  Added
// because op by op the pass is ~470 small PyTorch kernels (elementwise
// ops, reductions, cuBLAS gemv and the lane selects), and even replayed
// from a CUDA graph the card spends ~0.7-1.2 ms a pass on the gaps
// between them, whatever the batch.  Here a pass is six graph nodes:
//
//   A  `ipm_residuals`: the merit and mu, the best-iterate, stall and stop
//      bookkeeping (written in place: best iterate, best merit, done,
//      stall, iterations, active), the residuals, the scalings D, the
//      Schur matrix S = P + G' D1 G + A' D2_eff A + reg I, and the
//      predictor's right-hand side;
//   2  kernel 2 factors S (`_factor`);
//   3  kernel 3 solves for the predictor (`_solve`);
//   B  `ipm_predictor`: the predictor's back-substitution, its step
//      lengths, mu_aff and the centring, and the corrector's right-hand
//      side;
//   3  kernel 3 solves for the corrector;
//   C  `ipm_step`: the corrector's back-substitution, the step lengths at
//      0.99 and the update of the iterate, in place.
//
// The arithmetic is the plain pass's (`_one_pass`), in full float32, with
// its clamps and its NaN propagation (a NaN merit stops a lane as a
// breakdown); only the order of sums differs.  A lane that does not step
// this pass (stopped before it, or stopping at it) does no more than the
// bookkeeping: A writes the identity as its S and 0 as its right-hand
// side, so kernels 2 and 3 stay finite on it, and B and C return at once.
//
// What bounds them on this card.  By the roofline (3.35 TB/s, 67 TFLOP/s
// in float32), at batch256's 768 lanes (n = 60, 60 rows of box_theta, 90
// soft rows): A reads T, P, the lanes' A, iterates and data and writes S,
// the right-hand sides and the work rows (36 MB, 0.0108 ms) against 0.47
// GFLOP, mostly S's lower triangle (0.0070 ms); B moves 25 MB (0.0075
// ms), C 27 MB (0.0081 ms): all bound by bytes.  What a lane really waits
// for is its block's chain of phases (the copies in, two matvecs, the
// reductions, S's 1,830 dot products of 150 terms in A) between
// barriers.  Reached on an NVIDIA H100 80GB HBM3 at 700 W, as CUDA graphs
// of 50 launches (chip_smoke.py): A 0.0628 ms (17% of its bound, ~0.010
// of it the copies in), B 0.0327 ms (23%), C 0.0259 ms (31%); a whole
// pass from a graph 0.20 ms against 1.33 ms for the plain pass's 496
// operations.
// The design:
//
//  * One QP lane a block of 256 threads, so 768 lanes are ~two waves of
//    132 SMs and the few lanes of a replanning loop are a few blocks.
//  * A block first starts every copy it needs from device memory at once
//    (cp.async, 16 bytes where aligned): the rows of T and of the lane's
//    A ([T; A], 150 x 60 floats), P in A, the lane's vectors and its work
//    row; one wait, so a lane pays the memory latency once and not once a
//    vector.  Everything after runs from shared memory.
//  * Both matvecs (T u, A u) and both transposed ones (T' w, A' w) are one
//    pass over the staged rows each: a warp a row for the first, 64
//    threads a column and four row groups for the second.
//  * S is assembled in 4 x 4 tiles of its lower triangle, a thread a tile
//    (two threads a tile, each half of the rows, where the tiles are at
//    most half the threads), reading each staged row as two 16-byte
//    broadcasts; the tile goes out mirrored, so S is exactly symmetric.
//  * Every reduction (dot products for mu and mu_aff, the maxima of the
//    merit, the minima of the step lengths) is one shuffle tree a warp
//    and one pass over the warps, several values at once.
//  * What B and C need of A's residuals and scalings goes through a work
//    row a lane in device memory ([B, drcvar_ipm_work_floats]), read
//    once, so nothing is computed twice.
//
// Launch counters: `ipm_residuals.launches`, `ipm_predictor.launches` and
// `ipm_step.launches` on the wrappers in ops/cuda_ipm.py.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // blocks an SM: at most 85 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kColThreads = 64;                  // a column a thread ...
constexpr int kGroups = kThreads / kColThreads;  // ... in four row groups
constexpr int kMaxN = 64;
constexpr int kMaxHp = 64;
constexpr int kMaxM2 = 256;
constexpr int kMaxReduce = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPtrs = 30;

// The iterate's vectors, in the order of the table.
enum Vec { kU, kS, kW1, kW2, kW3, kL1, kL2, kL3, kVecs };

// The table the wrappers pass: the call's data, the iterate, the best
// iterate and the lanes' bookkeeping, each [B, ...] (P and T shared).
struct Ptrs {
  const float* P;
  const float* T;
  const float* q_u;
  const float* h1;
  const float* A;
  const float* b;
  const float* p_ss;
  const float* q_s;
  const float* q_scale;
  float* x[kVecs];
  float* best[kVecs];
  float* best_merit;
  bool* done;
  int* stall;
  int* iters;
  bool* active;
};

Ptrs unpack(const void* const* t) {
  Ptrs p;
  p.P = static_cast<const float*>(t[0]);
  p.T = static_cast<const float*>(t[1]);
  p.q_u = static_cast<const float*>(t[2]);
  p.h1 = static_cast<const float*>(t[3]);
  p.A = static_cast<const float*>(t[4]);
  p.b = static_cast<const float*>(t[5]);
  p.p_ss = static_cast<const float*>(t[6]);
  p.q_s = static_cast<const float*>(t[7]);
  p.q_scale = static_cast<const float*>(t[8]);
  for (int v = 0; v < kVecs; ++v) {
    p.x[v] = static_cast<float*>(const_cast<void*>(t[9 + v]));
    p.best[v] = static_cast<float*>(const_cast<void*>(t[17 + v]));
  }
  p.best_merit = static_cast<float*>(const_cast<void*>(t[25]));
  p.done = static_cast<bool*>(const_cast<void*>(t[26]));
  p.stall = static_cast<int*>(const_cast<void*>(t[27]));
  p.iters = static_cast<int*>(const_cast<void*>(t[28]));
  p.active = static_cast<bool*>(const_cast<void*>(t[29]));
  return p;
}

struct Dims {
  int n, hp, m1, m2, nt, ldt;  // nt rows of [T; A], stride ldt in smem
  __host__ __device__ Dims(int n_, int hp_, int m2_)
      : n(n_), hp(hp_), m1(2 * n_ + 2 * hp_), m2(m2_), nt(hp_ + m2_),
        ldt((n_ + 3) & ~3) {}
  __host__ __device__ int len(int v) const {
    return v == kU ? n : (v == kW1 || v == kL1) ? m1 : m2;
  }
};

// A lane's work row: what B and C read of A's (and B's) results.
struct Work {
  static constexpr int kStep = 0;  // 1 where the lane steps this pass
  static constexpr int kMu = 1;
  int d1, rp1, rc1, d2, d3, mss, rp2, rp3, rds, rc2, rc3, ts, rdu, floats;
  __host__ __device__ explicit Work(const Dims& d) {
    int o = 4;
    d1 = o; o += d.m1;
    rp1 = o; o += d.m1;
    rc1 = o; o += d.m1;
    d2 = o; o += d.m2;
    d3 = o; o += d.m2;
    mss = o; o += d.m2;
    rp2 = o; o += d.m2;
    rp3 = o; o += d.m2;
    rds = o; o += d.m2;
    rc2 = o; o += d.m2;
    rc3 = o; o += d.m2;
    ts = o; o += d.m2;
    rdu = o; o += d.n;
    floats = o;
  }
};

// A lane's shared memory.  `carve` lays it out from a base address (0 on
// the host, which only wants the size); every array starts 16-byte
// aligned.
struct Sh {
  float *TA, *P, *wk, *cw, *tav, *u, *du, *qu, *rdu, *colp, *red;
  float *s, *w2, *w3, *l2, *l3, *b, *pss, *qs, *d2, *d3, *mss, *rp2, *rp3,
      *rds, *ts, *rc2, *rc3, *ds, *dl2, *dl3, *dw2, *dw3;
  float *w1, *l1, *h1, *d1, *rp1, *rc1, *dl1, *dw1, *v1;
};

__host__ __device__ inline int carve(Sh& sh, uintptr_t base, const Dims& d,
                                     bool stage_P) {
  int off = 0;
  auto take = [&](float*& slot, int k) {
    slot = reinterpret_cast<float*>(base + sizeof(float) * off);
    off += (k + 3) & ~3;
  };
  take(sh.TA, d.nt * d.ldt);
  take(sh.P, stage_P ? d.n * d.n : 0);
  take(sh.wk, d.nt);
  take(sh.cw, d.nt);
  take(sh.tav, d.nt);
  take(sh.u, d.n);
  take(sh.du, d.n);
  take(sh.qu, d.n);
  take(sh.rdu, d.n);
  take(sh.colp, kGroups * kColThreads);
  take(sh.red, kWarps * kMaxReduce);
  float** m2v[] = {&sh.s, &sh.w2, &sh.w3, &sh.l2, &sh.l3, &sh.b, &sh.pss,
                   &sh.qs, &sh.d2, &sh.d3, &sh.mss, &sh.rp2, &sh.rp3,
                   &sh.rds, &sh.ts, &sh.rc2, &sh.rc3, &sh.ds, &sh.dl2,
                   &sh.dl3, &sh.dw2, &sh.dw3};
  for (float** slot : m2v) take(*slot, d.m2);
  float** m1v[] = {&sh.w1, &sh.l1, &sh.h1, &sh.d1, &sh.rp1, &sh.rc1,
                   &sh.dl1, &sh.dw1, &sh.v1};
  for (float** slot : m1v) take(*slot, d.m1);
  return off;
}

size_t smem_bytes(const Dims& d, bool stage_P) {
  Sh sh;
  return sizeof(float) * carve(sh, 0, d, stage_P);
}

// The iterate's vectors of one lane in shared memory, in table order.
__device__ __forceinline__ float* sh_vec(const Sh& sh, int v) {
  switch (v) {
    case kU: return sh.u;
    case kS: return sh.s;
    case kW1: return sh.w1;
    case kW2: return sh.w2;
    case kW3: return sh.w3;
    case kL1: return sh.l1;
    case kL2: return sh.l2;
    default: return sh.l3;
  }
}

// Maxima, minima, clamps and relu that keep a NaN, as torch's do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float relu(float x) { return nan_max(x, 0.f); }
__device__ __forceinline__ float clamp_d(float x) {  // the scalings D
  return x < 1e-10f ? 1e-10f : (x > 1e10f ? 1e10f : x);
}
__device__ __forceinline__ float clamp_one(float x) {
  return x > 1.f ? 1.f : x;
}
// The largest step keeping v + a dv >= 0 (before the fraction and the
// clamp at 1): -v / dv where dv < 0, else infinity.
__device__ __forceinline__ float ratio(float v, float dv) {
  return dv < 0.f ? -v / dv : INFINITY;
}

enum Op { kSum, kMax, kMin };

__device__ __forceinline__ float combine(Op op, float a, float b) {
  return op == kSum ? a + b : (op == kMax ? nan_max(a, b) : nan_min(a, b));
}

// K values reduced over the block at once; every thread gets the results.
template <int K>
__device__ __forceinline__ void block_reduce(float (&v)[K], const Op (&op)[K],
                                             float* red) {
  static_assert(K <= kMaxReduce, "red holds kMaxReduce values a warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] = combine(op[k], v[k], __shfl_xor_sync(kFull, v[k], o));
    if (lane == 0) red[warp * kMaxReduce + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float r = red[k];
    for (int w = 1; w < kWarps; ++w) r = combine(op[k], r, red[w * kMaxReduce + k]);
    v[k] = r;
  }
  __syncthreads();  // `red` is free for the next reduction
}

// Starts the copy of k floats from device memory into shared memory
// (cp.async: no registers, every copy of the block in flight at once),
// 16 bytes at a time where both ends are 16-byte aligned and k is a
// multiple of 4.  `fetched` waits for all of them.
__device__ __forceinline__ void fetch(float* dst, const float* src, int k) {
  const bool wide = (((reinterpret_cast<uintptr_t>(dst) |
                       reinterpret_cast<uintptr_t>(src)) & 15u) == 0) &&
                    (k & 3) == 0;
  if (wide) {
    for (int i = threadIdx.x; i < k / 4; i += kThreads)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  } else {
    for (int i = threadIdx.x; i < k; i += kThreads)
      __pipeline_memcpy_async(dst + i, src + i, 4);
  }
}

__device__ __forceinline__ void fetched() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

__device__ __forceinline__ void store(float* dst, const float* src, int k) {
  for (int i = threadIdx.x; i < k; i += kThreads) dst[i] = src[i];
}

// out[r] = M[r, :cols] . v for r < rows: a warp a row, four rows of a
// warp at a time so that their shuffle trees overlap.
__device__ void row_dots(const float* M, int ld, int rows, int cols,
                         const float* v, float* out) {
  constexpr int kRows = 4;
  const int lane = threadIdx.x & 31;
  for (int r0 = threadIdx.x >> 5; r0 < rows; r0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + k * kWarps;
      float a = 0.f;
      if (r < rows)
        for (int j = lane; j < cols; j += 32) a = fmaf(M[r * ld + j], v[j], a);
      acc[k] = a;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        acc[k] += __shfl_xor_sync(kFull, acc[k], o);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (lane == 0 && r0 + k * kWarps < rows) out[r0 + k * kWarps] = acc[k];
  }
}

// sum_k M[k, j] w[k] over k < rows, returned to thread j < cols (<= 64);
// every thread of the block calls it.  Reads `colp` after a barrier; the
// caller syncs before `colp` or `w` is written again.
__device__ float col_sum(const float* M, int ld, int rows, int cols,
                         const float* w, float* colp) {
  const int g = threadIdx.x / kColThreads, j = threadIdx.x % kColThreads;
  if (j < cols) {
    float acc = 0.f;
    for (int k = g; k < rows; k += kGroups) acc = fmaf(M[k * ld + j], w[k], acc);
    colp[g * kColThreads + j] = acc;
  }
  __syncthreads();
  float acc = 0.f;
  if (threadIdx.x < cols) {
    acc = colp[threadIdx.x];
    for (int h = 1; h < kGroups; ++h) acc += colp[h * kColThreads + threadIdx.x];
  }
  return acc;
}

// Row i of G v for G = [I; -I; T; -T], with tv = T v.
__device__ __forceinline__ float box_row(const float* v, const float* tv,
                                         int i, const Dims& d) {
  if (i < d.n) return v[i];
  if (i < 2 * d.n) return -v[i - d.n];
  if (i < 2 * d.n + d.hp) return tv[i - 2 * d.n];
  return -tv[i - 2 * d.n - d.hp];
}

// Starts the copy of [T; A] (the lane's A) into shared memory: rows
// 0..hp-1 from T, the rest from A, at stride ldt with the padding columns
// zero.
__device__ void stage_rows(float* TA, const float* T, const float* A,
                           const Dims& d) {
  if (d.ldt == d.n) {
    fetch(TA, T, d.hp * d.n);
    fetch(TA + d.hp * d.n, A, d.m2 * d.n);
    return;
  }
  for (int i = threadIdx.x; i < d.nt * d.n; i += kThreads) {
    const int k = i / d.n, j = i - k * d.n;
    __pipeline_memcpy_async(TA + k * d.ldt + j,
                            k < d.hp ? T + i : A + (i - d.hp * d.n), 4);
  }
  const int pad = d.ldt - d.n;
  for (int i = threadIdx.x; i < d.nt * pad; i += kThreads)
    TA[(i / pad) * d.ldt + d.n + i % pad] = 0.f;
}

// A lane that does not step: S = I and a zero right-hand side keep
// kernels 2 and 3 finite; B and C skip it.
__device__ void rest_lane(float* S, float* rhs, float* work, int n) {
  for (int i = threadIdx.x; i < n * n; i += kThreads)
    S[i] = i % (n + 1) == 0 ? 1.f : 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) rhs[i] = 0.f;
  if (threadIdx.x == 0) work[Work::kStep] = 0.f;
}

// S = P + diag(d1[:n] + d1[n:2n]) + [T; A]' diag(wk) [T; A] + reg I, in
// 4 x 4 tiles of the lower triangle, each written with its mirror over
// the staged P (whose upper triangle nothing reads), then copied out to S
// in whole rows.
__device__ void assemble_schur(const Sh& sh, float reg, const Dims& d,
                               float* S) {
  const int n = d.n, nb = (n + 3) >> 2, tiles = nb * (nb + 1) / 2;
  const bool split = 2 * tiles <= kThreads;
  const int half = split ? (threadIdx.x & 1) : 0;
  const int first = split ? (threadIdx.x >> 1) : threadIdx.x;
  const int step = split ? kThreads / 2 : kThreads;
  const int mid = (d.nt + 1) >> 1;
  const int k0 = split && half ? mid : 0;
  const int k1 = split && !half ? mid : d.nt;
  for (int base = 0; base < tiles; base += step) {
    const int tile = base + first;
    const bool on = tile < tiles;
    int I = 0;
    if (on)
      while ((I + 1) * (I + 2) / 2 <= tile) ++I;
    const int J = on ? tile - I * (I + 1) / 2 : 0;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    if (on) {
      for (int k = k0; k < k1; ++k) {
        const float4 ri = *reinterpret_cast<const float4*>(sh.TA + k * d.ldt + 4 * I);
        const float4 rj = *reinterpret_cast<const float4*>(sh.TA + k * d.ldt + 4 * J);
        const float w = sh.wk[k];
        const float ai[4] = {ri.x * w, ri.y * w, ri.z * w, ri.w * w};
        const float bj[4] = {rj.x, rj.y, rj.z, rj.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(ai[a], bj[c], acc[a][c]);
      }
    }
    if (split) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += __shfl_xor_sync(kFull, acc[a][c], 1);
    }
    if (on && half == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * I + a, j = 4 * J + c;
          if (i < n && j < n && (I > J || a >= c)) {
            float v = sh.P[i * n + j];
            if (i == j) v += sh.d1[i] + sh.d1[n + i];
            v += acc[a][c];
            if (i == j) v += reg;
            sh.P[i * n + j] = v;
            sh.P[j * n + i] = v;
          }
        }
      }
    }
  }
  __syncthreads();
  store(S, sh.P, n * n);
}

// The Newton system's reduced right-hand side for the complementarity
// targets rc1..3 (in shared memory):
//   t_s = -r_ds + d2 r_p2 - rc2 / w2 + d3 r_p3 - rc3 / w3        -> sh.ts
//   rhs = -r_du - G'(d1 r_p1 - rc1 / w1) - A'(d2 r_p2 - rc2 / w2)
//         + A'(d2 t_s / m_ss)                                     -> rhs
// Needs the staged rows.  Ends without a barrier after reading colp.
__device__ void newton_rhs(const Sh& sh, const Dims& d, float* rhs) {
  const int t = threadIdx.x, n = d.n, hp = d.hp;
  for (int r = t; r < d.m2; r += kThreads) {
    const float d2 = sh.d2[r];
    const float c2 = sh.rc2[r] / sh.w2[r], c3 = sh.rc3[r] / sh.w3[r];
    const float ts = -sh.rds[r] + d2 * sh.rp2[r] - c2 + sh.d3[r] * sh.rp3[r] - c3;
    sh.ts[r] = ts;
    sh.cw[hp + r] = (d2 * sh.rp2[r] - c2) - d2 * ts / sh.mss[r];
  }
  for (int i = t; i < d.m1; i += kThreads)
    sh.v1[i] = sh.d1[i] * sh.rp1[i] - sh.rc1[i] / sh.w1[i];
  __syncthreads();
  for (int k = t; k < hp; k += kThreads)
    sh.cw[k] = sh.v1[2 * n + k] - sh.v1[2 * n + hp + k];
  __syncthreads();
  const float col = col_sum(sh.TA, d.ldt, d.nt, n, sh.cw, sh.colp);
  if (t < n) rhs[t] = -sh.rdu[t] - (sh.v1[t] - sh.v1[n + t]) - col;
}

// The back-substitution of a Newton step from du (sh.du, with
// sh.tav = [T du; A du]) and the targets rc1..3 and t_s:
//   ds  = (t_s + d2 A du) / m_ss
//   dl1 = d1 (G du + r_p1) - rc1 / w1,  dl2 = d2 (A du - ds + r_p2) - rc2 / w2,
//   dl3 = d3 (-ds + r_p3) - rc3 / w3,   dw = -(rc + w dl) / l,
// then the step lengths min(1, frac * the largest step keeping w and l
// nonnegative), to every thread.
__device__ void directions(const Sh& sh, const Dims& d, float frac, float& a_p,
                           float& a_d) {
  const int t = threadIdx.x, hp = d.hp;
  float ap = INFINITY, ad = INFINITY;
  for (int r = t; r < d.m2; r += kThreads) {
    const float adu = sh.tav[hp + r];
    const float w2 = sh.w2[r], w3 = sh.w3[r], l2 = sh.l2[r], l3 = sh.l3[r];
    const float rc2 = sh.rc2[r], rc3 = sh.rc3[r];
    const float ds = (sh.ts[r] + sh.d2[r] * adu) / sh.mss[r];
    const float dl2 = sh.d2[r] * (adu - ds + sh.rp2[r]) - rc2 / w2;
    const float dl3 = sh.d3[r] * (-ds + sh.rp3[r]) - rc3 / w3;
    const float dw2 = -(rc2 + w2 * dl2) / l2;
    const float dw3 = -(rc3 + w3 * dl3) / l3;
    sh.ds[r] = ds;
    sh.dl2[r] = dl2;
    sh.dl3[r] = dl3;
    sh.dw2[r] = dw2;
    sh.dw3[r] = dw3;
    ap = nan_min(ap, nan_min(ratio(w2, dw2), ratio(w3, dw3)));
    ad = nan_min(ad, nan_min(ratio(l2, dl2), ratio(l3, dl3)));
  }
  for (int i = t; i < d.m1; i += kThreads) {
    const float w1 = sh.w1[i], l1 = sh.l1[i], rc1 = sh.rc1[i];
    const float gdu = box_row(sh.du, sh.tav, i, d);
    const float dl1 = sh.d1[i] * (gdu + sh.rp1[i]) - rc1 / w1;
    const float dw1 = -(rc1 + w1 * dl1) / l1;
    sh.dl1[i] = dl1;
    sh.dw1[i] = dw1;
    ap = nan_min(ap, ratio(w1, dw1));
    ad = nan_min(ad, ratio(l1, dl1));
  }
  float v[2] = {ap, ad};
  const Op op[2] = {kMin, kMin};
  block_reduce(v, op, sh.red);
  a_p = clamp_one(frac * v[0]);
  a_d = clamp_one(frac * v[1]);
}

// ---------------------------------------------------------------------
// A: residuals, bookkeeping, scalings, S and the predictor's right-hand
// side.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, kMinBlocks)
residuals_kernel(Ptrs p, float* S_all, float* rhs_all, float* work_all,
                 Dims d, int m_total, float reg, float tol, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x, t = threadIdx.x;
  const int n = d.n, hp = d.hp, m1 = d.m1, m2 = d.m2;
  const Work wl(d);
  float* work = work_all + static_cast<size_t>(q) * wl.floats;
  float* S = S_all + static_cast<size_t>(q) * n * n;
  float* rhs = rhs_all + static_cast<size_t>(q) * n;
  if (!p.active[q]) {
    rest_lane(S, rhs, work, n);
    return;
  }
  // Read before the first barrier; thread 0 writes them after it.
  const float best_merit = p.best_merit[q];
  const int stall = p.stall[q], iters = p.iters[q];

  Sh sh;
  carve(sh, reinterpret_cast<uintptr_t>(smem), d, true);
  stage_rows(sh.TA, p.T, p.A + static_cast<size_t>(q) * m2 * n, d);
  fetch(sh.P, p.P, n * n);
  for (int v = 0; v < kVecs; ++v)
    fetch(sh_vec(sh, v), p.x[v] + static_cast<size_t>(q) * d.len(v), d.len(v));
  fetch(sh.qu, p.q_u + static_cast<size_t>(q) * n, n);
  fetch(sh.h1, p.h1 + static_cast<size_t>(q) * m1, m1);
  fetch(sh.b, p.b + static_cast<size_t>(q) * m2, m2);
  fetch(sh.pss, p.p_ss + static_cast<size_t>(q) * m2, m2);
  fetch(sh.qs, p.q_s + static_cast<size_t>(q) * m2, m2);
  fetched();

  row_dots(sh.TA, d.ldt, d.nt, n, sh.u, sh.tav);  // [T u; A u]
  row_dots(sh.P, n, n, n, sh.u, sh.rdu);           // P u, completed below
  float mu_p = 0.f, viol_p = 0.f, rd_p = 0.f;
  for (int r = t; r < m2; r += kThreads) {
    const float s = sh.s[r], w2 = sh.w2[r], w3 = sh.w3[r];
    const float l2 = sh.l2[r], l3 = sh.l3[r];
    const float rds = sh.pss[r] * s + sh.qs[r] - l2 - l3;
    const float d2 = clamp_d(l2 / w2), d3 = clamp_d(l3 / w3);
    const float mss = sh.pss[r] + d2 + d3;
    sh.rds[r] = rds;
    sh.rp3[r] = -s + w3;
    sh.d2[r] = d2;
    sh.d3[r] = d3;
    sh.mss[r] = mss;
    sh.wk[hp + r] = d2 - d2 * d2 / mss;
    sh.cw[hp + r] = l2;
    mu_p += l2 * w2 + l3 * w3;
    rd_p = nan_max(rd_p, fabsf(rds));
    viol_p = nan_max(viol_p, relu(-s));
  }
  for (int i = t; i < m1; i += kThreads) {
    sh.d1[i] = clamp_d(sh.l1[i] / sh.w1[i]);
    mu_p += sh.l1[i] * sh.w1[i];
  }
  __syncthreads();

  for (int i = t; i < m1; i += kThreads) {
    const float gu = box_row(sh.u, sh.tav, i, d);
    sh.rp1[i] = gu + sh.w1[i] - sh.h1[i];
    viol_p = nan_max(viol_p, relu(gu - sh.h1[i]));
  }
  for (int r = t; r < m2; r += kThreads) {
    const float au = sh.tav[hp + r];
    sh.rp2[r] = au - sh.s[r] + sh.w2[r] - sh.b[r];
    viol_p = nan_max(viol_p, relu(au - sh.s[r] - sh.b[r]));
  }
  for (int k = t; k < hp; k += kThreads) {
    sh.cw[k] = sh.l1[2 * n + k] - sh.l1[2 * n + hp + k];
    sh.wk[k] = sh.d1[2 * n + k] + sh.d1[2 * n + hp + k];
  }
  __syncthreads();

  // r_du = P u + q_u + G' l1 + A' l2
  const float col = col_sum(sh.TA, d.ldt, d.nt, n, sh.cw, sh.colp);
  if (t < n) {
    const float rdu = sh.rdu[t] + sh.qu[t] + (sh.l1[t] - sh.l1[n + t]) + col;
    sh.rdu[t] = rdu;
    rd_p = nan_max(rd_p, fabsf(rdu));
  }
  float v[3] = {mu_p, viol_p, rd_p};
  const Op op[3] = {kSum, kMax, kMax};
  block_reduce(v, op, sh.red);
  const float mu = v[0] / static_cast<float>(m_total);
  const float merit = (mu + v[1] + v[2]) / p.q_scale[q];

  // Best iterate, stagnation / breakdown and the stop tests.
  const bool better = merit < best_merit;
  const bool improved = merit < best_merit * 0.995f;
  const int stall_n = improved ? 0 : stall + 1;
  const bool broke = !isfinite(merit);
  const float best_n = better ? merit : best_merit;
  const bool done_n = best_n < tol || broke || stall_n >= 10;
  const int iters_n = done_n ? iters : iters + 1;
  if (better)
    for (int v2 = 0; v2 < kVecs; ++v2)
      store(p.best[v2] + static_cast<size_t>(q) * d.len(v2), sh_vec(sh, v2),
            d.len(v2));
  if (t == 0) {
    p.best_merit[q] = best_n;
    p.done[q] = done_n;
    p.stall[q] = stall_n;
    p.iters[q] = iters_n;
    p.active[q] = !done_n && iters_n < max_iters;
    work[Work::kStep] = done_n ? 0.f : 1.f;
    work[Work::kMu] = mu;
  }
  if (done_n) {
    rest_lane(S, rhs, work, n);
    return;
  }

  // The predictor: rc = l w.
  for (int i = t; i < m1; i += kThreads) sh.rc1[i] = sh.l1[i] * sh.w1[i];
  for (int r = t; r < m2; r += kThreads) {
    sh.rc2[r] = sh.l2[r] * sh.w2[r];
    sh.rc3[r] = sh.l3[r] * sh.w3[r];
  }
  newton_rhs(sh, d, rhs);
  assemble_schur(sh, reg, d, S);
  store(work + wl.d1, sh.d1, m1);
  store(work + wl.rp1, sh.rp1, m1);
  store(work + wl.d2, sh.d2, m2);
  store(work + wl.d3, sh.d3, m2);
  store(work + wl.mss, sh.mss, m2);
  store(work + wl.rp2, sh.rp2, m2);
  store(work + wl.rp3, sh.rp3, m2);
  store(work + wl.rds, sh.rds, m2);
  store(work + wl.ts, sh.ts, m2);
  store(work + wl.rdu, sh.rdu, n);
}

// Loads what B and C read of a stepping lane: du, the iterate's w and l
// (and u, s where `all`), and the work row.
// Starts the copies of what B and C read of a stepping lane: the rows
// [T; A], du, the iterate's w and l (and u, s where `all`), and the work
// row.
__device__ void fetch_step(const Sh& sh, const Ptrs& p, const float* work,
                           const Work& wl, const float* du, int q,
                           const Dims& d, bool all) {
  stage_rows(sh.TA, p.T, p.A + static_cast<size_t>(q) * d.m2 * d.n, d);
  fetch(sh.du, du + static_cast<size_t>(q) * d.n, d.n);
  for (int v = all ? 0 : kW1; v < kVecs; ++v)
    fetch(sh_vec(sh, v), p.x[v] + static_cast<size_t>(q) * d.len(v), d.len(v));
  fetch(sh.d1, work + wl.d1, d.m1);
  fetch(sh.rp1, work + wl.rp1, d.m1);
  fetch(sh.d2, work + wl.d2, d.m2);
  fetch(sh.d3, work + wl.d3, d.m2);
  fetch(sh.mss, work + wl.mss, d.m2);
  fetch(sh.rp2, work + wl.rp2, d.m2);
  fetch(sh.rp3, work + wl.rp3, d.m2);
  fetch(sh.ts, work + wl.ts, d.m2);
}

// ---------------------------------------------------------------------
// B: the predictor's back-substitution and step, mu_aff, the centring,
// and the corrector's right-hand side.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, kMinBlocks)
predictor_kernel(Ptrs p, float* work_all, const float* du_all, float* rhs_all,
                 Dims d, int m_total) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x, t = threadIdx.x;
  const int n = d.n, m1 = d.m1, m2 = d.m2;
  const Work wl(d);
  float* work = work_all + static_cast<size_t>(q) * wl.floats;
  if (work[Work::kStep] == 0.f) return;
  const float mu = work[Work::kMu];
  Sh sh;
  carve(sh, reinterpret_cast<uintptr_t>(smem), d, false);
  fetch_step(sh, p, work, wl, du_all, q, d, false);
  fetch(sh.rds, work + wl.rds, m2);
  fetch(sh.rdu, work + wl.rdu, n);
  fetched();
  for (int i = t; i < m1; i += kThreads) sh.rc1[i] = sh.l1[i] * sh.w1[i];
  for (int r = t; r < m2; r += kThreads) {
    sh.rc2[r] = sh.l2[r] * sh.w2[r];
    sh.rc3[r] = sh.l3[r] * sh.w3[r];
  }
  __syncthreads();
  row_dots(sh.TA, d.ldt, d.nt, n, sh.du, sh.tav);  // [T du; A du]
  __syncthreads();
  float a_p, a_d;
  directions(sh, d, 1.f, a_p, a_d);

  float s = 0.f;
  for (int r = t; r < m2; r += kThreads)
    s += (sh.l2[r] + a_d * sh.dl2[r]) * (sh.w2[r] + a_p * sh.dw2[r]) +
         (sh.l3[r] + a_d * sh.dl3[r]) * (sh.w3[r] + a_p * sh.dw3[r]);
  for (int i = t; i < m1; i += kThreads)
    s += (sh.l1[i] + a_d * sh.dl1[i]) * (sh.w1[i] + a_p * sh.dw1[i]);
  float v[1] = {s};
  const Op op[1] = {kSum};
  block_reduce(v, op, sh.red);
  const float mu_aff = v[0] / static_cast<float>(m_total);
  const float c = mu_aff / (mu < 1e-30f ? 1e-30f : mu);
  const float sigma_mu = c * c * c * mu;

  // The corrector: rc = l w + dl_aff dw_aff - sigma mu.
  for (int i = t; i < m1; i += kThreads)
    sh.rc1[i] = sh.l1[i] * sh.w1[i] + sh.dl1[i] * sh.dw1[i] - sigma_mu;
  for (int r = t; r < m2; r += kThreads) {
    sh.rc2[r] = sh.l2[r] * sh.w2[r] + sh.dl2[r] * sh.dw2[r] - sigma_mu;
    sh.rc3[r] = sh.l3[r] * sh.w3[r] + sh.dl3[r] * sh.dw3[r] - sigma_mu;
  }
  newton_rhs(sh, d, rhs_all + static_cast<size_t>(q) * n);
  store(work + wl.rc1, sh.rc1, m1);
  store(work + wl.rc2, sh.rc2, m2);
  store(work + wl.rc3, sh.rc3, m2);
  store(work + wl.ts, sh.ts, m2);
}

// ---------------------------------------------------------------------
// C: the corrector's back-substitution, its step at 0.99 and the update
// of the iterate in place.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, kMinBlocks)
step_kernel(Ptrs p, const float* work_all, const float* du_all, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x, t = threadIdx.x;
  const int n = d.n, m1 = d.m1, m2 = d.m2;
  const Work wl(d);
  const float* work = work_all + static_cast<size_t>(q) * wl.floats;
  if (work[Work::kStep] == 0.f) return;
  Sh sh;
  carve(sh, reinterpret_cast<uintptr_t>(smem), d, false);
  fetch_step(sh, p, work, wl, du_all, q, d, true);
  fetch(sh.rc1, work + wl.rc1, m1);
  fetch(sh.rc2, work + wl.rc2, m2);
  fetch(sh.rc3, work + wl.rc3, m2);
  fetched();
  row_dots(sh.TA, d.ldt, d.nt, n, sh.du, sh.tav);  // [T du; A du]
  __syncthreads();
  float a_p, a_d;
  directions(sh, d, 0.99f, a_p, a_d);

  float* x[kVecs];
  for (int v = 0; v < kVecs; ++v) x[v] = p.x[v] + static_cast<size_t>(q) * d.len(v);
  for (int j = t; j < n; j += kThreads) x[kU][j] = sh.u[j] + a_p * sh.du[j];
  for (int r = t; r < m2; r += kThreads) {
    x[kS][r] = sh.s[r] + a_p * sh.ds[r];
    x[kW2][r] = sh.w2[r] + a_p * sh.dw2[r];
    x[kW3][r] = sh.w3[r] + a_p * sh.dw3[r];
    x[kL2][r] = sh.l2[r] + a_d * sh.dl2[r];
    x[kL3][r] = sh.l3[r] + a_d * sh.dl3[r];
  }
  for (int i = t; i < m1; i += kThreads) {
    x[kW1][i] = sh.w1[i] + a_p * sh.dw1[i];
    x[kL1][i] = sh.l1[i] + a_d * sh.dl1[i];
  }
}

bool bad_dims(int batch, int n, int hp, int m2) {
  return batch < 0 || n < 1 || n > kMaxN || hp < 0 || hp > kMaxHp ||
         m2 < 1 || m2 > kMaxM2;
}

// Lets a kernel take the shared memory of the largest lane it accepts.
template <typename Kernel>
int allow_smem(Kernel kernel, bool stage_P) {
  const size_t most = smem_bytes(Dims(kMaxN, kMaxHp, kMaxM2), stage_P);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most)));
}

}  // namespace

// Floats of a lane's work row.
extern "C" int drcvar_ipm_work_floats(int n, int hp, int m2) {
  return Work(Dims(n, hp, m2)).floats;
}

extern "C" int drcvar_ipm_residuals(const void* table, void* S, void* rhs,
                                    void* work, int batch, int n, int hp,
                                    int m2, int m_total, float reg, float tol,
                                    int max_iters, void* stream) {
  if (bad_dims(batch, n, hp, m2)) return static_cast<int>(cudaErrorInvalidValue);
  static const int allowed = allow_smem(residuals_kernel, true);
  if (allowed != 0) return allowed;
  if (batch == 0) return 0;
  const Dims d(n, hp, m2);
  residuals_kernel<<<batch, kThreads, smem_bytes(d, true),
                     static_cast<cudaStream_t>(stream)>>>(
      unpack(static_cast<const void* const*>(table)), static_cast<float*>(S),
      static_cast<float*>(rhs), static_cast<float*>(work), d, m_total, reg,
      tol, max_iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int drcvar_ipm_predictor(const void* table, void* work,
                                    const void* du, void* rhs, int batch,
                                    int n, int hp, int m2, int m_total,
                                    void* stream) {
  if (bad_dims(batch, n, hp, m2)) return static_cast<int>(cudaErrorInvalidValue);
  static const int allowed = allow_smem(predictor_kernel, false);
  if (allowed != 0) return allowed;
  if (batch == 0) return 0;
  const Dims d(n, hp, m2);
  predictor_kernel<<<batch, kThreads, smem_bytes(d, false),
                     static_cast<cudaStream_t>(stream)>>>(
      unpack(static_cast<const void* const*>(table)),
      static_cast<float*>(work), static_cast<const float*>(du),
      static_cast<float*>(rhs), d, m_total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int drcvar_ipm_step(const void* table, const void* work,
                               const void* du, int batch, int n, int hp,
                               int m2, void* stream) {
  if (bad_dims(batch, n, hp, m2)) return static_cast<int>(cudaErrorInvalidValue);
  static const int allowed = allow_smem(step_kernel, false);
  if (allowed != 0) return allowed;
  if (batch == 0) return 0;
  const Dims d(n, hp, m2);
  step_kernel<<<batch, kThreads, smem_bytes(d, false),
                static_cast<cudaStream_t>(stream)>>>(
      unpack(static_cast<const void* const*>(table)),
      static_cast<const float*>(work), static_cast<const float*>(du), d);
  return static_cast<int>(cudaGetLastError());
}

// The caps the kernels take, for the callers that choose them.
extern "C" int drcvar_ipm_caps(int which) {
  return which == 0 ? kMaxN : which == 1 ? kMaxHp : which == 2 ? kMaxM2 : kPtrs;
}
