// Attribution variants of the DR-CVaR halfspace kernel for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of the JAX package's kernel
// benchmark (experiments/kbench.py):
//
//   * `drcvar_variant`  <- `fused` (kernel bodies from `make_kernel`
//     with `_select_r3`, `_select_none`, `_select_fixed`; `prod_nosel`;
//     `minimal`): the DR-CVaR solve with its select swapped out;
//   * `drcvar_minimal_planes` <- `minimal_planes`: the read floor;
//   * `drcvar_select_rounds` <- `measure_prod_rounds`: how many passes
//     of the block-wide radix select a row needs.
//
// Each is one thread block per row, as the block path of the production
// kernel (halfspace_kernels.cu: its kernel for rows of more than 1024
// samples, and its only kernel before the warp path existed), so the
// differences between their times attribute THAT design's time to its
// stages.  At N <= 1024 the production kernel gives a warp a row and is
// faster than `nosel` here; the variants then say what a block a row
// costs, not where the production kernel's time goes:
//
//   nosel       pre-select stages, CVaR := mean(x) - shift;
//   prod_nosel  pre-select stages + sigma = sqrt(sum x^2 / N),
//               CVaR := mean(x) + sigma - shift;
//   r3          3-ary bisection on the uint32 keys between the row's
//               min and max key, early exit when the row is frozen
//               (count(key >= lo) == k or lo >= hi), at most 22 rounds;
//               then v = min{x : key >= lo} and the strict-greater tail;
//   fixed12/22  the same bisection with exactly 12 / 22 rounds (no early
//               exit; approximate by design);
//   minimal     one read of the row, two sums: g = gx + gy, h = (gx, gy);
//   minimal_planes  the same plus the row's own ego x in g (the TPU body
//               adds the first ego of its row tile, a tiling artefact).
//
// The TPU packs the bisection's two counts into one int32 (11-bit
// fields, N <= 2047); here each count is its own block sum, so N is
// bounded only by shared memory.  Pivot arithmetic is the TPU's uint32
// arithmetic exactly (span / 3, lo + third + 1, lo + 2 third + 1).
//
// `select_rounds` returns, per row, the first pass p in {1, 2, 3, 4} of
// the block path's 4-pass radix select after which every key sharing the
// k-th key's top 8p bits equals the k-th key: the passes the row needed,
// and so the room an early exit has (the warp path takes it where the
// chosen bin holds one key).  Its pre-select stage
// rounds every product and sum on its own (no contraction into FMAs) in
// the fixed order of `block_reduce`, so that its plain version can
// reproduce the projections, and hence the pass counts, bit for bit.
//
// What bounds them on this card: as the block path, the latency of
// block-wide barriers; `minimal` reads each sample once and makes two
// block sums, so its time is the floor set by device-memory bandwidth
// and the one-block-per-row launch.

#include "halfspace_common.cuh"

namespace {

using namespace drcvar;

enum Variant : int {
  kNoSel = 0,
  kProdNoSel = 1,
  kR3 = 2,
  kFixed = 3,
  kMinimal = 4,
  kMinimalPlanes = 5,
};

// 3-ary bisection on the keys of xs; returns lo (the TPU's `_select_r3`
// / `_select_fixed` loop, one row).
template <bool kEarlyExit>
__device__ unsigned bisect3(const float* xs, int n, int k, int rounds,
                            unsigned* red_u, int* red_i) {
  unsigned kmin = 0xffffffffu;
  unsigned kmax = 0u;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned key = float_key(xs[i]);
    kmin = min(kmin, key);
    kmax = max(kmax, key);
  }
  unsigned lo = block_reduce(kmin, red_u, Min());
  unsigned hi = block_reduce(kmax, red_u, Max());
  int c_lo = n;
  for (int t = 0; t < rounds; ++t) {
    const bool frozen = (c_lo == k) || (lo >= hi);
    if (kEarlyExit && frozen) break;
    const unsigned third = (hi - lo) / 3u;
    const unsigned m1 = lo + third + 1u;
    const unsigned m2 = lo + third * 2u + 1u;
    int n1 = 0;
    int n2 = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned key = float_key(xs[i]);
      n1 += key >= m1;
      n2 += key >= m2;
    }
    const int c1 = block_sum(n1, red_i);
    const int c2 = block_sum(n2, red_i);
    if (!frozen) {
      if (c2 >= k) {
        lo = m2;
        c_lo = c2;
      } else if (c1 >= k) {
        hi = m2 - 1u;
        lo = m1;
        c_lo = c1;
      } else {
        hi = m1 - 1u;
      }
    }
  }
  return lo;
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const float2* __restrict__ samples,
               const float2* __restrict__ ego, float2* __restrict__ h_out,
               float* __restrict__ g_out, int n, int k, int rounds,
               float inv_n, float an, float delta, float eps_over_alpha) {
  extern __shared__ float xs[];
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ unsigned red_u[kWarps];

  const int row = blockIdx.x;
  const float2* s = samples + static_cast<size_t>(row) * n;

  if constexpr (kVariant == kMinimal || kVariant == kMinimalPlanes) {
    float sx = 0.f;
    float sy = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 p = s[i];
      sx += p.x;
      sy += p.y;
    }
    const float gx = block_sum(sx, red_f) * inv_n;
    const float gy = block_sum(sy, red_f) * inv_n;
    if (threadIdx.x == 0) {
      h_out[row] = make_float2(gx, gy);
      if constexpr (kVariant == kMinimalPlanes) {
        g_out[row] = gx + gy + ego[row].x;
      } else {
        g_out[row] = gx + gy;
      }
    }
    return;
  } else {
    const RowStats r = row_projections(s, ego[row], n, inv_n, xs, red_f);
    float cvar;
    if constexpr (kVariant == kNoSel || kVariant == kProdNoSel) {
      float sum = 0.f;
      float sum2 = 0.f;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float x = xs[i];
        sum += x;
        sum2 += x * x;
      }
      cvar = block_sum(sum, red_f) / static_cast<float>(n);
      if constexpr (kVariant == kProdNoSel) {
        cvar += sqrtf(block_sum(sum2, red_f) * inv_n);
      }
    } else {
      const unsigned lo = bisect3<kVariant == kR3>(xs, n, k, rounds, red_u,
                                                   red_i);
      float vmin = __int_as_float(0x7f800000);  // +inf
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float x = xs[i];
        if (float_key(x) >= lo) vmin = fminf(vmin, x);
      }
      const float v = block_reduce(vmin, red_f, Min());
      float tail = 0.f;
      int cnt = 0;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float x = xs[i];
        if (x > v) {
          tail += x;
          ++cnt;
        }
      }
      const float sum_gt = block_sum(tail, red_f);
      const int size_gt = block_sum(cnt, red_i);
      cvar = (sum_gt + (an - static_cast<float>(size_gt)) * v) / an;
    }
    if (threadIdx.x == 0) {
      const float shift = r.hx * r.mx + r.hy * r.my;
      h_out[row] = make_float2(r.hx, r.hy);
      g_out[row] = cvar - shift - delta + eps_over_alpha;
    }
  }
}

// Pre-select stage with every operation rounded on its own, in the
// fixed order of block_reduce (see the file note), then the block path's
// select with its per-pass counts.
__global__ void __launch_bounds__(kThreads)
select_rounds_kernel(const float2* __restrict__ samples,
                     const float2* __restrict__ ego, int* __restrict__ out,
                     int n, int k, float inv_n) {
  extern __shared__ float xs[];
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int hist[kThreads];
  __shared__ int sel[2];
  __shared__ int pass_counts[4];

  const int row = blockIdx.x;
  const float2* s = samples + static_cast<size_t>(row) * n;
  const float2 e = ego[row];
  float sx = 0.f;
  float sy = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = s[i];
    sx = __fadd_rn(sx, __fsub_rn(p.x, e.x));
    sy = __fadd_rn(sy, __fsub_rn(p.y, e.y));
  }
  const float dx = __fmul_rn(block_sum(sx, red_f), inv_n);
  const float dy = __fmul_rn(block_sum(sy, red_f), inv_n);
  const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                          __fmul_rn(dy, dy)));
  const bool degen = norm < kEps;
  const float hx = degen ? 1.f : __fdiv_rn(dx, norm);
  const float hy = degen ? 0.f : __fdiv_rn(dy, norm);
  const float mx = __fadd_rn(e.x, dx);
  const float my = __fadd_rn(e.y, dy);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = s[i];
    xs[i] = __fadd_rn(__fmul_rn(__fsub_rn(mx, p.x), hx),
                      __fmul_rn(__fsub_rn(my, p.y), hy));
  }
  __syncthreads();
  block_kth_largest(xs, n, k, hist, red_i, sel, pass_counts);
  if (threadIdx.x == 0) {
    int p = 4;
    while (p > 1 && pass_counts[p - 2] == pass_counts[3]) --p;
    out[row] = p;
  }
}

template <int kVariant>
int launch_variant(const void* samples, const void* ego, void* h, void* g,
                   int rows, int n, int k, int rounds, float inv_n, float an,
                   float delta, float eps_over_alpha, void* stream) {
  const bool minimal = kVariant == kMinimal || kVariant == kMinimalPlanes;
  const size_t smem = minimal ? 0 : static_cast<size_t>(n) * sizeof(float);
  const cudaError_t err = reserve_smem(variant_kernel<kVariant>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  variant_kernel<kVariant><<<rows, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(samples), static_cast<const float2*>(ego),
      static_cast<float2*>(h), static_cast<float*>(g), n, k, rounds, inv_n,
      an, delta, eps_over_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 nosel, 1 prod_nosel, 2 r3 (early exit, at most `rounds`),
// 3 fixed (exactly `rounds`), 4 minimal, 5 minimal_planes.
extern "C" int drcvar_variant(const void* samples, const void* ego, void* h,
                              void* g, int rows, int n, int k, int variant,
                              int rounds, float inv_n, float an, float delta,
                              float eps_over_alpha, void* stream) {
  switch (variant) {
    case kNoSel:
      return launch_variant<kNoSel>(samples, ego, h, g, rows, n, k, rounds,
                                    inv_n, an, delta, eps_over_alpha, stream);
    case kProdNoSel:
      return launch_variant<kProdNoSel>(samples, ego, h, g, rows, n, k,
                                        rounds, inv_n, an, delta,
                                        eps_over_alpha, stream);
    case kR3:
      return launch_variant<kR3>(samples, ego, h, g, rows, n, k, rounds,
                                 inv_n, an, delta, eps_over_alpha, stream);
    case kFixed:
      return launch_variant<kFixed>(samples, ego, h, g, rows, n, k, rounds,
                                    inv_n, an, delta, eps_over_alpha, stream);
    case kMinimal:
      return launch_variant<kMinimal>(samples, ego, h, g, rows, n, k, rounds,
                                      inv_n, an, delta, eps_over_alpha,
                                      stream);
    case kMinimalPlanes:
      return launch_variant<kMinimalPlanes>(samples, ego, h, g, rows, n, k,
                                            rounds, inv_n, an, delta,
                                            eps_over_alpha, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int drcvar_select_rounds(const void* samples, const void* ego,
                                    void* out, int rows, int n, int k,
                                    float inv_n, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const cudaError_t err = reserve_smem(select_rounds_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_rounds_kernel<<<rows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(samples), static_cast<const float2*>(ego),
      static_cast<int*>(out), n, k, inv_n);
  return static_cast<int>(cudaGetLastError());
}
