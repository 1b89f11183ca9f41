// Attribution variants of the DR-CVaR halfspace kernel for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of the JAX package's kernel
// benchmark (experiments/kbench.py):
//
//   * `drcvar_variant`  <- `fused` (kernel bodies from `make_kernel`
//     with `_select_r3`, `_select_none`, `_select_fixed`; `prod_nosel`;
//     `minimal`): the DR-CVaR solve with its select swapped out;
//   * `drcvar_minimal_planes` <- `minimal_planes`: the read floor of a
//     block a row;
//   * `drcvar_select_rounds` <- `measure_prod_rounds`: the trip count of
//     the production select.
//
// The benchmark asks where the production kernel's time goes, so each
// variant has to BE the production kernel with one stage swapped, as the
// TPU variants are built from the production kernel's own stages.  The
// production kernel (halfspace_kernels.cu) has two designs, and so have
// the variants; the caller's plan (ops/cuda_kernels.py `halfspace_plan`)
// says which, and the entry points check it and refuse the rest:
//
//   * N <= 1024, a warp a row: the stages of halfspace_warp.cuh (load into
//     registers, centred statistics, keys, select, tail), the very code
//     the production kernel instantiates.  The samples are read once, no
//     __syncthreads() anywhere, four rows a block.
//   * N > 1024, a block a row: the projections in shared memory and the
//     block-wide reductions of halfspace_common.cuh, as the production
//     block path.
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
//   minimal     one read of the row, two sums: g = gx + gy, h = (gx, gy):
//               the read floor of the row's design;
//   minimal_planes  a block a row at any N: the same plus the row's own
//               ego x in g (the TPU body adds the first ego of its row
//               tile, a tiling artefact).
//
// Pivot arithmetic is the TPU's uint32 arithmetic exactly (span / 3,
// lo + third + 1, lo + 2 third + 1).  The TPU packs the bisection's two
// counts into one int32 (11-bit fields, N <= 2047).  The warp path does
// the same with 16-bit fields (N <= 1024), so a round is two compares a
// key in registers and ONE `__reduce_add_sync`; it leaves when ITS row is
// frozen (the warp is the row; a TPU block leaves on its worst row).  On
// the block path each count is its own block sum.
//
// `select_rounds`, N <= 1024: the passes (1..4) that the production
// select itself (`warp_kth_largest_key`, the function the production
// kernel calls, not a copy) ran on the row: it leaves when the chosen bin
// holds one key, and keys tied with the k-th run all four.  N > 1024: the
// block select always runs four passes; there the count is the first pass
// p after which every key sharing the k-th key's top 8p bits equals the
// k-th key: the room an early exit would have.  On either path the
// pre-select stage rounds every product and sum on its own (no
// contraction into FMAs) in a fixed order (`warp_sum` / `block_reduce`),
// so that its plain version can rebuild the projections, and hence the
// counts, bit for bit.
//
// What bounds them on this card: bytes (8 KB of samples a row against 16
// float operations a sample and two compares a key and round).  What held
// the earlier block-a-row versions at N = 1000 to an eighth (r3) and a
// quarter (select_rounds) of that bound was latency: two passes over
// shared memory and two block-wide reductions of two barriers each in
// every bisection round (some 90 barriers a row), 29 barriers and a second
// read of the samples in select_rounds.  A warp a row has no barrier: the
// loads of one warp overlap the rounds of the others, and the schedulers'
// instruction rate sets the time.

#include "halfspace_warp.cuh"

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

// The block path's 3-ary bisection on the keys of xs; returns lo (the
// TPU's `_select_r3` / `_select_fixed` loop, one row).
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

// N > 1024 (and `minimal_planes` at any N): one 256-thread block a row.
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

// N > 1024: the pre-select stage with every operation rounded on its
// own, in the fixed order of block_reduce (see the file note), then the
// block path's select with its per-pass counts.
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

// The warp path's 3-ary bisection on a row's keys in registers; returns
// lo.  A slot past n holds the key of -inf, below every pivot, and stays
// out of the minimum.
template <int kVpl, bool kEarlyExit>
__device__ __forceinline__ unsigned warp_bisect3(const unsigned (&key)[kVpl],
                                                 int n, int k, int rounds,
                                                 int lane) {
  unsigned kmin = 0xffffffffu;
  unsigned kmax = 0u;
#pragma unroll
  for (int r = 0; r < kVpl; ++r) {
    if (warp_slot(r, lane) < n) kmin = min(kmin, key[r]);
    kmax = max(kmax, key[r]);
  }
  unsigned lo = __reduce_min_sync(kFull, kmin);
  unsigned hi = __reduce_max_sync(kFull, kmax);
  int c_lo = n;
#pragma unroll 1
  for (int t = 0; t < rounds; ++t) {
    const bool frozen = (c_lo == k) || (lo >= hi);   // the same in all lanes
    if (kEarlyExit && frozen) break;
    const unsigned third = (hi - lo) / 3u;
    const unsigned m1 = lo + third + 1u;
    const unsigned m2 = lo + third * 2u + 1u;
    unsigned packed = 0u;   // count(key >= m1) | count(key >= m2) << 16
#pragma unroll
    for (int r = 0; r < kVpl; ++r) {
      packed += (key[r] >= m1 ? 1u : 0u) + (key[r] >= m2 ? 0x10000u : 0u);
    }
    packed = __reduce_add_sync(kFull, packed);
    const int c1 = static_cast<int>(packed & 0xffffu);
    const int c2 = static_cast<int>(packed >> 16);
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

// N <= 32 * kVpl <= 1024: the production warp kernel with its select (and
// for `minimal` everything but the load) swapped out.
template <int kVpl, int kVariant>
__global__ void __launch_bounds__(32 * kWarpMaxRows, 2)
variant_warp_kernel(const float2* __restrict__ samples,
                    const float2* __restrict__ ego, float2* __restrict__ h_out,
                    float* __restrict__ g_out, int rows, bool wide_loads,
                    int n, int k, int rounds, float inv_n, float an,
                    float delta, float eps_over_alpha) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp; no barrier follows

  float2 p[kVpl];
  warp_load_row<kVpl>(samples + static_cast<size_t>(row) * n, n, wide_loads,
                      lane, p);
  if constexpr (kVariant == kMinimal) {
    float sx = 0.f;
    float sy = 0.f;
#pragma unroll
    for (int r = 0; r < kVpl; ++r) {   // a slot past n holds (0, 0)
      sx += p[r].x;
      sy += p[r].y;
    }
    const float gx = warp_sum(sx) * inv_n;
    const float gy = warp_sum(sy) * inv_n;
    if (lane == 0) {
      h_out[row] = make_float2(gx, gy);
      g_out[row] = gx + gy;
    }
  } else {
    const RowStats st = warp_row_stats<kVpl, false>(p, ego[row], n, inv_n,
                                                    lane);
    unsigned key[kVpl];
    warp_row_keys<kVpl, false>(p, st, n, lane, key);
    float cvar;
    if constexpr (kVariant == kNoSel || kVariant == kProdNoSel) {
      float sum = 0.f;
      float sum2 = 0.f;
#pragma unroll
      for (int r = 0; r < kVpl; ++r) {
        const float x = key_float(key[r]);
        if (x > __uint_as_float(kNegInfBits)) {
          sum += x;
          sum2 += x * x;
        }
      }
      cvar = warp_sum(sum) / static_cast<float>(n);
      if constexpr (kVariant == kProdNoSel) {
        cvar += sqrtf(warp_sum(sum2) * inv_n);
      }
    } else {
      const unsigned lo =
          warp_bisect3<kVpl, kVariant == kR3>(key, n, k, rounds, lane);
      unsigned kv = 0xffffffffu;
#pragma unroll
      for (int r = 0; r < kVpl; ++r) {
        if (key[r] >= lo) kv = min(kv, key[r]);
      }
      const float v = key_float(__reduce_min_sync(kFull, kv));
      float sum_gt;
      int size_gt;
      warp_tail<kVpl, true>(key, v, sum_gt, size_gt);
      cvar = (sum_gt + (an - static_cast<float>(size_gt)) * v) / an;
    }
    if (lane == 0) {
      const float shift = st.hx * st.mx + st.hy * st.my;
      h_out[row] = make_float2(st.hx, st.hy);
      g_out[row] = cvar - shift - delta + eps_over_alpha;
    }
  }
}

// N <= 32 * kVpl <= 1024: the production kernel's stages up to the select
// with every operation rounded on its own, then the production select
// itself, which hands back the passes it ran.
template <int kVpl>
__global__ void __launch_bounds__(32 * kWarpMaxRows, 2)
select_rounds_warp_kernel(const float2* __restrict__ samples,
                          const float2* __restrict__ ego,
                          int* __restrict__ out, int rows, bool wide_loads,
                          int n, int k, float inv_n) {
  extern __shared__ int4 hists[];   // 256 counters a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  int* hist = reinterpret_cast<int*>(hists) + warp * kBins;

  float2 p[kVpl];
  warp_load_row<kVpl>(samples + static_cast<size_t>(row) * n, n, wide_loads,
                      lane, p);
  const float2 e = ego[row];
  warp_clear_hist(hist);
  const RowStats st = warp_row_stats<kVpl, true>(p, e, n, inv_n, lane);
  unsigned key[kVpl];
  warp_row_keys<kVpl, true>(p, st, n, lane, key);
  int passes = 0;
  warp_kth_largest_key<kVpl, true>(key, k, hist, &passes);
  if (lane == 0) out[row] = passes;
}

// What a variant's launch needs besides the tensors (host side only: the
// kernels take the scalars one by one).
struct VariantArgs {
  int rows, n, k, rounds;
  float inv_n, an, delta, eps_over_alpha;
};

template <int kVariant>
int launch_variant_block(const float2* samples, const float2* ego, float2* h,
                         float* g, const VariantArgs& a, cudaStream_t stream) {
  const bool minimal = kVariant == kMinimal || kVariant == kMinimalPlanes;
  const size_t smem = minimal ? 0 : static_cast<size_t>(a.n) * sizeof(float);
  const cudaError_t err = reserve_smem(variant_kernel<kVariant>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  variant_kernel<kVariant><<<a.rows, kThreads, smem, stream>>>(
      samples, ego, h, g, a.n, a.k, a.rounds, a.inv_n, a.an, a.delta,
      a.eps_over_alpha);
  return static_cast<int>(cudaGetLastError());
}

template <int kVpl, int kVariant>
int launch_variant_warp(const float2* samples, const float2* ego, float2* h,
                        float* g, const Plan& plan, const VariantArgs& a,
                        cudaStream_t stream) {
  const int rpb = plan.rows_per_block;
  variant_warp_kernel<kVpl, kVariant>
      <<<(a.rows + rpb - 1) / rpb, 32 * rpb, 0, stream>>>(
          samples, ego, h, g, a.rows, plan.load_bytes == 16, a.n, a.k,
          a.rounds, a.inv_n, a.an, a.delta, a.eps_over_alpha);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(std::integral_constant<int, V>()) for variant code V; the warp
// path has no `minimal_planes` (it stays a block a row at any N).
template <bool kWarpPath, typename F>
int with_variant(int variant, F&& f) {
  switch (variant) {
    case kNoSel:
      return f(std::integral_constant<int, kNoSel>());
    case kProdNoSel:
      return f(std::integral_constant<int, kProdNoSel>());
    case kR3:
      return f(std::integral_constant<int, kR3>());
    case kFixed:
      return f(std::integral_constant<int, kFixed>());
    case kMinimal:
      return f(std::integral_constant<int, kMinimal>());
    case kMinimalPlanes:
      if constexpr (!kWarpPath)
        return f(std::integral_constant<int, kMinimalPlanes>());
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// variant: 0 nosel, 1 prod_nosel, 2 r3 (early exit, at most `rounds`),
// 3 fixed (exactly `rounds`), 4 minimal, 5 minimal_planes (block path
// only).  values_per_lane 0: a block a row; else a warp a row.
extern "C" int drcvar_variant(const void* samples_, const void* ego_,
                              void* h_, void* g_, int rows, int n, int k,
                              int variant, int rounds, int values_per_lane,
                              int rows_per_block, int load_bytes, float inv_n,
                              float an, float delta, float eps_over_alpha,
                              void* stream_) {
  const float2* samples = static_cast<const float2*>(samples_);
  const float2* ego = static_cast<const float2*>(ego_);
  float2* h = static_cast<float2*>(h_);
  float* g = static_cast<float*>(g_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const VariantArgs a = {rows, n, k, rounds, inv_n, an, delta, eps_over_alpha};
  if (values_per_lane == 0) {   // the block path
    return with_variant<false>(variant, [&](auto code) {
      return launch_variant_block<decltype(code)::value>(samples, ego, h, g,
                                                         a, stream);
    });
  }
  const Plan plan = {values_per_lane, rows_per_block, load_bytes};
  const cudaError_t err = check_warp_plan(plan, n, samples);
  if (err != cudaSuccess) return static_cast<int>(err);
  return with_values_per_lane(values_per_lane, [&](auto values) {
    return with_variant<true>(variant, [&](auto code) {
      return launch_variant_warp<decltype(values)::value,
                                 decltype(code)::value>(samples, ego, h, g,
                                                        plan, a, stream);
    });
  });
}

extern "C" int drcvar_select_rounds(const void* samples_, const void* ego_,
                                    void* out_, int rows, int n, int k,
                                    int values_per_lane, int rows_per_block,
                                    int load_bytes, float inv_n,
                                    void* stream_) {
  const float2* samples = static_cast<const float2*>(samples_);
  const float2* ego = static_cast<const float2*>(ego_);
  int* out = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (values_per_lane == 0) {   // the block path
    const size_t smem = static_cast<size_t>(n) * sizeof(float);
    const cudaError_t err = reserve_smem(select_rounds_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    select_rounds_kernel<<<rows, kThreads, smem, stream>>>(samples, ego, out,
                                                           n, k, inv_n);
    return static_cast<int>(cudaGetLastError());
  }
  const Plan plan = {values_per_lane, rows_per_block, load_bytes};
  const cudaError_t err = check_warp_plan(plan, n, samples);
  if (err != cudaSuccess) return static_cast<int>(err);
  return with_values_per_lane(values_per_lane, [&](auto values) {
    select_rounds_warp_kernel<decltype(values)::value>
        <<<(rows + rows_per_block - 1) / rows_per_block, 32 * rows_per_block,
           rows_per_block * kBins * sizeof(int), stream>>>(
            samples, ego, out, rows, load_bytes == 16, n, k, inv_n);
    return static_cast<int>(cudaGetLastError());
  });
}
