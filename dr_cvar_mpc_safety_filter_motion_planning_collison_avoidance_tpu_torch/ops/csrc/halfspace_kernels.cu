// Safe-halfspace kernels for Hopper (sm_90a): all three metrics, and
// the DR-CVaR halfspace alone.
//
// `drcvar_all_metrics_halfspaces` replaces the Pallas TPU kernel
// `_all_metrics_kernel` of the JAX package (ops/pallas_kernels.py,
// entered through `fused_metric_halfspaces_planes`);
// `drcvar_fused_halfspace` replaces `_drcvar_kernel` (entered through
// `fused_drcvar_halfspace_planes`, the public `fused_drcvar_halfspace`).
// A row is one (scenario, timestep, obstacle) instance with N obstacle
// samples.  From ONE row of samples the kernels compute:
//
//   * ego-centred sample mean (centre before summing: near closest
//     approach mean - ego is O(1e-3) while positions are O(10));
//   * unit normal h = (mean - ego)/|mean - ego|, [1, 0] below 1e-10;
//   * the doubly-centred negated projections x_i = -(h . (xi_i - mean));
//   * the EXACT k-th largest x (k = clamp(ceil(alpha N), 1, N));
//   * the tie-safe CVaR tail CVaR = (sum_G + (alpha N - |G|) v)/(alpha N)
//     with v the k-th largest and G = {x >= v};
//   * outputs h, g_drcvar = CVaR - delta + epsilon/alpha and, in the
//     all-metrics instantiation only, g_cvar = CVaR + r~ - delta and the
//     mean metric's h_mean, g_mean (its normal taken from the ORIGIN, a
//     reference quirk).
//
// Each body is one template on the output set, instantiated twice: the
// DR-CVaR-only kernel is the all-metrics kernel with the mean metric's
// work compiled out, so the two give bit-equal (h, g_drcvar) on the
// same rows, on either path.
//
// What bounds them on this card: bytes.  A row of N = 1000 is 8 KB of
// samples and some 20 bytes of results, and the arithmetic (16 float
// operations a sample, three or so passes of an 8-bit radix select) is
// 5-10 times below the float32 rate.  What kept a block-a-row design at
// a quarter of that bound was not arithmetic either but latency: some 29
// block-wide barriers a row with 4 samples a thread between them, a
// second read of the samples, and blocks that load for a short part of
// their life.
//
// What the design does about it, for N <= 1024 (the warp path):
//
//   * One warp owns a row and a block is a few independent warps: there
//     is no __syncthreads() anywhere, only __syncwarp() around the
//     warp's own 256 histogram counters in shared memory.
//   * A lane holds up to 32 samples in registers (the number is a
//     template parameter: 2, 4, 8, 16 or 32 values a lane for N <= 64
//     ... 1024; slots past N are masked out of the sums and become -inf,
//     the smallest key, for the select).  The samples are read from
//     device memory ONCE, as 16-byte loads of two samples (8-byte loads
//     when a row's base is not 16-byte aligned: odd N or an offset view;
//     the caller says which, the entry point checks it), all issued
//     before the first use.  Both widths give a lane the same samples,
//     so their results are bit-equal.
//   * Sums are a lane's own registers in order, then a xor butterfly of
//     shuffles: a fixed order.
//   * The select (halfspace_warp.cuh) is the exact 8-bit radix select on
//     the monotone float -> uint32 keys, per warp: shared-memory atomics
//     into the warp's own counters, a scan of 8 bins a lane and five
//     shuffles, and it leaves as soon as the chosen bin holds one key.
//   * The tail and the outputs come from the registers that hold the
//     keys; lane 0 writes.
//   * The loads of one warp overlap the select of the others: at 96
//     registers a thread 20 rows are in flight an SM, and the schedulers'
//     instruction rate, not the loads, sets the kernel's time (a variant
//     that prefetched a warp's next row into shared memory while it
//     selected was slower on an H100).
//   * The row body is the stages of halfspace_warp.cuh (load, centred
//     statistics, keys, select, tail).  The kernel benchmark's variants
//     (halfspace_variants.cu) instantiate the same stages with one of
//     them swapped, so their times say where this kernel's time goes.
//
// Three paths, by the row's length N (ops/cuda_kernels.py
// `halfspace_plan`):
//
//   * N <= 1024, the warp path above.
//   * 1024 < N <= 49152, the block path: one 256-thread block a row with
//     the projections in shared memory and the block-wide 4-pass select
//     of halfspace_common.cuh; there the block's fixed cost is spread
//     over 4 or more times the samples.
//   * 49152 < N <= 393216, the cluster path: one thread-block cluster of
//     c = ceil(N / 49152) such blocks a row (2 ... 8, the portable
//     cluster size), block r holding the projections of the row's r-th
//     slice of ceil(N / c) samples in its own shared memory (one block's
//     227 KB holds some 58,000 floats, and a row may be longer).  The
//     stages are the block path's on the slice; the row's sums (the
//     centred mean, the tail's sum and count) are each block's reduced in
//     a fixed order and then added over the cluster in rank order through
//     distributed shared memory, and each select pass adds the c blocks'
//     histograms the same way, so every block holds the same bits and
//     picks the same bin.  Block rank 0 writes the outputs.  Like the
//     block path a block reads its slice twice (the sums, then the
//     projections), the second time mostly from L2.  A launch is refused
//     where no such cluster fits on the card (cudaOccupancyMaxActiveClusters
//     is 0), before the first launch at each cluster size and shared
//     memory.
//
// Offsets into the samples are 64-bit: rows x N x 2 floats passes 2^31
// at the cluster path's sizes.
//
// Samples are read as [B, N, 2] float2 directly: the TPU's SoA planes
// and its 128-lane / row-tile padding are layout, not contract.

#include "halfspace_warp.cuh"

namespace {

using namespace drcvar;

// What a row's results need besides the samples.
struct RowArgs {
  int n, k;
  float inv_n, an, r_combined, delta, eps_over_alpha;
};

struct RowOutputs {
  float2* h_mean;
  float* g_mean;
  float2* h_ego;
  float* g_cvar;
  float* g_drcvar;
};

// One thread writes a row's outputs from its statistics.  The kernels
// take the output pointers one by one, each __restrict__, so that the
// compiler may read the samples through the read-only path.
template <bool kAllMetrics>
__device__ __forceinline__ void write_row(
    float2* __restrict__ h_mean, float* __restrict__ g_mean,
    float2* __restrict__ h_ego, float* __restrict__ g_cvar,
    float* __restrict__ g_drcvar, int row, float an, float r_combined,
    float delta, float eps_over_alpha, float hx, float hy, float mx, float my,
    float sum_g, int size_g, float v) {
  const float shift = hx * mx + hy * my;
  const float cvar =
      (sum_g + (an - static_cast<float>(size_g)) * v) / an - shift;
  h_ego[row] = make_float2(hx, hy);
  g_drcvar[row] = cvar - delta + eps_over_alpha;
  if constexpr (kAllMetrics) {
    g_cvar[row] = cvar + r_combined - delta;
    const float norm_m = sqrtf(mx * mx + my * my);
    const bool degen_m = norm_m < kEps;
    const float hmx = degen_m ? 1.f : mx / norm_m;
    const float hmy = degen_m ? 0.f : my / norm_m;
    h_mean[row] = make_float2(hmx, hmy);
    g_mean[row] = -(hmx * mx + hmy * my - r_combined);
  }
}

// The warp path: N <= 32 * kVpl <= 1024, one warp a row, the stages of
// halfspace_warp.cuh at their production values.  Register r of lane l
// holds sample 64 (r / 2) + 2 l + (r % 2): the two samples of the lane's
// 16-byte load j = r / 2.
template <int kVpl, bool kAllMetrics>
__global__ void __launch_bounds__(32 * kWarpMaxRows, 2)
halfspace_warp_kernel(const float2* __restrict__ samples,
                      const float2* __restrict__ ego,
                      float2* __restrict__ h_mean, float* __restrict__ g_mean,
                      float2* __restrict__ h_ego, float* __restrict__ g_cvar,
                      float* __restrict__ g_drcvar, int rows, bool wide_loads,
                      RowArgs a) {
  extern __shared__ int4 hists[];   // 256 counters a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;   // the whole warp; no barrier follows
  int* hist = reinterpret_cast<int*>(hists) + warp * kBins;

  float2 p[kVpl];
  warp_load_row<kVpl>(samples + static_cast<size_t>(row) * a.n, a.n,
                      wide_loads, lane, p);
  const float2 e = ego[row];
  warp_clear_hist(hist);

  const RowStats st = warp_row_stats<kVpl, false>(p, e, a.n, a.inv_n, lane);
  unsigned key[kVpl];
  warp_row_keys<kVpl, false>(p, st, a.n, lane, key);

  const float v = key_float(warp_kth_largest_key<kVpl>(key, a.k, hist));

  // Tie-safe tail over G = {x >= v}: the tie count cancels.
  float sum_g;
  int size_g;
  warp_tail<kVpl, false>(key, v, sum_g, size_g);
  if (lane == 0)
    write_row<kAllMetrics>(h_mean, g_mean, h_ego, g_cvar, g_drcvar, row, a.an,
                           a.r_combined, a.delta, a.eps_over_alpha, st.hx,
                           st.hy, st.mx, st.my, sum_g, size_g, v);
}

// The block path: N > 1024, one 256-thread block a row, the projections
// in shared memory, the block-wide select.
template <bool kAllMetrics>
__global__ void __launch_bounds__(kThreads)
halfspace_block_kernel(const float2* __restrict__ samples,
                       const float2* __restrict__ ego,
                       float2* __restrict__ h_mean, float* __restrict__ g_mean,
                       float2* __restrict__ h_ego, float* __restrict__ g_cvar,
                       float* __restrict__ g_drcvar, int n, int k, float inv_n,
                       float an, float r_combined, float delta,
                       float eps_over_alpha) {
  extern __shared__ float xs[];
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int hist[kThreads];
  __shared__ int sel[2];

  const int row = blockIdx.x;
  const RowStats r = row_projections(
      samples + static_cast<size_t>(row) * n, ego[row], n, inv_n, xs, red_f);

  const float v = block_kth_largest(xs, n, k, hist, red_i, sel);

  float tail = 0.f;
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float x = xs[i];
    if (x >= v) {
      tail += x;
      ++cnt;
    }
  }
  const float sum_g = block_sum(tail, red_f);
  const int size_g = block_sum(cnt, red_i);

  if (threadIdx.x == 0)
    write_row<kAllMetrics>(h_mean, g_mean, h_ego, g_cvar, g_drcvar, row, an,
                           r_combined, delta, eps_over_alpha, r.hx, r.hy,
                           r.mx, r.my, sum_g, size_g, v);
}

// The cluster path: 49152 < N, one cluster of c 256-thread blocks a row
// (blockIdx.x / c), block rank r the samples [r slice, min((r + 1) slice,
// N)) with their projections in its shared memory; the block path's
// stages on the slice, the sums and histograms added over the cluster.
template <bool kAllMetrics>
__global__ void __launch_bounds__(kThreads)
halfspace_cluster_kernel(const float2* __restrict__ samples,
                         const float2* __restrict__ ego,
                         float2* __restrict__ h_mean,
                         float* __restrict__ g_mean,
                         float2* __restrict__ h_ego,
                         float* __restrict__ g_cvar,
                         float* __restrict__ g_drcvar, int n, int slice,
                         int k, float inv_n, float an, float r_combined,
                         float delta, float eps_over_alpha) {
  extern __shared__ float xs[];
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int hist[2 * kThreads];
  __shared__ int sel[2];
  __shared__ float2 mean_slot;
  __shared__ float tail_slot;
  __shared__ int size_slot;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int row = blockIdx.x / cluster.num_blocks();
  const int lo = static_cast<int>(rank) * slice;
  const int m = min(slice, n - lo);
  const RowStats r = row_projections(
      samples + static_cast<size_t>(row) * n + lo, ego[row], m, inv_n, xs,
      red_f, ClusterRowTotal{&mean_slot});

  const float v =
      radix_select(xs, m, k, ClusterHists{hist}, red_i, sel, nullptr);

  float tail = 0.f;
  int cnt = 0;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const float x = xs[i];
    if (x >= v) {
      tail += x;
      ++cnt;
    }
  }
  const float block_tail = block_sum(tail, red_f);
  const int block_size = block_sum(cnt, red_i);
  if (threadIdx.x == 0) {
    tail_slot = block_tail;
    size_slot = block_size;
  }
  const float sum_g = cluster_sum(&tail_slot);
  const int size_g = cluster_sum(&size_slot);

  if (rank == 0 && threadIdx.x == 0)
    write_row<kAllMetrics>(h_mean, g_mean, h_ego, g_cvar, g_drcvar, row, an,
                           r_combined, delta, eps_over_alpha, r.hx, r.hy,
                           r.mx, r.my, sum_g, size_g, v);
  cluster.sync();  // no block leaves while another reads its slots
}

// The select alone on given rows [B, N] of floats: checks the select bit
// for bit against a sort-based k-th value on identical inputs.
template <int kVpl>
__global__ void __launch_bounds__(32 * kWarpMaxRows, 2)
kth_largest_warp_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int rows, int n, int k) {
  extern __shared__ int4 hists[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  int* hist = reinterpret_cast<int*>(hists) + warp * kBins;
  const float* r = x + static_cast<size_t>(row) * n;
  unsigned key[kVpl];
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const int i = 32 * j + lane;
    key[j] = float_key(i < n ? __ldg(r + i) : __int_as_float(0xff800000));
  }
  warp_clear_hist(hist);
  const unsigned v = warp_kth_largest_key<kVpl>(key, k, hist);
  if (lane == 0) out[row] = key_float(v);
}

__global__ void __launch_bounds__(kThreads)
kth_largest_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int n, int k) {
  extern __shared__ float xs[];
  __shared__ int red_i[kWarps];
  __shared__ int hist[kThreads];
  __shared__ int sel[2];
  const float* r = x + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = r[i];
  __syncthreads();
  const float v = block_kth_largest(xs, n, k, hist, red_i, sel);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

__global__ void __launch_bounds__(kThreads)
kth_largest_cluster_kernel(const float* __restrict__ x,
                           float* __restrict__ out, int n, int slice,
                           int k) {
  extern __shared__ float xs[];
  __shared__ int red_i[kWarps];
  __shared__ int hist[2 * kThreads];
  __shared__ int sel[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int row = blockIdx.x / cluster.num_blocks();
  const int lo = static_cast<int>(rank) * slice;
  const int m = min(slice, n - lo);
  const float* r = x + static_cast<size_t>(row) * n + lo;
  for (int i = threadIdx.x; i < m; i += kThreads) xs[i] = r[i];
  __syncthreads();
  const float v =
      radix_select(xs, m, k, ClusterHists{hist}, red_i, sel, nullptr);
  if (rank == 0 && threadIdx.x == 0) out[row] = v;
  cluster.sync();  // no block leaves while another reads its counters
}

// The samples a block of a c-block cluster holds of a row of n.
inline int cluster_slice(int n, int c) { return (n + c - 1) / c; }

// Whether the plan's blocks a row fit rows of n samples: 1 on the warp
// and block paths, ceil(n / kBlockMaxN) (2 ... 8) on the cluster path.
inline bool cluster_plan_fits(int values_per_lane, int cluster, int n) {
  if (values_per_lane != 0) return cluster == 1;
  return cluster == (n + kBlockMaxN - 1) / kBlockMaxN &&
         cluster <= kMaxClusterBlocks;
}

// Launches `kernel` as `rows` clusters of c kThreads-thread blocks with
// `smem` bytes of dynamic shared memory each.  `checked` (one entry a
// cluster size, kept by the caller for its kernel) records the largest
// shared memory at which a cluster was found to fit; a launch above it
// asks cudaOccupancyMaxActiveClusters first and is refused where no
// cluster fits.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), size_t* checked,
                            int rows, int c, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(c);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows) * c);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  if (smem > checked[c]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[c] = smem;
  }
  err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kVpl, bool kAllMetrics>
int launch_warp(const float2* samples, const float2* ego,
                const RowOutputs& out, int rows, const Plan& plan,
                const RowArgs& a, cudaStream_t stream) {
  const cudaError_t err = check_warp_plan(plan, a.n, samples);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rpb = plan.rows_per_block;
  halfspace_warp_kernel<kVpl, kAllMetrics>
      <<<(rows + rpb - 1) / rpb, 32 * rpb, rpb * kBins * sizeof(int),
         stream>>>(samples, ego, out.h_mean, out.g_mean, out.h_ego,
                   out.g_cvar, out.g_drcvar, rows, plan.load_bytes == 16, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAllMetrics>
int launch_halfspace(const void* samples_, const void* ego_,
                     const RowOutputs& out, int rows, const Plan& plan,
                     int cluster, const RowArgs& a, void* stream_) {
  const float2* samples = static_cast<const float2*>(samples_);
  const float2* ego = static_cast<const float2*>(ego_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!cluster_plan_fits(plan.values_per_lane, cluster, a.n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 1) {   // the cluster path
    const int slice = cluster_slice(a.n, cluster);
    static size_t checked[kMaxClusterBlocks + 1] = {};
    return static_cast<int>(launch_clusters(
        halfspace_cluster_kernel<kAllMetrics>, checked, rows, cluster,
        static_cast<size_t>(slice) * sizeof(float), stream, samples, ego,
        out.h_mean, out.g_mean, out.h_ego, out.g_cvar, out.g_drcvar, a.n,
        slice, a.k, a.inv_n, a.an, a.r_combined, a.delta,
        a.eps_over_alpha));
  }
  if (plan.values_per_lane == 0) {   // the block path
    const size_t smem = static_cast<size_t>(a.n) * sizeof(float);
    const cudaError_t err =
        reserve_smem(halfspace_block_kernel<kAllMetrics>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    halfspace_block_kernel<kAllMetrics><<<rows, kThreads, smem, stream>>>(
        samples, ego, out.h_mean, out.g_mean, out.h_ego, out.g_cvar,
        out.g_drcvar, a.n, a.k, a.inv_n, a.an, a.r_combined, a.delta,
        a.eps_over_alpha);
    return static_cast<int>(cudaGetLastError());
  }
  return with_values_per_lane(plan.values_per_lane, [&](auto values) {
    return launch_warp<decltype(values)::value, kAllMetrics>(
        samples, ego, out, rows, plan, a, stream);
  });
}

template <int kVpl>
int launch_kth_warp(const float* x, float* out, int rows, int n, int k,
                    const Plan& plan, cudaStream_t stream) {
  if (!warp_plan_fits(plan, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = plan.rows_per_block;
  kth_largest_warp_kernel<kVpl>
      <<<(rows + rpb - 1) / rpb, 32 * rpb, rpb * kBins * sizeof(int),
         stream>>>(x, out, rows, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int drcvar_all_metrics_halfspaces(
    const void* samples, const void* ego, void* h_mean, void* g_mean,
    void* h_ego, void* g_cvar, void* g_drcvar, int rows, int n, int k,
    int values_per_lane, int rows_per_block, int load_bytes, int cluster,
    float inv_n, float an, float r_combined, float delta,
    float eps_over_alpha, void* stream) {
  const RowOutputs out = {static_cast<float2*>(h_mean),
                          static_cast<float*>(g_mean),
                          static_cast<float2*>(h_ego),
                          static_cast<float*>(g_cvar),
                          static_cast<float*>(g_drcvar)};
  return launch_halfspace<true>(
      samples, ego, out, rows, {values_per_lane, rows_per_block, load_bytes},
      cluster,
      {n, k, inv_n, an, r_combined, delta, eps_over_alpha}, stream);
}

extern "C" int drcvar_fused_halfspace(const void* samples, const void* ego,
                                      void* h, void* g_tilde, int rows, int n,
                                      int k, int values_per_lane,
                                      int rows_per_block, int load_bytes,
                                      int cluster, float inv_n, float an,
                                      float delta, float eps_over_alpha,
                                      void* stream) {
  const RowOutputs out = {nullptr, nullptr, static_cast<float2*>(h), nullptr,
                          static_cast<float*>(g_tilde)};
  return launch_halfspace<false>(
      samples, ego, out, rows, {values_per_lane, rows_per_block, load_bytes},
      cluster,
      {n, k, inv_n, an, 0.f, delta, eps_over_alpha}, stream);
}

extern "C" int drcvar_kth_largest(const void* x_, void* out_, int rows, int n,
                                  int k, int values_per_lane,
                                  int rows_per_block, int cluster,
                                  void* stream_) {
  const float* x = static_cast<const float*>(x_);
  float* out = static_cast<float*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!cluster_plan_fits(values_per_lane, cluster, n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 1) {   // the cluster path
    const int slice = cluster_slice(n, cluster);
    static size_t checked[kMaxClusterBlocks + 1] = {};
    return static_cast<int>(launch_clusters(
        kth_largest_cluster_kernel, checked, rows, cluster,
        static_cast<size_t>(slice) * sizeof(float), stream, x, out, n, slice,
        k));
  }
  if (values_per_lane == 0) {   // the block path
    const size_t smem = static_cast<size_t>(n) * sizeof(float);
    const cudaError_t err = reserve_smem(kth_largest_block_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kth_largest_block_kernel<<<rows, kThreads, smem, stream>>>(x, out, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  const Plan plan = {values_per_lane, rows_per_block, 0};
  return with_values_per_lane(values_per_lane, [&](auto values) {
    return launch_kth_warp<decltype(values)::value>(x, out, rows, n, k, plan,
                                                    stream);
  });
}

extern "C" const char* drcvar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
