// Safe-halfspace kernels for Hopper (sm_90a): all three metrics, and
// the DR-CVaR halfspace alone.
//
// `drcvar_all_metrics_halfspaces` replaces the Pallas TPU kernel
// `_all_metrics_kernel` of the JAX package (ops/pallas_kernels.py,
// entered through `fused_metric_halfspaces_planes`);
// `drcvar_fused_halfspace` replaces `_drcvar_kernel` (entered through
// `fused_drcvar_halfspace_planes`, the public `fused_drcvar_halfspace`).
// One thread block per row; a row is one (scenario, timestep, obstacle)
// instance with N obstacle samples.  From ONE row of samples the kernel
// computes:
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
// The body is one template on the output set, instantiated twice: the
// DR-CVaR-only kernel is the all-metrics kernel with the mean metric's
// work compiled out, so the two give bit-equal (h, g_drcvar) on the
// same rows.
//
// What bounds it on this card: the samples are read twice from device
// memory (8 bytes each; the second read of a row usually hits L2) and
// the select makes four passes over the row's projections in shared
// memory, 4 bytes each.  At N = 1000 a row is 8 KB of samples and 4 KB of
// shared memory, so the kernel is bound by the latency of its block-wide
// barriers and the histogram's shared-memory atomics, not by bandwidth.
//
// What the design does about it: the TPU kernel's packed-count
// bisection with moment-seeded pivots (tuned for the TPU's vector unit)
// is replaced by a bounded 4-pass radix select: each pass histograms
// the next 8 bits of the monotone float -> uint32 key of the rows still
// matching the prefix, in 256 int32 shared-memory counters, and one
// block-wide scan picks the bin holding the k-th largest.  Exactly four
// passes whatever the data (ties, constant rows, outliers), and no
// packed fields, so N is bounded only by shared memory (4 bytes a
// sample).  Samples are read as [B, N, 2] float2 directly: the TPU's SoA
// planes and its 128-lane / row-tile padding are layout, not contract.

#include "halfspace_common.cuh"

namespace {

using namespace drcvar;

template <bool kAllMetrics>
__global__ void __launch_bounds__(kThreads)
halfspace_kernel(const float2* __restrict__ samples,
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

  // Tie-safe tail over G = {x >= v}: the tie count cancels.
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

  if (threadIdx.x == 0) {
    const float shift = r.hx * r.mx + r.hy * r.my;
    const float cvar =
        (sum_g + (an - static_cast<float>(size_g)) * v) / an - shift;
    h_ego[row] = make_float2(r.hx, r.hy);
    g_drcvar[row] = cvar - delta + eps_over_alpha;
    if constexpr (kAllMetrics) {
      g_cvar[row] = cvar + r_combined - delta;
      const float norm_m = sqrtf(r.mx * r.mx + r.my * r.my);
      const bool degen_m = norm_m < kEps;
      const float hmx = degen_m ? 1.f : r.mx / norm_m;
      const float hmy = degen_m ? 0.f : r.my / norm_m;
      h_mean[row] = make_float2(hmx, hmy);
      g_mean[row] = -(hmx * r.mx + hmy * r.my - r_combined);
    }
  }
}

// The select alone on given rows: checks the select bit for bit against
// a sort-based k-th value on identical inputs.
__global__ void __launch_bounds__(kThreads)
kth_largest_kernel(const float* __restrict__ x, float* __restrict__ out,
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

template <bool kAllMetrics>
int launch_halfspace(const void* samples, const void* ego, void* h_mean,
                     void* g_mean, void* h_ego, void* g_cvar, void* g_drcvar,
                     int rows, int n, int k, float inv_n, float an,
                     float r_combined, float delta, float eps_over_alpha,
                     void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const cudaError_t err = reserve_smem(halfspace_kernel<kAllMetrics>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  halfspace_kernel<kAllMetrics><<<rows, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(samples), static_cast<const float2*>(ego),
      static_cast<float2*>(h_mean), static_cast<float*>(g_mean),
      static_cast<float2*>(h_ego), static_cast<float*>(g_cvar),
      static_cast<float*>(g_drcvar), n, k, inv_n, an, r_combined, delta,
      eps_over_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int drcvar_all_metrics_halfspaces(
    const void* samples, const void* ego, void* h_mean, void* g_mean,
    void* h_ego, void* g_cvar, void* g_drcvar, int rows, int n, int k,
    float inv_n, float an, float r_combined, float delta,
    float eps_over_alpha, void* stream) {
  return launch_halfspace<true>(samples, ego, h_mean, g_mean, h_ego, g_cvar,
                                g_drcvar, rows, n, k, inv_n, an, r_combined,
                                delta, eps_over_alpha, stream);
}

extern "C" int drcvar_fused_halfspace(const void* samples, const void* ego,
                                      void* h, void* g_tilde, int rows, int n,
                                      int k, float inv_n, float an,
                                      float delta, float eps_over_alpha,
                                      void* stream) {
  return launch_halfspace<false>(samples, ego, nullptr, nullptr, h, nullptr,
                                 g_tilde, rows, n, k, inv_n, an, 0.f, delta,
                                 eps_over_alpha, stream);
}

extern "C" int drcvar_kth_largest(const void* x, void* out, int rows, int n,
                                  int k, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const cudaError_t err = reserve_smem(kth_largest_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kth_largest_kernel<<<rows, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* drcvar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
