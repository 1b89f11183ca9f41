// All-metrics safe-halfspace kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_all_metrics_kernel` of the JAX
// package (ops/pallas_kernels.py, entered through
// `fused_metric_halfspaces_planes`).  One thread block per row; a row is
// one (scenario, timestep, obstacle) instance with N obstacle samples.
// From ONE row of samples it computes all three risk metrics'
// halfspaces:
//
//   * ego-centred sample mean (centre before summing: near closest
//     approach mean - ego is O(1e-3) while positions are O(10));
//   * unit normal h = (mean - ego)/|mean - ego|, [1, 0] below 1e-10;
//   * the mean metric's normal, taken from the ORIGIN (reference quirk);
//   * the doubly-centred negated projections x_i = -(h . (xi_i - mean));
//   * the EXACT k-th largest x (k = clamp(ceil(alpha N), 1, N));
//   * the tie-safe CVaR tail CVaR = (sum_G + (alpha N - |G|) v)/(alpha N)
//     with v the k-th largest and G = {x >= v};
//   * outputs h_mean, g_mean, h, g_cvar = CVaR + r~ - delta and
//     g_drcvar = CVaR - delta + epsilon/alpha.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // also the number of histogram bins
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-10f;
constexpr unsigned kFull = 0xffffffffu;

// Monotone map float32 -> uint32 (total order of non-NaN values).
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u ^ 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// Block-wide sum; every thread receives the total.  `red` holds kWarps
// values in shared memory.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T total = red[0];
  for (int w = 1; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Block-wide inclusive prefix sum over threadIdx.x.
__device__ int block_inclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_tot[w];
  __syncthreads();
  return v;
}

// Exact k-th largest of xs[0, n) in shared memory, 1 <= k <= n.
// Every thread receives the value.
__device__ float block_kth_largest(const float* xs, int n, int k, int* hist,
                                   int* warp_tot, int* sel) {
  unsigned prefix = 0u;
  unsigned mask = 0u;
  int krem = k;  // rank of the target among the keys matching `prefix`
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[threadIdx.x] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned key = float_key(xs[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1);
    }
    __syncthreads();
    // Thread t holds bin 255 - t, so the scan runs from the largest keys
    // down; exactly one thread's bin holds the krem-th largest.
    const int c = hist[kThreads - 1 - threadIdx.x];
    const int incl = block_inclusive_scan(c, warp_tot);
    const int excl = incl - c;
    if (excl < krem && krem <= incl) {
      sel[0] = kThreads - 1 - threadIdx.x;
      sel[1] = krem - excl;
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(sel[0]) << shift;
    mask |= 0xffu << shift;
    krem = sel[1];
  }
  return key_float(prefix);
}

__global__ void __launch_bounds__(kThreads)
all_metrics_kernel(const float2* __restrict__ samples,
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
  const float2* s = samples + static_cast<size_t>(row) * n;
  const float2 e = ego[row];

  // Pass 1: ego-centred sums.
  float sx = 0.f;
  float sy = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = s[i];
    sx += p.x - e.x;
    sy += p.y - e.y;
  }
  const float dx = block_sum(sx, red_f) * inv_n;
  const float dy = block_sum(sy, red_f) * inv_n;

  const float norm = sqrtf(dx * dx + dy * dy);
  const bool degen = norm < kEps;
  const float hx = degen ? 1.f : dx / norm;
  const float hy = degen ? 0.f : dy / norm;
  const float mx = e.x + dx;
  const float my = e.y + dy;

  // Pass 2: doubly-centred negated projections into shared memory.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = s[i];
    xs[i] = (mx - p.x) * hx + (my - p.y) * hy;
  }
  __syncthreads();

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
    const float shift = hx * mx + hy * my;
    const float cvar =
        (sum_g + (an - static_cast<float>(size_g)) * v) / an - shift;
    h_ego[row] = make_float2(hx, hy);
    g_cvar[row] = cvar + r_combined - delta;
    g_drcvar[row] = cvar - delta + eps_over_alpha;

    const float norm_m = sqrtf(mx * mx + my * my);
    const bool degen_m = norm_m < kEps;
    const float hmx = degen_m ? 1.f : mx / norm_m;
    const float hmy = degen_m ? 0.f : my / norm_m;
    h_mean[row] = make_float2(hmx, hmy);
    g_mean[row] = -(hmx * mx + hmy * my - r_combined);
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

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int drcvar_all_metrics_halfspaces(
    const void* samples, const void* ego, void* h_mean, void* g_mean,
    void* h_ego, void* g_cvar, void* g_drcvar, int rows, int n, int k,
    float inv_n, float an, float r_combined, float delta,
    float eps_over_alpha, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const cudaError_t err = reserve_smem(all_metrics_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  all_metrics_kernel<<<rows, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(samples), static_cast<const float2*>(ego),
      static_cast<float2*>(h_mean), static_cast<float*>(g_mean),
      static_cast<float2*>(h_ego), static_cast<float*>(g_cvar),
      static_cast<float*>(g_drcvar), n, k, inv_n, an, r_combined, delta,
      eps_over_alpha);
  return static_cast<int>(cudaGetLastError());
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
