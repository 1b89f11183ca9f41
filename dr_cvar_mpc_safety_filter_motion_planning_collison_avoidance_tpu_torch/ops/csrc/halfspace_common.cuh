// Device code shared by the halfspace kernels (halfspace_kernels.cu) and
// their attribution variants (halfspace_variants.cu): the monotone float
// -> uint32 key map and, for one thread block per row of N samples, the
// block-wide reductions and the 4-pass 8-bit radix select.  The block
// path of the halfspace kernels (rows of more than 1024 samples) and
// every variant run these; rows that fit a warp run the warp-level
// select of halfspace_warp.cuh instead.

#pragma once

#include <cuda_runtime.h>

namespace drcvar {

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

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  template <typename T>
  __device__ T operator()(T a, T b) const { return b < a ? b : a; }
};
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a < b ? b : a; }
};

// Block-wide reduction; every thread receives the result.  `red` holds
// kWarps values in shared memory.  The order is fixed: a xor butterfly
// in each warp, then warps 0..kWarps-1 in turn (the select_rounds plain
// version reproduces it for sums).
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T total = red[0];
  for (int w = 1; w < kWarps; ++w) total = op(total, red[w]);
  __syncthreads();
  return total;
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  return block_reduce(v, red, Add());
}

// Block-wide inclusive prefix sum over threadIdx.x.
__device__ inline int block_inclusive_scan(int v, int* warp_tot) {
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
// Every thread receives the value.  With `pass_counts` (4 ints in
// shared memory), pass p (0-based) stores how many keys share the
// k-th key's top 8(p+1) bits.
__device__ inline float block_kth_largest(const float* xs, int n, int k,
                                          int* hist, int* warp_tot,
                                          int* sel,
                                          int* pass_counts = nullptr) {
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
      if (pass_counts != nullptr) pass_counts[(24 - shift) / 8] = c;
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(sel[0]) << shift;
    mask |= 0xffu << shift;
    krem = sel[1];
  }
  return key_float(prefix);
}

// The row statistics before the select.
struct RowStats {
  float hx, hy;  // unit normal ego -> mean ([1, 0] below kEps)
  float mx, my;  // sample mean, as ego + mean(samples - ego)
};

// Pre-select stages of the all-metrics kernel: ego-centred sums (centre
// before summing: near closest approach mean - ego is O(1e-3) while
// positions are O(10)), the unit normal, and the doubly-centred negated
// projections x_i = -(h . (xi_i - mean)) written to xs in shared memory.
__device__ inline RowStats row_projections(const float2* __restrict__ s,
                                           float2 e, int n, float inv_n,
                                           float* xs, float* red_f) {
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
  RowStats r;
  r.hx = degen ? 1.f : dx / norm;
  r.hy = degen ? 0.f : dy / norm;
  r.mx = e.x + dx;
  r.my = e.y + dy;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = s[i];
    xs[i] = (r.mx - p.x) * r.hx + (r.my - p.y) * r.hy;
  }
  __syncthreads();
  return r;
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace drcvar
