// Device code shared by the halfspace kernels (halfspace_kernels.cu) and
// their attribution variants (halfspace_variants.cu): the monotone float
// -> uint32 key map and, for one thread block per row of N samples, the
// block-wide reductions and the 4-pass 8-bit radix select.  The block
// path of the halfspace kernels (rows of 1025 ... 49152 samples) and
// every variant run these; rows that fit a warp run the warp-level
// select of halfspace_warp.cuh instead.  The cluster path (rows of
// 49153 ... 393216 samples) runs the same stages on a slice of the row a
// block, with the row's sums and the select's histograms added over a
// thread-block cluster through distributed shared memory (ClusterHists,
// cluster_sum).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace drcvar {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // also the number of histogram bins
constexpr int kWarps = kThreads / 32;
// The block path holds a row's projections in one block's shared memory,
// the cluster path a slice of at most as many in each of at most 8 blocks
// (the portable cluster size): ops/cuda_kernels.py's BLOCK_MAX_N and
// MAX_CLUSTER_BLOCKS.
constexpr int kBlockMaxN = 49152;
constexpr int kMaxClusterBlocks = 8;
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

// Exact k-th largest of xs[0, n) in shared memory: the 4-pass 8-bit
// radix select on the monotone keys from the top digit down, each pass
// counting the digit of the keys that match the digits chosen so far.
// `hists` says where pass p's 256 counters live and how thread t reads
// the count of bin 255 - t once every thread has counted: the block's own
// counters (BlockHists) or the sum of every block's in a cluster
// (ClusterHists), so that 1 <= k <= the row's length.  Every thread
// receives the value.  With `pass_counts` (4 ints in shared memory), pass
// p (0-based) stores how many keys share the k-th key's top 8(p+1) bits.
template <typename Hists>
__device__ inline float radix_select(const float* xs, int n, int k,
                                     const Hists& hists, int* warp_tot,
                                     int* sel, int* pass_counts) {
  unsigned prefix = 0u;
  unsigned mask = 0u;
  int krem = k;  // rank of the target among the keys matching `prefix`
  for (int shift = 24, pass = 0; shift >= 0; shift -= 8, ++pass) {
    int* hist = hists.of_pass(pass);
    hist[threadIdx.x] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned key = float_key(xs[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1);
    }
    // Thread t holds bin 255 - t, so the scan runs from the largest keys
    // down; exactly one thread's bin holds the krem-th largest.
    const int c = hists.count(pass, kThreads - 1 - threadIdx.x);
    const int incl = block_inclusive_scan(c, warp_tot);
    const int excl = incl - c;
    if (excl < krem && krem <= incl) {
      sel[0] = kThreads - 1 - threadIdx.x;
      sel[1] = krem - excl;
      if (pass_counts != nullptr) pass_counts[pass] = c;
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(sel[0]) << shift;
    mask |= 0xffu << shift;
    krem = sel[1];
  }
  return key_float(prefix);
}

// One block's counters, reused by every pass.
struct BlockHists {
  int* hist;  // kThreads counters
  __device__ int* of_pass(int) const { return hist; }
  __device__ int count(int, int bin) const {
    __syncthreads();
    return hist[bin];
  }
};

// Exact k-th largest of xs[0, n) in shared memory, 1 <= k <= n, by one
// block (see radix_select).
__device__ inline float block_kth_largest(const float* xs, int n, int k,
                                          int* hist, int* warp_tot,
                                          int* sel,
                                          int* pass_counts = nullptr) {
  return radix_select(xs, n, k, BlockHists{hist}, warp_tot, sel,
                      pass_counts);
}

// A cluster's counters: each block counts its own slice of the row into
// its own counters, and every block adds all blocks' counts of a bin in
// rank order (integers: the same in every block), so every block picks
// the same bin.  Passes alternate between two sets of counters: a block
// clears pass p + 2's set only after pass p + 1's cluster barrier, which
// no block reaches before it has read pass p's counts of every block.
struct ClusterHists {
  int* hist;  // 2 * kThreads counters
  __device__ int* of_pass(int pass) const {
    return hist + (pass & 1) * kThreads;
  }
  __device__ int count(int pass, int bin) const {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    int c = 0;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      c += cluster.map_shared_rank(of_pass(pass), r)[bin];
    return c;
  }
};

__device__ __forceinline__ float2 plus(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float plus(float a, float b) { return a + b; }
__device__ __forceinline__ int plus(int a, int b) { return a + b; }

// The sum over a cluster's blocks of the value at `slot` in each block's
// shared memory, which thread 0 of each block wrote before the call:
// after a cluster barrier every thread adds the blocks' values in rank
// order, so every block gets the same bits.  A slot is written once a
// launch, so no block can overwrite one that another still reads.
template <typename T>
__device__ T cluster_sum(T* slot) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  T total = *cluster.map_shared_rank(slot, 0u);
  for (unsigned r = 1; r < cluster.num_blocks(); ++r)
    total = plus(total, *cluster.map_shared_rank(slot, r));
  return total;
}

// The block path's row total of the block's sums: the sums themselves.
struct BlockRowTotal {
  __device__ float2 operator()(float2 sums) const { return sums; }
};

// The cluster path's: every block's sums added over the cluster.
struct ClusterRowTotal {
  float2* slot;  // this block's, in shared memory
  __device__ float2 operator()(float2 sums) const {
    if (threadIdx.x == 0) *slot = sums;
    return cluster_sum(slot);
  }
};

// The row statistics before the select.
struct RowStats {
  float hx, hy;  // unit normal ego -> mean ([1, 0] below kEps)
  float mx, my;  // sample mean, as ego + mean(samples - ego)
};

// Pre-select stages of the all-metrics kernel: ego-centred sums (centre
// before summing: near closest approach mean - ego is O(1e-3) while
// positions are O(10)), the unit normal, and the doubly-centred negated
// projections x_i = -(h . (xi_i - mean)) written to xs in shared memory.
// s[0, n) is the block's samples: the whole row on the block path, the
// block's slice on the cluster path, where `row_total` adds the blocks'
// sums (inv_n is one over the whole row's length either way).
template <typename RowTotal = BlockRowTotal>
__device__ inline RowStats row_projections(const float2* __restrict__ s,
                                           float2 e, int n, float inv_n,
                                           float* xs, float* red_f,
                                           RowTotal row_total = {}) {
  float sx = 0.f;
  float sy = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = s[i];
    sx += p.x - e.x;
    sy += p.y - e.y;
  }
  const float sum_x = block_sum(sx, red_f);
  const float2 sums = row_total(make_float2(sum_x, block_sum(sy, red_f)));
  const float dx = sums.x * inv_n;
  const float dy = sums.y * inv_n;

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
