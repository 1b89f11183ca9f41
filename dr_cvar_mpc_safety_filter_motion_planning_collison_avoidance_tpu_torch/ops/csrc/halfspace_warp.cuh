// Warp-level device code of the halfspace kernels (halfspace_kernels.cu):
// one warp owns a row of at most 1024 values, every value in a register,
// and nothing in it waits for another warp.  The block-level helpers of
// halfspace_common.cuh serve the longer rows and the attribution variants.

#pragma once

#include "halfspace_common.cuh"

namespace drcvar {

constexpr int kBins = 256;            // one 8-bit digit of the key
constexpr int kWarpMaxRows = 8;       // warps (rows) a block, at most

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Zeroes the warp's 256 counters (8 a lane); every entry of the select
// expects them zero and leaves them zero.
__device__ __forceinline__ void warp_clear_hist(int* hist) {
  int4* mine = reinterpret_cast<int4*>(hist) + 2 * (threadIdx.x & 31);
  mine[0] = make_int4(0, 0, 0, 0);
  mine[1] = make_int4(0, 0, 0, 0);
  __syncwarp();
}

// Exact k-th largest of the 32 * kVpl keys a warp holds in registers
// (kVpl a lane, any assignment), 1 <= k <= 32 * kVpl; every lane receives
// it.  `hist` is the warp's own 256 counters of shared memory.
//
// An 8-bit radix select from the top digit down.  Each pass histograms
// the digit of the keys that still match the digits chosen so far, lane
// l sums the 8 bins 8 (31 - l) .. 8 (31 - l) + 7, a shuffle scan from the
// largest bins down finds the lane and then the bin that holds the k-th
// largest, and the keys outside that bin no longer match.  The select
// leaves as soon as the chosen bin holds a single key; keys tied with the
// k-th run all four passes, after which the chosen digits are the key.
template <int kVpl>
__device__ __forceinline__ unsigned warp_kth_largest_key(
    const unsigned (&key)[kVpl], int k, int* hist) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0u;    // the digits chosen so far
  unsigned mask = 0u;      // and the bits they cover
  int krem = k;            // rank of the target among the active keys
  int count = 0;           // keys in the chosen bin
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    // Plain shared-memory atomics: the top digit of doubly-centred
    // projections (a sign and 7 exponent bits) crowds 1000 keys into a
    // handful of bins, yet electing one lane per distinct bin with
    // `__match_any_sync` measured slower on an H100 than letting the adds
    // collide.
#pragma unroll
    for (int r = 0; r < kVpl; ++r) {
      if (((key[r] ^ prefix) & mask) == 0u)
        atomicAdd(&hist[(key[r] >> shift) & 0xffu], 1);
    }
    __syncwarp();

    // Lane l reads (and clears for the next pass) its 8 bins; c[0] is the
    // largest of them.
    int4* mine = reinterpret_cast<int4*>(hist) + 2 * (31 - lane);
    const int4 lo = mine[0];
    const int4 hi = mine[1];
    mine[0] = make_int4(0, 0, 0, 0);
    mine[1] = make_int4(0, 0, 0, 0);
    const int c[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += c[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - sum;
    const bool holds = excl < krem && krem <= incl;   // exactly one lane
    int rem = krem - excl;
    int digit = 0;
    int in_bin = 0;
    bool found = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!found) {
        if (rem <= c[i]) {
          found = true;
          digit = 8 * (31 - lane) + 7 - i;
          in_bin = c[i];
        } else {
          rem -= c[i];
        }
      }
    }
    const int src = __ffs(__ballot_sync(kFull, holds)) - 1;
    digit = __shfl_sync(kFull, digit, src);
    krem = __shfl_sync(kFull, rem, src);
    count = __shfl_sync(kFull, in_bin, src);
    __syncwarp();   // the clears land before the next pass's adds

    prefix |= static_cast<unsigned>(digit) << shift;
    mask |= 0xffu << shift;
    if (count == 1) {
      unsigned last = 0u;   // the one key of the warp that still matches
#pragma unroll
      for (int r = 0; r < kVpl; ++r) {
        if (((key[r] ^ prefix) & mask) == 0u) last = key[r];
      }
      return __reduce_max_sync(kFull, last);
    }
  }
  return prefix;
}

}  // namespace drcvar
