// Warp-level device code of the halfspace kernels (halfspace_kernels.cu)
// and of their attribution variants (halfspace_variants.cu): one warp owns
// a row of at most 1024 samples, every sample in a register, and nothing
// in it waits for another warp.
//
// The row body is cut into the stages below (load, centred statistics,
// keys of the projections, select, tail).  The production kernels and the
// variants are instantiations of the SAME stages, so a variant is the
// production kernel with one stage swapped, and the difference of their
// times is that stage's time.  A stage's policy parameter (`kRoundEach`,
// `kCountPasses`, `kStrict`) compiles, at its production value, to the
// code the production kernel had before the stages were shared.
//
// The block-level helpers of halfspace_common.cuh serve the rows of more
// than 1024 samples.

#pragma once

#include <cstdint>
#include <type_traits>

#include "halfspace_common.cuh"

namespace drcvar {

constexpr int kBins = 256;            // one 8-bit digit of the key
constexpr int kWarpMaxRows = 8;       // warps (rows) a block, at most
constexpr unsigned kNegInfBits = 0xff800000u;

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

// The sample that register r of lane `lane` holds: the two samples of the
// lane's 16-byte load j = r / 2 are 64 j + 2 lane and the next.
__device__ __forceinline__ int warp_slot(int r, int lane) {
  return 64 * (r >> 1) + 2 * lane + (r & 1);
}

// Stage 1: the row's n samples into registers, read once; a slot past n
// holds (0, 0).  16-byte loads of two samples when the caller vouches for
// the row's alignment, 8-byte loads of one else; both give a lane the
// same samples.  All loads are issued before the first use.
template <int kVpl>
__device__ __forceinline__ void warp_load_row(const float2* __restrict__ s,
                                              int n, bool wide_loads,
                                              int lane, float2 (&p)[kVpl]) {
  if (wide_loads) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const int n4 = n >> 1;
#pragma unroll
    for (int j = 0; j < kVpl / 2; ++j) {
      const int i = 32 * j + lane;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n4) q = __ldg(s4 + i);
      p[2 * j] = make_float2(q.x, q.y);
      p[2 * j + 1] = make_float2(q.z, q.w);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kVpl; ++r) {
      const int i = warp_slot(r, lane);
      p[r] = i < n ? __ldg(s + i) : make_float2(0.f, 0.f);
    }
  }
}

// Stage 2: ego-centred sums (a lane's registers in order, then the xor
// butterfly: a fixed order), the unit normal and the sample mean.  With
// `kRoundEach` every operation is rounded on its own (no contraction into
// FMAs), so that torch operations can rebuild the results bit for bit.
template <int kVpl, bool kRoundEach>
__device__ __forceinline__ RowStats warp_row_stats(const float2 (&p)[kVpl],
                                                   float2 e, int n,
                                                   float inv_n, int lane) {
  float sx = 0.f;
  float sy = 0.f;
#pragma unroll
  for (int r = 0; r < kVpl; ++r) {
    if (warp_slot(r, lane) < n) {
      if constexpr (kRoundEach) {
        sx = __fadd_rn(sx, __fsub_rn(p[r].x, e.x));
        sy = __fadd_rn(sy, __fsub_rn(p[r].y, e.y));
      } else {
        sx += p[r].x - e.x;
        sy += p[r].y - e.y;
      }
    }
  }
  RowStats st;
  if constexpr (kRoundEach) {
    const float dx = __fmul_rn(warp_sum(sx), inv_n);
    const float dy = __fmul_rn(warp_sum(sy), inv_n);
    const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)));
    const bool degen = norm < kEps;
    st.hx = degen ? 1.f : __fdiv_rn(dx, norm);
    st.hy = degen ? 0.f : __fdiv_rn(dy, norm);
    st.mx = __fadd_rn(e.x, dx);
    st.my = __fadd_rn(e.y, dy);
  } else {
    const float dx = warp_sum(sx) * inv_n;
    const float dy = warp_sum(sy) * inv_n;
    const float norm = sqrtf(dx * dx + dy * dy);
    const bool degen = norm < kEps;
    st.hx = degen ? 1.f : dx / norm;
    st.hy = degen ? 0.f : dy / norm;
    st.mx = e.x + dx;
    st.my = e.y + dy;
  }
  return st;
}

// Stage 3: keys of the doubly-centred negated projections
// x_i = -(h . (xi_i - mean)); a slot past n holds -inf, below every key.
template <int kVpl, bool kRoundEach>
__device__ __forceinline__ void warp_row_keys(const float2 (&p)[kVpl],
                                              const RowStats& st, int n,
                                              int lane,
                                              unsigned (&key)[kVpl]) {
#pragma unroll
  for (int r = 0; r < kVpl; ++r) {
    const bool valid = warp_slot(r, lane) < n;
    float x;
    if constexpr (kRoundEach) {
      x = __fadd_rn(__fmul_rn(__fsub_rn(st.mx, p[r].x), st.hx),
                    __fmul_rn(__fsub_rn(st.my, p[r].y), st.hy));
    } else {
      x = (st.mx - p[r].x) * st.hx + (st.my - p[r].y) * st.hy;
    }
    key[r] = float_key(valid ? x : __uint_as_float(kNegInfBits));
  }
}

// Stage 4: exact k-th largest of the 32 * kVpl keys a warp holds in
// registers (kVpl a lane, any assignment), 1 <= k <= 32 * kVpl; every lane
// receives it.  `hist` is the warp's own 256 counters of shared memory.
// With `kCountPasses`, *passes receives the passes the select ran (1..4).
//
// An 8-bit radix select from the top digit down.  Each pass histograms
// the digit of the keys that still match the digits chosen so far, lane
// l sums the 8 bins 8 (31 - l) .. 8 (31 - l) + 7, a shuffle scan from the
// largest bins down finds the lane and then the bin that holds the k-th
// largest, and the keys outside that bin no longer match.  The select
// leaves as soon as the chosen bin holds a single key; keys tied with the
// k-th run all four passes, after which the chosen digits are the key.
template <int kVpl, bool kCountPasses = false>
__device__ __forceinline__ unsigned warp_kth_largest_key(
    const unsigned (&key)[kVpl], int k, int* hist, int* passes = nullptr) {
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
      if constexpr (kCountPasses) *passes = (32 - shift) / 8;
      return __reduce_max_sync(kFull, last);
    }
  }
  if constexpr (kCountPasses) *passes = 4;
  return prefix;
}

// Stage 5: sum and size of the tail {x >= v} (`kStrict`: {x > v}) from
// the key registers; every lane receives both.
template <int kVpl, bool kStrict>
__device__ __forceinline__ void warp_tail(const unsigned (&key)[kVpl],
                                          float v, float& sum, int& size) {
  float tail = 0.f;
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kVpl; ++r) {
    const float x = key_float(key[r]);
    if (kStrict ? x > v : x >= v) {
      tail += x;
      ++cnt;
    }
  }
  sum = warp_sum(tail);
  size = __reduce_add_sync(kFull, cnt);
}

// The caller's plan of a launch (ops/cuda_kernels.py `halfspace_plan`):
// values a lane (0: the block path), rows a block and the width of the
// sample loads in bytes.  The entry points hold it against what the
// kernels take and refuse the rest.
struct Plan {
  int values_per_lane, rows_per_block, load_bytes;
};

inline bool warp_plan_fits(const Plan& plan, int n) {
  return n <= 32 * plan.values_per_lane && plan.rows_per_block >= 1 &&
         plan.rows_per_block <= kWarpMaxRows;
}

// cudaSuccess if a warp-path plan (with loads) fits rows of n samples
// that start at `samples`, else the error the entry point returns.
inline cudaError_t check_warp_plan(const Plan& plan, int n,
                                   const void* samples) {
  const bool wide = plan.load_bytes == 16;
  if (!warp_plan_fits(plan, n) || (!wide && plan.load_bytes != 8))
    return cudaErrorInvalidValue;
  if (wide && ((reinterpret_cast<uintptr_t>(samples) & 15u) || (n & 1)))
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// Calls f(std::integral_constant<int, V>()) for the instantiated number
// of values a lane V == values_per_lane; refuses any other.
template <typename F>
int with_values_per_lane(int values_per_lane, F&& f) {
  switch (values_per_lane) {
    case 2:
      return f(std::integral_constant<int, 2>());
    case 4:
      return f(std::integral_constant<int, 4>());
    case 8:
      return f(std::integral_constant<int, 8>());
    case 16:
      return f(std::integral_constant<int, 16>());
    case 32:
      return f(std::integral_constant<int, 32>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace drcvar
