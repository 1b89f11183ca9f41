// A Monte Carlo chunk's obstacle draws for Hopper (sm_90a), in one launch.
//
// Replaces no Pallas kernel: the JAX package splits one key a run and
// lets XLA batch the draws.  The port's Monte Carlo study draws each
// run's obstacles from that run's own card generator
// (`torch.Generator(device="cuda").manual_seed(seed)`): `torch.randn` for
// the Gaussian samples, then `exponential_` for the Laplace realization
// (simulation/obstacles.py).  As a Python loop that is ~1,500 launches
// and ~0.33 ms of host time a run.  This kernel writes the same numbers,
// bit for bit, for every run of a chunk at once: it replays what PyTorch's
// two distribution kernels compute from each run's generator.
//
// What PyTorch computes (aten/src/ATen/native/cuda/DistributionTemplates.h,
// for a contiguous float32 tensor of `numel` elements):
//
//  * One launch of 256-thread blocks on min(ceil(numel / 256), SMs x
//    (threads an SM / 256)) blocks; thread `tid` of the `threads` in the
//    grid owns Philox4x32-10 subsequence `tid` of the generator's seed,
//    starting at the generator's offset, and on its i-th round draws one
//    block of four 32-bit words (the counter's low 64 bits offset / 4 + i,
//    its high 64 bits tid).  Element `e` takes word (e / threads) % 4 of
//    round (e / threads) / 4 of thread e % threads.  The launch then
//    advances the generator's offset by 4 x the rounds a thread makes.
//    The grid depends on the card; the caller passes it
//    (ops/cuda_draws.py::philox_plan reads the card's multiprocessor count
//    and threads a multiprocessor).
//  * `randn` (normal_, curand_normal4): the block's words (x, y) and (z, w)
//    go through curand's Box-Muller, u = x 2^-32 + 2^-33, v = y 2 pi 2^-32
//    + pi 2^-32, sqrt(-2 log u) (sin v, cos v): element word 0 takes the
//    sine of the first pair, 1 its cosine, 2 and 3 those of the second.
//    Then mean 0 + std 1 x the value.
//  * `exponential_` (curand_uniform4): u = word 2^-32 + 2^-33 in (0, 1],
//    and -log u, but eps / 2 where u >= 1 - eps / 2 (float32's eps), at
//    the offset `randn` left the generator at.
//
// Then the loop's float32 operations, each rounded on its own as the
// separate PyTorch kernels round it (no contraction into an FMA): sample
// = nominal + randn x sqrt(noise_var), realization = nominal +
// sqrt(noise_var / 2) x (E0 - E1), and the noise is 0 at t = 0.  The
// intrinsics are those the two PyTorch kernels compile to: in curand's
// Box-Muller the accurate `logf` and `sqrtf` and the fast `__sincosf`; in
// the exponential transform the fast `__logf` (PyTorch's device `log` of
// a float, measured against `exponential_` on the card: with `logf` 85%
// of the values differ in their last bits, with `__logf` none).
//
// What bounds it.  By the roofline, its bytes: a head_on_n20 study (300
// runs, 20 samples, 151 steps) writes 8.0 MB, 0.0024 ms at 3.35 TB/s.
// Reached on an NVIDIA H100 80GB HBM3 at 700 W: 0.0346 ms (1024 runs:
// 0.0811 ms against 0.0081), each element computing a Philox block of
// ten rounds and its transform; the loop it replaces spends ~110 ms of
// host time a study.  One thread an output element, a grid-stride loop:
// samples first, then realizations (two exponential draws each), then
// the nominal paths repeated for every run.
//
// Launch counter: `obstacle_draws.launches` on the wrapper in
// ops/cuda_draws.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;     // the grid-stride loop's cap

constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;

constexpr float k2Pow32Inv = 2.3283064e-10f;                // 2^-32
constexpr float k2Pow32Inv2Pi = 2.3283064e-10f * 6.2831855f;  // 2 pi 2^-32
constexpr float kHalfEps = 1.1920929e-07f / 2.0f;           // FLT_EPSILON / 2

// Philox4x32-10 of counter c under key k: curand's rounds and key steps.
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words of element `e`'s round, and which of them it takes, for a
// launch of `threads` threads whose generator stood at `start` blocks.
__device__ __forceinline__ uint4 block_of(uint64_t seed, int64_t e,
                                          int64_t threads, uint64_t start,
                                          int* word) {
  const int64_t q = e / threads;
  const uint64_t tid = static_cast<uint64_t>(e - q * threads);
  const uint64_t round = start + static_cast<uint64_t>(q >> 2);
  *word = static_cast<int>(q & 3);
  const uint4 ctr = make_uint4(static_cast<uint32_t>(round),
                               static_cast<uint32_t>(round >> 32),
                               static_cast<uint32_t>(tid),
                               static_cast<uint32_t>(tid >> 32));
  return philox(ctr, make_uint2(static_cast<uint32_t>(seed),
                                static_cast<uint32_t>(seed >> 32)));
}

// curand_normal4's value for word `word` of the block.
__device__ __forceinline__ float normal_of(uint4 b, int word) {
  const uint32_t x = word < 2 ? b.x : b.z;
  const uint32_t y = word < 2 ? b.y : b.w;
  const float u = fmaf(static_cast<float>(x), k2Pow32Inv, k2Pow32Inv / 2.0f);
  const float v = fmaf(static_cast<float>(y), k2Pow32Inv2Pi,
                       k2Pow32Inv2Pi / 2.0f);
  const float s = sqrtf(-2.0f * logf(u));
  float sn, cs;
  __sincosf(v, &sn, &cs);
  const float z = __fmul_rn((word & 1) ? cs : sn, s);
  return __fadd_rn(__fmul_rn(z, 1.0f), 0.0f);   // normal_'s std and mean
}

// exponential_'s value (rate 1) for word `word` of the block.
__device__ __forceinline__ float exponential_of(uint4 b, int word) {
  const uint32_t w = word == 0 ? b.x : word == 1 ? b.y : word == 2 ? b.z : b.w;
  const float u = fmaf(static_cast<float>(w), k2Pow32Inv, k2Pow32Inv / 2.0f);
  const float lg = u >= 1.0f - kHalfEps ? -kHalfEps : __logf(u);
  return __fmul_rn(-1.0f, lg);
}

struct Dims {
  int64_t runs;       // S
  int64_t per_run;    // n_obs x N x (T+1) x 2 sample floats a run
  int64_t path;       // n_obs x (T+1) x 2 floats of a path
  int64_t steps;      // T + 1
  int64_t threads_s;  // randn's grid, in threads
  int64_t threads_e;  // exponential_'s grid, in threads
  uint64_t start_e;   // exponential_'s first round: randn's rounds
};

__global__ void __launch_bounds__(kThreads)
draws_kernel(const float* __restrict__ nominal,
             const int64_t* __restrict__ seeds, float* __restrict__ nominal_out,
             float* __restrict__ samples, float* __restrict__ realization,
             Dims d, float c_gauss, float c_lap) {
  const int64_t n_samples = d.runs * d.per_run;
  const int64_t n_paths = d.runs * d.path;
  const int64_t total = n_samples + 2 * n_paths;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t obs_floats = d.per_run / d.path * d.steps * 2;  // N (T+1) 2
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < total; g += step) {
    if (g < n_samples) {
      const int64_t run = g / d.per_run;
      const int64_t e = g - run * d.per_run;
      // [n_obs, N, T+1, 2]: the sample's obstacle, step and coordinate.
      const int64_t c = e & 1;
      const int64_t t = (e >> 1) % d.steps;
      const int64_t obs = e / obs_floats;
      const float nom = __ldg(nominal + (obs * d.steps + t) * 2 + c);
      float noise = 0.0f;
      if (t != 0) {
        int word;
        const uint4 b = block_of(static_cast<uint64_t>(__ldg(seeds + run)), e,
                                 d.threads_s, 0, &word);
        noise = __fmul_rn(normal_of(b, word), c_gauss);
      }
      samples[g] = __fadd_rn(nom, noise);
    } else if (g < n_samples + n_paths) {
      const int64_t h = g - n_samples;
      const int64_t run = h / d.path;
      const int64_t j = h - run * d.path;
      const int64_t t = (j >> 1) % d.steps;
      float noise = 0.0f;
      if (t != 0) {
        const uint64_t seed = static_cast<uint64_t>(__ldg(seeds + run));
        int w0, w1;
        const uint4 b0 = block_of(seed, j, d.threads_e, d.start_e, &w0);
        const uint4 b1 = block_of(seed, j + d.path, d.threads_e, d.start_e,
                                  &w1);
        noise = __fmul_rn(c_lap, __fsub_rn(exponential_of(b0, w0),
                                           exponential_of(b1, w1)));
      }
      realization[h] = __fadd_rn(__ldg(nominal + j), noise);
    } else {
      const int64_t h = g - n_samples - n_paths;
      nominal_out[h] = __ldg(nominal + h % d.path);
    }
  }
}

}  // namespace

extern "C" int drcvar_obstacle_draws(const void* nominal, const void* seeds,
                                     void* nominal_out, void* samples,
                                     void* realization, int runs, int n_obs,
                                     int n_samples, int steps, int threads_s,
                                     int threads_e, uint64_t start_e,
                                     float c_gauss, float c_lap,
                                     void* stream) {
  if (runs < 0 || n_obs < 1 || n_samples < 1 || steps < 1 || threads_s < 1 ||
      threads_e < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (runs == 0) return 0;
  Dims d;
  d.runs = runs;
  d.path = static_cast<int64_t>(n_obs) * steps * 2;
  d.per_run = d.path * n_samples;
  d.steps = steps;
  d.threads_s = threads_s;
  d.threads_e = threads_e;
  d.start_e = start_e;
  const int64_t total = d.runs * (d.per_run + 2 * d.path);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  draws_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nominal), static_cast<const int64_t*>(seeds),
      static_cast<float*>(nominal_out), static_cast<float*>(samples),
      static_cast<float*>(realization), d, c_gauss, c_lap);
  return static_cast<int>(cudaGetLastError());
}
