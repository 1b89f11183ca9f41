// Batched small dense Cholesky factorisation and solve for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels `_chol_kernel` and `_solve_kernel` of the
// JAX package (ops/pallas_linalg.py, entered through `batched_cholesky`
// and `batched_cho_solve`).  The MPC interior-point method factors one
// n x n Schur matrix (n = 60 for the H = 30 MPC) and solves two
// right-hand sides per iteration for every QP of the batch; its
// active-set polish factors a 60 x 60 and a 64 x 64 matrix and solves
// 65 right-hand sides at once.
//
// What bounds them on this card: a 60 x 60 factorisation is 72 kFLOP on
// 14 KB, so neither FLOPs nor bytes are the limit.  The n sequential
// column steps are: each step is a block-wide barrier, and the work
// between two barriers is at most one trailing-update sweep.
//
// What the design does about it: one thread block per matrix, with the
// matrix (and the right-hand sides) in shared memory, row stride n_max+1
// to spread the column reads over the banks.  Every global access is a
// coalesced load at the start and a store at the end.  The TPU kernels'
// batch-last [n, n, B] layout (which put 128 instances on the vector
// lanes) is not carried over: here the batch is the grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;
constexpr int kLd = kMaxN + 1;

// Right-looking lower Cholesky of one n x n SPD matrix per block.  A
// non-positive pivot yields NaN, as the library factorisations do.
__global__ void __launch_bounds__(kThreads)
cholesky_kernel(const float* __restrict__ S, float* __restrict__ L, int n) {
  __shared__ float a[kMaxN * kLd];
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    a[i * kLd + (idx - i * n)] = S[base + idx];
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float d = sqrtf(a[j * kLd + j]);
    __syncthreads();  // every thread has read the pivot
    for (int i = j + threadIdx.x; i < n; i += kThreads)
      a[i * kLd + j] = (i == j) ? d : a[i * kLd + j] / d;
    __syncthreads();
    // Trailing update of the lower triangle: a[r][c] -= L[r][j] L[c][j].
    const int m = n - j - 1;
    for (int idx = threadIdx.x; idx < m * m; idx += kThreads) {
      const int r = j + 1 + idx / m;
      const int c = j + 1 + idx % m;
      if (c <= r) a[r * kLd + c] -= a[r * kLd + j] * a[c * kLd + j];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    L[base + idx] = (j <= i) ? a[i * kLd + j] : 0.f;
  }
}

// Solves L L^T X = R for one instance per block; R and X are n x k.
// Forward substitution column by column, then backward.
__global__ void __launch_bounds__(kThreads)
cho_solve_kernel(const float* __restrict__ L, const float* __restrict__ R,
                 float* __restrict__ X, int n, int k) {
  extern __shared__ float smem[];
  float* l = smem;               // n x kLd, lower triangle used
  float* x = smem + kMaxN * kLd; // n x k
  const size_t lbase = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * n * k;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    l[i * kLd + (idx - i * n)] = L[lbase + idx];
  }
  for (int idx = threadIdx.x; idx < n * k; idx += kThreads)
    x[idx] = R[rbase + idx];
  __syncthreads();

  // Forward: L Y = R.
  for (int j = 0; j < n; ++j) {
    const float d = l[j * kLd + j];
    for (int c = threadIdx.x; c < k; c += kThreads) x[j * k + c] /= d;
    __syncthreads();
    const int rows = n - j - 1;
    for (int idx = threadIdx.x; idx < rows * k; idx += kThreads) {
      const int i = j + 1 + idx / k;
      const int c = idx % k;
      x[i * k + c] -= l[i * kLd + j] * x[j * k + c];
    }
    __syncthreads();
  }
  // Backward: L^T X = Y; column j of L^T is row j of L.
  for (int j = n - 1; j >= 0; --j) {
    const float d = l[j * kLd + j];
    for (int c = threadIdx.x; c < k; c += kThreads) x[j * k + c] /= d;
    __syncthreads();
    for (int idx = threadIdx.x; idx < j * k; idx += kThreads) {
      const int i = idx / k;
      const int c = idx % k;
      x[i * k + c] -= l[j * kLd + i] * x[j * k + c];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < n * k; idx += kThreads)
    X[rbase + idx] = x[idx];
}

}  // namespace

extern "C" int drcvar_batched_cholesky(const void* S, void* L, int batch,
                                       int n, void* stream) {
  cholesky_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<float*>(L), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int drcvar_batched_cho_solve(const void* L, const void* R, void* X,
                                        int batch, int n, int k,
                                        void* stream) {
  const size_t smem = (static_cast<size_t>(kMaxN) * kLd +
                       static_cast<size_t>(n) * k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cho_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cho_solve_kernel<<<batch, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(R),
      static_cast<float*>(X), n, k);
  return static_cast<int>(cudaGetLastError());
}
