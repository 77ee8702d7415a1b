// Batched Cholesky factor and Cholesky solve of small SPD matrices (n = 120
// on the dense interior point's path), one thread block per matrix.  CUDA
// C++ for sm_90a, plain C entry points (loaded with ctypes by
// hector_torch/qp/chol.py).
//
// Replaces the two Pallas TPU kernels of hector/qp/pallas_chol.py:
//   chol_factor_kernel  <-  _chol_kernel  (:48, pl.pallas_call at :129,
//                           reached through cholesky_nnb :114)
//   chol_solve_kernel   <-  _solve_kernel (:77, pl.pallas_call at :156,
//                           reached through cholesky_solve_nnb :146)
// They compute what those compute: the lower Cholesky factor L of each
// matrix (right-looking, column by column, scaled by the reciprocal square
// root of the pivot), and x with L L^T x = rhs by forward then back
// substitution in the column (axpy) order of the TPU kernel.
//
// What bounds them on the card: bytes.  A factor reads the 29 KB lower
// triangle and writes the whole 57.6 KB matrix (L and the zeros above it)
// for n^3/3 = 576 K operations, 6.6 a byte where the card can do 20; a
// solve reads the 29 KB triangle of L for 2 n^2 = 29 K operations.
// What stands between these kernels and that bound is the chain of n
// (factor) or 2n (solve) dependent steps, each ended by a block barrier, and
// in the factor the shared-memory traffic of the rank-1 updates (a load, a
// multiply-add and a store per entry: no register tile yet).
//
// What the design does about it.  The TPU kernels put the batch on the 128
// lanes and keep a multi-megabyte tile of 128 whole matrices in fast memory;
// no SM has that.  Here ONE MATRIX IS ONE BLOCK: its lower triangle is
// loaded once into shared memory, packed row by row (n (n + 1) / 2 floats,
// 29 KB at n = 120, so six or seven blocks fit an SM and hide each other's
// barriers), the threads share each column's rank-1 update of the trailing
// lower triangle, and the result is written back once, so device memory
// sees every byte once.  One thread per scenario, as in the fused Riccati
// kernel, would stream each trailing matrix through L2 n times.
//   - Layout.  The kernels take element strides (row, column, batch), so one
//     kernel serves both the (B, n, n) tensors the interior point hands over
//     (a block's loads are then contiguous and coalesced) and the batch-minor
//     (n, n, B) views of the public cholesky_nnb / cholesky_solve_nnb (loads
//     strided by B: right, slow, used by tests).
//   - Ragged batch.  The grid is the batch: no padding lanes, no identity
//     padding copy.
//   - Only the lower triangle is read or kept.  Row r starts at
//     r (r + 1) / 2, so a walk along a row is free of bank conflicts; a walk
//     down a column (the pivot column of the factor, the forward pass of the
//     solve) has a growing stride and meets some, on n values a step.  The
//     factor writes zeros above the diagonal (the contract of cholesky_nnb).
//   - In the rank-1 update a warp takes FACTOR_ROWS rows at a time along the
//     columns, so each col[c] is loaded once for them and their
//     read-modify-writes are independent of each other.
//   - The solve keeps x[t] in a register of thread t and broadcasts one
//     x[j] per step through a double-buffered shared slot: one barrier per
//     step.
//
// Floating point: no fast math.  The pivot scale is 1.0f / sqrtf(pivot),
// both IEEE-rounded, as the plain PyTorch version computes it.  There is no
// pivot floor: a non-positive or NaN pivot gives inf or NaN, which stays in
// its own matrix (= its own block; every loop has a fixed trip count, so
// nothing hangs) and is caught by the interior point's quarantine.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int FACTOR_THREADS = 256;  // 8 warps
constexpr int FACTOR_ROWS = 4;       // rows a warp updates together

// offset of element (r, c), c <= r, in the packed lower triangle
__host__ __device__ inline int tri(int r, int c) { return r * (r + 1) / 2 + c; }

// bytes of dynamic shared memory: the packed lower triangle and one column
// (factor) or broadcast slot (solve)
inline size_t smem_bytes(int n) {
  return (static_cast<size_t>(tri(n, 0)) + n) * sizeof(float);
}

constexpr int MAX_DEVICES = 64;

// Raise `kernel`'s limit of dynamic shared memory to `smem` bytes on the
// current device.  `have` remembers the limit set on each device, so the
// attribute is set once per device and size, not once per launch.
template <class Kernel>
cudaError_t ensure_smem(Kernel kernel, int (&have)[MAX_DEVICES], size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < MAX_DEVICES;
  if (known && have[dev] >= static_cast<int>(smem)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && known) have[dev] = static_cast<int>(smem);
  return err;
}

// One block factors one matrix.  m and l may alias.
__global__ void __launch_bounds__(FACTOR_THREADS) chol_factor_kernel(
    const float* m, float* l, int n, long long m_sr, long long m_sc,
    long long m_sb, long long l_sr, long long l_sc, long long l_sb) {
  extern __shared__ float smem[];
  float* a = smem;               // a[tri(r, c)], the lower triangle
  float* col = smem + tri(n, 0);  // the scaled pivot column of this step
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int WARPS = FACTOR_THREADS / 32;
  m += static_cast<long long>(blockIdx.x) * m_sb;
  l += static_cast<long long>(blockIdx.x) * l_sb;

  for (int e = tid; e < n * n; e += FACTOR_THREADS) {
    const int r = e / n, c = e - r * n;
    if (c <= r) a[tri(r, c)] = m[r * m_sr + c * m_sc];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // col[t] = a[t][j] / sqrt(a[j][j]) for t >= j
    const float inv = 1.0f / sqrtf(a[tri(j, j)]);
    for (int t = j + tid; t < n; t += FACTOR_THREADS) col[t] = a[tri(t, j)] * inv;
    __syncthreads();
    // final column j, and the rank-1 update of the trailing lower triangle
    for (int t = j + tid; t < n; t += FACTOR_THREADS) a[tri(t, j)] = col[t];
    for (int r0 = j + 1 + warp * FACTOR_ROWS; r0 < n;
         r0 += WARPS * FACTOR_ROWS) {
      float cr[FACTOR_ROWS];
#pragma unroll
      for (int q = 0; q < FACTOR_ROWS; ++q)
        cr[q] = (r0 + q < n) ? col[r0 + q] : 0.0f;
      const int rmax = min(r0 + FACTOR_ROWS - 1, n - 1);
      for (int c = j + 1 + lane; c <= rmax; c += 32) {
        const float cc = col[c];
#pragma unroll
        for (int q = 0; q < FACTOR_ROWS; ++q) {
          const int r = r0 + q;
          if (r < n && c <= r) a[tri(r, c)] -= cr[q] * cc;
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < n * n; e += FACTOR_THREADS) {
    const int r = e / n, c = e - r * n;
    l[r * l_sr + c * l_sc] = (c <= r) ? a[tri(r, c)] : 0.0f;
  }
}

// One block solves L L^T x = rhs for one matrix; blockDim.x >= n, thread t
// owns x[t].
__global__ void chol_solve_kernel(const float* l, const float* rhs, float* x,
                                  int n, long long l_sr, long long l_sc,
                                  long long l_sb, long long r_sn,
                                  long long r_sb, long long x_sn,
                                  long long x_sb) {
  extern __shared__ float smem[];
  float* a = smem;
  float* slot = smem + tri(n, 0);  // slot[j & 1]: x[j] of the current step
  const int t = threadIdx.x;
  l += static_cast<long long>(blockIdx.x) * l_sb;
  rhs += static_cast<long long>(blockIdx.x) * r_sb;
  x += static_cast<long long>(blockIdx.x) * x_sb;

  for (int e = t; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e - r * n;
    if (c <= r) a[tri(r, c)] = l[r * l_sr + c * l_sc];
  }
  float xt = (t < n) ? rhs[t * r_sn] : 0.0f;
  __syncthreads();

  // forward: x[j] = x[j] / L[j][j]; x[t] -= L[t][j] x[j] for t > j
  for (int j = 0; j < n; ++j) {
    if (t == j) {
      xt = xt / a[tri(j, j)];
      slot[j & 1] = xt;
    }
    __syncthreads();
    if (t > j && t < n) xt -= a[tri(t, j)] * slot[j & 1];
  }
  // back: x[j] = x[j] / L[j][j]; x[t] -= L[j][t] x[j] for t < j
  for (int j = n - 1; j >= 0; --j) {
    if (t == j) {
      xt = xt / a[tri(j, j)];
      slot[j & 1] = xt;
    }
    __syncthreads();
    if (t < j) xt -= a[tri(j, t)] * slot[j & 1];
  }
  if (t < n) x[t * x_sn] = xt;
}

}  // namespace

extern "C" {

// Largest n the kernels take: the matrix must fit a block's shared memory.
// Asked once, when the library is loaded.
int chol_max_n() {
  int n = 1;
  while (smem_bytes(n + 1) <= 232448) ++n;
  return n;
}

// Factor `batch` matrices on `stream`.  Element (r, c) of matrix b is at
// m[r * m_sr + c * m_sc + b * m_sb] (strides in elements); l likewise, and
// l may be m.  Returns the CUDA error of the launch (0 = launched).
int chol_factor(const float* m, float* l, int n, int batch, long long m_sr,
                long long m_sc, long long m_sb, long long l_sr, long long l_sc,
                long long l_sb, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = smem_bytes(n);
  static int have[MAX_DEVICES] = {};
  cudaError_t err = ensure_smem(chol_factor_kernel, have, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_factor_kernel<<<batch, FACTOR_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      m, l, n, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb);
  return static_cast<int>(cudaGetLastError());
}

// Solve L L^T x = rhs for `batch` matrices on `stream`; rhs element t of
// matrix b at rhs[t * r_sn + b * r_sb], x likewise.
int chol_solve(const float* l, const float* rhs, float* x, int n, int batch,
               long long l_sr, long long l_sc, long long l_sb, long long r_sn,
               long long r_sb, long long x_sn, long long x_sb, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = smem_bytes(n);
  static int have[MAX_DEVICES] = {};
  cudaError_t err = ensure_smem(chol_solve_kernel, have, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((n + 31) / 32) * 32;
  chol_solve_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      l, rhs, x, n, l_sr, l_sc, l_sb, r_sn, r_sb, x_sn, x_sb);
  return static_cast<int>(cudaGetLastError());
}

const char* chol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
