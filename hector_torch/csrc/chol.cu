// Batched Cholesky factor and Cholesky solve of small SPD matrices (n = 120
// on the dense interior point's path), one thread block per matrix.  CUDA
// C++ for sm_90a, plain C entry points (loaded with ctypes by
// hector_torch/qp/chol.py).
//
// Replaces the two Pallas TPU kernels of hector/qp/pallas_chol.py:
//   chol_factor_kernel       <-  _chol_kernel  (:48, pl.pallas_call at :129,
//   (chol_factor_smem_kernel     reached through cholesky_nnb :114)
//    for n above 248)
//   chol_solve_kernel        <-  _solve_kernel (:77, pl.pallas_call at :156,
//                                reached through cholesky_solve_nnb :146)
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
// dependent pivots (factor) or 2n dependent steps (solve), and the on-chip
// traffic of the factor's updates.
//
// The TPU kernels put the batch on the 128 lanes and keep a multi-megabyte
// tile of 128 whole matrices in fast memory; no SM has that.  Here ONE
// MATRIX IS ONE BLOCK, and the block holds its matrix on chip from one
// read of device memory to one write.  One thread per scenario, as in the
// fused Riccati kernel, would stream each trailing matrix through L2 n
// times.  The kernels take element strides (row, column, batch), so one
// kernel serves both the (B, n, n) tensors the interior point hands over
// and the batch-minor (n, n, B) views of the public cholesky_nnb /
// cholesky_solve_nnb (loads strided by B: right, slow, used by tests).
// The grid is the batch: no padding lanes, no identity padding copy.
//
// The factor, n <= 248 (chol_factor_kernel): register tiles.
//   - The matrix is cut into 8 x 8 tiles, T = ceil(n / 8) tile rows; each
//     of the T (T + 1) / 2 lower tiles lives in the 64 registers of one
//     thread for the whole factorization (n = 120: 15 x 15 grid, 120 tiles,
//     4 warps).  Tiles are numbered down the tile columns, so the work of
//     a panel sits on the warps of the later columns, not spread as idle
//     lanes over all of them, and a warp whose columns are final leaves
//     the panel loop, writes its tiles back and is done (a panel's
//     barriers count only the warps still in the loop).  A ragged edge is
//     padded inside the registers with an identity (pivot 1, zeros), which
//     never reaches a real entry.
//   - Blocked right-looking order, one 8-wide panel at a time: the thread
//     of the diagonal tile factors it alone in registers and publishes L
//     and the 8 pivot reciprocals; the threads of the tile column below it
//     solve their tiles against it and publish the panel (transposed, so
//     a tile's 8 rows are two float4 reads); every trailing tile then
//     takes its rank-8 update in registers, 16 shared loads (4 float4)
//     feeding 64 FMAs a column.  The per-entry shared-memory load, FMA and
//     store of the earlier shared-triangle kernel become one FMA, and the
//     barriers drop from 2 a column to 2 a panel (240 -> 28 at n = 120).
//   - The rounding is the column-by-column kernel's, entry by entry: every
//     entry takes its contributions in column order j = 0, 1, ..., one FMA
//     each (a -= L[r][j] L[c][j]), then the scaling by the IEEE
//     1.0f / sqrtf(pivot) of its column.  A panel's contributions are never
//     summed first.  So the result is the shared-triangle kernel's, bit for
//     bit, and chip_smoke.py checks that.
//   - Loads and stores: with a unit column stride, row and batch strides
//     that are multiples of 4, 16-byte aligned pointers and n a multiple of
//     8 (the (B, 120, 120) tensors of the interior point), each tile row
//     is two 16-byte accesses and no address needs a divide; otherwise
//     element by element, bounds-checked.  Each 32-byte sector is used
//     whole, but a warp's request spans its 32 tiles, not one line: the
//     load is 5-12 % of a block's cycles (profile_chol_kernel.py).  The
//     thread of tile (I, J) also writes the zero tile (J, I) above the
//     diagonal.
//   - Registers: __launch_bounds__(512, 1) caps a thread at 128, so at
//     n = 120 (128 threads) four blocks fit an SM.
//   - What bounds it now is each block's chain of panels, not bytes: 0.316
//     ms for 4,096 matrices against the 0.106 ms byte bound (H100 80GB
//     HBM3, 700 W).  The diagonal tile's 8 square roots and divides in one
//     thread, and the wait for them, take about 45 % of the last warp's
//     cycles; the four blocks an SM hide part of the chain (held to two,
//     the kernel is 1.46x slower; profile_chol_kernel.py).
//
// The factor, 248 < n <= 339 (chol_factor_smem_kernel): the lower triangle
// packed in shared memory (row r at r (r + 1) / 2; 229 KB at n = 339),
// 256 threads sharing each column's rank-1 update, two barriers a column.
// A register tile grid does not fit there: 946 tiles at n = 339.  The
// choice is made by n in chol_factor, never on a failure.  It is the
// kernel the tile kernel replaced on the dense path, and
// chol_factor_shared launches it at any n so that the two can be compared.
//
// The solve (chol_solve_kernel): L's packed lower triangle in shared memory,
// x[t] in a register of thread t, one x[j] broadcast per step through a
// double-buffered shared slot: one barrier per step.
//
// Floating point: no fast math.  The pivot scale is 1.0f / sqrtf(pivot),
// both IEEE-rounded, as the plain PyTorch version computes it.  There is no
// pivot floor: a non-positive or NaN pivot gives inf or NaN, which stays in
// its own matrix (= its own block; every loop has a fixed trip count, so
// nothing hangs) and is caught by the interior point's quarantine.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

// ---- register-tile factor ----
constexpr int TILE = 8;
constexpr int TILE_MAX_THREADS = 512;  // 16 warps
constexpr int TILE_MAX_T = 31;         // 31 * 32 / 2 = 496 tiles <= 512 threads
constexpr int TILE_MAX_N = TILE * TILE_MAX_T;  // 248

// ---- shared-triangle factor and solve ----
constexpr int FACTOR_THREADS = 256;  // 8 warps
constexpr int FACTOR_ROWS = 4;       // rows a warp updates together

// offset of element (r, c), c <= r, in the packed lower triangle
__host__ __device__ inline int tri(int r, int c) { return r * (r + 1) / 2 + c; }

// bytes of dynamic shared memory: the packed lower triangle and one column
// (factor) or broadcast slot (solve)
inline size_t smem_bytes(int n) {
  return (static_cast<size_t>(tri(n, 0)) + n) * sizeof(float);
}

__host__ __device__ inline int tile_rows(int n) { return (n + TILE - 1) / TILE; }

// threads of the tile kernel at n: one a lower tile, whole warps
inline int tile_threads(int n) {
  const int t = tile_rows(n);
  return (t * (t + 1) / 2 + 31) / 32 * 32;
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

// One 8 x 8 tile of a matrix held by one thread: a[i][k] is element
// (8 I + i, 8 J + k).
using Tile = float[TILE][TILE];

// Load tile (ti, tj).  Entries past the edge (row or column >= n) are the
// identity's.  `vec`: unit column stride, 16-byte aligned rows, n % 8 == 0.
__device__ __forceinline__ void load_tile(Tile& a, const float* m, int n, int ti,
                                          int tj, long long sr, long long sc,
                                          bool vec) {
  const int r0 = ti * TILE, c0 = tj * TILE;
  if (vec) {
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      const float4* p = reinterpret_cast<const float4*>(m + (r0 + i) * sr + c0);
      const float4 x = p[0], y = p[1];
      a[i][0] = x.x; a[i][1] = x.y; a[i][2] = x.z; a[i][3] = x.w;
      a[i][4] = y.x; a[i][5] = y.y; a[i][6] = y.z; a[i][7] = y.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TILE; ++i)
#pragma unroll
    for (int k = 0; k < TILE; ++k) {
      const int r = r0 + i, c = c0 + k;
      a[i][k] = (r < n && c < n) ? m[r * sr + c * sc] : (r == c ? 1.0f : 0.0f);
    }
}

// Write tile (ti, tj) of L: `a` below the diagonal (and on it), zeros above;
// with `zero` the whole tile is zeros.  Entries past the edge are skipped.
__device__ __forceinline__ void store_tile(float* l, const Tile& a, int n, int ti,
                                           int tj, long long sr, long long sc,
                                           bool vec, bool zero) {
  const int r0 = ti * TILE, c0 = tj * TILE;
  const bool diag = ti == tj;
  float v[TILE][TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i)
#pragma unroll
    for (int k = 0; k < TILE; ++k)
      v[i][k] = (zero || (diag && k > i)) ? 0.0f : a[i][k];
  if (vec) {
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      float4* p = reinterpret_cast<float4*>(l + (r0 + i) * sr + c0);
      p[0] = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      p[1] = make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TILE; ++i)
#pragma unroll
    for (int k = 0; k < TILE; ++k) {
      const int r = r0 + i, c = c0 + k;
      if (r < n && c < n) l[r * sr + c * sc] = v[i][k];
    }
}

// Profiling switches, for profile_chol_kernel.py (the default build has
// neither).  CHOL_PHASE_CLOCKS: the block's last thread, whose warp stays in
// the panel loop to the end, adds the SM cycles since its last mark to the
// phase it leaves (g_chol_cycles[CHOL_PHASES] counts the blocks).
// CHOL_EXTRA_SMEM: bytes of dynamic shared memory the tile kernel's launch
// asks for and leaves unused, to hold an SM to fewer blocks.
#ifdef CHOL_PHASE_CLOCKS
constexpr int CHOL_PHASES = 7;
__device__ unsigned long long g_chol_cycles[CHOL_PHASES + 1];
#define PHASE_MARK(i)                      \
  if (threadIdx.x == blockDim.x - 1) {     \
    const long long now = clock64();       \
    clk_sum[i] += now - clk_last;          \
    clk_last = now;                        \
  }
#else
#define PHASE_MARK(i)
#endif
#ifndef CHOL_EXTRA_SMEM
#define CHOL_EXTRA_SMEM 0
#endif

// Barrier 1 of the block, complete when `count` threads (whole warps) have
// arrived: the warps still in the panel loop; those that have left it take
// no part.
__device__ __forceinline__ void bar_sync(int count) {
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
}

// Write the final tile (ti, tj) of L and, below the diagonal, the zero tile
// (tj, ti) above it.
__device__ __forceinline__ void store_tiles(float* l, const Tile& a, int n, int ti,
                                            int tj, long long sr, long long sc,
                                            bool vec) {
  store_tile(l, a, n, ti, tj, sr, sc, vec, false);
  if (ti != tj) store_tile(l, a, n, tj, ti, sr, sc, vec, true);
}

// One block factors one matrix, one lower 8 x 8 tile per thread (n <= 248;
// blockDim.x = tile_threads(n)).  m and l may alias.  `vec` as load_tile.
__global__ void __launch_bounds__(TILE_MAX_THREADS, 1) chol_factor_kernel(
    const float* m, float* l, int n, long long m_sr, long long m_sc,
    long long m_sb, long long l_sr, long long l_sc, long long l_sb, int vec) {
  // pan[k][r]: L[r][8 p + k] of the tile column below the diagonal tile
  // (p, p) of the current panel p
  __shared__ __align__(16) float pan[TILE][TILE_MAX_N];
  // dg[k][c]: L[8 p + c][8 p + k] of the diagonal tile (p, p), c > k; then
  // dg[8][k], its 8 pivot reciprocals
  __shared__ __align__(16) float dg[TILE + 1][TILE];
  const int nt = tile_rows(n);
  m += static_cast<long long>(blockIdx.x) * m_sb;
  l += static_cast<long long>(blockIdx.x) * l_sb;
#ifdef CHOL_PHASE_CLOCKS
  __shared__ unsigned long long clk_sum[CHOL_PHASES];
  __shared__ long long clk_last;
  if (threadIdx.x == blockDim.x - 1) {
    clk_last = clock64();
    for (int i = 0; i < CHOL_PHASES; ++i) clk_sum[i] = 0;
  }
#endif

  // this thread's tile (ti, tj), numbered down the tile columns; tj == nt:
  // none (the last warp's spare threads)
  int tj = 0, first = 0;
  while (tj < nt && static_cast<int>(threadIdx.x) >= first + nt - tj) {
    first += nt - tj;
    ++tj;
  }
  const int ti = tj + static_cast<int>(threadIdx.x) - first;
  const bool owns = tj < nt;
  // the last tile column of this thread's warp: its tiles are all final
  // after that panel, and the warp leaves the loop, writes them back and
  // is done
  const int wt = min(static_cast<int>(threadIdx.x) | 31, nt * (nt + 1) / 2 - 1);
  int wlast = 0;
  for (int rest = wt; rest >= nt - wlast; ++wlast) rest -= nt - wlast;

  Tile a;
  if (owns) load_tile(a, m, n, ti, tj, m_sr, m_sc, vec != 0);
  PHASE_MARK(0);  // load

  // Each buffer is written between one barrier and the next and read before
  // the one after, so a single copy of each serves.  The barriers of panel p
  // are for the warps still in the loop: from the one that holds tile
  // (p, p), the first of column p, to the last.
  for (int p = 0; p <= wlast; ++p) {
    // the diagonal tile, in registers, column by column
    if (owns && ti == p && tj == p) {
#pragma unroll
      for (int k = 0; k < TILE; ++k) {
        const float inv = 1.0f / sqrtf(a[k][k]);
#pragma unroll
        for (int i = k; i < TILE; ++i) a[i][k] *= inv;
#pragma unroll
        for (int c = k + 1; c < TILE; ++c)
#pragma unroll
          for (int i = c; i < TILE; ++i) a[i][c] = fmaf(-a[i][k], a[c][k], a[i][c]);
        dg[TILE][k] = inv;
      }
#pragma unroll
      for (int k = 0; k < TILE; ++k) {
        float4* q = reinterpret_cast<float4*>(dg[k]);
        q[0] = make_float4(a[0][k], a[1][k], a[2][k], a[3][k]);
        q[1] = make_float4(a[4][k], a[5][k], a[6][k], a[7][k]);
      }
    }
    PHASE_MARK(1);  // diagonal factor
    if (p == nt - 1) break;
    const int active = blockDim.x - (p * nt - p * (p - 1) / 2) / 32 * 32;
    bar_sync(active);
    PHASE_MARK(2);  // waiting for the diagonal tile
    // the tile column below it: a <- a L_pp^-T, column by column
    if (owns && tj == p && ti > p) {
#pragma unroll
      for (int k = 0; k < TILE; ++k) {
        const float4* q = reinterpret_cast<const float4*>(dg[k]);
        const float4 d0 = q[0], d1 = q[1];
        const float lk[TILE] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        const float inv = dg[TILE][k];
#pragma unroll
        for (int i = 0; i < TILE; ++i) a[i][k] *= inv;
#pragma unroll
        for (int c = k + 1; c < TILE; ++c)
#pragma unroll
          for (int i = 0; i < TILE; ++i) a[i][c] = fmaf(-a[i][k], lk[c], a[i][c]);
      }
#pragma unroll
      for (int k = 0; k < TILE; ++k) {
        float4* q = reinterpret_cast<float4*>(&pan[k][ti * TILE]);
        q[0] = make_float4(a[0][k], a[1][k], a[2][k], a[3][k]);
        q[1] = make_float4(a[4][k], a[5][k], a[6][k], a[7][k]);
      }
    }
    PHASE_MARK(3);  // column solve
    bar_sync(active);
    PHASE_MARK(4);  // waiting for the panel
    // the trailing tiles: the panel's rank-8 update, one column at a time
    if (owns && tj > p) {
#pragma unroll
      for (int k = 0; k < TILE; ++k) {
        const float4* xr = reinterpret_cast<const float4*>(&pan[k][ti * TILE]);
        const float4* yc = reinterpret_cast<const float4*>(&pan[k][tj * TILE]);
        const float4 x0 = xr[0], x1 = xr[1], y0 = yc[0], y1 = yc[1];
        const float x[TILE] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float y[TILE] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < TILE; ++i)
#pragma unroll
          for (int c = 0; c < TILE; ++c) a[i][c] = fmaf(-x[i], y[c], a[i][c]);
      }
    }
    PHASE_MARK(5);  // trailing update
  }
  if (owns) store_tiles(l, a, n, ti, tj, l_sr, l_sc, vec != 0);
#ifdef CHOL_PHASE_CLOCKS
  PHASE_MARK(6);  // store
  if (threadIdx.x == blockDim.x - 1) {
    for (int i = 0; i < CHOL_PHASES; ++i) atomicAdd(&g_chol_cycles[i], clk_sum[i]);
    atomicAdd(&g_chol_cycles[CHOL_PHASES], 1ULL);
  }
#endif
}

// One block factors one matrix in shared memory (any n up to chol_max_n()).
// m and l may alias.
__global__ void __launch_bounds__(FACTOR_THREADS) chol_factor_smem_kernel(
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
          if (r < n && c <= r) a[tri(r, c)] = fmaf(-cr[q], cc, a[tri(r, c)]);
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

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

int launch_tile(const float* m, float* l, int n, int batch, long long m_sr,
                long long m_sc, long long m_sb, long long l_sr, long long l_sc,
                long long l_sb, cudaStream_t stream) {
  const bool vec = n % TILE == 0 && m_sc == 1 && l_sc == 1 && m_sr % 4 == 0 &&
                   l_sr % 4 == 0 && m_sb % 4 == 0 && l_sb % 4 == 0 &&
                   aligned16(m) && aligned16(l);
  if (CHOL_EXTRA_SMEM > 0) {
    static int have[MAX_DEVICES] = {};
    const cudaError_t err = ensure_smem(chol_factor_kernel, have, CHOL_EXTRA_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_factor_kernel<<<batch, tile_threads(n), CHOL_EXTRA_SMEM, stream>>>(
      m, l, n, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int launch_smem(const float* m, float* l, int n, int batch, long long m_sr,
                long long m_sc, long long m_sb, long long l_sr, long long l_sc,
                long long l_sb, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  static int have[MAX_DEVICES] = {};
  cudaError_t err = ensure_smem(chol_factor_smem_kernel, have, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_factor_smem_kernel<<<batch, FACTOR_THREADS, smem, stream>>>(
      m, l, n, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest n the kernels take: the matrix must fit a block's shared memory
// (the shared-triangle factor and the solve).  Asked once, when the library
// is loaded.
int chol_max_n() {
  int n = 1;
  while (smem_bytes(n + 1) <= 232448) ++n;
  return n;
}

// Largest n chol_factor gives the register-tile kernel; above it, the
// shared-triangle kernel.
int chol_factor_tile_max_n() { return TILE_MAX_N; }

// Factor `batch` matrices on `stream`.  Element (r, c) of matrix b is at
// m[r * m_sr + c * m_sc + b * m_sb] (strides in elements); l likewise, and
// l may be m.  n <= chol_factor_tile_max_n() launches the register-tile
// kernel, a larger n the shared-triangle kernel.  Returns the CUDA error of
// the launch (0 = launched).
int chol_factor(const float* m, float* l, int n, int batch, long long m_sr,
                long long m_sc, long long m_sb, long long l_sr, long long l_sc,
                long long l_sb, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= TILE_MAX_N)
    return launch_tile(m, l, n, batch, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb, st);
  return launch_smem(m, l, n, batch, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb, st);
}

// chol_factor through the shared-triangle kernel at any n (to compare the
// two kernels on the same matrices).
int chol_factor_shared(const float* m, float* l, int n, int batch,
                       long long m_sr, long long m_sc, long long m_sb,
                       long long l_sr, long long l_sc, long long l_sb,
                       void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return launch_smem(m, l, n, batch, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb,
                     static_cast<cudaStream_t>(stream));
}

// What the factor kernel that takes n (the shared-triangle kernel if
// `shared` is not 0) is compiled to and how many of its blocks of that n
// an SM holds: registers a thread, local bytes a thread, static and dynamic
// shared bytes a block, threads a block, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int chol_factor_attributes(int n, int shared, int* num_regs, int* local_bytes,
                           int* static_smem, int* dynamic_smem, int* threads,
                           int* blocks_per_sm) {
  const bool tile = !shared && n <= TILE_MAX_N;
  cudaFuncAttributes fa;
  cudaError_t err = tile ? cudaFuncGetAttributes(&fa, chol_factor_kernel)
                         : cudaFuncGetAttributes(&fa, chol_factor_smem_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nthreads = tile ? tile_threads(n) : FACTOR_THREADS;
  const size_t dyn = tile ? CHOL_EXTRA_SMEM : smem_bytes(n);
  static int have_tile[MAX_DEVICES] = {}, have_smem[MAX_DEVICES] = {};
  err = tile ? ensure_smem(chol_factor_kernel, have_tile, dyn)
             : ensure_smem(chol_factor_smem_kernel, have_smem, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0;
  err = tile ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, chol_factor_kernel,
                                                             nthreads, dyn)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &nb, chol_factor_smem_kernel, nthreads, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = fa.numRegs;
  *local_bytes = static_cast<int>(fa.localSizeBytes);
  *static_smem = static_cast<int>(fa.sharedSizeBytes);
  *dynamic_smem = static_cast<int>(dyn);
  *threads = nthreads;
  *blocks_per_sm = nb;
  return 0;
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

#ifdef CHOL_PHASE_CLOCKS
// The tile kernel's cycles by phase since the last call, summed over the
// blocks (out[CHOL_PHASES]), and the blocks (out[CHOL_PHASES]); zeroes them.
int chol_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_chol_cycles, sizeof(g_chol_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[CHOL_PHASES + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_chol_cycles, zero, sizeof(zero)));
}
#endif

}  // extern "C"
