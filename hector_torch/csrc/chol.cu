// Batched Cholesky factor and Cholesky solve of small SPD matrices (n = 120
// on the dense interior point's path, 288 at horizon 24), one thread block
// per matrix.  CUDA C++ for sm_90a, plain C entry points (loaded with ctypes
// by hector_torch/qp/chol.py).
//
// Replaces the two Pallas TPU kernels of hector/qp/pallas_chol.py:
//   chol_factor_kernel         <-  _chol_kernel  (:48, pl.pallas_call at :129,
//   (chol_factor_cluster_kernel    reached through cholesky_nnb :114)
//    above 248)
//   chol_solve_kernel          <-  _solve_kernel (:77, pl.pallas_call at :156,
//   (chol_solve_stream_kernel      reached through cholesky_solve_nnb :146)
//    above 248)
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
// dependent pivots (factor) or 2n dependent divides (solve), and the on-chip
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
// Tiles.  The tile kernels cut the matrix into 8 x 8 tiles, T = ceil(n / 8)
// tile rows, and number the T (T + 1) / 2 lower tiles down the tile columns
// (tile (I, J), I >= J).  A ragged edge is padded with an identity (pivot
// 1, zeros), which never reaches a real entry.  Loads and stores: with a
// unit column stride, row and batch strides that are multiples of 4,
// 16-byte aligned pointers and n a multiple of 8 (the (B, 120, 120)
// tensors of the interior point), each tile row is two 16-byte accesses and
// no address needs a divide; the cluster factor also takes n a multiple of
// 4 so (every n = 12 h of the interior point), each half row one 16-byte
// access or none past the edge; otherwise element by element,
// bounds-checked (slower: profile_chol_kernel.py times n = 249 beside 252).
//
// The factor, n <= 248 (chol_factor_kernel): register tiles.
//   - Each lower tile lives in the 64 registers of one thread for the whole
//     factorization (n = 120: 15 x 15 grid, 120 tiles, 4 warps).  The work
//     of a panel sits on the warps of the later columns, not spread as idle
//     lanes over all of them, and a warp whose columns are final leaves the
//     panel loop, writes its tiles back and is done (a panel's barriers
//     count only the warps still in the loop).
//   - Blocked right-looking order, one 8-wide panel at a time: the thread
//     of the diagonal tile factors it alone in registers and publishes L
//     and the 8 pivot reciprocals; the threads of the tile column below it
//     solve their tiles against it and publish the panel (transposed, so
//     a tile's 8 rows are two float4 reads); every trailing tile then
//     takes its rank-8 update in registers, 16 shared loads (4 float4)
//     feeding 64 FMAs a column.  2 barriers a panel (28 at n = 120).
//   - The rounding is the column-by-column kernel's, entry by entry: every
//     entry takes its contributions in column order j = 0, 1, ..., one FMA
//     each (a -= L[r][j] L[c][j]), then the scaling by the IEEE
//     1.0f / sqrtf(pivot) of its column.  A panel's contributions are never
//     summed first.  So the result is the shared-triangle kernel's, bit for
//     bit, and chip_smoke.py checks that.
//   - Registers: __launch_bounds__(512, 1) caps a thread at 128, so at
//     n = 120 (128 threads) four blocks fit an SM.
//   - What bounds it now is each block's chain of panels, not bytes: 0.316
//     ms for 4,096 matrices against the 0.106 ms byte bound (H100 80GB
//     HBM3, 700 W).  The diagonal tile's 8 square roots and divides in one
//     thread, and the wait for them, take about 45 % of the last warp's
//     cycles; the four blocks an SM hide part of the chain (held to two,
//     the kernel is 1.46x slower; profile_chol_kernel.py).
//
// The factor, 248 < n <= 339 (chol_factor_cluster_kernel; n = 288 at
// horizon 24): the register-tile kernel spread over a thread-block cluster
// of two blocks, one matrix a cluster.
//   - One lower tile a thread in registers, as above; a block holds at most
//     512 tiles, a cluster 1,024 (T <= 44, n <= 352; n = 288: 666 tiles,
//     352 threads a block).  Block r holds the tile columns J with
//     J % 2 == r (numbered down its columns), so both keep work as the
//     panels' active set shrinks, and the diagonal tile (p, p) and the
//     tile column below it sit in one block, the panel's owner p % 2.
//   - Panel p: the owner factors the diagonal tile and solves the column
//     below it behind its own counting barrier (bar.sync 1, its warps
//     still in the loop), as the tile kernel does; the column's threads
//     write the panel into their own block's shared memory and through
//     distributed shared memory (mapa) into the partner's; one cluster
//     barrier (barrier.cluster.arrive / wait: release / acquire at cluster
//     scope) publishes it; every trailing tile of both blocks takes its
//     rank-8 update from its own block's copy.  The panel buffer
//     alternates with the parity of p, so the owner of panel p + 1 writes
//     while the partner still reads panel p; the cluster barrier between
//     panels p and p + 2 keeps each buffer's reads before its next writes.
//   - A warp whose tiles are final leaves the loop and writes them back,
//     then only arrives at the cluster barriers left: every thread takes
//     part in every cluster barrier, so none counts on how exited threads
//     are treated, and no block exits before the last one, after which
//     nothing is written to another block.  A cluster barrier after the
//     loads makes sure both blocks have started.
//   - One cluster barrier and one block barrier a panel (36 panels at
//     n = 288) against the shared-triangle kernel's two block barriers a
//     column (576), and each update from registers: 16 shared loads (4
//     float4) a column for 64 FMAs, no shared stores.
//   - The rounding is the tile kernel's (factor_diag, solve_cols,
//     update_rank8 as they are), so the result is the shared-triangle
//     kernel's bit for bit, and the tile kernel's at n <= 248
//     (chol_factor_cluster launches it at any n up to 352).
//   - Registers: __launch_bounds__(512, 1), at most 128 a thread: one
//     block an SM, a cluster on two SMs, 66 matrices in flight on 132 SMs.
//   - What bounds it is each cluster's chain of panels, not bytes: at
//     1,024 x n = 288, 1.39-1.41 ms against the 0.152 ms byte bound (the
//     shared-triangle kernel 6.28 ms, torch.linalg.cholesky 2.75-2.79 ms;
//     H100 80GB HBM3, 700 W).  A matrix takes about 182 K SM cycles, 95 %
//     of them its 35 panels, each about 4,900: the diagonal tile's factor
//     28 %, its update by the panel before 27 %, the cluster barrier 24 %,
//     the column solve and its stores 15 % (profile_chol_kernel.py).
//
// chol_factor_smem_kernel (any n up to chol_max_n()): the lower triangle
// packed in shared memory (row r at r (r + 1) / 2; 229 KB at n = 339), 256
// threads sharing each column's rank-1 update, two barriers a column.  The
// route (the kernel above 248 until the cluster kernel replaced it) no
// longer takes it: chol_factor_shared launches it at any n, the yardstick
// the tile and cluster kernels are held to bit for bit.
//
// The solve, n <= 248 (chol_solve_kernel): register tiles, the factor's
// layout.  One lower tile of L per thread in registers, x and the pivots'
// reciprocals in shared memory.
//   - Forward, panel p: the thread of the diagonal tile solves its 8
//     entries of x in registers and publishes them (barrier); the threads
//     of tile column p below it each apply x_I -= L_Ip x_p to their own
//     tile row I, one writer a row (barrier).
//   - Back, panel p from the last: the diagonal tile solves with L_pp^T
//     (barrier); the threads of tile row p apply x_J -= L_pJ^T x_p for
//     J < p (barrier).  x goes out at the end, coalesced.
//   - 58 barriers at n = 120 against 240 (one a step) in the shared-memory
//     solve; the divides sit 8 to a thread in one chain, and take the fast
//     path below, three dependent operations each instead of a divide's.
//   - Rounding: each entry takes its contributions in the shared-memory
//     solve's order, one FMA each (forward: columns 0, 1, ..., then the
//     IEEE divide by the pivot; back: columns in descending order, then the
//     divide), so x is that kernel's, bit for bit.
//   - What bounds it: each block's chain of 28 diagonal steps and barriers;
//     held to 3 and 2 blocks an SM instead of 4 it is 1.3x and 1.7x slower
//     (profile_chol_kernel.py).  0.124 ms for 4,096 matrices at n = 120
//     against the 0.037 ms byte bound, the shared-memory solve 0.357 and
//     torch.cholesky_solve 1.449 (H100 80GB HBM3, 700 W).
//
// The solve, 248 < n <= 339 (chol_solve_stream_kernel; n = 288 at horizon
// 24): L streamed through shared memory a panel at a time, eight matrices an
// SM.
//   - What bounds it: bytes.  Each sweep reads each element of L once for
//     one FMA, so L is never on chip whole: the two sweeps read the triangle
//     twice (333 KB a matrix at n = 288; 1,024 of them do not fit L2), 0.102
//     ms for 1,024 matrices at 3.35 TB/s against the 0.052 ms bound of one
//     read.  The shared-memory solve below held the 167.6 KB triangle in
//     shared memory: one block an SM, eight waves, its load paid in full
//     before its 576 barrier steps.
//   - One block of 4 warps a matrix; shared memory holds x (padded with
//     zeros to 8 T), the pivots' reciprocals and a ring of two panel
//     buffers (20.7 KB at n = 288), so 8 blocks fit an SM and 1,024
//     matrices run in one wave; a block waiting on its copies or on its
//     diagonal step is covered by the seven others.
//   - Each step copies the panel of the step after it with cp.async
//     (16-byte chunks through L2 where rows are 16-byte aligned and
//     n % 4 == 0, element by element otherwise; nothing above the diagonal
//     but the rest of a chunk), issued by warps 1-3 while thread 0 takes
//     the diagonal step, one group a step, waited for at the next step's
//     start, then a block barrier.  Forward, step p: tile column p,
//     rows 8 p ... n - 1, 32 B a row; the thread of the diagonal tile solves
//     x_p (barrier); every row r >= 8 (p + 1) applies x_r -= L_rp x_p.  Back,
//     step p from the last: tile row p, columns 0 ... 8 p + 7; the diagonal
//     tile solves x_p against L_pp^T (the last one forward and back in one
//     step, as the tile solve does); every column c < 8 p applies
//     x_c -= L_pc^T x_p.  2 barriers a step, 2 T - 1 steps.
//   - Rounding: forward_diag / back_diag and their IEEE fallback as the tile
//     solve runs them, the updates one FMA a column in the shared-triangle
//     solve's order, so x is that kernel's bit for bit (and the tile
//     solve's: chol_solve_stream launches it at any n).
//   - 0.187 ms for 1,024 matrices at n = 288 (1.82 TB/s), against 1.624 ms
//     for the shared-memory solve and 1.317 ms for torch.cholesky_solve
//     (H100 80GB HBM3, 700 W).  Held to 4 blocks an SM it is 2 % slower,
//     to 2 36 %: past 4 blocks the memory, not the chains, bounds it
//     (profile_chol_kernel.py).
//
// chol_solve_smem_kernel (any n up to chol_max_n()): L's packed lower
// triangle in shared memory, x[t] in a register of thread t, one x[j]
// broadcast per step through a double-buffered shared slot: one barrier per
// step.  The route (the solve above 248 until the streaming kernel replaced
// it) no longer takes it: chol_solve_shared launches it at any n, the
// yardstick the tile and streaming solves are held to bit for bit.
//
// Every kernel is chosen by n in its C entry point (chol_factor_route,
// chol_solve_route), never on a failure.
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

// ---- register tiles (factor and solve) ----
constexpr int TILE = 8;
constexpr int TILE_MAX_THREADS = 512;  // 16 warps
constexpr int TILE_MAX_T = 31;         // 31 * 32 / 2 = 496 tiles <= 512 threads
constexpr int TILE_MAX_N = TILE * TILE_MAX_T;  // 248

// ---- the cluster factor: register tiles over a cluster of two blocks ----
constexpr int CLUSTER = 2;            // blocks a matrix
constexpr int CLUSTER_MAX_T = 44;     // block 0: 44 + 42 + ... + 2 = 506 tiles <= 512
constexpr int CLUSTER_MAX_N = TILE * CLUSTER_MAX_T;  // 352
constexpr int PAN_N = CLUSTER_MAX_N;  // row stride of a panel buffer
constexpr int PAN_BUFS = 2;           // panel buffers, by the parity of the panel

// ---- shared-triangle factor and solve ----
constexpr int FACTOR_THREADS = 256;  // 8 warps
constexpr int FACTOR_ROWS = 4;       // rows a warp updates together

constexpr size_t BLOCK_SMEM_MAX = 232448;  // bytes of shared memory a block may hold

// ---- the streaming solve ----
constexpr int STREAM_THREADS = 128;   // 4 warps
constexpr int STREAM_MIN_BLOCKS = 8;  // blocks an SM: 8 x 132 SMs >= 1,024 matrices
constexpr int STREAM_BUFS = 2;        // panel buffers in the ring

// the kernels, as chol_kernel_attributes and the routes number them
enum KernelId {
  FACTOR_TILE, FACTOR_SHARED, SOLVE_TILE, SOLVE_SHARED, FACTOR_CLUSTER, SOLVE_STREAM
};

// offset of element (r, c), c <= r, in the packed lower triangle
__host__ __device__ inline int tri(int r, int c) { return r * (r + 1) / 2 + c; }

// bytes of dynamic shared memory: the packed lower triangle and one column
// (factor) or broadcast slot (solve)
inline size_t smem_bytes(int n) {
  return (static_cast<size_t>(tri(n, 0)) + n) * sizeof(float);
}

__host__ __device__ inline int tile_rows(int n) { return (n + TILE - 1) / TILE; }

__host__ __device__ inline int tile_count(int n) {
  const int t = tile_rows(n);
  return t * (t + 1) / 2;
}

// coordinates (ti, tj) of tile g; tj == nt: none (g past the last tile)
__device__ __forceinline__ void tile_coords(int g, int nt, int& ti, int& tj) {
  int first = 0;
  tj = 0;
  while (tj < nt && g >= first + nt - tj) {
    first += nt - tj;
    ++tj;
  }
  ti = tj + g - first;
}

// threads of the register-tile kernels at n: one a lower tile, whole warps
inline int tile_threads(int n) { return (tile_count(n) + 31) / 32 * 32; }

// The cluster factor's tiles: block `rank` holds the tile columns J with
// J % CLUSTER == rank, numbered down its columns.  Its tiles in the columns
// before p (p = nt: all of them).
__host__ __device__ inline int cluster_tiles_before(int nt, int rank, int p) {
  int s = 0;
  for (int j = rank; j < p; j += CLUSTER) s += nt - j;
  return s;
}

// coordinates (ti, tj) of tile g of block `rank`; tj >= nt: none
__device__ __forceinline__ void cluster_tile_coords(int g, int nt, int rank, int& ti,
                                                    int& tj) {
  tj = rank;
  while (tj < nt && g >= nt - tj) {
    g -= nt - tj;
    tj += CLUSTER;
  }
  ti = tj + g;
}

// threads of each block of the cluster factor at n: block 0 holds the most
// tiles
inline int cluster_threads(int n) {
  const int t = tile_rows(n);
  return (cluster_tiles_before(t, 0, t) + 31) / 32 * 32;
}

// its dynamic shared memory: the panel buffers and the diagonal tile
constexpr size_t CLUSTER_SMEM =
    (PAN_BUFS * TILE * PAN_N + (TILE + 1) * TILE) * sizeof(float);

// The streaming solve's dynamic shared memory at n: x and the pivots'
// reciprocals (8 T floats each) and STREAM_BUFS panel buffers of 8 x 8 T
// (20,736 B at n = 288)
inline size_t stream_smem_bytes(int n) {
  return static_cast<size_t>(2 + STREAM_BUFS * TILE) * TILE * tile_rows(n) * sizeof(float);
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
// identity's.  `vec`: unit column stride, 16-byte aligned rows, and n % 8 ==
// 0, or with `Halves` n % 4 == 0: each half row of 4 then lies wholly inside
// the matrix or wholly past its edge, and moves as one float4 or not at all
// (the cluster factor; every n = 12 h of the interior point).
template <bool Halves = false>
__device__ __forceinline__ void load_tile(Tile& a, const float* m, int n, int ti,
                                          int tj, long long sr, long long sc,
                                          bool vec) {
  const int r0 = ti * TILE, c0 = tj * TILE;
  if (vec && Halves) {
#pragma unroll
    for (int i = 0; i < TILE; ++i)
#pragma unroll
      for (int h = 0; h < TILE; h += 4) {
        const int r = r0 + i, c = c0 + h;
        const float4 x = (r < n && c < n)
                             ? *reinterpret_cast<const float4*>(m + r * sr + c)
                             : make_float4(r == c, r == c + 1, r == c + 2, r == c + 3);
        a[i][h] = x.x; a[i][h + 1] = x.y; a[i][h + 2] = x.z; a[i][h + 3] = x.w;
      }
    return;
  }
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
// `vec` and `Halves` as load_tile.
template <bool Halves = false>
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
  if (vec && Halves) {
#pragma unroll
    for (int i = 0; i < TILE; ++i)
#pragma unroll
      for (int h = 0; h < TILE; h += 4) {
        const int r = r0 + i, c = c0 + h;
        if (r < n && c < n)
          *reinterpret_cast<float4*>(l + r * sr + c) =
              make_float4(v[i][h], v[i][h + 1], v[i][h + 2], v[i][h + 3]);
      }
    return;
  }
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

// Write the final tile (ti, tj) of L and, below the diagonal, the zero tile
// (tj, ti) above it.
template <bool Halves = false>
__device__ __forceinline__ void store_tiles(float* l, const Tile& a, int n, int ti,
                                            int tj, long long sr, long long sc,
                                            bool vec) {
  store_tile<Halves>(l, a, n, ti, tj, sr, sc, vec, false);
  if (ti != tj) store_tile<Halves>(l, a, n, tj, ti, sr, sc, vec, true);
}

// Eight floats from 16-byte aligned shared memory, and back.
__device__ __forceinline__ void get8(float (&v)[TILE], const float* s) {
  const float4 x = reinterpret_cast<const float4*>(s)[0];
  const float4 y = reinterpret_cast<const float4*>(s)[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

__device__ __forceinline__ void put8(float* s, const float (&v)[TILE]) {
  reinterpret_cast<float4*>(s)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(s)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Write `a` to shared memory column by column, column k at s + k * ks
// (s[k * ks + i] = a[i][k]).
__device__ __forceinline__ void put_cols(float* s, const Tile& a, int ks) {
#pragma unroll
  for (int k = 0; k < TILE; ++k) {
    const float c[TILE] = {a[0][k], a[1][k], a[2][k], a[3][k],
                           a[4][k], a[5][k], a[6][k], a[7][k]};
    put8(s + k * ks, c);
  }
}

// The factor's three tile steps.  Each entry takes its contributions in
// column order, one FMA each, then its column's pivot scaling.

// a <- its lower Cholesky factor, column by column (the entries above the
// diagonal are left as they are); inv[k] <- the 8 pivot reciprocals
__device__ __forceinline__ void factor_diag(Tile& a, float* inv) {
#pragma unroll
  for (int k = 0; k < TILE; ++k) {
    const float r = 1.0f / sqrtf(a[k][k]);
#pragma unroll
    for (int i = k; i < TILE; ++i) a[i][k] *= r;
#pragma unroll
    for (int c = k + 1; c < TILE; ++c)
#pragma unroll
      for (int i = c; i < TILE; ++i) a[i][c] = fmaf(-a[i][k], a[c][k], a[i][c]);
    inv[k] = r;
  }
}

// a <- a L^-T for the factored diagonal tile L, given column by column
// (dg[8 k + c] = L[c][k]) with its pivot reciprocals inv
__device__ __forceinline__ void solve_cols(Tile& a, const float* dg, const float* inv) {
#pragma unroll
  for (int k = 0; k < TILE; ++k) {
    float lk[TILE];
    get8(lk, dg + k * TILE);
    const float r = inv[k];
#pragma unroll
    for (int i = 0; i < TILE; ++i) a[i][k] *= r;
#pragma unroll
    for (int c = k + 1; c < TILE; ++c)
#pragma unroll
      for (int i = 0; i < TILE; ++i) a[i][c] = fmaf(-a[i][k], lk[c], a[i][c]);
  }
}

// a <- a - X Y^T for two tiles of the panel given column by column, column
// k of X at x + k * ks and of Y at y + k * ks
__device__ __forceinline__ void update_rank8(Tile& a, const float* x, const float* y,
                                             int ks) {
#pragma unroll
  for (int k = 0; k < TILE; ++k) {
    float xk[TILE], yk[TILE];
    get8(xk, x + k * ks);
    get8(yk, y + k * ks);
#pragma unroll
    for (int i = 0; i < TILE; ++i)
#pragma unroll
      for (int c = 0; c < TILE; ++c) a[i][c] = fmaf(-xk[i], yk[c], a[i][c]);
  }
}

// Profiling switches, for profile_chol_kernel.py (the default build has
// none).  CHOL_PHASE_CLOCKS: the register-tile factor block's last thread,
// whose warp stays in the panel loop to the end, adds the SM cycles since
// its last mark to the phase it leaves (g_chol_cycles[CHOL_PHASES] counts
// the blocks).  CHOL_STEP_CLOCKS: thread 0 of each of the first
// CHOL_STEP_BLOCKS blocks of the register-tile solve writes the SM clock at its start, after each barrier and at its
// end (g_chol_steps), a timeline of the block's steps.  CHOL_EXTRA_SMEM:
// bytes of dynamic shared memory the register-tile kernels' launches ask for
// and leave unused, to hold an SM to fewer blocks.
// CHOL_PHASE_CLOCKS also clocks the cluster factor's chain of panels, each
// step by the thread on it (g_chol_cluster_cycles, CLUSTER_PHASES of them,
// then the matrices): panel p starts when the cluster barrier of panel
// p - 1 lets the thread of the diagonal tile (p, p) go; it updates that tile
// (phase 1) and factors it (2); the thread of tile (p + 1, p), in the same
// block and so on the same SM clock, leaves the block barrier (3: from the
// diagonal tile's end), solves and writes the panel to both blocks (4) and
// waits at the cluster barrier (5), which starts panel p + 1.  The thread
// of the last tile clocks the loads and the first cluster barrier (0), its
// store (6) and its whole run (7).
// CHOL_PHASE_CLOCKS also clocks the two solves above 248, by thread 0 of each
// block (g_chol_solve_cycles[kernel], SOLVE_PHASES of them, then the
// blocks): the shared-memory solve's load (0), forward sweep (1), back sweep
// (2) and store (3); the streaming solve's thread 0, which takes every
// diagonal step: its prologue (0: the first panel issued, x and the
// reciprocals loaded), its waits for its copies (1), the barrier after them
// (2), the diagonal steps (3), issuing the next panel (4), the barrier after
// the diagonal step (5), its own updates (6) and the store (7).
#ifdef CHOL_PHASE_CLOCKS
constexpr int CHOL_PHASES = 7;
__device__ unsigned long long g_chol_cycles[CHOL_PHASES + 1];
constexpr int CLUSTER_PHASES = 8;
__device__ unsigned long long g_chol_cluster_cycles[CLUSTER_PHASES + 1];
constexpr int SOLVE_PHASES = 8;
__device__ unsigned long long g_chol_solve_cycles[2][SOLVE_PHASES + 1];
#define PHASE_MARK(i)                      \
  if (threadIdx.x == blockDim.x - 1) {     \
    const long long now = clock64();       \
    clk_sum[i] += now - clk_last;          \
    clk_last = now;                        \
  }
#else
#define PHASE_MARK(i)
#endif
#ifdef CHOL_STEP_CLOCKS
constexpr int CHOL_STEP_BLOCKS = 4096, CHOL_STEPS = 96;
__device__ long long g_chol_steps[CHOL_STEP_BLOCKS * CHOL_STEPS];
#define STEP_START int step_ = 0; STEP_MARK
#define STEP_MARK                                                        \
  if (threadIdx.x == 0 && blockIdx.x < CHOL_STEP_BLOCKS)                 \
    g_chol_steps[blockIdx.x * CHOL_STEPS + min(step_, CHOL_STEPS - 1)] = \
        clock64();                                                       \
  ++step_;
#else
#define STEP_START
#define STEP_MARK
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

// The barrier of the thread-block cluster: every thread of the cluster that
// has not exited arrives (release) and waits (acquire), so what a thread
// wrote to its own or the partner's shared memory before it is seen after
// it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" ::: "memory");
}

// The address of `p` (in this block's shared memory) in the shared memory
// of block `rank` of the cluster (distributed shared memory, a generic
// address).
__device__ __forceinline__ float* cluster_map(float* p, unsigned rank) {
  float* r;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(p), "r"(rank));
  return r;
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

  // this thread's tile (ti, tj); tj == nt: none (the last warp's spare
  // threads)
  int ti, tj;
  tile_coords(threadIdx.x, nt, ti, tj);
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
      factor_diag(a, dg[TILE]);
      put_cols(dg[0], a, TILE);
    }
    PHASE_MARK(1);  // diagonal factor
    if (p == nt - 1) break;
    const int active = blockDim.x - (p * nt - p * (p - 1) / 2) / 32 * 32;
    bar_sync(active);
    PHASE_MARK(2);  // waiting for the diagonal tile
    // the tile column below it: a <- a L_pp^-T, column by column
    if (owns && tj == p && ti > p) {
      solve_cols(a, dg[0], dg[TILE]);
      put_cols(&pan[0][ti * TILE], a, TILE_MAX_N);
    }
    PHASE_MARK(3);  // column solve
    bar_sync(active);
    PHASE_MARK(4);  // waiting for the panel
    // the trailing tiles: the panel's rank-8 update, one column at a time
    if (owns && tj > p) update_rank8(a, &pan[0][ti * TILE], &pan[0][tj * TILE], TILE_MAX_N);
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

#ifdef CHOL_PHASE_CLOCKS
#define CLK(...) __VA_ARGS__
// thread 0 adds the SM cycles since its last mark to phase i of sclk
#define SOLVE_MARK(i)                 \
  if (threadIdx.x == 0) {             \
    const long long now = clock64();  \
    sclk[i] += now - slast;           \
    slast = now;                      \
  }
// and, at its end, adds them to kernel k's sums
#define SOLVE_CLOCKS_OUT(k)                                                    \
  if (threadIdx.x == 0) {                                                      \
    for (int i = 0; i < SOLVE_PHASES; ++i)                                     \
      atomicAdd(&g_chol_solve_cycles[k][i], static_cast<unsigned long long>(sclk[i])); \
    atomicAdd(&g_chol_solve_cycles[k][SOLVE_PHASES], 1ULL);                    \
  }
#else
#define CLK(...)
#define SOLVE_MARK(i)
#define SOLVE_CLOCKS_OUT(k)
#endif

// One cluster of CLUSTER blocks factors one matrix, one lower 8 x 8 tile per
// thread (n <= CLUSTER_MAX_N; blockDim.x = cluster_threads(n), CLUSTER
// blocks a matrix, CLUSTER_SMEM bytes of dynamic shared memory).  m and l
// may alias.  `vec` as load_tile<true> (half rows).
__global__ void __launch_bounds__(TILE_MAX_THREADS, 1) chol_factor_cluster_kernel(
    const float* m, float* l, int n, long long m_sr, long long m_sc,
    long long m_sb, long long l_sr, long long l_sc, long long l_sb, int vec) {
  // pan + (p % PAN_BUFS) * TILE * PAN_N, [k][r]: L[r][8 p + k] of the tile
  // column below the diagonal tile (p, p) of panel p; dg, [k][c]:
  // L[8 p + c][8 p + k] of the diagonal tile, c > k, then [8][k], its 8
  // pivot reciprocals (written and read only in the panel's owner)
  extern __shared__ __align__(16) float csmem[];
  float* const pan = csmem;
  float* const dg = csmem + PAN_BUFS * TILE * PAN_N;
  const int nt = tile_rows(n);
  // a cluster is CLUSTER consecutive blocks of the grid: matrix `mat`, and
  // this block's rank in it
  const int rank = blockIdx.x % CLUSTER;
  const long long mat = blockIdx.x / CLUSTER;

  // this thread's tile (ti, tj); tj >= nt: none
  int ti, tj;
  cluster_tile_coords(threadIdx.x, nt, rank, ti, tj);
  const bool owns = tj < nt;
  const int mine = cluster_tiles_before(nt, rank, nt);  // this block's tiles
  const int warps = (mine + 31) / 32;                   // its warps holding any
  // the last tile column of this thread's warp (-1: it holds no tile): after
  // that panel its tiles are final, and the warp leaves the loop and writes
  // them back
  int wlast = -1;
  if (static_cast<int>(threadIdx.x & ~31u) < mine) {
    int wi;
    cluster_tile_coords(min(static_cast<int>(threadIdx.x | 31u), mine - 1), nt, rank,
                        wi, wlast);
  }
  CLK(__shared__ long long clk_diag_end;  // this block's diagonal tile done
      long long clk[CLUSTER_PHASES] = {};
      const long long clk_start = clock64();
      const bool clk_last = ti == nt - 1 && tj == nt - 1;
      long long clk_go, clk_upd, clk_solved = 0;)

  Tile a;
  if (owns) load_tile<true>(a, m + mat * m_sb, n, ti, tj, m_sr, m_sc, vec != 0);
  // both blocks have started (their shared memory may be written to) and
  // every tile is loaded (l may be m)
  cluster_sync();
  CLK(clk_go = clk_upd = clock64();
      if (clk_last) clk[0] += clk_go - clk_start;)

  // this block's tiles in the tile columns before panel p, at its own panels
  int before = 0;
  for (int p = 0; p <= wlast; ++p) {
    float* const pb = pan + (p % PAN_BUFS) * TILE * PAN_N;
    // the diagonal tile, in registers, column by column
    if (owns && ti == p && tj == p) {
      factor_diag(a, dg + TILE * TILE);
      put_cols(dg, a, TILE);
      CLK(clk_diag_end = clock64(); clk[1] += clk_upd - clk_go;
          clk[2] += clk_diag_end - clk_upd;)
    }
    if (p == nt - 1) break;
    const bool solver = owns && tj == p && ti > p;
    if (p % CLUSTER == rank) {
      // this block's panel, behind a barrier of its warps still in the loop:
      // the tile column below the diagonal tile, a <- a L_pp^-T, written to
      // both blocks' panel buffer
      bar_sync(32 * (warps - before / 32));
      before += nt - p;
      CLK(if (solver && ti == p + 1) clk[3] += (clk_solved = clock64()) - clk_diag_end;)
      if (solver) {
        solve_cols(a, dg, dg + TILE * TILE);
        put_cols(pb + ti * TILE, a, PAN_N);
        put_cols(cluster_map(pb + ti * TILE, (rank + 1) % CLUSTER), a, PAN_N);
      }
      CLK(if (solver && ti == p + 1) {
            const long long now = clock64();
            clk[4] += now - clk_solved;
            clk_solved = now;
          })
    }
    cluster_sync();
    CLK(clk_go = clock64();
        if (solver && ti == p + 1) clk[5] += clk_go - clk_solved;)
    // the trailing tiles of both blocks: the panel's rank-8 update from this
    // block's copy, one column at a time
    if (owns && tj > p) update_rank8(a, pb + ti * TILE, pb + tj * TILE, PAN_N);
    CLK(clk_upd = clock64();)
  }
  CLK(const long long clk_store = clock64();)
  if (owns) store_tiles<true>(l + mat * l_sb, a, n, ti, tj, l_sr, l_sc, vec != 0);
  // then it takes part in the cluster barriers of the panels left, so that
  // every thread of the cluster arrives at all nt - 1 of them
  for (int p = wlast + 1; p < nt - 1; ++p) cluster_sync();
  CLK(if (clk_last) {
        const long long now = clock64();
        clk[6] += now - clk_store;
        clk[7] += now - clk_start;
        atomicAdd(&g_chol_cluster_cycles[CLUSTER_PHASES], 1ULL);
      }
      for (int i = 0; i < CLUSTER_PHASES; ++i)
        if (clk[i] != 0)
          atomicAdd(&g_chol_cluster_cycles[i], static_cast<unsigned long long>(clk[i]));)
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

// The solve's divides.  x / d is IEEE-rounded; with r = 1 / d (IEEE-rounded,
// computed once per pivot when L is loaded) the FMA correction of x r
// (Markstein) gives the same quotient in three dependent operations instead
// of a divide's reciprocal, refinement, range check and branch, as long as
// no step leaves the normal range: |x| and |d| in [2^-60, 2^60], or x = +0
// (-0 would come out +0; a subnormal x is off by an ulp).  The fast path
// collects whether that held for every divide of a tile (`ok`); where it did
// not, solve_diag_ieee solves the tile again with IEEE divides, so the result
// is the divide's, bit for bit, always.
constexpr float DIV_LO = 0x1p-60f, DIV_HI = 0x1p60f;

// (bitwise & and |: with && and || the checks compiled to branches, which
// made the kernel markedly slower)
__device__ __forceinline__ bool div_in_range(float x) {
  const float ax = fabsf(x);
  return (ax >= DIV_LO) & (ax <= DIV_HI);
}

__device__ __forceinline__ float fast_divide(float x, float d, float r, bool& ok) {
  ok &= div_in_range(x) | ((x == 0.0f) & !signbit(x));
  const float q0 = x * r;
  return fmaf(fmaf(-d, q0, x), r, q0);
}

// v <- L^-1 v for the diagonal tile L in a, with rc[i] = 1 / L[i][i]: entry
// i takes columns 0, 1, ... of its row, one FMA each, then the divide by its
// pivot.
__device__ __forceinline__ void forward_diag(float (&v)[TILE], const Tile& a,
                                             const float (&rc)[TILE], bool& ok) {
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) v[i] = fmaf(-a[i][k], v[k], v[i]);
    v[i] = fast_divide(v[i], a[i][i], rc[i], ok);
  }
}

// v <- L^-T v likewise: entry i takes rows 7, 6, ... of its column, then the
// divide.
__device__ __forceinline__ void back_diag(float (&v)[TILE], const Tile& a,
                                          const float (&rc)[TILE], bool& ok) {
#pragma unroll
  for (int i = TILE - 1; i >= 0; --i) {
#pragma unroll
    for (int k = TILE - 1; k > i; --k) v[i] = fmaf(-a[k][i], v[k], v[i]);
    v[i] = fast_divide(v[i], a[i][i], rc[i], ok);
  }
}

// forward_diag and/or back_diag with IEEE divides, in place on x (shared
// memory), the tile with first row j0 read from L in device memory: rolled
// loops, so that the code of the fast path stays small (inlined, the unrolled
// fallback made the kernel markedly slower without ever running).  Entries past
// n, which the fast path pads with the identity, add nothing to a real entry
// and are left as they are (+0).
__device__ __forceinline__ void solve_diag_ieee(float* x, const float* l, int n,
                                                int j0, long long sr, long long sc,
                                                bool fwd, bool back) {
  const int m = min(TILE, n - j0);
#pragma unroll 1
  for (int i = 0; fwd && i < m; ++i) {
    float v = x[i];
#pragma unroll 1
    for (int k = 0; k < i; ++k) v = fmaf(-l[(j0 + i) * sr + (j0 + k) * sc], x[k], v);
    x[i] = v / l[(j0 + i) * (sr + sc)];
  }
#pragma unroll 1
  for (int i = m - 1; back && i >= 0; --i) {
    float v = x[i];
#pragma unroll 1
    for (int k = m - 1; k > i; --k) v = fmaf(-l[(j0 + k) * sr + (j0 + i) * sc], x[k], v);
    x[i] = v / l[(j0 + i) * (sr + sc)];
  }
}

// The diagonal tile p's 8 entries of x in xs: the forward solve if `fwd`,
// then the back solve if `back`; fast divides with the pivot reciprocals
// rcs, and solve_diag_ieee if a fast one was out of range (or a pivot:
// !rc_ok).
__device__ __forceinline__ void solve_diag(float* xs, const float* rcs, const Tile& a,
                                           bool rc_ok, int p, bool fwd, bool back,
                                           const float* l, int n, long long sr,
                                           long long sc) {
  float v[TILE], rc[TILE];
  get8(v, xs + p * TILE);
  get8(rc, rcs + p * TILE);
  bool ok = rc_ok;
  if (fwd) forward_diag(v, a, rc, ok);
  if (back) back_diag(v, a, rc, ok);
  if (ok)
    put8(xs + p * TILE, v);
  else
    solve_diag_ieee(xs + p * TILE, l, n, p * TILE, sr, sc, fwd, back);
}

// One block solves L L^T x = rhs for one matrix, one lower 8 x 8 tile of L
// per thread (n <= 248; blockDim.x = tile_threads(n)).  x may alias rhs.
// `vec` as load_tile.
__global__ void __launch_bounds__(TILE_MAX_THREADS, 1) chol_solve_kernel(
    const float* l, const float* rhs, float* x, int n, long long l_sr,
    long long l_sc, long long l_sb, long long r_sn, long long r_sb,
    long long x_sn, long long x_sb, int vec) {
  __shared__ __align__(16) float xs[TILE_MAX_N];   // x, padded with zeros
  __shared__ __align__(16) float rcs[TILE_MAX_N];  // 1 / L[j][j]
  const int nt = tile_rows(n);
  l += static_cast<long long>(blockIdx.x) * l_sb;
  rhs += static_cast<long long>(blockIdx.x) * r_sb;
  x += static_cast<long long>(blockIdx.x) * x_sb;
  STEP_START
  int ti, tj;
  tile_coords(threadIdx.x, nt, ti, tj);
  const bool owns = tj < nt, diag = owns && ti == tj;

  Tile a;
  if (owns) load_tile(a, l, n, ti, tj, l_sr, l_sc, vec != 0);
  // the diagonal tile's pivot reciprocals, for the fast divides
  bool rc_ok = diag;
  if (diag) {
    float rc[TILE];
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      rc_ok &= div_in_range(a[i][i]);
      rc[i] = 1.0f / a[i][i];
    }
    put8(rcs + ti * TILE, rc);
  }
  for (int r = threadIdx.x; r < nt * TILE; r += blockDim.x)
    xs[r] = r < n ? rhs[r * r_sn] : 0.0f;
  __syncthreads();
  STEP_MARK

  // Past the edge L is the identity and x stays +0 (in a lane whose x is
  // finite), so a padded entry's term in a real one, fma(-(+0), +0, v), adds
  // -0 and leaves v as it is, bit for bit: no loop needs a bound.
  // forward, L y = rhs: x_p <- L_pp^-1 x_p, then x_I -= L_Ip x_p for I > p
  for (int p = 0; p < nt - 1; ++p) {
    if (diag && tj == p) solve_diag(xs, rcs, a, rc_ok, p, true, false, l, n, l_sr, l_sc);
    __syncthreads();
    STEP_MARK
    if (owns && tj == p && ti > p) {
      float xp[TILE], xi[TILE];
      get8(xp, xs + p * TILE);
      get8(xi, xs + ti * TILE);
#pragma unroll
      for (int k = 0; k < TILE; ++k)
#pragma unroll
        for (int i = 0; i < TILE; ++i) xi[i] = fmaf(-a[i][k], xp[k], xi[i]);
      put8(xs + ti * TILE, xi);
    }
    __syncthreads();
    STEP_MARK
  }
  // back, L^T x = y, from the last panel: x_p <- L_pp^-T x_p, final, then
  // x_J -= L_pJ^T x_p for J < p
  for (int p = nt - 1; p >= 0; --p) {
    if (diag && tj == p)
      solve_diag(xs, rcs, a, rc_ok, p, p == nt - 1, true, l, n, l_sr, l_sc);
    __syncthreads();
    STEP_MARK
    if (p == 0) break;
    if (owns && ti == p && tj < p) {
      float xp[TILE], xj[TILE];
      get8(xp, xs + p * TILE);
      get8(xj, xs + tj * TILE);
#pragma unroll
      for (int k = TILE - 1; k >= 0; --k)
#pragma unroll
        for (int c = 0; c < TILE; ++c) xj[c] = fmaf(-a[k][c], xp[k], xj[c]);
      put8(xs + tj * TILE, xj);
    }
    __syncthreads();
    STEP_MARK
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) x[r * x_sn] = xs[r];
  STEP_MARK
}

// One block solves L L^T x = rhs for one matrix, L's lower triangle in
// shared memory (any n up to chol_max_n()); blockDim.x >= n, thread t owns
// x[t].  x may alias rhs.
__global__ void chol_solve_smem_kernel(const float* l, const float* rhs, float* x,
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

  CLK(long long sclk[SOLVE_PHASES] = {}; long long slast = clock64();)

  for (int e = t; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e - r * n;
    if (c <= r) a[tri(r, c)] = l[r * l_sr + c * l_sc];
  }
  float xt = (t < n) ? rhs[t * r_sn] : 0.0f;
  __syncthreads();
  SOLVE_MARK(0)

  // forward: x[j] = x[j] / L[j][j]; x[t] -= L[t][j] x[j] for t > j
  for (int j = 0; j < n; ++j) {
    if (t == j) {
      xt = xt / a[tri(j, j)];
      slot[j & 1] = xt;
    }
    __syncthreads();
    if (t > j && t < n) xt = fmaf(-a[tri(t, j)], slot[j & 1], xt);
  }
  SOLVE_MARK(1)
  // back: x[j] = x[j] / L[j][j]; x[t] -= L[j][t] x[j] for t < j
  for (int j = n - 1; j >= 0; --j) {
    if (t == j) {
      xt = xt / a[tri(j, j)];
      slot[j & 1] = xt;
    }
    __syncthreads();
    if (t < j) xt = fmaf(-a[tri(j, t)], slot[j & 1], xt);
  }
  SOLVE_MARK(2)
  if (t < n) x[t * x_sn] = xt;
  SOLVE_MARK(3)
  SOLVE_CLOCKS_OUT(0)
}

// Asynchronous copies from device memory into shared memory (cp.async): the
// issuing thread waits for those it committed with copy_wait, and no
// thread reads a destination before that and a barrier.  16 bytes (both
// addresses 16-byte aligned; cached in L2 only) or 4.  smem_address: the
// shared-memory address of p, as the copies take it.
__device__ __forceinline__ unsigned smem_address(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(smem_address(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(smem_address(dst)), "l"(src) : "memory");
}

// close this thread's copies issued since the last commit into a group
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `Pending` of the groups this thread committed are in
// flight
template <int Pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
}

// The lower triangle of the 8 x 8 tile at s (row i at s + i * ld) from
// shared memory; the entries above the diagonal, which no diagonal step
// reads, are zeros.
__device__ __forceinline__ void smem_tile(Tile& a, const float* s, int ld) {
#pragma unroll
  for (int i = 0; i < TILE; ++i)
#pragma unroll
    for (int k = 0; k < TILE; ++k) a[i][k] = k <= i ? s[i * ld + k] : 0.0f;
}

// Issue the copies of the streaming solve's step s into buf.  For s < nt - 1
// the forward sweep's tile column p = s, rows 8 p ... n - 1, row r at buf +
// 8 (r - 8 p); then the back sweep's tile row p = 2 nt - 2 - s, columns 0 ...
// 8 p + 7, row 8 p + k at buf + k n8, its rows past the edge written as the
// identity's.  Nothing above the diagonal is copied but the rest of a chunk
// that starts on or below it.  `vec`: unit column stride, 16-byte aligned
// rows, n % 4 == 0: 16-byte chunks, each wholly inside the matrix or past
// its edge; otherwise element by element.  Warps 1, 2, ... copy, each
// thread always the same half row or column of 8 (so its addresses step by
// a constant), while thread 0 takes the diagonal step (warp 0 issuing its
// share after that step lengthened every step's chain).
__device__ __forceinline__ void stream_panel(float* buf, const float* l, int n, int nt,
                                             int s, long long sr, long long sc,
                                             bool vec) {
  constexpr int CN = STREAM_THREADS - 32;  // copying threads: warps 1, 2, ...
  const int ct = static_cast<int>(threadIdx.x) - 32;
  if (ct < 0) return;
  const int n8 = TILE * nt;
  if (s < nt - 1) {
    const int p = s, rows = n - TILE * p;
    const float* lp = l + TILE * p * (sr + sc);  // L[8 p][8 p]
    if (vec) {
      const int h = (ct & 1) * 4;
      for (int r = ct >> 1; r < rows; r += CN / 2)
        if (h <= r) copy_async16(buf + TILE * r + h, lp + r * sr + h);
    } else {
      const int k = ct & 7;
      for (int r = ct >> 3; r < rows; r += CN / 8)
        if (k <= r) copy_async4(buf + TILE * r + k, lp + r * sr + k * sc);
    }
    return;
  }
  const int p = 2 * nt - 2 - s, k = ct & 7, r = TILE * p + k;
  const float* lr = l + r * sr;  // row r
  float* const d = buf + k * n8;
  if (vec) {
    for (int c = (ct >> 3) * 4; c < TILE * (p + 1); c += CN / 2) {
      if (r >= n)
        *reinterpret_cast<float4*>(d + c) = make_float4(r == c, r == c + 1, r == c + 2, r == c + 3);
      else if (c <= r)
        copy_async16(d + c, lr + c);
    }
  } else {
    for (int c = ct >> 3; c < TILE * (p + 1); c += CN / 8) {
      if (r >= n)
        d[c] = r == c ? 1.0f : 0.0f;
      else if (c <= r)
        copy_async4(d + c, lr + c * sc);
    }
  }
}

// One block solves L L^T x = rhs for one matrix, streaming L through shared
// memory a panel at a time (any n up to chol_max_n(); blockDim.x =
// STREAM_THREADS, stream_smem_bytes(n) bytes of dynamic shared memory).  x
// may alias rhs.  `vec` as stream_panel.
__global__ void __launch_bounds__(STREAM_THREADS, STREAM_MIN_BLOCKS)
    chol_solve_stream_kernel(const float* l, const float* rhs, float* x, int n,
                             long long l_sr, long long l_sc, long long l_sb,
                             long long r_sn, long long r_sb, long long x_sn,
                             long long x_sb, int vec) {
  extern __shared__ __align__(16) float ssmem[];
  const int nt = tile_rows(n), n8 = TILE * nt;
  float* const xs = ssmem;             // x, padded with zeros
  float* const rcs = ssmem + n8;       // 1 / L[j][j], 1 past the edge
  float* const ring = ssmem + 2 * n8;  // STREAM_BUFS panel buffers, TILE * n8 each
  const int t = threadIdx.x;
  l += static_cast<long long>(blockIdx.x) * l_sb;
  rhs += static_cast<long long>(blockIdx.x) * r_sb;
  x += static_cast<long long>(blockIdx.x) * x_sb;
  CLK(long long sclk[SOLVE_PHASES] = {}; long long slast = clock64();)
  // forward steps 0 ... nt - 2, then back steps from tile nt - 1 down to 0
  const int steps = 2 * nt - 1;

  stream_panel(ring, l, n, nt, 0, l_sr, l_sc, vec != 0);
  copy_commit();
  for (int j = t; j < n8; j += blockDim.x) {
    xs[j] = j < n ? rhs[j * r_sn] : 0.0f;
    rcs[j] = j < n ? 1.0f / l[j * (l_sr + l_sc)] : 1.0f;
  }
  SOLVE_MARK(0)

  // Padded entries of x are +0 and stay so (in a lane whose x is finite);
  // the forward updates skip them, and in the back updates a padded row's
  // term, fma(-(+0), +0, v), leaves v as it is, bit for bit.
  for (int s = 0; s < steps; ++s) {
    const bool fwd = s < nt - 1;
    const int p = fwd ? s : steps - 1 - s;
    const float* pan = ring + (s % STREAM_BUFS) * TILE * n8;
    // step s's panel has landed (each thread's copies), and every thread
    // is done with step s - 1 (its buffer is free, x is up to date)
    copy_wait<0>();
    SOLVE_MARK(1)
    __syncthreads();
    SOLVE_MARK(2)
    if (t == 0) {
      Tile a;
      if (fwd)
        smem_tile(a, pan, TILE);
      else
        smem_tile(a, pan + TILE * p, n8);
      bool rc_ok = true;
#pragma unroll
      for (int i = 0; i < TILE; ++i) rc_ok &= div_in_range(a[i][i]);
      solve_diag(xs, rcs, a, rc_ok, p, fwd || p == nt - 1, !fwd, l, n, l_sr, l_sc);
    }
    SOLVE_MARK(3)
    // the next step's panel, into the other buffer (warps 1, 2, ...)
    if (s + 1 < steps)
      stream_panel(ring + ((s + 1) % STREAM_BUFS) * TILE * n8, l, n, nt, s + 1, l_sr,
                   l_sc, vec != 0);
    copy_commit();
    SOLVE_MARK(4)
    if (s == steps - 1) break;
    __syncthreads();
    SOLVE_MARK(5)
    float xp[TILE];
    get8(xp, xs + TILE * p);
    if (fwd) {
      // x_r -= L[r][8 p + k] x_p[k], k = 0, 1, ..., for r >= 8 (p + 1)
      for (int r = TILE * (p + 1) + t; r < n; r += blockDim.x) {
        float lr[TILE];
        get8(lr, pan + TILE * (r - TILE * p));
        float v = xs[r];
#pragma unroll
        for (int k = 0; k < TILE; ++k) v = fmaf(-lr[k], xp[k], v);
        xs[r] = v;
      }
    } else {
      // x_c -= L[8 p + k][c] x_p[k], k = 7, 6, ..., for c < 8 p
      for (int c = t; c < TILE * p; c += blockDim.x) {
        float v = xs[c];
#pragma unroll
        for (int k = TILE - 1; k >= 0; --k) v = fmaf(-pan[k * n8 + c], xp[k], v);
        xs[c] = v;
      }
    }
    SOLVE_MARK(6)
  }
  __syncthreads();
  for (int r = t; r < n; r += blockDim.x) x[r * x_sn] = xs[r];
  SOLVE_MARK(7)
  SOLVE_CLOCKS_OUT(1)
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// Whether the tile kernels may move the tiles of a as float4: see load_tile
// (`halves`: by half rows, n % 4 == 0).
bool vec_ok(int n, long long sr, long long sc, long long sb, const void* a,
            bool halves = false) {
  return n % (halves ? 4 : TILE) == 0 && sc == 1 && sr % 4 == 0 && sb % 4 == 0 &&
         aligned16(a);
}

int launch_tile(const float* m, float* l, int n, int batch, long long m_sr,
                long long m_sc, long long m_sb, long long l_sr, long long l_sc,
                long long l_sb, cudaStream_t stream) {
  const bool vec = vec_ok(n, m_sr, m_sc, m_sb, m) && vec_ok(n, l_sr, l_sc, l_sb, l);
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

// The launch of the cluster factor: CLUSTER blocks a matrix.  `attr` holds
// the cluster's dimension for the configuration's lifetime.
cudaLaunchConfig_t cluster_config(int n, int batch, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(CLUSTER * batch));
  cfg.blockDim = dim3(static_cast<unsigned>(cluster_threads(n)));
  cfg.dynamicSmemBytes = CLUSTER_SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch_cluster(const float* m, float* l, int n, int batch, long long m_sr,
                   long long m_sc, long long m_sb, long long l_sr, long long l_sc,
                   long long l_sb, cudaStream_t stream) {
  if (n > CLUSTER_MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      vec_ok(n, m_sr, m_sc, m_sb, m, true) && vec_ok(n, l_sr, l_sc, l_sb, l, true);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(n, batch, stream, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, chol_factor_cluster_kernel, m, l, n, m_sr, m_sc, m_sb,
                         l_sr, l_sc, l_sb, vec ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_solve_tile(const float* l, const float* rhs, float* x, int n, int batch,
                      long long l_sr, long long l_sc, long long l_sb,
                      long long r_sn, long long r_sb, long long x_sn,
                      long long x_sb, cudaStream_t stream) {
  const bool vec = vec_ok(n, l_sr, l_sc, l_sb, l);
  if (CHOL_EXTRA_SMEM > 0) {
    static int have[MAX_DEVICES] = {};
    const cudaError_t err = ensure_smem(chol_solve_kernel, have, CHOL_EXTRA_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_solve_kernel<<<batch, tile_threads(n), CHOL_EXTRA_SMEM, stream>>>(
      l, rhs, x, n, l_sr, l_sc, l_sb, r_sn, r_sb, x_sn, x_sb, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int solve_smem_threads(int n) { return (n + 31) / 32 * 32; }

int launch_solve_smem(const float* l, const float* rhs, float* x, int n, int batch,
                      long long l_sr, long long l_sc, long long l_sb,
                      long long r_sn, long long r_sb, long long x_sn,
                      long long x_sb, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  static int have[MAX_DEVICES] = {};
  const cudaError_t err = ensure_smem(chol_solve_smem_kernel, have, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_smem_kernel<<<batch, solve_smem_threads(n), smem, stream>>>(
      l, rhs, x, n, l_sr, l_sc, l_sb, r_sn, r_sb, x_sn, x_sb);
  return static_cast<int>(cudaGetLastError());
}

int launch_solve_stream(const float* l, const float* rhs, float* x, int n, int batch,
                        long long l_sr, long long l_sc, long long l_sb,
                        long long r_sn, long long r_sb, long long x_sn,
                        long long x_sb, cudaStream_t stream) {
  const bool vec = vec_ok(n, l_sr, l_sc, l_sb, l, true);
  const size_t smem = stream_smem_bytes(n) + CHOL_EXTRA_SMEM;
  static int have[MAX_DEVICES] = {};
  const cudaError_t err = ensure_smem(chol_solve_stream_kernel, have, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_stream_kernel<<<batch, STREAM_THREADS, smem, stream>>>(
      l, rhs, x, n, l_sr, l_sc, l_sb, r_sn, r_sb, x_sn, x_sb, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// What `kernel` is compiled to (registers, local bytes, static shared
// bytes) and, launched at n as its entry point launches it (threads, dynamic
// shared bytes), how many of its blocks an SM holds.
template <class K>
int attributes(K kernel, int threads, size_t dyn, int (&have)[MAX_DEVICES],
               int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ensure_smem(kernel, have, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, threads, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = static_cast<int>(dyn);
  out[4] = threads;
  out[5] = nb;
  out[6] = 1;
  out[7] = 0;
  return 0;
}

}  // namespace

extern "C" {

// Largest n the kernels take: the matrix must fit a block's shared memory
// (the shared-memory solve and the shared-triangle factor) and the cluster
// factor's tiles (CLUSTER_MAX_N).  Asked once, when the library is loaded.
int chol_max_n() {
  int n = 1;
  while (n < CLUSTER_MAX_N && smem_bytes(n + 1) <= BLOCK_SMEM_MAX) ++n;
  return n;
}

// Largest n chol_factor and chol_solve give their register-tile kernels;
// above it, the cluster factor and the streaming solve.
int chol_factor_tile_max_n() { return TILE_MAX_N; }

// The kernel chol_factor launches at n: FACTOR_TILE or FACTOR_CLUSTER.
int chol_factor_route(int n) { return n <= TILE_MAX_N ? FACTOR_TILE : FACTOR_CLUSTER; }

// The kernel chol_solve launches at n: SOLVE_TILE or SOLVE_STREAM.
int chol_solve_route(int n) { return n <= TILE_MAX_N ? SOLVE_TILE : SOLVE_STREAM; }

// Factor `batch` matrices on `stream`.  Element (r, c) of matrix b is at
// m[r * m_sr + c * m_sc + b * m_sb] (strides in elements); l likewise, and
// l may be m.  The kernel is chol_factor_route(n)'s.  Returns the CUDA error
// of the launch (0 = launched).
int chol_factor(const float* m, float* l, int n, int batch, long long m_sr,
                long long m_sc, long long m_sb, long long l_sr, long long l_sc,
                long long l_sb, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chol_factor_route(n) == FACTOR_TILE)
    return launch_tile(m, l, n, batch, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb, st);
  return launch_cluster(m, l, n, batch, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb, st);
}

// chol_factor through the cluster kernel at any n up to CLUSTER_MAX_N (to
// hold it to the tile kernel at n <= 248).
int chol_factor_cluster(const float* m, float* l, int n, int batch,
                        long long m_sr, long long m_sc, long long m_sb,
                        long long l_sr, long long l_sc, long long l_sb,
                        void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return launch_cluster(m, l, n, batch, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb,
                        static_cast<cudaStream_t>(stream));
}

// chol_factor through the shared-triangle kernel at any n (to compare the
// kernels on the same matrices).
int chol_factor_shared(const float* m, float* l, int n, int batch,
                       long long m_sr, long long m_sc, long long m_sb,
                       long long l_sr, long long l_sc, long long l_sb,
                       void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return launch_smem(m, l, n, batch, m_sr, m_sc, m_sb, l_sr, l_sc, l_sb,
                     static_cast<cudaStream_t>(stream));
}

// Solve L L^T x = rhs for `batch` matrices on `stream`; rhs element t of
// matrix b at rhs[t * r_sn + b * r_sb], x likewise, and x may be rhs.  The
// kernel is chol_solve_route(n)'s.
int chol_solve(const float* l, const float* rhs, float* x, int n, int batch,
               long long l_sr, long long l_sc, long long l_sb, long long r_sn,
               long long r_sb, long long x_sn, long long x_sb, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chol_solve_route(n) == SOLVE_TILE)
    return launch_solve_tile(l, rhs, x, n, batch, l_sr, l_sc, l_sb, r_sn, r_sb,
                             x_sn, x_sb, st);
  return launch_solve_stream(l, rhs, x, n, batch, l_sr, l_sc, l_sb, r_sn, r_sb,
                             x_sn, x_sb, st);
}

// chol_solve through the streaming kernel at any n (to hold it to the tile
// solve at n <= 248).
int chol_solve_stream(const float* l, const float* rhs, float* x, int n, int batch,
                      long long l_sr, long long l_sc, long long l_sb,
                      long long r_sn, long long r_sb, long long x_sn,
                      long long x_sb, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return launch_solve_stream(l, rhs, x, n, batch, l_sr, l_sc, l_sb, r_sn, r_sb,
                             x_sn, x_sb, static_cast<cudaStream_t>(stream));
}

// chol_solve through the shared-memory kernel at any n (to compare the
// solve kernels on the same matrices).
int chol_solve_shared(const float* l, const float* rhs, float* x, int n, int batch,
                      long long l_sr, long long l_sc, long long l_sb,
                      long long r_sn, long long r_sb, long long x_sn,
                      long long x_sb, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return launch_solve_smem(l, rhs, x, n, batch, l_sr, l_sc, l_sb, r_sn, r_sb,
                           x_sn, x_sb, static_cast<cudaStream_t>(stream));
}

// What kernel `kernel` (a KernelId) is compiled to and how many of its
// blocks of that n an SM holds: out[0..7] = registers a thread, local bytes
// a thread, static and dynamic shared bytes a block, threads a block, blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), blocks a matrix
// (the cluster's size), and for the cluster factor the clusters the device
// runs at once (cudaOccupancyMaxActiveClusters; 0 for the others).
int chol_kernel_attributes(int kernel, int n, int* out) {
  static int have[SOLVE_STREAM + 1][MAX_DEVICES] = {};
  switch (kernel) {
    case FACTOR_TILE:
      return attributes(chol_factor_kernel, tile_threads(n), CHOL_EXTRA_SMEM,
                        have[kernel], out);
    case FACTOR_SHARED:
      return attributes(chol_factor_smem_kernel, FACTOR_THREADS, smem_bytes(n),
                        have[kernel], out);
    case SOLVE_TILE:
      return attributes(chol_solve_kernel, tile_threads(n), CHOL_EXTRA_SMEM,
                        have[kernel], out);
    case SOLVE_SHARED:
      return attributes(chol_solve_smem_kernel, solve_smem_threads(n),
                        smem_bytes(n), have[kernel], out);
    case FACTOR_CLUSTER: {
      if (n > CLUSTER_MAX_N) return static_cast<int>(cudaErrorInvalidValue);
      int err = attributes(chol_factor_cluster_kernel, cluster_threads(n),
                           CLUSTER_SMEM, have[kernel], out);
      if (err != 0) return err;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(n, 1, nullptr, &attr);
      int clusters = 0;
      err = static_cast<int>(cudaOccupancyMaxActiveClusters(
          &clusters, reinterpret_cast<const void*>(chol_factor_cluster_kernel), &cfg));
      if (err != 0) return err;
      out[6] = CLUSTER;
      out[7] = clusters;
      return 0;
    }
    case SOLVE_STREAM:
      return attributes(chol_solve_stream_kernel, STREAM_THREADS,
                        stream_smem_bytes(n) + CHOL_EXTRA_SMEM, have[kernel], out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* chol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef CHOL_STEP_CLOCKS
// The timelines g_chol_steps of the last launch of the register-tile solve:
// out[b * CHOL_STEPS + i], the SM clock at step i of block b < 4096.
int chol_step_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_chol_steps, sizeof(g_chol_steps)));
}
#endif

#ifdef CHOL_PHASE_CLOCKS
// The tile kernel's cycles by phase since the last call, summed over the
// blocks (out[CHOL_PHASES]), and the blocks (out[CHOL_PHASES]); zeroes them.
int chol_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_chol_cycles, sizeof(g_chol_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[CHOL_PHASES + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_chol_cycles, zero, sizeof(zero)));
}

// The cycles by phase of thread 0 of the shared-memory solve (kernel =
// SOLVE_SHARED) or of the streaming solve (SOLVE_STREAM) since the last call,
// summed over the blocks, and the blocks (out[SOLVE_PHASES]); zeroes them.
int chol_solve_phase_cycles(int kernel, unsigned long long* out) {
  if (kernel != SOLVE_SHARED && kernel != SOLVE_STREAM)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t off = (kernel == SOLVE_STREAM ? 1 : 0) * (SOLVE_PHASES + 1) *
                     sizeof(unsigned long long);
  const size_t size = (SOLVE_PHASES + 1) * sizeof(unsigned long long);
  cudaError_t err = cudaMemcpyFromSymbol(out, g_chol_solve_cycles, size, off);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[SOLVE_PHASES + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_chol_solve_cycles, zero, size, off));
}

// The cluster factor's cycles by phase since the last call, summed over the
// matrices (out[CLUSTER_PHASES]); zeroes them.
int chol_cluster_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_chol_cluster_cycles,
                                         sizeof(g_chol_cluster_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[CLUSTER_PHASES + 1] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_chol_cluster_cycles, zero, sizeof(zero)));
}
#endif

}  // extern "C"
