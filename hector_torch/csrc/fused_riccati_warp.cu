// Fused Riccati interior point for the Hector stage QP (h=10, nx=13, nu=12,
// nc=16), ONE WARP PER SCENARIO.  CUDA C++ for sm_90a, plain C entry point
// (loaded with ctypes by hector_torch/qp/fused_riccati.py).
//
// Replaces the Pallas TPU kernel hector/qp/pallas_riccati.py:_kernel (:63),
// whose body is _solve_tile (:73-631), launched by pl.pallas_call at :668.
// It computes what _solve_tile computes: the fixed-sigma interior point
// (rollout, barrier weights on the 12 lower and 8 upper one-sided rows,
// backward Riccati sweep with a 12x12 Cholesky that keeps only K and kff,
// forward rollout, fraction-to-boundary steps, clipped updates), then, when
// polish_rounds > 0, the primal-dual active-set polish (:542-610), then the
// final residuals mu, r_dual and r_prim.
//
// The kernel is a template on POLISH, compiled twice.  <false> is what the
// default configuration (polish_rounds = 0) launches: every polish
// statement sits under `if constexpr (POLISH)`, so it holds the interior
// point alone.  <true> runs the interior point without the freeze (its
// mu_floor is 0, pallas_riccati.py:144) and then polish_rounds *
// polish_iters augmented-Lagrangian Riccati solves as further iterations of
// THE SAME rolled loop, through the same newton_dir call site (a second site
// would inline the sweep twice and change <false>'s registers).
//
// What bounds it on the card: arithmetic.  A solve reads ~3.3 KB and writes
// ~0.5 KB per scenario but does ~2 MFLOP of dependent scalar FP32 work (the
// per-stage Cholesky and triangular solves), so the bound is the FP32
// CUDA-core rate, not HBM.  The matrices differ per scenario and are 12x13,
// so there is nothing for the tensor cores to share.
//
// What the design does about it.  The one-thread-per-scenario kernel kept
// ~1,650 floats of iterate and work arrays and the 13x13 / 12x12 / 12x13
// sweep matrices in thread-local arrays indexed in rolled loops: all of it
// in local memory, 255 registers, 8 warps an SM, every stage through L1/L2.
// Here a warp owns a scenario and nothing is thread-local but registers:
//   - Shared memory, per warp (struct Scen, 14.0 KB, so 16 warps fit an
//     SM at 128 registers): the scenario's inputs (loaded once, coalesced
//     across the block's scenarios) but x0 and xd, which the rollout reads
//     into registers; u, q_lin, r_lin, d_row, du, P, P A, [W | z], B^T P,
//     L and the per-stage [K | kff] (1,680 floats, no global scratch;
//     outside the sweep the same words hold the per-row scratch).
//   - Registers: the constraint rows.  Row n = k * 16 + r of the 160 rows
//     lives in lane n % 32, so a lane always holds the same row r = lane % 16
//     of stages k = 2t + lane / 16, t = 0..4: its slacks, duals, residuals
//     and bounds are arrays indexed by the unrolled t only.  A row that has
//     no lower (upper) side keeps an inactive one (s = 1, lambda = 0) and
//     adds exact zeros.
//   - Work is split over outputs, never over a reduction index: each entry
//     of P A, A^T (P A) - W^T W, B^T P, Re, each column of G = diag(m) B^T
//     (P A) and each C u row is one lane's sequential sum.  The lanes of a
//     phase run the same instructions: A = I + E is applied through E's
//     columns (at most three entries each, absent ones with value 0), not
//     through a branch per column class, since a divergent branch runs its
//     paths one after the other and each waits on shared memory.
//   - The Cholesky keeps row i in lane i; each entry is stored when final,
//     and step j reads row j's finished entries back.  The triangular
//     solves run a column of [G | beta] a lane (14), the back substitution
//     in its row (axpy) order, both reading rows of L.
//   - What limits it: at first the SM's one shared-memory pipe (almost
//     every multiply-add had its own load), so rows of L, W's columns, B,
//     the mask and du are read as float4 (a broadcast float4 is one
//     shared-memory request); now the dependent chains of the Cholesky and
//     the substitutions, and the issue rate (see PERF.md).
//   - Sums across lanes: only mu (and the integer count n_act).  Each lane
//     adds its five rows in order t = 0..4, then a __shfl_xor_sync butterfly
//     (offsets 16, 8, 4, 2, 1) adds the lanes; its order does not depend on
//     the data and every lane ends with the same bits, so the freeze test is
//     warp-uniform.  rate_p, ratio_d, s_min and r_d / r_prim are jmax / jmin
//     butterflies (order-free), `finite` is __all_sync.
//   - Early exit.  A lane whose mu is below mu_floor, or whose step is not
//     finite, is skipped, and its state does not change; the next iteration
//     would recompute the same mu and the same step and skip it again.  So
//     the warp leaves the interior point at the first skip (before the
//     Newton solve when mu decides) and goes on to the polish (<true>) or
//     the final residuals: the same u and stats bit for bit as running all
//     iterations.  On closed-loop QPs in float32 lanes freeze after 7-9 of
//     the 14 iterations; with the polish only a step that is not finite
//     leaves early.
//
//   - The polish (<true>).  Its row state lives in the rows' slots: the
//     multipliers nu_p and the best round's nu_b, one register a slot; the
//     active sets as bits of one word; the row masks rebuilt from the bound
//     values (lb > -big, ub < big on all 16 rows, not the interior point's
//     one-sided sets).  The polished iterate u_p takes the place of u in
//     shared memory, so the rollout and C u read it where they always do;
//     the best round's u_b is four registers a lane (entry lane + 32 j),
//     and the interior point's u (the fallback) waits in u_out.  A polish
//     step puts its C^T argument nu + rho act (C u_p - bnd) into the row
//     scratch and rho act into d_row, where newton_dir reads them.  The
//     merit's maxima are warp_max butterflies and its finite tests
//     __all_sync, so the round ends, the best-of-rounds update and the
//     acceptance are the same in every lane.
//   - Registers of <true>.  Every value the rolled loop carries stays live
//     across the inlined newton_dir, where <false> already takes all 128
//     registers; 14 warps an SM would not give more (the register file is
//     split over the SM's four schedulers: 4 warps each either way).  So
//     the polish carries no new arrays: it keeps its row state in the
//     registers of the interior point's slacks and duals, which it no
//     longer needs once mu is written and the fallback multipliers are
//     kept (lam_ip), and it reads the bounds again from the cache and
//     recomputes the primal residuals after each newton_dir instead of
//     carrying them across it.  No local memory, 16 warps an SM.
//   - The fallback count.  A lane whose polish is rejected keeps the
//     interior point's iterate.  Lane 0 of each warp adds one to the
//     device's g_polish_counts[0] (lanes polished) and, where the polish was
//     rejected, one to g_polish_counts[1], under the same `if constexpr`,
//     so <false> neither carries nor touches them;
//     fused_riccati_warp_polish_counts reads both back.
//
// Floating point: no fast math and no flush-to-zero.  The isfinite guards,
// the inf ratios of the dual step and the skip logic need IEEE division,
// sqrt and inf.  jmax/jmin propagate NaN as jnp.maximum/minimum do.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstddef>

// Solver constants; the layout must match _Params in fused_riccati.py.
struct FusedRiccatiParams {
  float q2[13];      // 2 * state weights
  float r2[12];      // 2 * input weights
  float r2reg[12];   // 2 * input weights + KKT regularization
  float sigma;
  float frac;
  float big;
  float init_slack;
  float init_dual;
  int iters;
  int pol_rounds;    // polish: rounds of active-set estimation (0 = off)
  int pol_iters;     // polish: augmented-Lagrangian solves per round
  float pol_rho;     // polish: penalty
  float pol_tol;     // polish: a lane is accepted at merit <= 10 * pol_tol
};

namespace {

using Params = FusedRiccatiParams;

constexpr int H = 10;     // horizon
constexpr int NX = 13;    // state  [rpy, p, omega, v, g]
constexpr int NU = 12;    // input  [F_L, F_R, M_L, M_R]
constexpr int NC = 16;    // constraint rows per stage
constexpr int WS = NX + 1;            // a row of [W | z] and [K | kff]
constexpr int SLOTS = H * NC / 32;    // constraint rows per lane
constexpr int WARPS = 2;              // scenarios per block
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 8;         // blocks an SM: 16 warps, 128 registers
constexpr int UREGS = (H * NU + 31) / 32;  // entries of u a lane holds
constexpr unsigned FULL = 0xffffffffu;

static_assert(H * NC == 32 * SLOTS, "rows must fill whole warps");
static_assert(UREGS <= SLOTS, "u_b lives in a row array");

// Unused dynamic shared memory a block; profile_warp_kernel.py builds with
// it set to hold an SM to fewer warps.
#ifndef FR_EXTRA_SMEM
#define FR_EXTRA_SMEM 0
#endif

// Lanes <true> polished, and lanes whose polish it rejected, since the
// library was loaded, on this device (see the fallback count above).
__device__ unsigned long long g_polish_counts[2];

// Phase clocks, for profile_warp_kernel.py (built with -DFR_PHASE_CLOCKS;
// in the default build PHASE() is nothing): at each mark lane 0 adds the
// SM cycles since the warp's last mark to that phase, per scenario slot.
#ifdef FR_PHASE_CLOCKS
constexpr int PHASES = 11, CLOCK_SLOTS = 32768;
__device__ unsigned long long g_phase_cycles[CLOCK_SLOTS][PHASES];
__device__ long long g_phase_last[CLOCK_SLOTS];
__device__ __forceinline__ void phase_mark(int i) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    const int slot = (blockIdx.x * WARPS + (threadIdx.x >> 5)) % CLOCK_SLOTS;
    const long long t = clock64();
    if (i >= 0) g_phase_cycles[slot][i] += t - g_phase_last[slot];
    g_phase_last[slot] = t;
  }
}
#define PHASE(i) phase_mark(i)
#else
#define PHASE(i)
#endif

// One scenario's working set in shared memory.  The arrays read as float4
// come first, each a multiple of four floats, so they stay 16-byte aligned.
struct alignas(16) Scen {
  float L[NU * NU];     // Re, then its Cholesky factor with 1 / L[i][i] on
                        // the diagonal (lower triangle; read by whole rows)
  float Wt[WS * NU];    // [W | z] = L^-1 [G | beta], by columns
  union {
    float K[H * WS * NU];  // [K_k | kff_k] by columns, k = 0..H-1, inside
                           // newton_dir
    float rows[H * NC];    // per-row scratch outside it: C^T argument, B u,
  };                       // multipliers
  float b69[3 * NU];    // B[6:9, :], row-major
  float umask[H * NU];
  float r_lin[H * NU];
  float d_row[H * NC];  // barrier weights; the costates in the residuals
  float du[H * NU];
  float s69[9];         // A[0:3, 6:9], row-major
  float scal[3];        // dt (A[3+r, 9+r]), A[11, 12], dt/m (B[9+a, a])
  float ecv[NX * 3];    // A = I + E: the values of column j of E (e_row)
  float cm[NC * NU];    // C, row-major
  float u[H * NU];
  float q_lin[H * NX];
  float P[NX * NX];
  float Q[NX * NX];     // P A
  float bp[NU * 6];     // columns 6..11 of bp = diag(m) B^T P
  float p[NX];
};
static_assert(offsetof(Scen, b69) % 16 == 0 && offsetof(Scen, umask) % 16 == 0 &&
                  offsetof(Scen, r_lin) % 16 == 0 && offsetof(Scen, Wt) % 16 == 0 &&
                  offsetof(Scen, d_row) % 16 == 0 && offsetof(Scen, du) % 16 == 0 &&
                  offsetof(Scen, K) % 16 == 0 && sizeof(Scen) % 16 == 0,
              "float4 reads need 16-byte alignment");

constexpr int SCEN_FLOATS = sizeof(Scen) / sizeof(float);

struct Consts {  // the weights, in shared memory so lanes may index them
  float q2[NX], r2[NU], r2reg[NU];
};

// 8 blocks of WARPS scenarios an SM (with the 1 KB each block reserves)
static_assert(WARPS * sizeof(Scen) + sizeof(Consts) + 1024 <= 233472 / MIN_BLOCKS,
              "shared memory for MIN_BLOCKS blocks an SM");

// The float4 at p (16-byte aligned) into v[0..3], and back.
__device__ __forceinline__ void ld4(float* v, const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// Butterfly reductions: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Row a and column c of entry n of a lower triangle stored row by row:
// a = floor((sqrt(8 n + 1) - 1) / 2).  Exact for the n < 91 used here:
// 8 n + 1 is an odd square at the first entry of a row, and otherwise at
// least 8 below the next one, so sqrt stays 4 / (2 a + 3) below it.
__device__ __forceinline__ void tri_pair(int n, int& a, int& c) {
  a = static_cast<int>((__fsqrt_rn(static_cast<float>(8 * n + 1)) - 1.f) * 0.5f);
  c = n - a * (a + 1) / 2;
}

// The leg (0 or 1) whose force or moment input column c is.
__device__ __forceinline__ int leg_of(int c) { return c < 6 ? c / 3 : (c - 6) / 3; }

// Row of entry t (0..2) of column j of E, where A = I + E: columns 6..8
// hold rows 0..2 (s69), 9..11 row j - 6 (dt), 12 row 11; an absent entry
// is row 0 with value 0 (s.ecv).
__device__ __forceinline__ int e_row(int j, int t) {
  if (j >= 6 && j < 9) return t;
  if (t > 0) return 0;
  return j == 12 ? 11 : (j >= 9 ? j - 6 : 0);
}

// Column j of (X A): X[j] + sum_t E[x_t][j] X[x_t], X a row of stride 1;
// with stride NX, entry (j, b) of A^T X.  The same three multiply-adds in
// every lane, whatever the column.
__device__ __forceinline__ float times_a(const Scen& s, const float* x, int j,
                                         int st) {
  const float* e = s.ecv + 3 * j;
  float v = x[j * st];
  v += e[0] * x[e_row(j, 0) * st];
  v += e[1] * x[e_row(j, 1) * st];
  v += e[2] * x[e_row(j, 2) * st];
  return v;
}

// Lane m holds x[m] (m < 13); returns component m of A x.
__device__ __forceinline__ float a_mul_lane(const Scen& s, float v, int m) {
  const float x6 = __shfl_sync(FULL, v, 6), x7 = __shfl_sync(FULL, v, 7);
  const float x8 = __shfl_sync(FULL, v, 8), x12 = __shfl_sync(FULL, v, 12);
  const float xp6 = __shfl_sync(FULL, v, (m + 6) & 31);
  if (m < 3)
    v += s.s69[3 * m] * x6 + s.s69[3 * m + 1] * x7 + s.s69[3 * m + 2] * x8;
  else if (m < 6)
    v += s.scal[0] * xp6;
  else if (m == 11)
    v += s.scal[1] * x12;
  return v;
}

// Lane m holds x[m] (m < 13); returns component m of A^T x (lanes past 12
// get x[m] + terms of column 0 of E, which are 0).
__device__ __forceinline__ float at_mul_lane(const Scen& s, float v, int m) {
  const int j = m < NX ? m : 0;
  float r = v;
#pragma unroll
  for (int t = 0; t < 3; ++t) r += s.ecv[3 * j + t] * __shfl_sync(FULL, v, e_row(j, t));
  return r;
}

// acc = sum_j crow[j] * v[j], in the order of c_mul
__device__ __forceinline__ float row_dot(const float* crow, const float* v) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < NU; ++j) acc += crow[j] * v[j];
  return acc;
}

// Bound data of one constraint row for the polish (pallas_riccati.py:92-98,
// 549): float masks of the finite sides taken from the bound values, the
// equality flag (lb == ub: the swing legs' zero rows) and the bounds with
// the absent sides set to 0.
struct PolRow {
  float fl, fu, feq, lb_c, ub_c;
};

__device__ __forceinline__ PolRow pol_row(float lbv, float ubv, float big) {
  PolRow w;
  w.fl = (lbv > -big) ? 1.f : 0.f;
  w.fu = (ubv < big) ? 1.f : 0.f;
  w.lb_c = (lbv > -big) ? lbv : 0.f;
  w.ub_c = (ubv < big) ? ubv : 0.f;
  w.feq = w.fl * w.fu * ((w.ub_c - w.lb_c < 1e-12f) ? 1.f : 0.f);
  return w;
}

// The active sets of a lane's rows in one word: bit t says slot t is
// lower-active (a_l), bit t + 8 upper-active (a_u).
constexpr int A_U = 8;

// Bit i of the active-set word as 0 or 1.
__device__ __forceinline__ float bitf(unsigned m, int i) {
  return ((m >> i) & 1u) ? 1.f : 0.f;
}

// Active-set estimate of one row from the sign of nu + rho (C u - bound)
// (estimate, pallas_riccati.py:554-560), into slot t of the word.
__device__ __forceinline__ void pol_estimate(const PolRow& w, float rho, float nu,
                                             float cu, int t, unsigned& act) {
  const float t_u = nu + rho * (cu - w.ub_c);
  const float t_l = -nu + rho * (w.lb_c - cu);
  const float au = jmax(w.fu * ((t_u > 0.f) ? 1.f : 0.f), w.feq);
  const float al = jmax(w.fl * ((t_l > 0.f) ? 1.f : 0.f) * (1.f - au), w.feq);
  act &= ~((1u << t) | (1u << (t + A_U)));
  act |= (al != 0.f ? 1u << t : 0u) | (au != 0.f ? 1u << (t + A_U) : 0u);
}

// The row's active flag, and the bound it is held to: lower-active (and
// equality) rows target lb, upper-active rows ub (pallas_riccati.py:570-572).
__device__ __forceinline__ void pol_target(const PolRow& w, float al, float au,
                                           float& on, float& low, float& bnd) {
  on = jmax(al, au);
  low = jmax(al * (1.f - au), w.feq);
  bnd = low * w.lb_c + (1.f - low) * au * w.ub_c;
}

// q_lin[k] = q2 * (x_{k+1} - xd[k]) along the rollout of s.u from x0 (lane
// m holds x0[m]); xd is the batch-minor input, offset by the scenario, read
// through the cache.
__device__ void rollout_qlin(Scen& s, const Consts& cst, int lane, float x0,
                             const float* __restrict__ xd, size_t B) {
  // B diag(m_k) u_k for every stage, rows 6..11 of the state (6 a stage)
  for (int n = lane; n < H * 6; n += 32) {
    const int k = n / 6, r = n - 6 * k;
    const float* uk = s.u + k * NU;
    const float* mk = s.umask + k * NU;
    float v;
    if (r < 3) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j) acc += s.b69[r * NU + j] * (uk[j] * mk[j]);
      v = acc;
    } else {
      const int a = r - 3;
      v = s.scal[2] * (uk[a] * mk[a] + uk[3 + a] * mk[3 + a]);
    }
    s.rows[n] = v;
  }
  __syncwarp();
  float xdk[H];  // all of lane m's xd at once: one trip to the cache
#pragma unroll
  for (int k = 0; k < H; ++k) xdk[k] = lane < NX ? __ldg(xd + (k * NX + lane) * B) : 0.f;
  float x = x0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    x = a_mul_lane(s, x, lane);
    if (lane >= 6 && lane < 12) x += s.rows[k * 6 + lane - 6];
    if (lane < NX) s.q_lin[k * NX + lane] = (x - xdk[k]) * cst.q2[lane];
  }
  __syncwarp();
  PHASE(0);
}

// One LQR solve: backward Riccati sweep (storing only K, kff) and forward
// rollout.  Reads s.d_row, s.q_lin, s.r_lin; writes s.du.  Computes what
// newton_dir of pallas_riccati.py:235-398 computes, with G = bp A formed as
// diag(mk) B^T (P A) and the back substitution in its row (axpy) order.
__device__ void newton_dir(Scen& s, const Consts& cst, int lane) {
  const float dtl = s.scal[0], a1112 = s.scal[1], em = s.scal[2];
  for (int n = lane; n < NX * NX; n += 32) {
    const int i = n / NX;
    s.P[n] = (n == i * (NX + 1)) ? cst.q2[i] : 0.f;
  }
  if (lane < NX) s.p[lane] = s.q_lin[(H - 1) * NX + lane];
  __syncwarp();

#pragma unroll 1
  for (int k = H - 1; k >= 0; --k) {
    const float* mk = s.umask + k * NU;

    PHASE(6);
    // (1) Q = P A
    for (int n = lane; n < NX * NX; n += 32) {
      const int i = n / NX, j = n - NX * i;
      s.Q[n] = times_a(s, s.P + i * NX, j, 1);
    }
    // (2) bp = diag(mk) B^T P, columns 6..11 (what Re needs)
    for (int n = lane; n < NU * 6; n += 32) {
      const int i = n / 6;
      const float* x = s.P + 6 + (n - 6 * i);
      float acc = s.b69[i] * x[6 * NX] + s.b69[NU + i] * x[7 * NX] +
                  s.b69[2 * NU + i] * x[8 * NX];
      acc += (i < 6 ? em : 0.f) * x[(9 + i % 3) * NX];
      s.bp[n] = acc * mk[i];
    }
    __syncwarp();

    PHASE(1);
    // (3) Re = C^T D C (two-leg blocks) + diag(r2 + reg) + bp B diag(mk),
    // lower triangle, one entry a lane
    for (int n = lane; n < NU * (NU + 1) / 2; n += 32) {
      int i, j;
      tri_pair(n, i, j);
      const int leg = leg_of(i);
      float dl[8];
      ld4(dl, s.d_row + k * NC + 8 * leg);
      ld4(dl + 4, s.d_row + k * NC + 8 * leg + 4);
      float cdc = 0.f;
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int row = 8 * leg + rr;
        cdc += (dl[rr] * s.cm[row * NU + i]) * s.cm[row * NU + j];
      }
      float v = leg == leg_of(j) ? cdc : 0.f;
      v += i == j ? cst.r2reg[i] : 0.f;
      const float* bi = s.bp + 6 * i;
      float acc = bi[0] * s.b69[j] + bi[1] * s.b69[NU + j] + bi[2] * s.b69[2 * NU + j];
      acc += (j < 6 ? em : 0.f) * bi[3 + j % 3];
      v += acc * mk[j];
      s.L[i * NU + j] = v;
    }
    __syncwarp();

    PHASE(2);
    // (4) Cholesky, lower, pivot floor 1e-30, one reciprocal a pivot: lane
    // i < 12 holds row i and stores each entry when it is final, so step j
    // reads row j's finished entries as float4 broadcasts; the diagonal
    // keeps 1 / L[i][i], which is all the substitutions use of it
    {
      float row[NU];
      const int li = lane < NU ? lane : 0;
#pragma unroll
      for (int c = 0; c < NU; c += 4) ld4(row + c, s.L + li * NU + c);
#pragma unroll
      for (int t = 0; t < NU; ++t) row[t] = t <= lane ? row[t] : 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float v = row[j];
        float lj[NU];
#pragma unroll
        for (int c = 0; c < j; c += 4) ld4(lj + c, s.L + j * NU + c);
#pragma unroll
        for (int t = 0; t < j; ++t) v -= row[t] * lj[t];
        const float piv = __shfl_sync(FULL, v, j);
        const float ljj = sqrtf(jmax(piv, 1e-30f));
        const float rj = 1.0f / ljj;
        if (lane == j) row[j] = rj;
        else if (lane > j) row[j] = v * rj;
        if (lane >= j && lane < NU) s.L[lane * NU + j] = row[j];
        __syncwarp();
      }
    }

    PHASE(3);
    // (5) one column of [G | beta] a lane (14) in registers: lane m < 13
    // column m of G = diag(mk) B^T Q, lane 13 beta = diag(mk) B^T p + r_lin
    float w[NU];
    {
      const float* x = lane < NX ? s.Q + lane : s.p;
      const int st = lane < NX ? NX : 1;
      float xr[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) xr[r] = x[(6 + r) * st];
      const float beta = lane == NX ? 1.f : 0.f;
#pragma unroll
      for (int c = 0; c < NU; c += 4) {
        float b0[4], b1[4], b2[4], mv[4], rl[4];
        ld4(b0, s.b69 + c);
        ld4(b1, s.b69 + NU + c);
        ld4(b2, s.b69 + 2 * NU + c);
        ld4(mv, mk + c);
        ld4(rl, s.r_lin + k * NU + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = c + q;
          float acc = b0[q] * xr[0] + b1[q] * xr[1] + b2[q] * xr[2];
          if (i < 6) acc += em * xr[3 + i % 3];
          w[i] = acc * mv[q];
          w[i] += beta * rl[q];
        }
      }
    }
    __syncwarp();  // L written

    PHASE(4);
    // (6) forward substitution, a column a lane: [W | z] = L^-1 [G | beta]
    if (lane < WS) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float lr[NU];
#pragma unroll
        for (int c = 0; c <= i; c += 4) ld4(lr + c, s.L + i * NU + c);
#pragma unroll
        for (int t = 0; t < i; ++t) w[i] -= lr[t] * w[t];
        w[i] *= lr[i];
      }
#pragma unroll
      for (int c = 0; c < NU; c += 4) st4(s.Wt + lane * NU + c, w + c);
    }
    __syncwarp();

    PHASE(5);
    // (7) P <- A^T Q - W^T W + diag(q2) (lower triangle, mirrored), the new
    // p (lanes < 13), K = L^-T [W | z] (lanes < 14)
    for (int n = lane; n < NX * (NX + 1) / 2; n += 32) {
      int a, bb;
      tri_pair(n, a, bb);
      float v = times_a(s, s.Q + bb, a, NX);
      float wa[NU], wb[NU];
#pragma unroll
      for (int c = 0; c < NU; c += 4) {
        ld4(wa + c, s.Wt + a * NU + c);
        ld4(wb + c, s.Wt + bb * NU + c);
      }
      float ww = 0.f;
#pragma unroll
      for (int i = 0; i < NU; ++i) ww += wa[i] * wb[i];
      v = v - ww;
      v += a == bb ? cst.q2[a] : 0.f;
      s.P[a * NX + bb] = v;
      s.P[bb * NX + a] = v;
    }
    float pn = 0.f;
    if (lane < NX) {
      pn = times_a(s, s.p, lane, 1);  // (A^T p)[m]
      float z[NU];
#pragma unroll
      for (int c = 0; c < NU; c += 4) ld4(z + c, s.Wt + NX * NU + c);
      float acc = 0.f;                // (G^T kff)[m] = (W^T z)[m]
#pragma unroll
      for (int i = 0; i < NU; ++i) acc += z[i] * w[i];
      pn -= acc;
      if (k >= 1) pn += s.q_lin[(k - 1) * NX + lane];
    }
    if (lane < WS) {
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        float lr[NU];
#pragma unroll
        for (int c = 0; c <= i; c += 4) ld4(lr + c, s.L + i * NU + c);
        w[i] *= lr[i];
#pragma unroll
        for (int t = 0; t < i; ++t) w[t] -= lr[t] * w[i];
      }
#pragma unroll
      for (int c = 0; c < NU; c += 4) st4(s.K + (k * WS + lane) * NU + c, w + c);
    }
    __syncwarp();
    if (lane < NX) s.p[lane] = pn;
    __syncwarp();
  }

  PHASE(6);
  // forward rollout: du_k = -(K_k dx + kff_k), dx <- A dx + B diag(mk) du_k;
  // every lane keeps all of dx, lane i < 12 forms du_k[i]
  float dx[NX];
#pragma unroll
  for (int m = 0; m < NX; ++m) dx[m] = 0.f;
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
    if (lane < NU) {
      const float* kc = s.K + k * WS * NU + lane;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m) acc += kc[m * NU] * dx[m];
      s.du[k * NU + lane] = -(acc + kc[NX * NU]);
    }
    __syncwarp();
    if (k + 1 == H) break;
    float dum[NU];
#pragma unroll
    for (int c = 0; c < NU; c += 4) {
      float d4[4], m4[4];
      ld4(d4, s.du + k * NU + c);
      ld4(m4, s.umask + k * NU + c);
#pragma unroll
      for (int q = 0; q < 4; ++q) dum[c + q] = d4[q] * m4[q];
    }
    // A dx, in place: rows 0..5 and 11 read rows 6..9, 12, which stay
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      dx[r] += s.s69[3 * r] * dx[6] + s.s69[3 * r + 1] * dx[7] + s.s69[3 * r + 2] * dx[8];
      dx[3 + r] += dtl * dx[9 + r];
    }
    dx[11] += a1112 * dx[12];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; c += 4) {
        float b4[4];
        ld4(b4, s.b69 + r * NU + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc += b4[q] * dum[c + q];
      }
      dx[6 + r] += acc;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dx[9 + a] += em * (dum[a] + dum[3 + a]);
  }
  PHASE(7);
}

// Copies n elements of a batch-minor input into field `off` of each of the
// block's scenarios: consecutive threads read consecutive scenarios.
__device__ __forceinline__ void load_field(Scen* scen, int off,
                                           const float* __restrict__ g, int n,
                                           int b0, int batch) {
  float* base = reinterpret_cast<float*>(scen);
  for (int idx = threadIdx.x; idx < n * WARPS; idx += THREADS) {
    const int e = idx / WARPS, w = idx - e * WARPS;
    const int b = b0 + w;
    if (b < batch)
      base[w * SCEN_FLOATS + off + e] = __ldg(g + static_cast<size_t>(e) * batch + b);
  }
}

#define FIELD(name) static_cast<int>(offsetof(Scen, name) / sizeof(float))

template <bool POLISH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fused_riccati_warp_kernel(
    const float* __restrict__ s69_in, const float* __restrict__ scal_in,
    const float* __restrict__ b69_in, const float* __restrict__ umask_in,
    const float* __restrict__ x0_in, const float* __restrict__ xd_in,
    const float* __restrict__ cm_in, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, float* __restrict__ u_out,
    float* __restrict__ stats_out, int batch, Params prm) {
  __shared__ Scen scen[WARPS];
  __shared__ Consts cst;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int b0 = blockIdx.x * WARPS;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) cst.q2[i] = prm.q2[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      cst.r2[i] = prm.r2[i];
      cst.r2reg[i] = prm.r2reg[i];
    }
  }
  load_field(scen, FIELD(s69), s69_in, 9, b0, batch);
  load_field(scen, FIELD(scal), scal_in, 3, b0, batch);
  load_field(scen, FIELD(b69), b69_in, 3 * NU, b0, batch);
  load_field(scen, FIELD(umask), umask_in, H * NU, b0, batch);
  load_field(scen, FIELD(cm), cm_in, NC * NU, b0, batch);
  __syncthreads();
  const int b = b0 + wid;
  if (b >= batch) return;  // whole warps: no padding lanes
  Scen& s = scen[wid];
  PHASE(-1);
  const size_t B = static_cast<size_t>(batch);
  const float* xd = xd_in + b;
  const float x0 = lane < NX ? __ldg(x0_in + lane * B + b) : 0.f;
  for (int n = lane; n < NX * 3; n += 32) {  // the values of E's columns
    const int j = n / 3, t = n - 3 * j;
    s.ecv[n] = (j >= 6 && j < 9) ? s.s69[3 * t + j - 6]
               : (t == 0 && j >= 9 && j < 12) ? s.scal[0]
               : (t == 0 && j == 12) ? s.scal[1] : 0.f;
  }

  const float big = prm.big;
  const float kInf = __int_as_float(0x7f800000);
  // with the polish the interior point runs to its clamp-limited stall
  // point (the active set shows there): no complementarity freeze
  const float mu_floor = POLISH ? 0.0f : 10.0f * FLT_EPSILON;
  const float s_floor = 10.0f * FLT_EPSILON;
  const float d_cap = static_cast<float>(0.1 / static_cast<double>(FLT_EPSILON));
  const float sl_cap = 1e8f;

  // this lane's rows: row r of stages 2t + lane / 16; its lower side exists
  // on rows {0,1,2,3,4,7} of each leg, its upper side on rows {4,5,6,7}
  const int r = lane & 15, r8 = lane & 7, khalf = lane >> 4;
  const bool has_l = r8 < 5 || r8 == 7;
  const bool has_u = r8 >= 4;
  const float* crow = s.cm + r * NU;  // this lane's row of C
  float lbv[SLOTS], ubv[SLOTS];
  float cnt = 0.f;
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    const size_t e = static_cast<size_t>(32 * t + lane) * B + b;
    lbv[t] = __ldg(lb_in + e);
    ubv[t] = __ldg(ub_in + e);
    cnt += ((has_l && lbv[t] > -big) ? 1.f : 0.f) + ((has_u && ubv[t] < big) ? 1.f : 0.f);
  }
  const float n_act = fmaxf(warp_sum(cnt), 1.f);  // a count: exact in any order

  // iterate: u in shared memory; the rows' slacks and duals in registers
  float sl[SLOTS], ll[SLOTS], su[SLOTS], lu[SLOTS];
  float rp_l[SLOTS], rp_u[SLOTS];  // primal residuals, then ds
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    sl[t] = su[t] = 1.f;
    ll[t] = lu[t] = rp_l[t] = rp_u[t] = 0.f;
  }
  for (int n = lane; n < H * NU; n += 32) s.u[n] = 0.f;
  __syncwarp();

  // polish state (<true> only), in the registers of the interior point's
  // slacks and duals (see "Registers of <true>" above): once its iterate is
  // final they serve only the final mu, which the polish start writes to
  // stats_out, and the fallback multipliers, which it keeps in lam_ip.  The
  // polished iterate u_p takes s.u; the interior point's u waits in u_out.
  float (&nu_p)[SLOTS] = sl;     // row multipliers of the polished iterate
  float (&lam_ip)[SLOTS] = ll;   // the interior point's, signed full rows
  float (&nu_b)[SLOTS] = su;     // the best round's row multipliers
  float (&u_b)[SLOTS] = lu;      // the best round's u, entry lane + 32 j
  unsigned act = 0u;             // active sets (A_U)
  float bad_b = kInf;            // the best round's merit
  const int n_pol = POLISH ? prm.pol_rounds * prm.pol_iters : 0;

  // Iteration -1 is the unconstrained start (D = 0, r_lin = 0); iterations
  // 0..iters-1 are the interior-point steps; iterations iters.. are the
  // polish steps (<true> only).
#pragma unroll 1
  for (int it = -1; it < prm.iters + n_pol; ++it) {
    const bool pol = POLISH && it >= prm.iters;
    if constexpr (POLISH) {
      if (it == prm.iters) {
        // start of the polish (pallas_riccati.py:549-565): the interior
        // point's mu (as the final residuals sum it) and multipliers as
        // signed full rows, the first active-set estimate, u_p = u_b = u
        float acc_l = 0.f, acc_u = 0.f, lam[SLOTS];
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          acc_l += sl[t] * ll[t] * ((has_l && lbv[t] > -big) ? 1.f : 0.f);
          acc_u += su[t] * lu[t] * ((has_u && ubv[t] < big) ? 1.f : 0.f);
          lam[t] = has_l ? -ll[t] : 0.f;
          if (has_u) lam[t] = has_l ? lam[t] + lu[t] : lu[t];
        }
        const float mu = (warp_sum(acc_l) + warp_sum(acc_u)) / n_act;
        if (lane == 0) stats_out[b] = mu;
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const float cu = row_dot(crow, s.u + (2 * t + khalf) * NU);
          pol_estimate(pol_row(lbv[t], ubv[t], big), prm.pol_rho, lam[t], cu, t, act);
          lam_ip[t] = lam[t];
          nu_p[t] = jmax(bitf(act, t), bitf(act, t + A_U)) * lam[t];
          nu_b[t] = nu_p[t];
        }
#pragma unroll
        for (int j = 0; j < UREGS; ++j) {
          const int n = lane + 32 * j;
          u_b[j] = n < H * NU ? s.u[n] : 0.f;
          if (n < H * NU) u_out[static_cast<size_t>(n) * B + b] = u_b[j];
        }
      }
    }
    rollout_qlin(s, cst, lane, x0, xd, B);
    float smu = 0.f;
    if (it < 0) {
      for (int n = lane; n < H * NC; n += 32) s.d_row[n] = 0.f;
      for (int n = lane; n < H * NU; n += 32) s.r_lin[n] = 0.f;
    } else {
      if (pol) {
        // augmented-Lagrangian step on the active rows: d = rho act, C^T
        // argument nu + rho act (C u_p - bnd)
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const PolRow w = pol_row(lbv[t], ubv[t], big);
          float on, low, bnd;
          pol_target(w, bitf(act, t), bitf(act, t + A_U), on, low, bnd);
          const float cu = row_dot(crow, s.u + (2 * t + khalf) * NU);
          s.d_row[32 * t + lane] = prm.pol_rho * on;
          s.rows[32 * t + lane] = nu_p[t] + prm.pol_rho * (on * (cu - bnd));
        }
      } else {
        float acc_l = 0.f, acc_u = 0.f;
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const float cu = row_dot(crow, s.u + (2 * t + khalf) * NU);
          const bool ml = has_l && lbv[t] > -big;
          const bool mu_ = has_u && ubv[t] < big;
          rp_l[t] = ml ? cu - lbv[t] - sl[t] : 0.f;
          acc_l += sl[t] * ll[t] * (ml ? 1.f : 0.f);
          rp_u[t] = mu_ ? ubv[t] - cu - su[t] : 0.f;
          acc_u += su[t] * lu[t] * (mu_ ? 1.f : 0.f);
        }
        const float mu = (warp_sum(acc_l) + warp_sum(acc_u)) / n_act;
        // frozen: the state stays, so every later iteration skips too
        if (mu < mu_floor) {
          if constexpr (POLISH) {
            it = prm.iters - 1;  // on to the polish
            continue;
          }
          break;
        }
        smu = prm.sigma * mu;
        // d_row and the C^T argument, full rows: lower side, then upper added
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const bool ml = has_l && lbv[t] > -big;
          const bool mu_ = has_u && ubv[t] < big;
          // one reciprocal a slack, recomputed after the Newton solve
          const float inv_l = 1.0f / jmax(sl[t], s_floor);
          const float inv_u = 1.0f / jmax(su[t], s_floor);
          const float dl = ml ? jmin(ll[t] * inv_l, d_cap) : 0.f;
          const float tls = ml ? smu * inv_l : 0.f;
          const float dd = mu_ ? jmin(lu[t] * inv_u, d_cap) : 0.f;
          const float tus = mu_ ? smu * inv_u : 0.f;
          float drow = has_l ? dl : 0.f;
          float arg = has_l ? dl * rp_l[t] - tls : 0.f;
          if (has_u) {
            const float au = tus - dd * rp_u[t];
            drow = has_l ? drow + dd : dd;
            arg = has_l ? arg + au : au;
          }
          s.d_row[32 * t + lane] = drow;
          s.rows[32 * t + lane] = arg;
        }
      }
      __syncwarp();
      // r_lin = r2 u + C^T arg, one (stage, input) a lane
      for (int n = lane; n < H * NU; n += 32) {
        const int k = n / NU, j = n - NU * k;
        float acc = 0.f;
#pragma unroll
        for (int rr = 0; rr < NC; ++rr) acc += s.rows[k * NC + rr] * s.cm[rr * NU + j];
        s.r_lin[n] = cst.r2[j] * s.u[n] + acc;
      }
    }
    __syncwarp();

    PHASE(8);
    newton_dir(s, cst, lane);
    if constexpr (POLISH) {
      // the bounds again, from the cache: carried across newton_dir they
      // would cost <true> registers
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const size_t e = static_cast<size_t>(32 * t + lane) * B + b;
        lbv[t] = __ldg(lb_in + e);
        ubv[t] = __ldg(ub_in + e);
      }
    }

    if (it < 0) {
      // scale-aware start from the unconstrained solution
      float s_min = kInf;
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const float cu0 = row_dot(crow, s.du + (2 * t + khalf) * NU);
        const bool ml = has_l && lbv[t] > -big;
        const bool mu_ = has_u && ubv[t] < big;
        sl[t] = ml ? cu0 - lbv[t] : 1.f;
        if (ml) s_min = jmin(s_min, sl[t]);
        su[t] = mu_ ? ubv[t] - cu0 : 1.f;
        if (mu_) s_min = jmin(s_min, su[t]);
      }
      s_min = warp_min(s_min);
      const float shift = prm.init_slack + jmax(0.f, -1.5f * s_min);
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const bool ml = has_l && lbv[t] > -big;
        const bool mu_ = has_u && ubv[t] < big;
        sl[t] = ml ? sl[t] + shift : 1.f;
        ll[t] = ml ? prm.init_dual / sl[t] : 0.f;
        su[t] = mu_ ? su[t] + shift : 1.f;
        lu[t] = mu_ ? prm.init_dual / su[t] : 0.f;
      }
      PHASE(9);
      continue;
    }

    if constexpr (POLISH) {
      if (pol) {
        // full Newton step unless the direction is not finite
        bool fin = true;
        for (int n = lane; n < H * NU; n += 32) fin = fin && isfinite(s.du[n]);
        if (__all_sync(FULL, fin))
          for (int n = lane; n < H * NU; n += 32) s.u[n] += s.du[n];
        __syncwarp();
        // multiplier update; at a round's end the KKT merit (primal
        // violation, wrong-sign multiplier / 10), the best of rounds and
        // the next active set (pallas_riccati.py:580-600)
        const bool round_end = (it - prm.iters + 1) % prm.pol_iters == 0;
        float bad_p = -kInf, wrong = -kInf;
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const PolRow w = pol_row(lbv[t], ubv[t], big);
          const float au = bitf(act, t + A_U);
          float on, low, bnd;
          pol_target(w, bitf(act, t), au, on, low, bnd);
          const float cu = row_dot(crow, s.u + (2 * t + khalf) * NU);
          const float nu_n = on * (nu_p[t] + prm.pol_rho * (cu - bnd));
          nu_p[t] = nu_n;
          if (round_end) {
            bad_p = jmax(bad_p, jmax(w.fl * (w.lb_c - cu), w.fu * (cu - w.ub_c)));
            wrong = jmax(wrong, jmax(au * (1.f - w.feq) * jmax(-nu_n, 0.f),
                                     low * (1.f - w.feq) * jmax(nu_n, 0.f)));
            pol_estimate(w, prm.pol_rho, nu_n, cu, t, act);
          }
        }
        if (round_end) {
          bool ufin = true;
          for (int n = lane; n < H * NU; n += 32) ufin = ufin && isfinite(s.u[n]);
          bad_p = warp_max(bad_p);
          wrong = warp_max(wrong);
          const float bad_r = __all_sync(FULL, ufin) ? jmax(bad_p, 0.1f * wrong) : kInf;
          if (bad_r < bad_b) {
#pragma unroll
            for (int j = 0; j < UREGS; ++j) {
              const int n = lane + 32 * j;
              if (n < H * NU) u_b[j] = s.u[n];
            }
#pragma unroll
            for (int t = 0; t < SLOTS; ++t) nu_b[t] = nu_p[t];
          }
          bad_b = jmin(bad_r, bad_b);
        }
        continue;
      }
    }

    if constexpr (POLISH) {
      // the primal residuals once more, bit for bit as before the solve:
      // carried across newton_dir they would cost <true> registers
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const float cu = row_dot(crow, s.u + (2 * t + khalf) * NU);
        rp_l[t] = (has_l && lbv[t] > -big) ? cu - lbv[t] - sl[t] : 0.f;
        rp_u[t] = (has_u && ubv[t] < big) ? ubv[t] - cu - su[t] : 0.f;
      }
    }
    // slack/dual directions, step sizes, finiteness
    bool finite = true;
    for (int n = lane; n < H * NU; n += 32) finite = finite && isfinite(s.du[n]);
    float rate_p = 0.f;    // max_i (-ds_i) / s_i over rows with ds < 0
    float ratio_d = kInf;  // min_i lam_i / (-dlam_i) over rows with dlam < 0
    float dlam_l[SLOTS], dlam_u[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const float cdu = row_dot(crow, s.du + (2 * t + khalf) * NU);
      const bool ml = has_l && lbv[t] > -big;
      const bool mu_ = has_u && ubv[t] < big;
      const float inv_l = 1.0f / jmax(sl[t], s_floor);
      const float inv_u = 1.0f / jmax(su[t], s_floor);
      {
        const float dl = ml ? jmin(ll[t] * inv_l, d_cap) : 0.f;
        const float tt = cdu + rp_l[t];
        const float ds = ml ? tt : 0.f;
        const float dlam = ml ? smu * inv_l - ll[t] - dl * tt : 0.f;
        finite = finite && isfinite(ds) && isfinite(dlam);
        if (ml && ds < 0.f) rate_p = jmax(rate_p, -ds * inv_l);
        if (ml && dlam < 0.f) ratio_d = jmin(ratio_d, ll[t] / jmax(-dlam, 1e-30f));
        rp_l[t] = ds;
        dlam_l[t] = dlam;
      }
      {
        const float dd = mu_ ? jmin(lu[t] * inv_u, d_cap) : 0.f;
        const float tt = -cdu + rp_u[t];
        const float ds = mu_ ? tt : 0.f;
        const float dlam = mu_ ? smu * inv_u - lu[t] - dd * tt : 0.f;
        finite = finite && isfinite(ds) && isfinite(dlam);
        if (mu_ && ds < 0.f) rate_p = jmax(rate_p, -ds * inv_u);
        if (mu_ && dlam < 0.f) ratio_d = jmin(ratio_d, lu[t] / jmax(-dlam, 1e-30f));
        rp_u[t] = ds;
        dlam_u[t] = dlam;
      }
    }
    // a step that is not finite is skipped, and would be again: leave
    if (!__all_sync(FULL, finite)) {
      if constexpr (POLISH) {
        it = prm.iters - 1;  // on to the polish
        continue;
      }
      break;
    }
    rate_p = warp_max(rate_p);
    ratio_d = warp_min(ratio_d);
    const float a_p = prm.frac / jmax(rate_p, prm.frac);
    const float a_d = jmin(1.f, prm.frac * ratio_d);
    for (int n = lane; n < H * NU; n += 32) s.u[n] += a_p * s.du[n];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      if (has_l && lbv[t] > -big) {
        sl[t] = jmin(jmax(sl[t] + a_p * rp_l[t], 0.f), sl_cap);
        ll[t] = jmin(jmax(ll[t] + a_d * dlam_l[t], 0.f), sl_cap);
      }
      if (has_u && ubv[t] < big) {
        su[t] = jmin(jmax(su[t] + a_p * rp_u[t], 0.f), sl_cap);
        lu[t] = jmin(jmax(lu[t] + a_d * dlam_u[t], 0.f), sl_cap);
      }
    }
    __syncwarp();
    PHASE(9);
  }

  // accept the polished iterate only at a small KKT merit, else keep the
  // interior point's (pallas_riccati.py:603-610)
  bool pol_ok = false;
  if constexpr (POLISH) {
    bool fin = true;
#pragma unroll
    for (int j = 0; j < UREGS; ++j)
      if (lane + 32 * j < H * NU) fin = fin && isfinite(u_b[j]);
    const bool all_fin = __all_sync(FULL, fin);
    pol_ok = all_fin && bad_b <= 10.0f * prm.pol_tol;
#pragma unroll
    for (int j = 0; j < UREGS; ++j) {
      const int n = lane + 32 * j;
      if (n < H * NU) s.u[n] = pol_ok ? u_b[j] : u_out[static_cast<size_t>(n) * B + b];
    }
    __syncwarp();
  }

  PHASE(9);
  // ---- final residuals (pallas_riccati.py:612-631) ----
  rollout_qlin(s, cst, lane, x0, xd, B);
  float r_prim = 0.f, acc_l = 0.f, acc_u = 0.f;
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    // full-row signed multipliers: -lam_l + lam_u, or the polish's
    float lam;
    if constexpr (POLISH) {
      lam = pol_ok ? nu_b[t] : lam_ip[t];
    } else {
      lam = has_l ? -ll[t] : 0.f;
      if (has_u) lam = has_l ? lam + lu[t] : lu[t];
    }
    s.rows[32 * t + lane] = lam;
    const float cu = row_dot(crow, s.u + (2 * t + khalf) * NU);
    const float rpl = (lbv[t] > -big) ? jmax(lbv[t] - cu, 0.f) : 0.f;
    const float rpu = (ubv[t] < big) ? jmax(cu - ubv[t], 0.f) : 0.f;
    r_prim = jmax(r_prim, jmax(rpl, rpu));
    if constexpr (!POLISH) {
      acc_l += sl[t] * ll[t] * ((has_l && lbv[t] > -big) ? 1.f : 0.f);
      acc_u += su[t] * lu[t] * ((has_u && ubv[t] < big) ? 1.f : 0.f);
    }
  }
  // costates nu_k (lane m holds component m) into d_row
  float nu = lane < NX ? s.q_lin[(H - 1) * NX + lane] : 0.f;
#pragma unroll 1
  for (int k = H - 1; k >= 0; --k) {
    if (lane < NX) s.d_row[k * NX + lane] = nu;
    if (k >= 1) {
      nu = at_mul_lane(s, nu, lane);
      if (lane < NX) nu += s.q_lin[(k - 1) * NX + lane];
    }
  }
  __syncwarp();
  float r_d_max = 0.f;
  for (int n = lane; n < H * NU; n += 32) {
    const int k = n / NU, j = n - NU * k;
    const float* nk = s.d_row + k * NX;
    float acc = s.b69[j] * nk[6] + s.b69[NU + j] * nk[7] + s.b69[2 * NU + j] * nk[8];
    if (j < 6) acc += s.scal[2] * nk[9 + (j % 3)];
    const float bnu = acc * s.umask[n];
    float ct = 0.f;
#pragma unroll
    for (int rr = 0; rr < NC; ++rr) ct += s.rows[k * NC + rr] * s.cm[rr * NU + j];
    const float rd = cst.r2[j] * s.u[n] + bnu + ct;
    r_d_max = jmax(r_d_max, fabsf(rd));
  }
  r_d_max = warp_max(r_d_max);
  r_prim = warp_max(r_prim);
  float mu = 0.f;  // with the polish, written at its start
  if constexpr (!POLISH) mu = (warp_sum(acc_l) + warp_sum(acc_u)) / n_act;

  for (int n = lane; n < H * NU; n += 32) u_out[static_cast<size_t>(n) * B + b] = s.u[n];
  PHASE(10);
  if (lane == 0) {
    if constexpr (!POLISH) stats_out[b] = mu;
    if constexpr (POLISH) {
      atomicAdd(&g_polish_counts[0], 1ull);
      if (!pol_ok) atomicAdd(&g_polish_counts[1], 1ull);
    }
    stats_out[B + b] = r_d_max;
    stats_out[2 * B + b] = r_prim;
  }
}

template <bool POLISH>
int launch(const float* s69, const float* scal, const float* b69, const float* umask,
           const float* x0, const float* xd, const float* cm, const float* lb,
           const float* ub, float* u_out, float* stats_out, int batch,
           const Params& prm, cudaStream_t stream) {
  const int grid = (batch + WARPS - 1) / WARPS;
#if FR_EXTRA_SMEM > 0
  const cudaError_t err = cudaFuncSetAttribute(
      fused_riccati_warp_kernel<POLISH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FR_EXTRA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
#endif
  fused_riccati_warp_kernel<POLISH><<<grid, THREADS, FR_EXTRA_SMEM, stream>>>(
      s69, scal, b69, umask, x0, xd, cm, lb, ub, u_out, stats_out, batch, prm);
  return static_cast<int>(cudaGetLastError());
}

template <bool POLISH>
int attributes(int* num_regs, int* local_bytes, int* static_smem, int* dynamic_smem,
               int* threads, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fused_riccati_warp_kernel<POLISH>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, fused_riccati_warp_kernel<POLISH>, THREADS, FR_EXTRA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  *dynamic_smem = FR_EXTRA_SMEM;
  *threads = THREADS;
  *blocks_per_sm = nb;
  return 0;
}

}  // namespace

extern "C" {

// Launches one solve of `batch` scenarios on `stream` (a cudaStream_t), the
// kernel with the polish if params->pol_rounds > 0, and returns
// cudaGetLastError() as an int (0 = launched).  Every array is batch-minor
// float32: element e of scenario b at [e * batch + b].
int fused_riccati_warp_solve(const float* s69, const float* scal, const float* b69,
                             const float* umask, const float* x0, const float* xd,
                             const float* cm, const float* lb, const float* ub,
                             float* u_out, float* stats_out, int batch,
                             const FusedRiccatiParams* params, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (params->pol_rounds > 0) {
    if (params->pol_iters < 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch<true>(s69, scal, b69, umask, x0, xd, cm, lb, ub, u_out, stats_out,
                        batch, *params, st);
  }
  return launch<false>(s69, scal, b69, umask, x0, xd, cm, lb, ub, u_out, stats_out,
                       batch, *params, st);
}

const char* fused_riccati_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// What the compiled kernel takes, of the kernel with the polish if `polish`
// is not 0: registers a thread, local bytes a thread, static and dynamic
// shared bytes a block, threads a block, and the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int fused_riccati_warp_attributes(int polish, int* num_regs, int* local_bytes,
                                  int* static_smem, int* dynamic_smem, int* threads,
                                  int* blocks_per_sm) {
  return polish ? attributes<true>(num_regs, local_bytes, static_smem, dynamic_smem,
                                   threads, blocks_per_sm)
                : attributes<false>(num_regs, local_bytes, static_smem, dynamic_smem,
                                    threads, blocks_per_sm);
}

// The lanes the kernel with polish polished, and those whose polish it
// rejected, since the library was loaded, on the current device, into
// out[2] (a copy on the legacy default stream: the caller synchronises the
// device first, since PyTorch's own streams do not wait for it).
int fused_riccati_warp_polish_counts(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_polish_counts, 2 * sizeof(*out)));
}

#ifdef FR_PHASE_CLOCKS
// The SM cycles of each phase since the last call, summed over the warps
// (out[PHASES]); zeroes them.
int fused_riccati_warp_phase_cycles(unsigned long long* out) {
  static unsigned long long host[CLOCK_SLOTS][PHASES];
  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(host));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < PHASES; ++i) out[i] = 0;
  for (int n = 0; n < CLOCK_SLOTS; ++n)
    for (int i = 0; i < PHASES; ++i) out[i] += host[n][i];
  for (auto& row : host)
    for (auto& v : row) v = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, host, sizeof(host)));
}
#endif

}  // extern "C"
