// Fused Riccati interior point for the Hector stage QP (h=10, nx=13, nu=12,
// nc=16), one scenario per thread.  CUDA C++ for sm_90a, plain C entry point
// (loaded with ctypes by hector_torch/qp/fused_riccati.py).
//
// Replaces the Pallas TPU kernel hector/qp/pallas_riccati.py:_kernel (:63),
// whose body is _solve_tile (:73-631), launched by pl.pallas_call at :668.
// It computes what _solve_tile computes with polish_rounds = 0: the
// fixed-sigma interior point (rollout, barrier weights on the 12 lower and
// 8 upper one-sided rows, backward Riccati sweep with a 12x12 Cholesky that
// keeps only K and kff, forward rollout, fraction-to-boundary steps,
// clipped updates), then the final residuals mu, r_dual and r_prim.
//
// What bounds it on the card: arithmetic.  A solve reads ~3.3 KB and writes
// ~0.5 KB per scenario but does ~2 MFLOP of dependent scalar FP32 work (the
// per-stage Cholesky and triangular solves), so the bound is the FP32
// CUDA-core rate, not HBM.  The matrices differ per scenario and are 12x13,
// so there is nothing for the tensor cores to share.
//
// What the design does about it: one scenario per thread, so every scalar
// operation of the textbook algorithm is one FP32 instruction with no
// cross-thread traffic, and the structural savings of the TPU kernel are
// kept because they are arithmetic: sparse A and B, the two-leg column
// blocks of C^T D C (lower triangle only), one-sided rows, one reciprocal
// per slack, the rate form of the primal step, and the W^T W identity that
// avoids forming K before the P update.  Inputs and outputs are batch-minor
// (element-major, scenario-minor), so the 32 threads of a warp read 32
// neighbouring floats.  K and kff (1,680 floats per scenario) go to a
// batch-minor scratch the wrapper allocates.  P, Re/L, W and the iterate
// state are thread-local arrays; they spill to local memory, which this
// first version accepts (registers and spill bytes are recorded in PERF.md).
//
// Floating point: no fast math and no flush-to-zero.  The isfinite guards,
// the inf ratios of the dual step and the skip logic need IEEE division,
// sqrt and inf.  jmax/jmin propagate NaN as jnp.maximum/minimum do.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstddef>

// Solver constants, at global scope because the extern "C" entry point
// takes them; the layout must match _Params in fused_riccati.py.
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
};

namespace {

using Params = FusedRiccatiParams;

constexpr int H = 10;     // horizon
constexpr int NX = 13;    // state  [rpy, p, omega, v, g]
constexpr int NU = 12;    // input  [F_L, F_R, M_L, M_R]
constexpr int NC = 16;    // constraint rows per stage
constexpr int NL = 12;    // one-sided lower rows per stage
constexpr int NP = 8;     // one-sided upper rows per stage
constexpr int THREADS = 128;

// Lower-bounded rows {0,1,2,3,4,7} and upper-bounded rows {4,5,6,7} of each
// leg's 8 rows (hector/qp/pallas_riccati.py:110-111).
__host__ __device__ constexpr int lr_row(int i) {
  return 8 * (i / 6) + ((i % 6) < 5 ? (i % 6) : 7);
}
__host__ __device__ constexpr int ur_row(int i) { return 8 * (i / 4) + 4 + (i % 4); }
// upper row i is also a lower row (rows 4 and 7 of each leg)
__host__ __device__ constexpr bool ur_is_lr(int i) { return (i % 4) == 0 || (i % 4) == 3; }
// the 6 columns leg `leg` touches: its force and its moment block
__host__ __device__ constexpr int leg_col(int leg, int a) {
  return a < 3 ? 3 * leg + a : 6 + 3 * leg + (a - 3);
}

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// Per-scenario dynamics: A = I + E (E: s69 in rows 0:3 / cols 6:9, dt in
// (3+r, 9+r), -dt in (11, 12)); B nonzero in rows 6:9 (b69) and rows 9:12
// (dt/m on columns a and 3+a).
struct Dyn {
  float s69[3][3];
  float dtl, a1112, em;
  float b69[3][NU];
};

// Element e of a batch-minor input whose base is already offset by the lane.
#define AT(ptr, e) __ldg((ptr) + (size_t)(e) * B)

__device__ __forceinline__ void a_mul(const Dyn& d, float* x) {  // x <- A x
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    x[r] += d.s69[r][0] * x[6] + d.s69[r][1] * x[7] + d.s69[r][2] * x[8];
    x[3 + r] += d.dtl * x[9 + r];
  }
  x[11] += d.a1112 * x[12];
}

__device__ __forceinline__ void at_mul(const Dyn& d, float* x) {  // x <- A^T x
  x[12] += d.a1112 * x[11];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x[6 + c] += d.s69[0][c] * x[0] + d.s69[1][c] * x[1] + d.s69[2][c] * x[2];
    x[9 + c] += d.dtl * x[3 + c];
  }
}

// x += B diag(mk) du
__device__ __forceinline__ void b_mul_add(const Dyn& d, const float* mk,
                                          const float* du, float* x) {
  float dum[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) dum[j] = du[j] * mk[j];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NU; ++j) acc += d.b69[r][j] * dum[j];
    x[6 + r] += acc;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) x[9 + a] += d.em * (dum[a] + dum[3 + a]);
}

// out = diag(mk) B^T p
__device__ __forceinline__ void bt_mul(const Dyn& d, const float* mk,
                                       const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float acc = d.b69[0][i] * p[6] + d.b69[1][i] * p[7] + d.b69[2][i] * p[8];
    if (i < 6) acc += d.em * p[9 + (i % 3)];
    out[i] = acc * mk[i];
  }
}

__device__ __forceinline__ void load_mask(const float* umask, size_t B, int k,
                                          float* mk) {
#pragma unroll
  for (int j = 0; j < NU; ++j) mk[j] = AT(umask, k * NU + j);
}

// y = C u for one stage
__device__ __forceinline__ void c_mul(const float* cm, size_t B,
                                      const float* u, float* y) {
#pragma unroll
  for (int r = 0; r < NC; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NU; ++j) acc += AT(cm, r * NU + j) * u[j];
    y[r] = acc;
  }
}

// q_lin[k] = q2 * (x_{k+1} - xd[k]) along the rollout of u from x0
__device__ __forceinline__ void rollout_qlin(const Dyn& d, const Params& prm,
                                             const float* x0, const float* xd,
                                             const float* umask, size_t B,
                                             const float* u, float* q_lin) {
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = AT(x0, i);
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
    float mk[NU];
    load_mask(umask, B, k, mk);
    a_mul(d, x);
    b_mul_add(d, mk, u + k * NU, x);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      q_lin[k * NX + i] = (x[i] - AT(xd, k * NX + i)) * prm.q2[i];
  }
}

// One LQR solve: backward Riccati sweep (storing only K, kff) and forward
// rollout.  d_row (H*NC) barrier weights, q_lin (H*NX), r_lin (H*NU);
// writes du (H*NU).  Mirrors newton_dir, pallas_riccati.py:235-398.
__device__ __forceinline__ void newton_dir(
    const Dyn& d, const Params& prm, const float* umask, const float* cm,
    size_t B, const float* d_row, const float* q_lin, const float* r_lin,
    float* kscr, float* du) {
  float P[NX][NX];
  float p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = (i == j) ? prm.q2[i] : 0.f;
    p[i] = q_lin[(H - 1) * NX + i];
  }

#pragma unroll 1
  for (int k = H - 1; k >= 0; --k) {
    float mk[NU];
    load_mask(umask, B, k, mk);
    float L[NU][NU];  // Re, then its Cholesky factor (lower triangle)
    float rinv[NU];
    float W[NU][NX];  // bp = diag(mk) B^T P, then G = bp A, then L^-1 G, then K

    // Re = C^T D C (two-leg column blocks, lower triangle) + diag(r2 + reg)
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = 0.f;
#pragma unroll
    for (int leg = 0; leg < 2; ++leg) {
      float cr[8][6];
      float dr[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        dr[rr] = d_row[k * NC + 8 * leg + rr];
#pragma unroll
        for (int a = 0; a < 6; ++a)
          cr[rr][a] = AT(cm, (8 * leg + rr) * NU + leg_col(leg, a));
      }
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int bb = 0; bb <= a; ++bb) {
          float acc = 0.f;
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) acc += (dr[rr] * cr[rr][a]) * cr[rr][bb];
          L[leg_col(leg, a)][leg_col(leg, bb)] = acc;
        }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) L[i][i] += prm.r2reg[i];

    // bp = diag(mk) B^T P
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        float acc = d.b69[0][i] * P[6][m] + d.b69[1][i] * P[7][m] +
                    d.b69[2][i] * P[8][m];
        if (i < 6) acc += d.em * P[9 + (i % 3)][m];
        W[i][m] = acc * mk[i];
      }

    // Re += bp B diag(mk), lower triangle
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float acc = W[i][6] * d.b69[0][j] + W[i][7] * d.b69[1][j] +
                    W[i][8] * d.b69[2][j];
        if (j < 6) acc += W[i][9 + (j % 3)] * d.em;
        L[i][j] += acc * mk[j];
      }

    // Cholesky, lower, with the 1e-30 pivot floor and one reciprocal per pivot
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float piv = L[j][j];
#pragma unroll
      for (int t = 0; t < j; ++t) piv -= L[j][t] * L[j][t];
      const float ljj = sqrtf(jmax(piv, 1e-30f));
      const float rj = 1.0f / ljj;
      rinv[j] = rj;
      L[j][j] = ljj;
#pragma unroll
      for (int i = j + 1; i < NU; ++i) {
        float v = L[i][j];
#pragma unroll
        for (int t = 0; t < j; ++t) v -= L[i][t] * L[j][t];
        L[i][j] = v * rj;
      }
    }

    // G = bp A (column 12 first: it reads column 11 before that changes)
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      W[i][12] += d.a1112 * W[i][11];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        W[i][6 + c] += d.s69[0][c] * W[i][0] + d.s69[1][c] * W[i][1] +
                       d.s69[2][c] * W[i][2];
        W[i][9 + c] += d.dtl * W[i][3 + c];
      }
    }

    // beta = diag(mk) B^T p + r_lin[k]
    float z[NU];
    bt_mul(d, mk, p, z);
#pragma unroll
    for (int i = 0; i < NU; ++i) z[i] += r_lin[k * NU + i];

    // forward substitution: W <- L^-1 G, z <- L^-1 beta
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int t = 0; t < i; ++t) {
        const float lit = L[i][t];
#pragma unroll
        for (int m = 0; m < NX; ++m) W[i][m] -= lit * W[t][m];
        z[i] -= lit * z[t];
      }
#pragma unroll
      for (int m = 0; m < NX; ++m) W[i][m] *= rinv[i];
      z[i] *= rinv[i];
    }

    // p <- A^T p - W^T z + q_lin[k-1]   (G^T kff = W^T z)
    at_mul(d, p);
#pragma unroll
    for (int m = 0; m < NX; ++m) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NU; ++i) acc += z[i] * W[i][m];
      p[m] -= acc;
      if (k >= 1) p[m] += q_lin[(k - 1) * NX + m];
    }

    // P <- A^T P A - W^T W + diag(q2)   (G^T Re^-1 G = W^T W)
#pragma unroll
    for (int i = 0; i < NX; ++i) {  // P A, by columns
      P[i][12] += d.a1112 * P[i][11];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        P[i][6 + c] += d.s69[0][c] * P[i][0] + d.s69[1][c] * P[i][1] +
                       d.s69[2][c] * P[i][2];
        P[i][9 + c] += d.dtl * P[i][3 + c];
      }
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) {  // A^T (P A), by rows
      P[12][j] += d.a1112 * P[11][j];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        P[6 + c][j] += d.s69[0][c] * P[0][j] + d.s69[1][c] * P[1][j] +
                       d.s69[2][c] * P[2][j];
        P[9 + c][j] += d.dtl * P[3 + c][j];
      }
    }
#pragma unroll
    for (int a = 0; a < NX; ++a)
#pragma unroll
      for (int bb = 0; bb <= a; ++bb) {  // lower triangle, mirrored
        float ww = 0.f;
#pragma unroll
        for (int i = 0; i < NU; ++i) ww += W[i][a] * W[i][bb];
        float v = P[a][bb] - ww;
        if (a == bb) v += prm.q2[a];
        P[a][bb] = v;
        P[bb][a] = v;
      }

    // back substitution: K = L^-T W, kff = L^-T z; store to the scratch
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
#pragma unroll
      for (int t = i + 1; t < NU; ++t) {
        const float lti = L[t][i];
#pragma unroll
        for (int m = 0; m < NX; ++m) W[i][m] -= lti * W[t][m];
        z[i] -= lti * z[t];
      }
#pragma unroll
      for (int m = 0; m < NX; ++m) W[i][m] *= rinv[i];
      z[i] *= rinv[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int m = 0; m < NX; ++m) kscr[(size_t)((k * NU + i) * NX + m) * B] = W[i][m];
      kscr[(size_t)(H * NU * NX + k * NU + i) * B] = z[i];
    }
  }

  // forward rollout: du_k = -(K_k dx + kff_k), dx <- A dx + B_k du_k
  float dx[NX];
#pragma unroll
  for (int m = 0; m < NX; ++m) dx[m] = 0.f;
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
    float mk[NU];
    load_mask(umask, B, k, mk);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < NX; ++m)
        acc += kscr[(size_t)((k * NU + i) * NX + m) * B] * dx[m];
      du[k * NU + i] = -(acc + kscr[(size_t)(H * NU * NX + k * NU + i) * B]);
    }
    a_mul(d, dx);
    b_mul_add(d, mk, du + k * NU, dx);
  }
}

__global__ void __launch_bounds__(THREADS) fused_riccati_kernel(
    const float* __restrict__ s69_in, const float* __restrict__ scal_in,
    const float* __restrict__ b69_in, const float* __restrict__ umask,
    const float* __restrict__ x0, const float* __restrict__ xd,
    const float* __restrict__ cm, const float* __restrict__ lb,
    const float* __restrict__ ub, float* __restrict__ u_out,
    float* __restrict__ stats_out, float* __restrict__ kscr, int batch,
    Params prm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;  // no padding lanes
  const size_t B = static_cast<size_t>(batch);
  s69_in += b; scal_in += b; b69_in += b; umask += b; x0 += b; xd += b;
  cm += b; lb += b; ub += b; u_out += b; stats_out += b; kscr += b;

  Dyn d;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) d.s69[r][c] = AT(s69_in, r * 3 + c);
#pragma unroll
    for (int j = 0; j < NU; ++j) d.b69[r][j] = AT(b69_in, r * NU + j);
  }
  d.dtl = AT(scal_in, 0);
  d.a1112 = AT(scal_in, 1);
  d.em = AT(scal_in, 2);

  const float big = prm.big;
  const float kInf = __int_as_float(0x7f800000);
  const float mu_floor = 10.0f * FLT_EPSILON;
  const float s_floor = 10.0f * FLT_EPSILON;
  const float d_cap = static_cast<float>(0.1 / static_cast<double>(FLT_EPSILON));
  const float sl_cap = 1e8f;

  float n_act = 0.f;
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int i = 0; i < NL; ++i) n_act += (AT(lb, k * NC + lr_row(i)) > -big) ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) n_act += (AT(ub, k * NC + ur_row(i)) < big) ? 1.f : 0.f;
  }
  n_act = fmaxf(n_act, 1.f);

  // iterate: u, slacks/duals of the one-sided rows
  float u[H * NU], sl[H * NL], ll[H * NL], su[H * NP], lu[H * NP];
  // per-iteration work arrays
  float q_lin[H * NX], r_lin[H * NU], d_row[H * NC], du[H * NU];
  float inv_sl[H * NL], inv_su[H * NP];
  float r_pl[H * NL], r_pu[H * NP];  // primal residuals, then ds
  float dl_l[H * NL], dl_u[H * NP];
#pragma unroll 1
  for (int e = 0; e < H * NU; ++e) u[e] = 0.f;

  // Iteration -1 is the unconstrained start (D = 0, r_lin = 0); iterations
  // 0..iters-1 are the interior-point steps.  One call site keeps
  // newton_dir inlined once.
#pragma unroll 1
  for (int it = -1; it < prm.iters; ++it) {
    rollout_qlin(d, prm, x0, xd, umask, B, u, q_lin);
    float mu = 0.f, smu = 0.f;
    if (it < 0) {
#pragma unroll 1
      for (int e = 0; e < H * NC; ++e) d_row[e] = 0.f;
#pragma unroll 1
      for (int e = 0; e < H * NU; ++e) r_lin[e] = 0.f;
    } else {
      float acc_l = 0.f, acc_u = 0.f;
#pragma unroll 1
      for (int k = 0; k < H; ++k) {
        float cu[NC];
        c_mul(cm, B, u + k * NU, cu);
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int e = k * NL + i, r = lr_row(i);
          const float lbv = AT(lb, k * NC + r);
          const bool ml = lbv > -big;
          const float s = sl[e], lam = ll[e];
          r_pl[e] = ml ? cu[r] - lbv - s : 0.f;
          const float inv = 1.0f / jmax(s, s_floor);
          inv_sl[e] = inv;
          d_row[k * NC + r] = ml ? jmin(lam * inv, d_cap) : 0.f;
          acc_l += s * lam * (ml ? 1.f : 0.f);
        }
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int e = k * NP + i, r = ur_row(i);
          const float ubv = AT(ub, k * NC + r);
          const bool mu_ = ubv < big;
          const float s = su[e], lam = lu[e];
          r_pu[e] = mu_ ? ubv - cu[r] - s : 0.f;
          const float inv = 1.0f / jmax(s, s_floor);
          inv_su[e] = inv;
          const float dd = mu_ ? jmin(lam * inv, d_cap) : 0.f;
          d_row[k * NC + r] = ur_is_lr(i) ? d_row[k * NC + r] + dd : dd;
          acc_u += s * lam * (mu_ ? 1.f : 0.f);
        }
      }
      mu = (acc_l + acc_u) / n_act;
      smu = prm.sigma * mu;

      // r_lin = r2 u + C^T arg, arg = full_rows(d_l r_pl - tls, tus - d_u r_pu)
#pragma unroll 1
      for (int k = 0; k < H; ++k) {
        float arg[NC];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int e = k * NL + i;
          const bool ml = AT(lb, k * NC + lr_row(i)) > -big;
          const float dl = ml ? jmin(ll[e] * inv_sl[e], d_cap) : 0.f;
          const float tls = ml ? smu * inv_sl[e] : 0.f;
          arg[lr_row(i)] = dl * r_pl[e] - tls;
        }
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int e = k * NP + i, r = ur_row(i);
          const bool mu_ = AT(ub, k * NC + r) < big;
          const float dd = mu_ ? jmin(lu[e] * inv_su[e], d_cap) : 0.f;
          const float tus = mu_ ? smu * inv_su[e] : 0.f;
          const float a = tus - dd * r_pu[e];
          arg[r] = ur_is_lr(i) ? arg[r] + a : a;
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < NC; ++r) acc += arg[r] * AT(cm, r * NU + j);
          r_lin[k * NU + j] = prm.r2[j] * u[k * NU + j] + acc;
        }
      }
    }

    newton_dir(d, prm, umask, cm, B, d_row, q_lin, r_lin, kscr, du);

    if (it < 0) {
      // scale-aware start from the unconstrained solution
      float s_min = kInf;
#pragma unroll 1
      for (int k = 0; k < H; ++k) {
        float cu0[NC];
        c_mul(cm, B, du + k * NU, cu0);
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float lbv = AT(lb, k * NC + lr_row(i));
          const bool ml = lbv > -big;
          const float sh = ml ? cu0[lr_row(i)] - lbv : 1.f;
          sl[k * NL + i] = sh;
          if (ml) s_min = jmin(s_min, sh);
        }
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const float ubv = AT(ub, k * NC + ur_row(i));
          const bool mu_ = ubv < big;
          const float sh = mu_ ? ubv - cu0[ur_row(i)] : 1.f;
          su[k * NP + i] = sh;
          if (mu_) s_min = jmin(s_min, sh);
        }
      }
      const float shift = prm.init_slack + jmax(0.f, -1.5f * s_min);
#pragma unroll 1
      for (int k = 0; k < H; ++k) {
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int e = k * NL + i;
          const bool ml = AT(lb, k * NC + lr_row(i)) > -big;
          sl[e] = ml ? sl[e] + shift : 1.f;
          ll[e] = ml ? prm.init_dual / sl[e] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int e = k * NP + i;
          const bool mu_ = AT(ub, k * NC + ur_row(i)) < big;
          su[e] = mu_ ? su[e] + shift : 1.f;
          lu[e] = mu_ ? prm.init_dual / su[e] : 0.f;
        }
      }
      continue;
    }

    // slack/dual directions, step sizes, finiteness
    bool finite = true;
#pragma unroll 1
    for (int e = 0; e < H * NU; ++e) finite = finite && isfinite(du[e]);
    float rate_p = 0.f;   // max_i (-ds_i) / s_i over rows with ds < 0
    float ratio_d = kInf;  // min_i lam_i / (-dlam_i) over rows with dlam < 0
#pragma unroll 1
    for (int k = 0; k < H; ++k) {
      float cdu[NC];
      c_mul(cm, B, du + k * NU, cdu);
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int e = k * NL + i, r = lr_row(i);
        const bool ml = AT(lb, k * NC + r) > -big;
        const float dl = ml ? jmin(ll[e] * inv_sl[e], d_cap) : 0.f;
        const float t = cdu[r] + r_pl[e];
        const float ds = ml ? t : 0.f;
        const float dlam = ml ? smu * inv_sl[e] - ll[e] - dl * t : 0.f;
        finite = finite && isfinite(ds) && isfinite(dlam);
        if (ml && ds < 0.f) rate_p = jmax(rate_p, -ds * inv_sl[e]);
        if (ml && dlam < 0.f) ratio_d = jmin(ratio_d, ll[e] / jmax(-dlam, 1e-30f));
        r_pl[e] = ds;
        dl_l[e] = dlam;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int e = k * NP + i, r = ur_row(i);
        const bool mu_ = AT(ub, k * NC + r) < big;
        const float dd = mu_ ? jmin(lu[e] * inv_su[e], d_cap) : 0.f;
        const float t = -cdu[r] + r_pu[e];
        const float ds = mu_ ? t : 0.f;
        const float dlam = mu_ ? smu * inv_su[e] - lu[e] - dd * t : 0.f;
        finite = finite && isfinite(ds) && isfinite(dlam);
        if (mu_ && ds < 0.f) rate_p = jmax(rate_p, -ds * inv_su[e]);
        if (mu_ && dlam < 0.f) ratio_d = jmin(ratio_d, lu[e] / jmax(-dlam, 1e-30f));
        r_pu[e] = ds;
        dl_u[e] = dlam;
      }
    }
    const float a_p = prm.frac / jmax(rate_p, prm.frac);
    const float a_d = jmin(1.f, prm.frac * ratio_d);
    const bool skip = (mu < mu_floor) || !finite;
    if (!skip) {
#pragma unroll 1
      for (int e = 0; e < H * NU; ++e) u[e] += a_p * du[e];
#pragma unroll 1
      for (int k = 0; k < H; ++k) {
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int e = k * NL + i;
          if (AT(lb, k * NC + lr_row(i)) > -big) {
            sl[e] = jmin(jmax(sl[e] + a_p * r_pl[e], 0.f), sl_cap);
            ll[e] = jmin(jmax(ll[e] + a_d * dl_l[e], 0.f), sl_cap);
          }
        }
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int e = k * NP + i;
          if (AT(ub, k * NC + ur_row(i)) < big) {
            su[e] = jmin(jmax(su[e] + a_p * r_pu[e], 0.f), sl_cap);
            lu[e] = jmin(jmax(lu[e] + a_d * dl_u[e], 0.f), sl_cap);
          }
        }
      }
    }
  }

  // ---- final residuals (pallas_riccati.py:612-631) ----
  rollout_qlin(d, prm, x0, xd, umask, B, u, q_lin);
  float nu[NX];
#pragma unroll
  for (int m = 0; m < NX; ++m) nu[m] = q_lin[(H - 1) * NX + m];
  float r_d_max = 0.f, r_prim = 0.f, acc_l = 0.f, acc_u = 0.f;
#pragma unroll 1
  for (int k = H - 1; k >= 0; --k) {
    float mk[NU];
    load_mask(umask, B, k, mk);
    float lam_row[NC];  // full-row signed multipliers: -lam_l + lam_u
#pragma unroll
    for (int i = 0; i < NL; ++i) lam_row[lr_row(i)] = -ll[k * NL + i];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int r = ur_row(i);
      lam_row[r] = ur_is_lr(i) ? lam_row[r] + lu[k * NP + i] : lu[k * NP + i];
    }
    float bnu[NU];
    bt_mul(d, mk, nu, bnu);
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float ct = 0.f;
#pragma unroll
      for (int r = 0; r < NC; ++r) ct += lam_row[r] * AT(cm, r * NU + j);
      const float rd = prm.r2[j] * u[k * NU + j] + bnu[j] + ct;
      r_d_max = jmax(r_d_max, fabsf(rd));
    }
    if (k >= 1) {
      at_mul(d, nu);
#pragma unroll
      for (int m = 0; m < NX; ++m) nu[m] += q_lin[(k - 1) * NX + m];
    }
    float cu[NC];
    c_mul(cm, B, u + k * NU, cu);
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      const float lbv = AT(lb, k * NC + r), ubv = AT(ub, k * NC + r);
      const float rpl = (lbv > -big) ? jmax(lbv - cu[r], 0.f) : 0.f;
      const float rpu = (ubv < big) ? jmax(cu[r] - ubv, 0.f) : 0.f;
      r_prim = jmax(r_prim, jmax(rpl, rpu));
    }
#pragma unroll
    for (int i = 0; i < NL; ++i)
      acc_l += sl[k * NL + i] * ll[k * NL + i] *
               ((AT(lb, k * NC + lr_row(i)) > -big) ? 1.f : 0.f);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      acc_u += su[k * NP + i] * lu[k * NP + i] *
               ((AT(ub, k * NC + ur_row(i)) < big) ? 1.f : 0.f);
  }

#pragma unroll 1
  for (int e = 0; e < H * NU; ++e) u_out[(size_t)e * B] = u[e];
  stats_out[0] = (acc_l + acc_u) / n_act;
  stats_out[B] = r_d_max;
  stats_out[2 * B] = r_prim;
}

}  // namespace

extern "C" {

// Launches one solve of `batch` scenarios on `stream` (a cudaStream_t) and
// returns cudaGetLastError() as an int (0 = launched).  Every array is
// batch-minor float32: element e of scenario b at [e * batch + b].
int fused_riccati_solve(const float* s69, const float* scal, const float* b69,
                        const float* umask, const float* x0, const float* xd,
                        const float* cm, const float* lb, const float* ub,
                        float* u_out, float* stats_out, float* kscr, int batch,
                        const FusedRiccatiParams* params, void* stream) {
  if (batch <= 0) return 0;
  const int grid = (batch + THREADS - 1) / THREADS;
  fused_riccati_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      s69, scal, b69, umask, x0, xd, cm, lb, ub, u_out, stats_out, kscr, batch,
      *params);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_riccati_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Registers per thread, local (spill + array) bytes per thread and the
// largest block size the compiled kernel can launch with.
int fused_riccati_attributes(int* num_regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fused_riccati_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
