// The articulated plant's dynamics terms of one substep
// (hector_torch/plant/rnea.py: dynamics_plain) for every lane in one launch,
// ONE WARP PER LANE.  CUDA C++ for sm_90a, plain C entry point (loaded with
// ctypes through hector_torch/cuda.py, launched by rnea.dynamics).
//
// Replaces no TPU kernel: the JAX package leaves hector/plant/rnea.py to
// XLA's fusion.  The port's eager pass stacks 33 motions on one batch
// dimension and runs them through the recursive Newton-Euler pass, some 330
// small PyTorch ops a substep, each a launch (a graph node inside a captured
// period) that moves a few KB; here the substep's terms are one launch.
//
// A lane reads its state (trunk position and quaternion, joint angles, the
// generalized velocity nu = [v_world, omega_world, qd]) and the toe-frame
// contact offsets, and writes what the plant's substep needs: the mass
// matrix M (16, 16), the bias forces C nu + G (16), the contact points
// (P, 3), their velocities (P, 3) and the contact Jacobian (P, 3, 16), with
// P = 8 toe-box corners, + 8 trunk-box corners and 2 knees with the body
// points.  The algorithm is the plain path's own unit-motion recursion:
//   1. the geometry, which depends on q alone (the trunk rotation from the
//      quaternion; each link's rotation, joint origin, world axis, com and
//      world inertia; the contact points), once a lane;
//   2. 33 motions through it: 16 unit accelerations at rest (M's columns,
//      no gravity), the state's velocity at zero acceleration (the bias
//      under gravity, and the points' velocities), 16 unit velocities (the
//      Jacobian's columns, velocities alone).
//
// What bounds it on an H100.  The work is small (~40 kflop a lane) and
// sequential down each chain: a lane's M column is a forward pass of five
// joints a leg and a backward pass of five, ~2,000 dependent flops.  One
// thread a lane would run the 33 passes one after another (latency) and
// hold a 16x16 matrix and an 18x3x16 Jacobian (a spill), and 1,024 lanes
// would fill 16 of 132 SMs.  So a lane is a warp: the geometry is spread
// over threads by rows (row r of a link's rotation depends on row r of its
// parent's alone, so six threads, two legs by three rows, walk the chains
// with no exchange) and into shared memory, then thread k < 16 runs M's
// column k, thread 16 the bias and the state's point velocities, threads
// 17-31 the Jacobian's 16 columns (thread 17 two).  What is left is the
// chain of one motion's forward and backward pass (the bias thread's, the
// longest) and the writes, which are coalesced as they stand: a thread
// owns a column of M and of the Jacobian, whose index is the outputs' last
// axis, so a warp stores 64 contiguous bytes a row.  1,024 lanes are 1,024
// warps, LANES a block.
//
// Each statement is the plain path's operation in its order (sums of three
// terms left to right, the zero terms of a unit motion multiplied, not
// skipped, so a NaN in the state reaches what it reaches there); nvcc may
// contract a product and a sum into one rounding.  The Jacobian columns
// and the bias are the same passes the plain path runs, not a closed form.

#include <cuda_runtime.h>

// The argument structs live outside the anonymous namespace: the C entry
// points take them.

// One input tensor: its data and its strides in elements (lane, then the
// trailing axes); any layout, so the wrapper copies nothing.
struct WbIn {
  const void* p;
  long long s0, s1, s2;
};

struct WbArgs {
  // position (B,3), quat (B,4) wxyz, v_world (B,3), omega_world (B,3),
  // q (B,2,5), qd (B,2,5); cps (4,3) the left toe-frame contact offsets,
  // its s0 0 (one for every lane)
  WbIn position, quat, v_world, omega_world, q, qd, cps;
  // contiguous outputs: m (B,16,16), bias (B,16), pts (B,P,3), vels (B,P,3),
  // jac (B,P,3,16)
  void* out[5];
  int batch;
  int include_body;  // P = 18 if set, else 8
};

// Mirrored by cuda.WB_PARAM_FIELDS: the model of plant/model.py (per leg and
// joint: the offset in the parent frame, the pre-rotation, the axis, the
// mass, the com and the inertia about it), the trunk, its box corners,
// gravity.
template <typename T>
struct WbParams {
  T offset[2][5][3];
  T pre[2][5][3][3];
  T axis[2][5][3];
  T mass[2][5];
  T com[2][5][3];
  T inertia[2][5][3][3];
  T trunk_inertia[3][3];
  T corners[8][3];
  T trunk_mass, gravity;
};

namespace {

constexpr int LANES = 4;  // lanes (warps) a block
constexpr int THREADS = 32 * LANES;
constexpr int NDOF = 16;
constexpr int NCPS = 4;       // toe-box corners a leg
constexpr int NTOE = 2 * NCPS;
constexpr int NCORNERS = 8;   // trunk-box corners
constexpr int NBODY = NCORNERS + 2;

__device__ __forceinline__ void m_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void m_sincos(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> scale(V3<T> a, T s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <typename T>
__device__ __forceinline__ T dot(const T* a, const T* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V3<T> ld3(const T* p) {
  return {p[0], p[1], p[2]};
}
template <typename T>
__device__ __forceinline__ void st3(T* p, V3<T> v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
// m @ v
template <typename T>
__device__ __forceinline__ V3<T> mv(const T (&m)[3][3], V3<T> v) {
  return {(m[0][0] * v.x + m[0][1] * v.y) + m[0][2] * v.z,
          (m[1][0] * v.x + m[1][1] * v.y) + m[1][2] * v.z,
          (m[2][0] * v.x + m[2][1] * v.y) + m[2][2] * v.z};
}
// e_{k - base} as a vector of the components base..base+2 of a unit motion
template <typename T>
__device__ __forceinline__ V3<T> unit(int k, int base) {
  return {T(k == base), T(k == base + 1), T(k == base + 2)};
}

template <typename T>
__device__ __forceinline__ T load(const WbIn& x, long long b, int i = 0, int j = 0) {
  return static_cast<const T*>(x.p)[b * x.s0 + i * x.s1 + j * x.s2];
}
template <typename T>
__device__ __forceinline__ V3<T> load3(const WbIn& x, long long b) {
  return {load<T>(x, b, 0), load<T>(x, b, 1), load<T>(x, b, 2)};
}

// A lane's geometry, world frame, per leg and joint; written in step 1,
// read by every motion.
template <typename T>
struct Geo {
  T rot[2][5][3][3];  // link rotation
  T org[2][5][3];     // joint origin
  T d[2][5][3];       // parent rotation @ joint offset
  T ax[2][5][3];      // joint axis
  T r[2][5][3];       // com - origin
  T e[2][5][3];       // origin - the parent's origin (the trunk's at j = 0)
  T iw[2][5][3][3];   // inertia about the com
  T i0[3][3];         // the trunk's inertia
  T base_rot[3][3];
  T base_pos[3];
  T rel[2][NCPS][3];      // toe contact offsets, world frame
  T corner[NCORNERS][3];  // trunk-box corners about the trunk origin
};

// Row `row` of the trunk rotation (math.quat_to_rot).
template <typename T>
__device__ __forceinline__ void base_rot_row(const WbIn& quat, long long b, int row, T* out) {
  const T w = load<T>(quat, b, 0), x = load<T>(quat, b, 1), y = load<T>(quat, b, 2),
          z = load<T>(quat, b, 3);
  if (row == 0) {
    out[0] = T(1) - T(2) * (y * y + z * z);
    out[1] = T(2) * (x * y - w * z);
    out[2] = T(2) * (x * z + w * y);
  } else if (row == 1) {
    out[0] = T(2) * (x * y + w * z);
    out[1] = T(1) - T(2) * (x * x + z * z);
    out[2] = T(2) * (y * z - w * x);
  } else {
    out[0] = T(2) * (x * z - w * y);
    out[1] = T(2) * (y * z + w * x);
    out[2] = T(1) - T(2) * (x * x + y * y);
  }
}

// Step 1: row `row` of one leg's chain (rnea._geometry).  Row r of a link's
// rotation, origin, axis and com needs row r of its parent's alone.
template <typename T>
__device__ void chain_row(const WbArgs& a, const WbParams<T>& c, Geo<T>& g, long long b, int leg,
                          int row) {
  T rp[3];
  base_rot_row(a.quat, b, row, rp);
  T op = load<T>(a.position, b, row);
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    T s, co;
    m_sincos(load<T>(a.q, b, leg, j), &s, &co);
    const T omc = T(1) - co;
    // Rodrigues about the joint axis: (I + s K) + (1 - c) K K, K its cross
    // product matrix (K K exact for the model's principal axes, as the
    // plain path's float64 constant rounded to T is)
    const T* const u = c.axis[leg][j];
    const T kx[3][3] = {{T(0), -u[2], u[1]}, {u[2], T(0), -u[0]}, {-u[1], u[0], T(0)}};
    T ra[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T kk = (kx[i][0] * kx[0][k] + kx[i][1] * kx[1][k]) + kx[i][2] * kx[2][k];
        ra[i][k] = (T(i == k) + s * kx[i][k]) + omc * kk;
      }
    const T dr = dot(rp, c.offset[leg][j]);
    const T o = op + dr;
    T rpp[3], rot[3];  // this row of parent @ pre, and of the link's rotation
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rpp[k] = (rp[0] * c.pre[leg][j][0][k] + rp[1] * c.pre[leg][j][1][k]) +
               rp[2] * c.pre[leg][j][2][k];
#pragma unroll
    for (int k = 0; k < 3; ++k) rot[k] = (rpp[0] * ra[0][k] + rpp[1] * ra[1][k]) + rpp[2] * ra[2][k];
    const T rc = o + dot(rot, c.com[leg][j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) g.rot[leg][j][row][k] = rot[k];
    g.org[leg][j][row] = o;
    g.d[leg][j][row] = dr;
    g.ax[leg][j][row] = dot(rpp, c.axis[leg][j]);
    g.r[leg][j][row] = rc - o;
    g.e[leg][j][row] = o - op;
#pragma unroll
    for (int k = 0; k < 3; ++k) rp[k] = rot[k];
    op = o;
  }
}

// Step 2: row `row` of a link's world inertia (rot @ I) @ rot^T.
template <typename T>
__device__ __forceinline__ void world_inertia_row(const WbParams<T>& c, Geo<T>& g, int leg, int j,
                                                  int row) {
  const T(&rot)[3][3] = g.rot[leg][j];
  const T(&in)[3][3] = c.inertia[leg][j];
  T ri[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ri[k] = (rot[row][0] * in[0][k] + rot[row][1] * in[1][k]) + rot[row][2] * in[2][k];
#pragma unroll
  for (int col = 0; col < 3; ++col) g.iw[leg][j][row][col] = dot(ri, rot[col]);
}

// The motion of one leg, forward (rnea._motion) and backward (rnea._rnea):
// the joints' generalized forces into tau_out[j * tau_stride], the subtree
// wrench about the hip origin into f_sub, t_sub.  When `vels` is set (the
// state's motion), also the leg's points' velocities
// (rnea._point_velocities).
template <typename T>
__device__ __forceinline__ void leg_pass(const Geo<T>& g, const WbParams<T>& c, int leg, V3<T> w0,
                                         V3<T> wd0, V3<T> ao0, V3<T> gvec, const T (&qd)[5],
                                         const T (&qdd)[5], V3<T> v0, T* vels, int n_points,
                                         T* tau_out, int tau_stride, V3<T>& f_sub, V3<T>& t_sub) {
  V3<T> w_p = w0, wd_p = wd0, ao_p = ao0, v_p = v0;
  V3<T> f[5], t[5];
  V3<T> v_org3 = v0, v_org4 = v0, w4 = w0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const V3<T> d = ld3(g.d[leg][j]), ax = ld3(g.ax[leg][j]), r = ld3(g.r[leg][j]);
    // acceleration of the joint origin (a point on the parent body)
    const V3<T> ao = add(add(ao_p, cross(wd_p, d)), cross(w_p, cross(w_p, d)));
    const V3<T> w = add(w_p, scale(ax, qd[j]));
    const V3<T> wd = add(add(wd_p, scale(ax, qdd[j])), scale(cross(w_p, ax), qd[j]));
    const V3<T> a_com = add(add(ao, cross(wd, r)), cross(w, cross(w, r)));
    // Newton-Euler about the com
    f[j] = scale(sub(a_com, gvec), c.mass[leg][j]);
    t[j] = add(mv(g.iw[leg][j], wd), cross(w, mv(g.iw[leg][j], w)));
    if (vels != nullptr) {
      v_p = add(v_p, cross(w_p, ld3(g.e[leg][j])));
      if (j == 3) v_org3 = v_p;
      if (j == 4) {
        v_org4 = v_p;
        w4 = w;
      }
    }
    w_p = w;
    wd_p = wd;
    ao_p = ao;
  }
  // the subtree wrench about each joint origin
  V3<T> fs = {T(0), T(0), T(0)}, ts = fs;
#pragma unroll
  for (int j = 4; j >= 0; --j) {
    const V3<T> o = ld3(g.org[leg][j]);
    const V3<T> lever = j < 4 ? ld3(g.e[leg][j + 1]) : sub(o, o);
    ts = add(ts, cross(lever, fs));
    fs = add(fs, f[j]);
    ts = add(add(ts, t[j]), cross(ld3(g.r[leg][j]), f[j]));
    tau_out[j * tau_stride] = dot(ld3(g.ax[leg][j]), ts);
  }
  f_sub = fs;
  t_sub = ts;
  if (vels != nullptr) {
#pragma unroll
    for (int i = 0; i < NCPS; ++i)
      st3(vels + (leg * NCPS + i) * 3, add(v_org4, cross(w4, ld3(g.rel[leg][i]))));
    if (n_points > NTOE) st3(vels + (NTOE + NCORNERS + leg) * 3, v_org3);
  }
}

// Step 3, threads 0-16: M's column k (a unit acceleration at rest, no
// gravity) for k < 16, else the bias forces (the state's velocity at zero
// acceleration, under gravity) and the state's point velocities.
template <typename T>
__device__ void rnea_column(const WbArgs& a, const WbParams<T>& c, const Geo<T>& g, long long b,
                            int k, int n_points) {
  const bool bias = k == NDOF;
  const T zero = T(0);
  const V3<T> vz = {zero, zero, zero};
  const V3<T> v0 = bias ? load3<T>(a.v_world, b) : vz;
  const V3<T> w0 = bias ? load3<T>(a.omega_world, b) : vz;
  const V3<T> ao0 = unit<T>(k, 0), wd0 = unit<T>(k, 3);
  const V3<T> gvec = {zero, zero, -(bias ? c.gravity : zero)};
  T* const vels = bias ? static_cast<T*>(a.out[3]) + b * n_points * 3 : nullptr;
  // tau's entry i goes to m[b, i, k], or to bias[b, i]
  T* const tau = bias ? static_cast<T*>(a.out[1]) + b * NDOF
                      : static_cast<T*>(a.out[0]) + b * NDOF * NDOF + k;
  const int stride = bias ? 1 : NDOF;
  V3<T> f_sub[2], t_sub[2];
#pragma unroll
  for (int leg = 0; leg < 2; ++leg) {
    T qd[5], qdd[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      qd[j] = bias ? load<T>(a.qd, b, leg, j) : zero;
      qdd[j] = T(k == 6 + 5 * leg + j);
    }
    leg_pass(g, c, leg, w0, wd0, ao0, gvec, qd, qdd, v0, vels, n_points,
             tau + (6 + 5 * leg) * stride, stride, f_sub[leg], t_sub[leg]);
  }
  // the trunk, and the base wrench about the trunk origin
  const V3<T> f_trunk = scale(sub(ao0, gvec), c.trunk_mass);
  const V3<T> t_trunk = add(mv(g.i0, wd0), cross(w0, mv(g.i0, w0)));
  const V3<T> f_base = add(f_trunk, add(f_sub[0], f_sub[1]));
  V3<T> t_base = t_trunk;
#pragma unroll
  for (int leg = 0; leg < 2; ++leg)
    t_base = add(add(t_base, t_sub[leg]), cross(ld3(g.e[leg][0]), f_sub[leg]));
  tau[0 * stride] = f_base.x;
  tau[1 * stride] = f_base.y;
  tau[2 * stride] = f_base.z;
  tau[3 * stride] = t_base.x;
  tau[4 * stride] = t_base.y;
  tau[5 * stride] = t_base.z;
  if (bias && n_points > NTOE) {
#pragma unroll
    for (int i = 0; i < NCORNERS; ++i)
      st3(vels + (NTOE + i) * 3, add(v0, cross(w0, ld3(g.corner[i]))));
  }
}

// Step 3, threads 17-31: the Jacobian's column `col`, the points'
// velocities under the unit velocity e_col (rnea._point_velocities).
template <typename T>
__device__ void jacobian_column(const WbArgs& a, const Geo<T>& g, long long b, int col,
                                int n_points) {
  T* const jac = static_cast<T*>(a.out[4]) + b * n_points * 3 * NDOF + col;
  const V3<T> v0 = unit<T>(col, 0), w0 = unit<T>(col, 3);
#pragma unroll
  for (int leg = 0; leg < 2; ++leg) {
    V3<T> w_p = w0, v_p = v0, v_org3 = v0;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      v_p = add(v_p, cross(w_p, ld3(g.e[leg][j])));
      if (j == 3) v_org3 = v_p;
      w_p = add(w_p, scale(ld3(g.ax[leg][j]), T(col == 6 + 5 * leg + j)));
    }
#pragma unroll
    for (int i = 0; i < NCPS; ++i) {
      const V3<T> v = add(v_p, cross(w_p, ld3(g.rel[leg][i])));
      T* const o = jac + (leg * NCPS + i) * 3 * NDOF;
      o[0] = v.x;
      o[NDOF] = v.y;
      o[2 * NDOF] = v.z;
    }
    if (n_points > NTOE) {
      T* const o = jac + (NTOE + NCORNERS + leg) * 3 * NDOF;
      o[0] = v_org3.x;
      o[NDOF] = v_org3.y;
      o[2 * NDOF] = v_org3.z;
    }
  }
  if (n_points > NTOE) {
#pragma unroll
    for (int i = 0; i < NCORNERS; ++i) {
      const V3<T> v = add(v0, cross(w0, ld3(g.corner[i])));
      T* const o = jac + (NTOE + i) * 3 * NDOF;
      o[0] = v.x;
      o[NDOF] = v.y;
      o[2 * NDOF] = v.z;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wb_dynamics_kernel(const WbArgs a,
                                                               const WbParams<T> c) {
  __shared__ Geo<T> geo[LANES];
  const int lane = threadIdx.x / 32, t = threadIdx.x % 32;
  const long long b = static_cast<long long>(blockIdx.x) * LANES + lane;
  if (b >= a.batch) return;  // the whole warp
  Geo<T>& g = geo[lane];
  const int n_points = a.include_body ? NTOE + NBODY : NTOE;

  // 1. the chains (threads 0-5, a leg and a row each) and the trunk
  if (t < 6) {
    chain_row(a, c, g, b, t / 3, t % 3);
  } else if (t < 9) {
    base_rot_row(a.quat, b, t - 6, g.base_rot[t - 6]);
    g.base_pos[t - 6] = load<T>(a.position, b, t - 6);
  }
  __syncwarp();

  // 2. the links' world inertias (threads 0-29, a link and a row each), the
  // trunk's (thread 30), the contact points (threads 0-17)
  if (t < 30) {
    world_inertia_row(c, g, t / 15, (t / 3) % 5, t % 3);
  } else if (t == 30) {
    T rt[3][3];  // (base_rot @ I) @ base_rot^T
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rt[i][k] = (g.base_rot[i][0] * c.trunk_inertia[0][k] + g.base_rot[i][1] * c.trunk_inertia[1][k]) +
                   g.base_rot[i][2] * c.trunk_inertia[2][k];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) g.i0[i][k] = dot(rt[i], g.base_rot[k]);
  }
  T* const pts = static_cast<T*>(a.out[2]) + b * n_points * 3;
  if (t < NTOE) {
    // rnea._toe_offsets: the right leg's offsets mirrored in y
    const int leg = t / NCPS, i = t % NCPS;
    const T y = load<T>(a.cps, 0, i, 1);
    const V3<T> cp = {load<T>(a.cps, 0, i, 0), leg == 0 ? y : y * T(-1), load<T>(a.cps, 0, i, 2)};
    const V3<T> rel = mv(g.rot[leg][4], cp);
    st3(g.rel[leg][i], rel);
    st3(pts + t * 3, add(ld3(g.org[leg][4]), rel));
  } else if (t < NTOE + NCORNERS) {
    const int i = t - NTOE;
    const V3<T> rc = mv(g.base_rot, ld3(c.corners[i]));
    st3(g.corner[i], rc);
    if (n_points > NTOE) st3(pts + t * 3, add(ld3(g.base_pos), rc));
  } else if (t < NTOE + NBODY && n_points > NTOE) {
    st3(pts + t * 3, ld3(g.org[t - NTOE - NCORNERS][3]));
  }
  __syncwarp();

  // 3. the 33 motions
  if (t <= NDOF) {
    rnea_column(a, c, g, b, t, n_points);
  } else {
    for (int col = t - NDOF - 1; col < NDOF; col += 32 - NDOF - 1)
      jacobian_column(a, g, b, col, n_points);
  }
}

template <typename T>
int launch(const WbArgs& args, const void* params, cudaStream_t stream) {
  const int grid = (args.batch + LANES - 1) / LANES;
  wb_dynamics_kernel<T><<<grid, THREADS, 0, stream>>>(
      args, *static_cast<const WbParams<T>*>(params));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int attributes(K kernel, int* num_regs, int* local_bytes, int* shared_bytes, int* threads,
               int* blocks_per_sm) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = fa.numRegs;
  *local_bytes = static_cast<int>(fa.localSizeBytes);
  *shared_bytes = static_cast<int>(fa.sharedSizeBytes);
  *threads = THREADS;
  *blocks_per_sm = nb;
  return 0;
}

}  // namespace

extern "C" {

// Launches the dynamics terms of args->batch lanes on `stream` (a
// cudaStream_t): wb_dynamics_kernel<double> if `is_double`, else <float>;
// `params` points at the WbParams of that type.  Returns cudaGetLastError()
// as an int (0 = launched).
int wb_dynamics(int is_double, const WbArgs* args, const void* params, void* stream) {
  if (args->batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(*args, params, st) : launch<float>(*args, params, st);
}

const char* wb_dynamics_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// What the compiled kernel of the dtype takes: registers, local and static
// shared bytes, threads a block, and the blocks an SM holds at once.
int wb_dynamics_attributes(int is_double, int* num_regs, int* local_bytes, int* shared_bytes,
                           int* threads, int* blocks_per_sm) {
  return is_double ? attributes(wb_dynamics_kernel<double>, num_regs, local_bytes, shared_bytes,
                                threads, blocks_per_sm)
                   : attributes(wb_dynamics_kernel<float>, num_regs, local_bytes, shared_bytes,
                                threads, blocks_per_sm);
}

}  // extern "C"
