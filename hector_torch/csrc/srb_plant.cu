// One tier-1 plant step (hector_torch/plant/srb.py: step_plain) for every
// lane in one launch, ONE THREAD PER LANE.  CUDA C++ for sm_90a, plain C
// entry point (loaded with ctypes by hector_torch/plant/srb.py).  Beside it,
// from the same device functions, the controller tick's leg data
// (tick_legs_kernel, launched by hector_torch/kinematics.py: leg_data; see
// its note below).
//
// Replaces no TPU kernel: the JAX package leaves hector/plant/srb.py:step to
// XLA's fusion.  The port's eager step is some 745 small PyTorch ops, each a
// launch (a graph node inside a captured period) that moves a few KB; here
// the whole step is one launch.
//
// A lane reads its state (position, quaternion, velocities, joint angles and
// rates, stance anchors, last contact), its motor command (kp, kd, q_des),
// its stance wrench and scheduled contact, and optionally its push and its
// stairs terrain, and writes its next state.  Nothing crosses lanes, so a
// thread holds its lane in registers from the first load to the last store;
// the step is some thousand flops and ~70 transcendentals over a few hundred
// bytes, so what bounds it is the thread's chain of dependent operations,
// not memory.  THREADS = 64 spreads 1,024 lanes over 16 SMs, two warps
// each (on an H100, 11.2 us a step at 1,024 lanes, 13.2 at 16,384; 32
// threads a block 11.6 and 14.0).
//
// What it computes, in step_plain's order (it is a template on the state's
// dtype, float or double):
//   1. the torque-feasibility scale of the commanded stance wrench: the
//      Jacobian model's force-moment Jacobian (kinematics.leg_jacobians),
//      tau = J^T f_body, the scale min(1, limit / max|tau|);
//   2. the unilateral contact on the FK foot's penetration, the trunk-sphere
//      backstop, with the optional stairs terrain h floor(x / len);
//   3. the plant-side friction clamp on each foot's shear;
//   4. the force and torque sums with the optional push;
//   5. I_world^-1 by the adjugate (math.inv3) and the semi-implicit Euler
//      step with quat_integrate's renormalisation;
//   6. the stance IK (kinematics.leg_ik) towards the anchor seen from the
//      new pose, the servo tracking and the limp joints' velocity decay;
//   7. the touchdown anchor from a second FK.
// Every constant comes from the HectorConfig through SrbParams, rounded to
// the state's dtype as PyTorch rounds a Python scalar or a constant tensor.
//
// Rounding: each statement is one of step_plain's ops, in its order, and
// the source is compiled with -fmad=false, so a product and a sum are
// rounded apart as the eager ops round them.  The matrix products and the
// sums over legs and components run left to right, with the same terms as
// the eager products (the zero entries of a Jacobian or of diag(I) too, so
// that an infinite input gives NaN where the eager product does).
// Non-finite values propagate as the eager ops propagate them: the clamps
// and the max keep a NaN (torch.clamp, amax), which fminf/fmaxf would drop,
// and a 0/1 factor multiplies rather than selects.  The period's NaN
// quarantine (runtime._rollout) depends on it.

#include <cuda_runtime.h>

// The argument structs live outside the anonymous namespace: the C entry
// points take them.

// One input tensor: its data and its strides in elements (lane, then the
// trailing axes); any layout, so the wrapper copies nothing.
struct SrbIn {
  const void* p;
  long long s0, s1, s2;
};

struct SrbArgs {
  SrbIn position, quat, v_world, omega_world, q, qd, foot_anchor, contact;
  SrbIn kp, kd, q_des, wrench, sched;
  SrbIn disturbance, terrain_h, terrain_len;  // p null when absent
  // contiguous outputs: position (B,3), quat (B,4), v (B,3), omega (B,3),
  // q (B,2,5), qd (B,2,5), foot_anchor (B,2,3), contact (B,2) bool
  void* out[8];
  int batch;
};

// tick_legs_kernel's arguments: the raw motor angles (B, 2, 5) and the
// contiguous outputs j_fm (B, 2, 6, 5), p_leg (B, 2, 3), q_data (B, 2, 5)
struct LegsArgs {
  SrbIn q;
  void* out[3];
  int batch;
};

// Mirrored by srb._PARAM_FIELDS: the plant, FK, Jacobian and IK constants.
template <typename T>
struct SrbParams {
  T dt, mass, gravity, torque_limit, contact_kp, contact_kd, trunk_radius,
      ground_mu, joint_vel_limit, joint_tracking_tau, swing_joint_inertia;
  T inertia[3];
  T offsets[5];
  T hip_yaw[2][3];
  T hip_width[2][3];
  T fk_a_x, fk_a_y[2], fk_a_z, fk_b_y[2], fk_l[3];
  T jac_a_x, jac_a_y[2], jac_b_y[2], jac_l[3];
  T ik_hip_x, ik_hip_z, ik_dh, ik_dh2, ik_eps, ik_two_l, ik_side[2], pi;
};

namespace {

constexpr int THREADS = 64;

// sincosf / sincos: one argument reduction for both (on an H100 the
// kernel's outputs are the same bits as with sinf and cosf apart, over
// 16,384 lanes in float32 and float64, and it runs 1.4x faster)
__device__ __forceinline__ void m_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void m_sincos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float m_asin(float x) { return asinf(x); }
__device__ __forceinline__ double m_asin(double x) { return asin(x); }
__device__ __forceinline__ float m_acos(float x) { return acosf(x); }
__device__ __forceinline__ double m_acos(double x) { return acos(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

// torch.clamp's one-sided forms: a NaN stays NaN (both comparisons false)
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return x > hi ? hi : x;
}
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return clamp_max(clamp_min(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T load(const SrbIn& x, long long b, int i = 0, int j = 0) {
  return static_cast<const T*>(x.p)[b * x.s0 + i * x.s1 + j * x.s2];
}

__device__ __forceinline__ bool load_flag(const SrbIn& x, long long b, int i) {
  return static_cast<const unsigned char*>(x.p)[b * x.s0 + i * x.s1] != 0;
}

// kinematics._chain_terms of one leg: the trigonometry of the
// offset-corrected angles qe (chain_trig), which the FK and Jacobian models
// share (the same angles, other lengths), and the chain's reach with one
// model's lengths (chain_reach), each filled in place
template <typename T>
struct Chain {
  T c0, s0, c1, s1, c2, s2, c23, s23, c234, s234, sx, kz, v_x, v_y, v_z;
};

template <typename T>
__device__ __forceinline__ void chain_trig(const T qe[5], Chain<T>& t) {
  const T a23 = qe[2] + qe[3];
  const T a234 = a23 + qe[4];
  m_sincos(qe[0], &t.s0, &t.c0);
  m_sincos(qe[1], &t.s1, &t.c1);
  m_sincos(qe[2], &t.s2, &t.c2);
  m_sincos(a23, &t.s23, &t.c23);
  m_sincos(a234, &t.s234, &t.c234);
}

template <typename T>
__device__ __forceinline__ void chain_reach(Chain<T>& t, T b_y, T l1, T l2, T l3) {
  t.sx = l1 * t.s2 + l2 * t.s23 + l3 * t.s234;
  t.kz = l1 * t.c2 + l2 * t.c23 + l3 * t.c234;
  const T u_z = -t.kz;
  t.v_x = -t.sx;
  t.v_y = t.c1 * b_y - t.s1 * u_z;
  t.v_z = t.s1 * b_y + t.c1 * u_z;
}

template <typename T>
__device__ __forceinline__ Chain<T> chain_terms(const T qe[5], T b_y, T l1, T l2, T l3) {
  Chain<T> t;
  chain_trig(qe, t);
  chain_reach(t, b_y, l1, l2, l3);
  return t;
}

// kinematics.foot_position of leg `leg` (FK model), from the chain with the
// FK model's lengths
template <typename T>
__device__ __forceinline__ void fk_foot(const SrbParams<T>& c, int leg, const Chain<T>& t,
                                        T out[3]) {
  const T w_x = c.fk_a_x + t.v_x, w_y = c.fk_a_y[leg] + t.v_y;
  out[0] = t.c0 * w_x - t.s0 * w_y;
  out[1] = t.s0 * w_x + t.c0 * w_y;
  out[2] = c.fk_a_z + t.v_z;
}

// kinematics.foot_position of leg `leg` (FK model), from raw angles q
template <typename T>
__device__ __forceinline__ void foot_position(const SrbParams<T>& c, int leg, const T q[5],
                                              T out[3]) {
  T qe[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) qe[j] = q[j] + c.offsets[j];
  fk_foot(c, leg, chain_terms(qe, c.fk_b_y[leg], c.fk_l[0], c.fk_l[1], c.fk_l[2]), out);
}

// terrain_height: h floor(x / max(len, 1e-3))
template <typename T>
__device__ __forceinline__ T terrain(T x, T h, T len) {
  return h * m_floor(x / clamp_min(len, T(1e-3)));
}

template <typename T>
__device__ __forceinline__ void quat_to_rot(const T qt[4], T r[3][3]) {
  const T w = qt[0], x = qt[1], y = qt[2], z = qt[3];
  r[0][0] = T(1) - T(2) * (y * y + z * z);
  r[0][1] = T(2) * (x * y - w * z);
  r[0][2] = T(2) * (x * z + w * y);
  r[1][0] = T(2) * (x * y + w * z);
  r[1][1] = T(1) - T(2) * (x * x + z * z);
  r[1][2] = T(2) * (y * z - w * x);
  r[2][0] = T(2) * (x * z - w * y);
  r[2][1] = T(2) * (y * z + w * x);
  r[2][2] = T(1) - T(2) * (x * x + y * y);
}

// world position of leg `leg`'s FK foot: p + (hip_yaw + foot_position(q)) @ R^T
template <typename T>
__device__ __forceinline__ void fk_world(const SrbParams<T>& c, int leg, const T q[5],
                                         const T p[3], const T r[3][3], T out[3]) {
  T fp[3], hv[3];
  foot_position(c, leg, q, fp);
#pragma unroll
  for (int i = 0; i < 3; ++i) hv[i] = c.hip_yaw[leg][i] + fp[i];
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = p[j] + (hv[0] * r[j][0] + hv[1] * r[j][1] + hv[2] * r[j][2]);
}

// kinematics.leg_jacobians' J_force_moment of leg `leg`, from the chain with
// the Jacobian model's lengths b_y, l1-l3, handed to `column(j, col)` a joint
// at a time, so that the caller takes each column as it is made (the plant
// step sums its torque there): rows 0-2 the force Jacobian d p / d q_j
// (_chain_jacobian's closed form), rows 3-5 the joint axis, with its zero
// and one entries
template <typename T, typename F>
__device__ __forceinline__ void force_moment_jacobian(const SrbParams<T>& c, int leg,
                                                      const Chain<T>& t, T b_y, T l1, T l2,
                                                      T l3, F&& column) {
  const T c0 = t.c0, s0 = t.s0, c1 = t.c1, s1 = t.s1;
  const T w_x = c.jac_a_x + t.v_x, w_y = c.jac_a_y[leg] + t.v_y;
  const T zero = T(0), one = T(1);
  // the joint axes: yaw (0,0,1), roll (c0,s0,0), pitch (-c1 s0, c0 c1, s1)
  const T px = -c1 * s0, py = c0 * c1, pz = s1;
  // q0
  {
    const T col[6] = {-s0 * w_x - c0 * w_y, c0 * w_x - s0 * w_y, zero, zero, zero, one};
    column(0, col);
  }
  // q1: only v_y, v_z move
  {
    const T dvy = -s1 * b_y + c1 * t.kz;
    const T dvz = c1 * b_y + s1 * t.kz;
    const T col[6] = {-s0 * dvy, c0 * dvy, dvz, c0, s0, zero};
    column(1, col);
  }
  // q2, q3, q4: d sx and d kz of the planar reach
  const T dsx[3] = {l1 * t.c2 + l2 * t.c23 + l3 * t.c234, l2 * t.c23 + l3 * t.c234,
                    l3 * t.c234};
  const T dkz[3] = {-(l1 * t.s2 + l2 * t.s23 + l3 * t.s234), -(l2 * t.s23 + l3 * t.s234),
                    -l3 * t.s234};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T dvx = -dsx[j];
    const T dvy = s1 * dkz[j];
    const T dvz = -c1 * dkz[j];
    const T col[6] = {c0 * dvx - s0 * dvy, s0 * dvx + c0 * dvy, dvz, px, py, pz};
    column(2 + j, col);
  }
}

// tau = J_fm^T f of leg `leg`, as the (1, 6) x (6, 5) product: six terms a
// column, zeros included
template <typename T>
__device__ __forceinline__ void wrench_torques(const SrbParams<T>& c, int leg, const T q[5],
                                               const T f[6], T tau[5]) {
  T qe[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) qe[j] = q[j] + c.offsets[j];
  const T l1 = c.jac_l[0], l2 = c.jac_l[1], l3 = c.jac_l[2], b_y = c.jac_b_y[leg];
  const Chain<T> t = chain_terms(qe, b_y, l1, l2, l3);
  force_moment_jacobian(c, leg, t, b_y, l1, l2, l3, [&](int j, const T(&col)[6]) {
    tau[j] = f[0] * col[0] + f[1] * col[1] + f[2] * col[2] + f[3] * col[3] + f[4] * col[4] +
             f[5] * col[5];
  });
}

// kinematics.leg_ik of one leg: raw-frame joint targets towards the body-
// frame foot target d_b, with q_data the offset-corrected current angles
template <typename T>
__device__ __forceinline__ void leg_ik(const SrbParams<T>& c, int leg, const T d_b[3],
                                       const T q_data[5], T out[5]) {
  const T d0 = d_b[0] - c.ik_hip_x, d1 = d_b[1] - T(0), d2 = d_b[2] - c.ik_hip_z;
  const T dist3 = m_sqrt(d0 * d0 + d1 * d1 + d2 * d2);
  const T dist_yoz = m_sqrt(d1 * d1 + d2 * d2);
  const T dist_vert = m_sqrt(clamp_min(dist_yoz * dist_yoz - c.ik_dh2, c.ik_eps));
  const T dist_xoz = m_sqrt(clamp_min(dist3 * dist3 - c.ik_dh2, c.ik_eps));
  const T acos_arg1 = clamp(dist_xoz / c.ik_two_l, T(-1), T(1));
  const T acos_arg2 = clamp(dist_vert / dist_xoz, T(-1), T(1));
  const T divisor = m_abs(d0) == T(0) ? T(1e-6) : m_abs(d0);
  const T th1 = m_asin(clamp(d1 / dist_yoz, T(-1), T(1))) +
                m_asin(clamp(c.ik_dh * c.ik_side[leg] / dist_yoz, T(-1), T(1)));
  const T th2 = m_acos(acos_arg1) - m_acos(acos_arg2) * d0 / divisor;
  const T th3 = T(2) * m_asin(clamp(dist_xoz / c.ik_two_l, T(-1), T(1))) - c.pi;
  const T th4 = -q_data[3] - q_data[2];
  out[0] = T(0) - c.offsets[0];
  out[1] = th1 - c.offsets[1];
  out[2] = th2 - c.offsets[2];
  out[3] = th3 - c.offsets[3];
  out[4] = th4 - c.offsets[4];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) srb_plant_step_kernel(const SrbArgs a,
                                                                 const SrbParams<T> c) {
  const long long b = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= a.batch) return;
  const bool has_terrain = a.terrain_h.p != nullptr;
  const T h = has_terrain ? load<T>(a.terrain_h, b) : T(0);
  const T len = has_terrain ? load<T>(a.terrain_len, b) : T(0);

  T p[3], qt[4], v[3], om[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = load<T>(a.position, b, i);
    v[i] = load<T>(a.v_world, b, i);
    om[i] = load<T>(a.omega_world, b, i);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) qt[i] = load<T>(a.quat, b, i);
  T r[3][3];
  quat_to_rot(qt, r);
  const T vz = v[2];

  // trunk-sphere backstop
  const T trunk_ground = has_terrain ? terrain(p[0], h, len) : T(0);
  const T pen_trunk = trunk_ground + c.trunk_radius - p[2];
  const T n_trunk = clamp_min(c.contact_kp * pen_trunk - c.contact_kd * vz, T(0)) *
                    (pen_trunk > T(0) ? T(1) : T(0));

  // stance legs: scaled wrench, foot contact, friction clamp, their force
  // and torque on the body
  T force[3], torque[3];
#pragma unroll
  for (int leg = 0; leg < 2; ++leg) {
    T q[5], w[6];
#pragma unroll
    for (int j = 0; j < 5; ++j) q[j] = load<T>(a.q, b, leg, j);
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = load<T>(a.wrench, b, leg, k);
    const T in_f = load_flag(a.sched, b, leg) ? T(1) : T(0);

    // torque-feasibility scaling of the commanded stance wrench
    T f_body[6], tau[5];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      f_body[j] = -(w[0] * r[0][j] + w[1] * r[1][j] + w[2] * r[2][j]);
      f_body[3 + j] = -(w[3] * r[0][j] + w[4] * r[1][j] + w[5] * r[2][j]);
    }
    wrench_torques(c, leg, q, f_body, tau);
    T peak = m_abs(tau[0]);
#pragma unroll
    for (int j = 1; j < 5; ++j) {
      const T x = m_abs(tau[j]);
      peak = (x > peak || x != x) ? x : peak;  // amax: a NaN wins
    }
    const T scale =
        clamp_max(T(1) / clamp_min(peak, T(1e-6)) * c.torque_limit, T(1));
    const T s_in = scale * in_f;
    T we[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) we[k] = w[k] * s_in;

    // unilateral ground contact on the FK foot's penetration
    T fk0[3];
    fk_world(c, leg, q, p, r, fk0);
    const T ground0 = has_terrain ? terrain(fk0[0], h, len) : T(0);
    const T pen = ground0 - fk0[2];
    const T n_foot = clamp_min(c.contact_kp * pen - c.contact_kd * vz, T(0)) * in_f *
                     (pen > T(0) ? T(1) : T(0));

    // plant-side friction clamp on the foot's total shear
    const T fz_tot = we[2] + n_foot;
    const T shear_mag = m_sqrt(we[0] * we[0] + we[1] * we[1]);
    const T shear_cap = c.ground_mu * clamp_min(fz_tot, T(0));
    const T shear_scale = clamp_max(shear_cap / clamp_min(shear_mag, T(1e-9)), T(1));
    we[0] = we[0] * shear_scale;
    we[1] = we[1] * shear_scale;

    const T grf[3] = {we[0], we[1], we[2] + n_foot};
    T r_arm[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) r_arm[i] = load<T>(a.foot_anchor, b, leg, i) - p[i];
    const T tq[3] = {r_arm[1] * grf[2] - r_arm[2] * grf[1] + we[3],
                     r_arm[2] * grf[0] - r_arm[0] * grf[2] + we[4],
                     r_arm[0] * grf[1] - r_arm[1] * grf[0] + we[5]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      force[i] = leg == 0 ? grf[i] : force[i] + grf[i];
      torque[i] = leg == 0 ? tq[i] : torque[i] + tq[i];
    }
  }
  force[2] = force[2] + n_trunk;
  if (a.disturbance.p != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      force[i] = force[i] + load<T>(a.disturbance, b, i);
      torque[i] = torque[i] + load<T>(a.disturbance, b, 3 + i);
    }
  }

  // --- base dynamics ---
  // I_world = (R diag(I)) R^T, the zero terms of diag(I) included
  T iw[3][3];
  {
    T rd[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        rd[i][j] = r[i][0] * (j == 0 ? c.inertia[0] : T(0)) +
                   r[i][1] * (j == 1 ? c.inertia[1] : T(0)) +
                   r[i][2] * (j == 2 ? c.inertia[2] : T(0));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        iw[i][j] = rd[i][0] * r[j][0] + rd[i][1] * r[j][1] + rd[i][2] * r[j][2];
  }
  T rhs[3];
  {
    T lw[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) lw[i] = iw[i][0] * om[0] + iw[i][1] * om[1] + iw[i][2] * om[2];
    rhs[0] = torque[0] - (om[1] * lw[2] - om[2] * lw[1]);
    rhs[1] = torque[1] - (om[2] * lw[0] - om[0] * lw[2]);
    rhs[2] = torque[2] - (om[0] * lw[1] - om[1] * lw[0]);
  }
  T omega_dot[3];
  {
    // math.inv3: adjugate over determinant
    const T ia = iw[0][0], ib = iw[0][1], ic = iw[0][2];
    const T id = iw[1][0], ie = iw[1][1], iff = iw[1][2];
    const T ig = iw[2][0], ih = iw[2][1], ii = iw[2][2];
    const T co_a = ie * ii - iff * ih;
    const T co_b = -(id * ii - iff * ig);
    const T co_c = id * ih - ie * ig;
    const T det = ia * co_a + ib * co_b + ic * co_c;
    const T inv_det = T(1) / det;
    const T adj[3][3] = {{co_a, -(ib * ii - ic * ih), ib * iff - ic * ie},
                         {co_b, ia * ii - ic * ig, -(ia * iff - ic * id)},
                         {co_c, -(ia * ih - ib * ig), ia * ie - ib * id}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      omega_dot[i] = adj[i][0] * inv_det * rhs[0] + adj[i][1] * inv_det * rhs[1] +
                     adj[i][2] * inv_det * rhs[2];
  }

  const T dt = c.dt;
  const T g_vec[3] = {T(0), T(0), -c.gravity};
  T p_new[3], qn[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = v[i] + dt * (force[i] / c.mass + g_vec[i]);
    p_new[i] = p[i] + dt * v[i];  // semi-implicit Euler
    om[i] = om[i] + dt * omega_dot[i];
  }
  {
    // math.quat_integrate with its renormalisation
    const T w = qt[0], x = qt[1], y = qt[2], z = qt[3];
    const T ox = om[0], oy = om[1], oz = om[2];
    const T dw = T(-0.5) * (ox * x + oy * y + oz * z);
    const T dx = T(0.5) * (ox * w + oy * z - oz * y);
    const T dy = T(0.5) * (oy * w + oz * x - ox * z);
    const T dz = T(0.5) * (oz * w + ox * y - oy * x);
    qn[0] = w + dt * dw;
    qn[1] = x + dt * dx;
    qn[2] = y + dt * dy;
    qn[3] = z + dt * dz;
    const T norm = m_sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) qn[i] = qn[i] / norm;
  }
  {
    T* const o_p = static_cast<T*>(a.out[0]);
    T* const o_qt = static_cast<T*>(a.out[1]);
    T* const o_v = static_cast<T*>(a.out[2]);
    T* const o_om = static_cast<T*>(a.out[3]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o_p[b * 3 + i] = p_new[i];
      o_v[b * 3 + i] = v[i];
      o_om[b * 3 + i] = om[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) o_qt[b * 4 + i] = qn[i];
  }
  T r_new[3][3];
  quat_to_rot(qn, r_new);

  // --- joints: stance IK, servo tracking, limp decay; touchdown anchors ---
  T* const o_q = static_cast<T*>(a.out[4]);
  T* const o_qd = static_cast<T*>(a.out[5]);
  T* const o_anchor = static_cast<T*>(a.out[6]);
  bool* const o_contact = static_cast<bool*>(a.out[7]);
#pragma unroll
  for (int leg = 0; leg < 2; ++leg) {
    const bool in_contact = load_flag(a.sched, b, leg);
    T q[5], q_data[5], anchor[3];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      q[j] = load<T>(a.q, b, leg, j);
      q_data[j] = q[j] + c.offsets[j];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) anchor[i] = load<T>(a.foot_anchor, b, leg, i);
    // the anchor in the body frame of the new pose, plus the hip-width shift
    T d[3], anchor_b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = anchor[i] - p_new[i];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      anchor_b[j] =
          (d[0] * r_new[0][j] + d[1] * r_new[1][j] + d[2] * r_new[2][j]) + c.hip_width[leg][j];
    T q_stance[5];
    leg_ik(c, leg, anchor_b, q_data, q_stance);
    T q_new[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const T kp = load<T>(a.kp, b, leg, j);
      const T kd = load<T>(a.kd, b, leg, j);
      const T q_des = load<T>(a.q_des, b, leg, j);
      const T qd = load<T>(a.qd, b, leg, j);
      const bool has_target = (kp > T(0)) | in_contact;
      const T q_target = in_contact ? q_stance[j] : q_des;
      const T qd_des =
          clamp((q_target - q[j]) / c.joint_tracking_tau, -c.joint_vel_limit, c.joint_vel_limit);
      // limp joints: implicit first-order velocity decay through kd
      const T qd_limp = qd / (T(1) + dt * kd / c.swing_joint_inertia);
      const T qd_new = has_target ? qd_des : qd_limp;
      q_new[j] = q[j] + dt * qd_new;
      o_q[(b * 2 + leg) * 5 + j] = q_new[j];
      o_qd[(b * 2 + leg) * 5 + j] = qd_new;
    }
    // contact transitions: anchor at touchdown
    T fk[3];
    fk_world(c, leg, q_new, p_new, r_new, fk);
    const bool touchdown = in_contact & !load_flag(a.contact, b, leg);
    const T ground = has_terrain ? terrain(fk[0], h, len) : T(0);
    const T landed[3] = {fk[0], fk[1], ground};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      o_anchor[(b * 2 + leg) * 3 + i] = touchdown ? landed[i] : anchor[i];
    o_contact[b * 2 + leg] = in_contact;
  }
}

// The leg data of runtime.controller_tick (span tick.legs) for every lane
// in one launch, one thread a lane: kinematics.leg_jacobians' first output
// J_force_moment, foot_position (the FK model) and q_data = q + offsets,
// each leg's trigonometry taken once for both models.  Some 10 sincos and
// 200 flops a lane over 10 numbers in and 76 out, so, as in the plant step,
// the thread's chain of dependent operations bounds it, not memory.  Each
// output is kinematics.leg_data's plain version's ops in their order, zero
// and one entries written as they are, so a NaN or inf in q reaches the
// entries it reaches there.
template <typename T>
__global__ void __launch_bounds__(THREADS) tick_legs_kernel(const LegsArgs a,
                                                            const SrbParams<T> c) {
  const long long b = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= a.batch) return;
  T* const o_jfm = static_cast<T*>(a.out[0]);
  T* const o_p = static_cast<T*>(a.out[1]);
  T* const o_q = static_cast<T*>(a.out[2]);
#pragma unroll
  for (int leg = 0; leg < 2; ++leg) {
    const long long bl = b * 2 + leg;
    T qe[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      qe[j] = load<T>(a.q, b, leg, j) + c.offsets[j];
      o_q[bl * 5 + j] = qe[j];
    }
    // one trigonometry, the two models' reaches
    Chain<T> fk, jac;
    chain_trig(qe, fk);
    jac = fk;
    chain_reach(fk, c.fk_b_y[leg], c.fk_l[0], c.fk_l[1], c.fk_l[2]);
    const T b_y = c.jac_b_y[leg], l1 = c.jac_l[0], l2 = c.jac_l[1], l3 = c.jac_l[2];
    chain_reach(jac, b_y, l1, l2, l3);
    T p[3];
    fk_foot(c, leg, fk, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) o_p[bl * 3 + i] = p[i];
    force_moment_jacobian(c, leg, jac, b_y, l1, l2, l3, [&](int j, const T(&col)[6]) {
#pragma unroll
      for (int r = 0; r < 6; ++r) o_jfm[(bl * 6 + r) * 5 + j] = col[r];
    });
  }
}

template <typename T>
int launch(const SrbArgs& args, const void* params, cudaStream_t stream) {
  const int grid = (args.batch + THREADS - 1) / THREADS;
  srb_plant_step_kernel<T><<<grid, THREADS, 0, stream>>>(
      args, *static_cast<const SrbParams<T>*>(params));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_legs(const LegsArgs& args, const void* params, cudaStream_t stream) {
  const int grid = (args.batch + THREADS - 1) / THREADS;
  tick_legs_kernel<T><<<grid, THREADS, 0, stream>>>(
      args, *static_cast<const SrbParams<T>*>(params));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int attributes(K kernel, int* num_regs, int* local_bytes, int* threads, int* blocks_per_sm) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = fa.numRegs;
  *local_bytes = static_cast<int>(fa.localSizeBytes);
  *threads = THREADS;
  *blocks_per_sm = nb;
  return 0;
}

}  // namespace

extern "C" {

// Launches one plant step of args->batch lanes on `stream` (a cudaStream_t):
// srb_plant_step_kernel<double> if `is_double`, else <float>; `params`
// points at the SrbParams of that type.  Returns cudaGetLastError() as an
// int (0 = launched).
int srb_plant_step(int is_double, const SrbArgs* args, const void* params, void* stream) {
  if (args->batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(*args, params, st) : launch<float>(*args, params, st);
}

const char* srb_plant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the leg data of args->batch lanes on `stream`:
// tick_legs_kernel<double> if `is_double`, else <float>; `params` as for
// srb_plant_step.  Returns cudaGetLastError() as an int (0 = launched).
int tick_legs(int is_double, const LegsArgs* args, const void* params, void* stream) {
  if (args->batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? launch_legs<double>(*args, params, st)
                   : launch_legs<float>(*args, params, st);
}

// What the compiled kernel of the dtype takes: registers and local bytes a
// thread, threads a block, and the blocks an SM holds at once.
int srb_plant_attributes(int is_double, int* num_regs, int* local_bytes, int* threads,
                         int* blocks_per_sm) {
  return is_double ? attributes(srb_plant_step_kernel<double>, num_regs, local_bytes, threads,
                                blocks_per_sm)
                   : attributes(srb_plant_step_kernel<float>, num_regs, local_bytes, threads,
                                blocks_per_sm);
}

int tick_legs_attributes(int is_double, int* num_regs, int* local_bytes, int* threads,
                         int* blocks_per_sm) {
  return is_double ? attributes(tick_legs_kernel<double>, num_regs, local_bytes, threads,
                                blocks_per_sm)
                   : attributes(tick_legs_kernel<float>, num_regs, local_bytes, threads,
                                blocks_per_sm);
}

}  // extern "C"
