# The configuration's constants: a copy of hector_torch/config.py at commit
# dc0bcd9 (types and values only), so that the reference reads the same
# settings as the program without importing it.
"""Single source of truth for robot / MPC / gait / plant constants.

The reference hardcodes these constants in four different places (see
SURVEY.md §5 "Config / flag system"):

- ``hector_control/include/common/Biped.h:9-19`` (mass, hip offsets, link
  lengths),
- the symbolic Jacobian/FK in ``src/common/LegController.cpp:108-195``,
- the analytic IK in ``src/common/SwingLegController.cpp:157-187``,
- the MPC solver in ``ConvexMPC/SolverMPC.cpp`` and planner
  ``ConvexMPC/ConvexMPCLocomotion.cpp``.

Those four sites *disagree* in small ways (toe length 0.036 vs 0.04, hip
y-offsets 0.02 vs 0.015/0.0205, MPC mass 9.0 vs Biped mass 13.856).  We keep
each consumer's constants verbatim, grouped and documented, so parity with the
reference is exact while still having one python module to read.

Everything here is a frozen dataclass: hashable, serializable with every run.

This is the PyTorch port's own copy of ``hector/config.py``: importing that
module would run ``hector/__init__.py`` and with it JAX.  The values and
field names are identical (tests/test_torch_modules.py holds them equal);
``PlantConfig`` also carries the tier-2 plant's joint damping and limits,
which the JAX package writes inline in its whole-body step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

PI = 3.14159265359  # value used by the reference (ConvexMPCLocomotion.cpp:300)

# Joint-offset correction applied to the knee chain (hip-pitch, knee, toe) in
# *three* places in the reference (LegController.cpp:111-113,
# ConvexMPCLocomotion.cpp:302-307, SolverMPC.cpp:382-388).
JOINT_OFFSETS = (0.0, 0.0, 0.3 * PI, -0.6 * PI, 0.3 * PI)


@dataclasses.dataclass(frozen=True)
class LegFKModel:
    """Constants of the FK chain used by foot-position computation.

    Derived from the symbolic expressions at
    ``src/common/LegController.cpp:190-194`` (which differ from the Jacobian's
    own constants below -- a reference quirk we reproduce faithfully).

    Chain: p = Rz(q0) @ (a + Rx(q1) @ (b + sum_i Ry(theta_i) @ (0,0,-l_i)))
    with theta = (q2, q2+q3, q2+q3+q4), side = +1 for the left leg (leg 0).
    """

    a_x: float = -3.0 / 200.0        # -0.015
    a_y_side: float = 1.0 / 50.0     # +0.02 * side
    a_z: float = -3.0 / 50.0         # -0.06
    b_y_side: float = 23.0 / 1000.0  # +0.023 * side
    l_thigh: float = 11.0 / 50.0     # 0.22
    l_calf: float = 11.0 / 50.0      # 0.22
    l_toe: float = 9.0 / 250.0       # 0.036  (NOT the Jacobian's 0.04)


@dataclasses.dataclass(frozen=True)
class LegJacobianModel:
    """Constants of the chain the reference's symbolic Jacobian was generated
    from (``src/common/LegController.cpp:131-186``).

    Distinct from LegFKModel: toe length is 0.04, the hip offsets are
    (-0.0135, -0.015*side) and (-(0.018*side + 0.0025)).  The linear Jacobian
    is d p_J / d q of the chain below; the angular block's columns are the
    world-frame joint axes (z, Rz@x, Rz@Rx@y).
    """

    a_x: float = -0.0135
    a_y_side: float = -0.015
    b_y_side: float = -0.018
    b_y_const: float = -0.0025
    l_thigh: float = 0.22
    l_calf: float = 0.22
    l_toe: float = 0.04


@dataclasses.dataclass(frozen=True)
class LegIKModel:
    """Constants of the geometric 5-DoF IK
    (``src/common/SwingLegController.cpp:157-187``).

    hip_roll point = (hipRollLocation.x - 0.06, 0, hipYawLocation.z +
    2*hipRollLocation.z) = (-0.0135, 0, -0.267) with Biped.h values.
    """

    hip_x: float = 0.0465 - 0.06           # -0.0135
    hip_z: float = -0.126 + 2 * (-0.0705)  # -0.267
    distance_horizontal: float = 0.0205
    l_link: float = 0.22
    eps_vertical: float = 0.00001


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Body-level constants (``include/common/Biped.h:9-19`` and
    ``ConvexMPC/RobotState.cpp:45``, ``hector_description/xacro/const.xacro``).
    """

    mass: float = 13.856
    # hip yaw location in body frame; y is mirrored for the right leg
    hip_yaw_x: float = -0.005
    hip_yaw_y: float = -0.057   # leg 0 (left): -0.057, leg 1: +0.057
    hip_yaw_z: float = -0.126
    hip_roll_x: float = 0.0465
    hip_roll_y: float = 0.015
    hip_roll_z: float = -0.0705
    hip_link: float = 0.038
    thigh_link: float = 0.22
    calf_link: float = 0.22
    # trunk+thigh lumped inertia used by the MPC (RobotState.cpp:45)
    inertia_body: Tuple[float, float, float] = (0.5413, 0.5200, 0.0691)
    torque_limit: float = 33.5  # Nm (const.xacro, SolverMPC.cpp:463)

    def hip_yaw_location(self, leg: int) -> Tuple[float, float, float]:
        sign = 1.0 if leg == 0 else -1.0
        return (self.hip_yaw_x, sign * self.hip_yaw_y, self.hip_yaw_z)


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """MPC problem constants.

    Sources: ``ConvexMPCLocomotion.cpp:14,20,321-322,410``,
    ``SolverMPC.cpp:16,423,473-490,488-490``.
    """

    dt: float = 0.001                 # control tick (main.cpp:30, 1 kHz)
    iterations_between_mpc: int = 40  # gait-segment ticks (FSMState_Walking.cpp:5)
    mpc_cadence: int = 5              # solve every 5 ticks (ConvexMPCLocomotion.cpp:277)
    horizon: int = 10
    mass: float = 9.0                 # SolverMPC.cpp:423 (NOT Biped.mass -- quirk)
    gravity: float = 9.81
    f_max: float = 500.0              # setup_problem arg (ConvexMPCLocomotion.cpp:410)
    mu_constraint: float = 2.0        # SolverMPC.cpp:488 (the 0.25 passed in is ignored)
    lt: float = 0.09                  # toe lever arm (SolverMPC.cpp:489)
    lh: float = 0.06                  # heel lever arm (SolverMPC.cpp:490)
    mx_bound: float = 0.01            # Mx upper bound (SolverMPC.cpp:473)
    big_number: float = 5e10          # BIG_NUMBER (SolverMPC.cpp:16)
    # state weights Q: roll pitch yaw, x y z, droll dpitch dyaw, dx dy dz
    weights: Tuple[float, ...] = (
        100.0, 100.0, 250.0, 200.0, 200.0, 300.0,
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    # input regularization Alpha (ConvexMPCLocomotion.cpp:322)
    alpha: Tuple[float, ...] = (
        1e-4, 1e-4, 5e-4, 1e-4, 1e-4, 5e-4,
        1e-2, 1e-2, 1e-2, 1e-2, 1e-2, 1e-2)
    body_height: float = 0.55         # ConvexMPCLocomotion.cpp:55,356
    max_pos_error: float = 0.05       # xy drift clamp (ConvexMPCLocomotion.cpp:335)

    @property
    def dt_mpc(self) -> float:
        return self.dt * self.iterations_between_mpc  # 0.04 s


@dataclasses.dataclass(frozen=True)
class GaitConfig:
    """A phase-offset gait (``ConvexMPC/GaitGenerator.cpp``).

    walking  = Gait(10, (0,5), (5,5))   (ConvexMPCLocomotion.cpp:16)
    standing = Gait(10, (0,0), (10,10)) (ConvexMPCLocomotion.cpp:17)
    """

    n_segments: int = 10
    offsets: Tuple[int, int] = (0, 5)
    durations: Tuple[int, int] = (5, 5)

    @property
    def stance(self) -> int:
        return self.durations[0]

    @property
    def swing(self) -> int:
        return self.n_segments - self.durations[0]


WALKING_GAIT = GaitConfig(10, (0, 5), (5, 5))
STANDING_GAIT = GaitConfig(10, (0, 0), (10, 10))


@dataclasses.dataclass(frozen=True)
class SwingConfig:
    """Swing-leg controller constants (``src/common/SwingLegController.cpp``)."""

    swing_height: float = 0.15        # :105
    raibert_gain: float = 1.75        # :111
    vel_gain: float = 0.1             # :112
    p_rel_max: float = 0.3            # :110
    hip_width_offset_x: float = -0.015   # :146
    hip_width_offset_y: float = -0.055   # :146 (times side)
    kp_swing: Tuple[float, ...] = (30.0, 30.0, 30.0, 30.0, 20.0)  # :198
    kd_swing: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)       # :200


@dataclasses.dataclass(frozen=True)
class PlantConfig:
    """Tier-1 batched SRB plant (replaces Gazebo ODE; SURVEY.md §2.3), and
    the two constants of the tier-2 plant that the JAX package keeps
    inline."""

    dt: float = 0.001
    mass: float = 13.856
    inertia_body: Tuple[float, float, float] = (0.5413, 0.5200, 0.0691)
    gravity: float = 9.81
    torque_limit: float = 33.5
    joint_vel_limit: float = 21.0     # rad/s (const.xacro)
    # first-order joint-servo tracking for kinematic swing legs
    joint_tracking_tau: float = 0.02
    # effective link inertia seen by a limp (kp=0) joint's kd damping
    # (distal thigh+calf+toe lumped about the joint, ~0.5 kg at ~0.2 m)
    swing_joint_inertia: float = 0.02
    # unilateral ground contact (penalty spring-damper on penetration; the
    # batched analog of the ODE quick-solver contact in
    # unitree_gazebo/worlds/normal.world)
    contact_kp: float = 3.0e4         # N/m   (static droop mg/kp ~ 4.5 mm)
    contact_kd: float = 500.0         # N s/m (zeta ~ 0.4 at 13.856 kg)
    trunk_radius: float = 0.10        # m, trunk collision backstop
    ground_mu: float = 1.0            # ground friction (plant-side cap)
    # the tier-2 articulated plant (plant/whole_body.py), which the JAX
    # package writes inline (hector/plant/whole_body.py:159,209-210):
    # URDF <dynamics damping> of every joint, N m s/rad
    joint_damping: float = 0.1
    # URDF joint limits, +-rad, per joint of a leg (hip yaw, hip roll
    # +-45 deg; thigh, calf, toe +-100 deg)
    joint_limit: Tuple[float, ...] = (0.785, 0.785, 1.745, 1.745, 1.745)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Fixed-iteration batched PDIP QP solver settings (hector/qp/pdip.py)."""

    # float32 converges to its ~6-8 mN accuracy floor by ~14 iterations on
    # the Hector QP family (f64 parity tests use 25)
    iterations: int = 14
    # Mehrotra predictor-corrector for the dense/pure-JAX paths; the fused
    # Pallas stage kernel always uses the fixed-sigma single-corrector step
    # (one linear solve per iteration, nothing persisted but K/kff)
    mehrotra: bool = True
    # centering parameter for the fixed-sigma path
    sigma_fixed: float = 0.1
    frac_to_boundary: float = 0.99
    init_slack: float = 1.0
    init_dual: float = 1.0
    # rows with |bound| above this threshold are treated as one-sided
    big_threshold: float = 1e9
    # Tikhonov jitter added to the KKT diagonal for float32 robustness
    kkt_reg: float = 1e-8
    # --- active-set polish (closes the literal 1e-3 N qpOASES parity bar
    # in float32; tests/test_pallas_riccati.py) ---
    # The interior-point loop's d_cap/s_floor clamps stall its iterates
    # REGARDLESS of precision (the same fixed-sigma schedule in float64
    # stalls at the same iterate): typically a few mN from the exact
    # optimum, up to ~0.1 N on near-degenerate standing scenarios whose
    # Hessian has flat directions.  With polish_rounds > 0 the solver
    # runs a primal-dual active-set refinement (PDAS set estimation +
    # augmented-Lagrangian equality solves at penalty polish_rho, with
    # best-of-rounds selection by a KKT merit and per-lane fallback to
    # the IP iterate -- hector/qp/riccati.py polish block).  On the
    # operating-envelope state distribution this lands within ~2e-4 N of
    # qpOASES in pure float32 (tests/test_qpoases_parity.py); on
    # uniformly-random EXTREME states ~5% of lanes reject the polish and
    # fall back to the ~1e-2 IP iterate.  Cost ~rounds*iters extra
    # Riccati solves.  0 = off (the production closed-loop default: the
    # 14-iteration interior smoothing is part of the adjudicated walking
    # behavior, PERF.md lateral-envelope section).
    polish_rounds: int = 0
    polish_iters: int = 4
    polish_rho: float = 300.0
    polish_tol: float = 1e-6
    # solver backend (hector_torch.mpc.mpc_update):
    #   'auto'                -> by the problem's device, as the reference
    #                         resolves it by jax.default_backend()
    #                         (hector/mpc.py:160-164): 'riccati_pallas' on
    #                         the card, 'riccati' on the CPU
    #   'riccati_pallas'      -> the fused Riccati interior point
    #                         (hector_torch/qp/fused_riccati.py): the CUDA
    #                         kernel for CUDA tensors, its plain PyTorch
    #                         version for CPU tensors; with polish_rounds > 0
    #                         the kernel that carries the polish; horizon 10
    #   'riccati_pallas_interpret' -> the fused plain version on any device
    #                         (no kernel launch), with or without the polish
    #   'riccati'             -> the stage solver (hector_torch/qp/riccati.py;
    #                         Mehrotra unless mehrotra=False, polish when
    #                         polish_rounds > 0) on any device, batched
    #                         PyTorch ops, no kernel of its own
    #   the condensed dense interior point (hector_torch/qp/pdip.py):
    #   'dense_auto' | 'pallas' -> the CUDA Cholesky factor and solve kernels
    #                         (hector_torch/qp/chol.py) for CUDA tensors,
    #                         their plain versions for CPU tensors
    #   'pallas_interpret'    -> the plain versions on any device, in the
    #                         batch-minor layout of the TPU kernels
    #   'xla'                 -> torch.linalg on (B, n, n); only by name
    #   'qpoases'             -> the reference's qpOASES on the host, one
    #                         lane after another (hector_torch/qp/
    #                         ref_check.py); raises without its sources
    backend: str = 'auto'


@dataclasses.dataclass(frozen=True)
class HectorConfig:
    robot: RobotModel = RobotModel()
    mpc: MPCConfig = MPCConfig()
    swing: SwingConfig = SwingConfig()
    plant: PlantConfig = PlantConfig()
    solver: SolverConfig = SolverConfig()
    fk: LegFKModel = LegFKModel()
    jac: LegJacobianModel = LegJacobianModel()
    ik: LegIKModel = LegIKModel()


DEFAULT_CONFIG = HectorConfig()
