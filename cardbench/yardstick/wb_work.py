"""The work of one substep of the articulated plant, a lane, by the least
algorithm that computes it: the yardstick of ``plant_roofline.wb``.

Frozen here so that it charges the same work whatever implements the
plant (the port's 33 unit-motion passes of rnea.dynamics, or a kernel):
operations counted as in workcounts.op_count ('flop' each multiply and
each add, an FMA 2; a divide, a square root, a sine or a cosine one
operation), for a floating trunk and two chains of five revolute joints
(16 DoF, 11 bodies) in spatial vectors about the trunk's origin
(reference/whole_body.py), with the structure a careful implementation
uses: a rotation about a principal axis, symmetric matrices by their
triangle, a spatial inertia by its 10 parameters, a point's Jacobian row
by its non-zero columns.  The ground terms are charged for the eight
toe-box corners, whose contact carries the robot; the trunk's and the
knees' backstop points for their positions and contact law only (their
rows of J' D J are zero while the robot stands).
"""

from __future__ import annotations

N_DOF = 16
N_JOINTS = 10
N_BODIES = 11
N_TOE = 8            # toe-box corners, both legs
N_BODY_POINTS = 10   # trunk-box corners and knees
CROSS = 9            # a cross product: 6 multiplies, 3 subtractions
MAT3 = 45            # a 3x3 matrix product
MATVEC3 = 15         # a 3x3 matrix times a vector
SPATIAL_IV = 66      # a spatial inertia times a motion (6x6 by 6)


def op_count():
    """Operations of one substep, a lane, by term."""
    terms = {}
    # the trunk's rotation from its quaternion, the joints' sines and
    # cosines, each link's rotation (a principal-axis rotation composed
    # with its parent's), joint origin, com and motion subspace [a; o x a]
    terms['kinematics'] = (30 + 2 * N_JOINTS
                           + N_JOINTS * (MAT3 + 2 * (MATVEC3 + 3) + CROSS))
    # each body's spatial inertia about the trunk origin: R I R' (its
    # triangle), the com's terms m c and I - m cx cx
    terms['inertias'] = N_BODIES * (MAT3 + MAT3 // 2 + 3 + 30)
    # composite inertias, toe to hip and into the trunk (10 parameters)
    terms['composites'] = (N_JOINTS + 2) * 10
    # the mass matrix: F_j = Ic_j S_j, then S_i' F_j for i an ancestor
    # of j (15 pairs a leg), 11 operations each; the base block is a
    # selection of the total inertia
    terms['crba'] = N_JOINTS * SPATIAL_IV + 2 * 15 * 11
    # the bias forces at zero acceleration: the base's convective term;
    # a joint's velocity (S qd), v + S qd and the product v x S qd; each
    # body's I a + v x* I v; the backward sums and S' F
    terms['rnea'] = (CROSS + N_JOINTS * (6 + 6 + 3 * CROSS + 3 + 6)
                     + N_BODIES * (2 * SPATIAL_IV + 3 * CROSS + 3)
                     + N_JOINTS * (6 + 11) + 2 * 6)
    # contact points: toe corners (a rotation and an offset), trunk
    # corners; the Jacobian's joint columns a_j x (p - o_j) of the toe
    # corners (5 joints) and the knees (3 joints); the points' velocities
    # J nu over each row's non-zero columns (toe 11, trunk 6, knee 9)
    terms['points'] = ((N_TOE + 8) * (MATVEC3 + 3)
                       + N_TOE * 5 * (3 + CROSS) + 2 * 3 * (3 + CROSS)
                       + 3 * (N_TOE * 21 + 8 * 11 + 2 * 17))
    # the contact law a point: penetration and its clamps, the normal
    # spring, the estimate, the anchor, the tangential spring, its norm
    # (a root), the cone's ratio (a divide), the scale and the slide
    terms['contact_law'] = (N_TOE + N_BODY_POINTS) * 40
    # J' D J over the toe rows (24 rows of 11 columns: D j, then the
    # triangle of j j'), J' (f0 - D v)
    terms['jdj'] = 3 * N_TOE * (11 + 11 * 12) + 3 * N_TOE * (2 + 22)
    # the servo's explicit torque and clamp, A qd, the right-hand side,
    # dt J'DJ + diag(dt A) + 1e-6 on the left (its triangle)
    terms['servo_and_sides'] = (N_JOINTS * (8 + 2) + N_DOF * 2
                                + 2 * 136 + N_JOINTS + N_DOF)
    # the 16x16 Cholesky factorisation (n^3/3 multiply-adds, n roots,
    # n(n-1)/2 divides) and its two triangular solves
    n = N_DOF
    terms['solve'] = (2 * (n ** 3 - n) // 6 + n + n * (n - 1) // 2
                      + 2 * n * n)
    # the integration: velocities, the two caps (a norm, a root, a
    # divide, the scale), the joint rates' and angles' clamps and limits,
    # the trunk's position and the quaternion step and norm
    terms['integrate'] = 12 + 2 * 12 + N_JOINTS * (4 + 6) + 6 + 40
    return terms


def operations_per_substep():
    return sum(op_count().values())


def bytes_per_substep():
    """The state a lane reads and writes once a substep: position 3,
    quaternion 4, velocities 3 + 3, joint angles and rates 10 + 10,
    anchors 18 x 2 (float32) and sticking 18 (one byte), in and out;
    the servo command (5 x 10) and the push (6) in (float32)."""
    state = 4 * (3 + 4 + 3 + 3 + 10 + 10 + 2 * (N_TOE + N_BODY_POINTS)) \
        + (N_TOE + N_BODY_POINTS)
    return 2 * state + 4 * (5 * N_JOINTS + 6)
