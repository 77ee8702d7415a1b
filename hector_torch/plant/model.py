"""Articulated Hector model: joint tree + lumped link inertials.

The port's own copy of ``hector/plant/model.py`` (numpy only; importing
that module would run ``hector/__init__.py`` and with it JAX): the same
values, names and layouts, held equal by tests/test_torch_whole_body.py.

Transcribed from ``hector_description/xacro/{const,leg,robot}.xacro`` (the
same URDF Gazebo simulates).  Fixed "*_trans" motor-mass links are lumped
into their parent links here (combined mass/com/inertia via parallel axis)
-- Gazebo does the equivalent internally for fixed joints.

Notable model facts (cross-checked against the controller constants):

- URDF total mass = 11.6884 kg.  Biped.h claims 13.856 (unused by any code
  path) and the MPC hardcodes 9.0 (SolverMPC.cpp:423) -- three different
  masses in the reference; the plant follows the URDF.
- the thigh/calf/toe joint origins carry constant pitch offsets
  (0.25pi, -0.5pi, 0.25pi) -- close to but NOT equal to the controller's
  (0.3pi, -0.6pi, 0.3pi) correction (LegController.cpp:111): the
  controller's kinematics are an approximation of the URDF; we reproduce
  both sides faithfully.
- the toe is a 0.15 m box whose sole spans x in [-0.065, +0.085] around the
  ankle -- matching the MPC's line-contact lever arms lt=0.09 / lh=0.06.
"""

from __future__ import annotations

import numpy as np

PI = np.pi

# ---------- per-leg joint tree (leg frame constants; mirror = +1 L, -1 R)

def _rpy_to_mat(r, p, y):
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _lump(parts):
    """parts: [(mass, com(3), inertia_about_com(3,3))] in a common frame ->
    (mass, com, inertia about combined com)."""
    m_tot = sum(p[0] for p in parts)
    com = sum(p[0] * np.asarray(p[1]) for p in parts) / m_tot
    inertia = np.zeros((3, 3))
    for m, c, i_c in parts:
        d = np.asarray(c) - com
        inertia += np.asarray(i_c) + m * (np.dot(d, d) * np.eye(3)
                                          - np.outer(d, d))
    return m_tot, com, inertia


def _rot_inertia_x90(diag):
    """Inertia diag rotated by -pi/2 about x (the *_trans inertial rpy)."""
    ixx, iyy, izz = diag
    return np.diag([ixx, izz, iyy])


_TRANS_I = _rot_inertia_x90([0.00048, 0.00048, 0.00071])
_TRANS_M = 0.605


def leg_model(mirror: float):
    """Joint tree + lumped inertials for one leg.

    Returns list of 5 dicts: offset (in parent frame), pre-rotation,
    axis (child frame), mass, com (child frame), inertia (about com).
    Joint order: hip yaw, hip roll (hip2), thigh, calf, toe.
    """
    m = mirror
    hip = _lump([
        (0.173, [0.0268, -0.00315, -0.0272],
         np.diag([0.00022, 0.00024, 0.00016])),
        (_TRANS_M, [0.079, 0.015 * m, -0.0705], _TRANS_I),
    ])
    hip2 = _lump([
        (0.0722, [-0.033217, -0.010231, 0.0],
         np.diag([0.00004, 0.000101, 0.00007])),
        (_TRANS_M, [-0.06, -0.015 * m, 0.0], _TRANS_I),
    ])
    thigh = _lump([
        (0.397, [-0.000147, 0.01991 * m, -0.081117],
         np.diag([0.0019, 0.00218, 0.00033])),
        (_TRANS_M, [0.0, 0.0625 * m, 0.0], _TRANS_I),
        (_TRANS_M, [0.0, -0.0225 * m, -0.097], _TRANS_I),
    ])
    calf = (0.163, np.array([0.0, 0.020417 * m, -0.1141]),
            np.diag([0.00071, 0.00071, 0.000068352]))
    toe = (0.184, np.array([0.010569, 0.017949 * m, -0.017118]),
           np.diag([0.00005, 0.00021, 0.0002]))

    eye = np.eye(3)
    return [
        dict(offset=np.array([0.0, 0.047 * m, -0.1265]), pre=eye,
             axis=np.array([0.0, 0.0, 1.0]),
             mass=hip[0], com=hip[1], inertia=hip[2]),
        dict(offset=np.array([0.0465, 0.015 * m, -0.0705]), pre=eye,
             axis=np.array([1.0, 0.0, 0.0]),
             mass=hip2[0], com=hip2[1], inertia=hip2[2]),
        dict(offset=np.array([-0.06, 0.018 * m, 0.0]),
             pre=_rpy_to_mat(0, 0.25 * PI, 0), axis=np.array([0.0, 1.0, 0.0]),
             mass=thigh[0], com=thigh[1], inertia=thigh[2]),
        dict(offset=np.array([0.0, 0.0, -0.22]),
             pre=_rpy_to_mat(0, -0.5 * PI, 0), axis=np.array([0.0, 1.0, 0.0]),
             mass=calf[0], com=calf[1], inertia=calf[2]),
        dict(offset=np.array([0.0, 0.0, -0.22]),
             pre=_rpy_to_mat(0, 0.25 * PI, 0), axis=np.array([0.0, 1.0, 0.0]),
             mass=toe[0], com=toe[1], inertia=toe[2]),
    ]


TRUNK_MASS = 4.87
TRUNK_INERTIA = np.diag([0.052, 0.0441, 0.0184])

# Contact corners of the toe collision box (leg.xacro toe <collision>:
# origin xyz = (toe_x, toe_y*mirror, toe_z) = (0.01, +-0.0194, -0.02),
# box toe_length x toe_width x toe_height = 0.15 x 0.02 x 0.04;
# const.xacro toe block) -- the box's bottom face corners.
#
# DOCUMENTED DIVERGENCE from the URDF (tests/test_model_urdf.py): the
# URDF sole sits toe_y = 19.4 mm OUTBOARD of the toe frame per leg; we
# model it CENTERED (y = +-half_width about 0), matching the
# *controller's* foot model (the reference FK/IK/Raibert pipeline,
# LegController.cpp:108-195, knows nothing of toe_y either).  With the
# outboard offset enabled the closed loop develops a lateral limit cycle
# and falls within ~1.5 s of walking -- the controller regulates roll
# about a foot line 2 cm inboard of the true patch.  The offset is kept
# as a sensitivity axis (ContactConfig.toe_y_offset; the lateral-sweep
# harness can probe it) rather than a silent geometry choice.
#
# The 2 cm width matters: it is the foot's only roll support/damping in
# single stance; modeling the foot as a zero-width line (the r1
# two-point version) removes all lateral contact stiffness and the
# walking gait develops a growing lateral rocking limit cycle.
TOE_BOX_Y_CENTER = 0.0194   # the URDF's outboard offset (unused default)
CONTACT_POINTS_TOE = np.array([
    [0.085, 0.01, -0.04],    # toe tip, outboard
    [0.085, -0.01, -0.04],   # toe tip, inboard
    [-0.065, 0.01, -0.04],   # heel, outboard
    [-0.065, -0.01, -0.04],  # heel, inboard
])


def stacked_leg_models():
    """Arrays stacked over (leg, joint): offsets (2,5,3), pre (2,5,3,3),
    axis (2,5,3), mass (2,5), com (2,5,3), inertia (2,5,3,3)."""
    legs = [leg_model(1.0), leg_model(-1.0)]
    def stack(key):
        return np.stack([np.stack([j[key] for j in leg]) for leg in legs])
    return {k: stack(k) for k in
            ('offset', 'pre', 'axis', 'mass', 'com', 'inertia')}


def total_mass() -> float:
    models = stacked_leg_models()
    return float(TRUNK_MASS + models['mass'].sum())
