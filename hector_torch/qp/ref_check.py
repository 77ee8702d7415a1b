"""Host-side QP oracles (port of ``hector/qp/ref_check.py``).

Two double-precision solvers of the condensed QP, both native code bound
with ctypes and run on the host in float64:

- the clean-room active-set oracle ``native/qp_oracle.cpp``
  (:func:`solve_dense`, :func:`solve_qpdata`), the independent reference
  the card's float32 kernels are held to;
- the reference's own qpOASES (:func:`qpoases_solve_dense`,
  :func:`solve_qpdata_qpoases` with its swing-variable elimination, and
  :func:`solve_batched_qpoases`, the ``'qpoases'`` backend of
  ``hector_torch.mpc``), compiled with ``native/qpoases_bridge.cpp`` from
  the vendored qpOASES sources of the reference checkout
  (``HECTOR_QPOASES_DIR``).  Without those sources the backend raises
  before any solve: it never plans in their place.

Both libraries are built with g++ at first use, with the flags the JAX
package builds them with, into ``hector_torch/_build/`` (never under
``native/``): the port's oracle answers bit for bit what JAX's does.
Inputs may be tensors on any device or numpy arrays.
"""

from __future__ import annotations

import ctypes
import glob
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import _native
from .fused_riccati import QPSolution

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_LIB = None
_QPOASES_LIB = None


def _f64(x) -> np.ndarray:
    """x (a tensor on any device, an array or a number) as a contiguous
    float64 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to('cpu', torch.float64).numpy()
    return np.ascontiguousarray(x, np.float64)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_DOUBLE_P)


def _lib():
    global _LIB
    if _LIB is None:
        so, _ = _native.build('g++', [_native.NATIVE_DIR / 'qp_oracle.cpp'],
                              'qp_oracle', _native.GXX_FLAGS)
        lib = ctypes.CDLL(str(so))
        lib.qp_oracle_solve.restype = ctypes.c_int
        lib.qp_oracle_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, _DOUBLE_P, _DOUBLE_P, _DOUBLE_P,
            _DOUBLE_P, _DOUBLE_P, _DOUBLE_P, ctypes.c_int, ctypes.c_double,
            ctypes.c_double]
        _LIB = lib
    return _LIB


def _dense_args(h_mat, g_vec, a_mat, lb, ub):
    """The five QP arrays in float64, their sizes checked against the
    solvers' (n, n), (n,), (m, n), (m,), (m,) layout."""
    h, g, a, lo, hi = map(_f64, (h_mat, g_vec, a_mat, lb, ub))
    n, m = g.shape[0], lo.shape[0]
    if (g.shape != (n,) or h.shape != (n, n) or a.shape != (m, n)
            or lo.shape != (m,) or hi.shape != (m,)):
        raise ValueError(f'QP shapes H {h.shape}, g {g.shape}, A {a.shape}, '
                         f'lb {lo.shape}, ub {hi.shape} do not fit n={n}, '
                         f'm={m}')
    return h, g, a, lo, hi


def solve_dense(h_mat, g_vec, a_mat, lb, ub, max_iter: int = 2000,
                tol: float = 1e-10, big_threshold: float = 1e9
                ) -> np.ndarray:
    """Solve min 1/2 x^T H x + g^T x s.t. lb <= A x <= ub in float64 with
    the native active-set oracle.  Returns x (n,); raises RuntimeError on
    solver failure."""
    h, g, a, lo, hi = _dense_args(h_mat, g_vec, a_mat, lb, ub)
    x = np.zeros(g.shape[0], np.float64)
    rc = _lib().qp_oracle_solve(g.shape[0], lo.shape[0], _ptr(h), _ptr(g),
                                _ptr(a), _ptr(lo), _ptr(hi), _ptr(x),
                                max_iter, tol, big_threshold)
    if rc != 0:
        raise RuntimeError(f'qp_oracle_solve failed rc={rc}')
    return x


def constraint_matrix(c_block, h: int) -> np.ndarray:
    """The full (16h, 12h) constraint matrix: the per-step block repeated
    down the diagonal, as fmat is laid out (SolverMPC.cpp:552-555)."""
    c = _f64(c_block)
    a = np.zeros((16 * h, 12 * h))
    for i in range(h):
        a[16 * i:16 * (i + 1), 12 * i:12 * (i + 1)] = c
    return a


def solve_qpdata(qp, **kw) -> np.ndarray:
    """Solve a ``QPData`` with the native oracle in float64.  Fields without
    a batch axis (one QP) give x (12h,); with a leading batch axis, one
    solve a lane gives (B, 12h).  ``kw`` goes to :func:`solve_dense`."""
    if qp.g_vec.ndim == 2:
        return np.stack([solve_qpdata(type(qp)(*[f[b] for f in qp]), **kw)
                         for b in range(qp.g_vec.shape[0])])
    h = qp.lb.shape[-2]
    return solve_dense(qp.h_mat, qp.g_vec, constraint_matrix(qp.c_block, h),
                       _f64(qp.lb).reshape(-1), _f64(qp.ub).reshape(-1),
                       **kw)


# ---------------------------------------------------------------------------
# The reference's qpOASES, compiled out of tree from its vendored sources
# (SolverMPC.cpp:702-712 usage, reproduced by native/qpoases_bridge.cpp).

# the vendored qpOASES of the reference checkout
# (Hector_ROS_Simulation/hector_control/third_party/qpOASES), named by
# HECTOR_QPOASES_DIR; unset, the backend is unavailable and raises
QPOASES_REF_DIR = os.environ.get('HECTOR_QPOASES_DIR')


class QPoasesFailure(RuntimeError):
    """qpOASES returned a non-zero returnValue for one QP."""


def qpoases_available() -> bool:
    """True when HECTOR_QPOASES_DIR names a directory with a ``src/``."""
    return (QPOASES_REF_DIR is not None
            and os.path.isdir(os.path.join(QPOASES_REF_DIR, 'src')))


def require_qpoases() -> None:
    """Raise unless the qpOASES sources are present: the 'qpoases' backend
    checks this before it solves anything."""
    if not qpoases_available():
        raise RuntimeError(
            f"the 'qpoases' backend needs the qpOASES sources: set "
            f'HECTOR_QPOASES_DIR to the vendored qpOASES of the reference '
            f'checkout (now {QPOASES_REF_DIR!r}); they are missing')


def _qpoases():
    global _QPOASES_LIB
    if _QPOASES_LIB is None:
        require_qpoases()
        srcs = sorted(glob.glob(os.path.join(QPOASES_REF_DIR, 'src',
                                             '*.cpp')))
        if not srcs:
            raise RuntimeError(f'no qpOASES sources under {QPOASES_REF_DIR}')
        flags = _native.GXX_FLAGS + (
            '-I', os.path.join(QPOASES_REF_DIR, 'include'),
            '-D__SUPPRESSANYOUTPUT__')
        so, _ = _native.build(
            'g++', [_native.NATIVE_DIR / 'qpoases_bridge.cpp', *srcs],
            'qpoases_bridge', flags)
        lib = ctypes.CDLL(str(so))
        lib.qpoases_solve.restype = ctypes.c_int
        lib.qpoases_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, _DOUBLE_P, _DOUBLE_P, _DOUBLE_P,
            _DOUBLE_P, _DOUBLE_P, ctypes.c_int, _DOUBLE_P,
            ctypes.POINTER(ctypes.c_int)]
        _QPOASES_LIB = lib
    return _QPOASES_LIB


def qpoases_solve_dense(h_mat, g_vec, a_mat, lb, ub,
                        nwsr: int = 500) -> np.ndarray:
    """min 1/2 x^T H x + g^T x  s.t.  lb <= A x <= ub, via the reference's
    qpOASES under its exact options (setToMPC, PL_NONE, nWSR=500).  Raises
    QPoasesFailure when qpOASES fails."""
    h, g, a, lo, hi = _dense_args(h_mat, g_vec, a_mat, lb, ub)
    x = np.zeros(g.shape[0], np.float64)
    nwsr_used = ctypes.c_int(0)
    rc = _qpoases().qpoases_solve(g.shape[0], lo.shape[0], _ptr(h), _ptr(g),
                                  _ptr(a), _ptr(lo), _ptr(hi), nwsr, _ptr(x),
                                  ctypes.byref(nwsr_used))
    if rc != 0:
        raise QPoasesFailure(f'qpOASES init failed returnValue={rc}')
    return x


def solve_qpdata_qpoases(qp, gait, nwsr: int = 500) -> np.ndarray:
    """Solve one ``QPData`` (no batch axis) with the reference's qpOASES,
    including its swing-variable elimination (SolverMPC.cpp:589-697): for
    every (step, leg) with gait == 0 the leg's 6 variables and 8 constraint
    rows are removed before the solve and its forces scattered back as
    zeros.  Returns the full (12h,) solution."""
    h_full, g_full = _f64(qp.h_mat), _f64(qp.g_vec)
    lb, ub = _f64(qp.lb), _f64(qp.ub)
    gait = _f64(gait)
    h = lb.shape[-2]
    n = g_full.shape[0]
    keep_v = np.ones(n, bool)
    keep_c = np.ones(16 * h, bool)
    for i in range(h):
        for leg in range(2):
            if gait[i, leg] == 0:
                # vars: F(3) at 12i+3*leg, M(3) at 12i+6+3*leg
                keep_v[12 * i + 3 * leg:12 * i + 3 * leg + 3] = False
                keep_v[12 * i + 6 + 3 * leg:12 * i + 9 + 3 * leg] = False
                keep_c[16 * i + 8 * leg:16 * i + 8 * leg + 8] = False
    a_full = constraint_matrix(qp.c_block, h)
    x_red = qpoases_solve_dense(
        h_full[np.ix_(keep_v, keep_v)], g_full[keep_v],
        a_full[np.ix_(keep_c, keep_v)],
        lb.reshape(-1)[keep_c], ub.reshape(-1)[keep_c], nwsr)
    x = np.zeros(n)
    x[keep_v] = x_red
    return x


class GaitQPData(NamedTuple):
    """A batch of condensed QPs (``builder.QPData``'s fields) with the gait
    table (B, h, 2) each was built for: what the 'qpoases' backend needs
    for the reference's swing-variable elimination."""

    h_mat: torch.Tensor
    g_vec: torch.Tensor
    c_block: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    gait: torch.Tensor


def solve_batched_qpoases(problem: GaitQPData, nwsr: int = 500
                          ) -> QPSolution:
    """The 'qpoases' backend: the whole batch goes to the host in float64
    and qpOASES solves one lane after another (the JAX package's
    sequential host callback, ref_check.py:208-247).  As there, a lane
    whose solve fails gets the zero solution for that period (the reference
    keeps its previous one, SolverMPC.cpp:713-715), and each solution is
    rounded through float32 before it is cast to the problem's dtype and
    device.  Raises before any solve when the sources are missing."""
    require_qpoases()
    g_vec = problem.g_vec
    arrays = [_f64(f) for f in problem]
    n = g_vec.shape[1]
    u = np.zeros((g_vec.shape[0], n), np.float32)
    for b in range(g_vec.shape[0]):
        qp = GaitQPData(*[a[b] for a in arrays])
        try:
            u[b] = solve_qpdata_qpoases(qp, qp.gait, nwsr)
        except QPoasesFailure:
            pass
    u = torch.from_numpy(u).to(device=g_vec.device, dtype=g_vec.dtype)
    zero = torch.zeros(g_vec.shape[0], dtype=g_vec.dtype,
                       device=g_vec.device)
    return QPSolution(u=u, mu=zero, r_dual=zero, r_prim=zero)
