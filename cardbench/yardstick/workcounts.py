"""The work counts the benchmark's rooflines divide by, and the card's
published peaks.

Frozen copies, so that a change to the port cannot move the yardstick:
``op_count`` and ``bytes_per_scenario`` from hector_torch/qp/fused_riccati.py
(counted from csrc/fused_riccati_warp.cu), ``factor_bytes`` and
``solve_bytes`` from hector_torch/qp/chol.py (csrc/chol.cu), all at commit
dc0bcd9.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
FP32_PEAK = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # bytes/s

H = 10      # horizon / gait segments
NX = 13     # state dim  [rpy, p, omega, v, g]
NU = 12     # input dim  [F_L, F_R, M_L, M_R]
NC = 16     # constraint rows per stage
# the fused kernel's inputs, per scenario (fused_riccati._SHAPES)
_SHAPES = dict(s69=(3, 3), scal=(3,), b69=(3, NU), u_mask=(H, NU), x0=(NX,),
               xd=(H, NX), c_block=(NC, NU), lb=(H, NC), ub=(H, NC))


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def bytes_per_scenario():
    """Bytes one fused solve must move: every input read once, u and stats
    written once."""
    n_in = sum(_numel(s) for s in _SHAPES.values())
    return 4 * (n_in + H * NU + 3)


def op_count(iterations: int, polish_steps: int = 0):
    """FP32 operations of one solve, per scenario, counted from the kernel
    source: 'flop' counts each multiply and each add (an FMA is 2),
    divides and square roots are counted apart.  The dual-step ratio
    divides, taken only on rows whose dual direction is negative, are left
    out, so the count is a lower bound of the kernel's work.
    ``polish_steps`` = polish_rounds * polish_iters more Riccati solves,
    each with its rollout, two C u products, the row targets (7 operations
    a row), C^T, the step and the multiplier update (4 a row); the merit
    and set estimate at the round ends are left out."""
    a_mul = 3 * 6 + 3 * 2 + 2                  # A x, sparse
    b_mul_add = NU + 3 * 2 * NU + 3 * 3        # B diag(m) u added to x
    bt_mul = 6 * 8 + 6 * 6                     # diag(m) B^T p
    rollout = H * (a_mul + b_mul_add + 2 * NX)  # with q_lin
    c_mul = NC * (2 * NU - 1)                  # C u, one stage
    ct_mul = NU * (2 * NC - 1) + 2 * NU        # r2 u + C^T y, one stage

    stage = 0
    stage += 2 * 21 * 8 * 3 + NU               # C^T D C leg blocks + R
    stage += 6 * NX * 8 + 6 * NX * 6           # bp = diag(m) B^T P
    stage += 57 * 9 + 21 * 7                   # Re += bp B diag(m)
    stage += 2 * 66                            # Cholesky pivots
    stage += sum((NU - 1 - j) * (2 * j + 1) for j in range(NU))
    stage += NU * (2 + 3 * 6 + 3 * 2)          # G = bp A
    stage += bt_mul + NU                       # beta
    sub = 2 * (NX + 1) * 66 + (NX + 1) * NU    # one triangular solve
    stage += 2 * sub                           # forward and back
    stage += a_mul + NX * 2 * NU + NX          # p update
    stage += 2 * NX * a_mul                    # A^T P A
    stage += 91 * (2 * NU - 1) + 91 + NX       # - W^T W + diag(q2)
    fwd = NU * 2 * NX + a_mul + b_mul_add      # forward rollout, one stage
    newton = H * (stage + fwd)

    rows = H * (NU + 8)                        # one-sided rows per solve
    per_iter = (rollout + H * c_mul + rows * 6 + 2 + rows * 2
                + H * ct_mul + newton + H * c_mul + rows * 8
                + H * NU * 2 + rows * 4 * 2)
    start = rollout + newton + H * c_mul + rows * 3
    final = rollout + H * (bt_mul + ct_mul + NX + c_mul + 2 * NC) + rows * 3
    per_polish = (rollout + 2 * H * c_mul + H * NC * 7 + H * ct_mul + newton
                  + H * NU + H * NC * 4)
    return dict(
        flop=start + iterations * per_iter + polish_steps * per_polish + final,
        div=((iterations + 1 + polish_steps) * H * NU + rows
             + iterations * (rows + 1) + 1),
        sqrt=(iterations + 1 + polish_steps) * H * NU)


def operations(iterations: int, polish_steps: int = 0):
    """All operations of one fused solve, a divide or a square root one
    operation each."""
    c = op_count(iterations, polish_steps)
    return c['flop'] + c['div'] + c['sqrt']


def factor_bytes(n: int):
    """Bytes one factorization must move (float32): the lower triangle of
    the matrix read once, the whole n x n result written once (L below the
    diagonal, the zeros above it)."""
    return 4 * (n * (n + 1) // 2 + n * n)


def solve_bytes(n: int):
    """Bytes one solve must move (float32): the lower triangle of L and rhs
    read once, x written once."""
    return 4 * (n * (n + 1) // 2 + 2 * n)


def bound_s(n_bytes, n_ops):
    """The least time the card could take: (seconds, 'bytes' or
    'operations')."""
    bytes_s = n_bytes / HBM_BYTES_PER_S
    ops_s = n_ops / FP32_PEAK
    return (ops_s, 'operations') if ops_s >= bytes_s else (bytes_s, 'bytes')
