"""Fused Riccati interior point: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``hector/qp/pallas_riccati.py:_kernel``
(body ``_solve_tile``, launched at ``:668``).  Both versions here run the
fixed-sigma interior point of that kernel with ``polish_rounds = 0`` on the
compact ``StageQPParts`` (h=10, nx=13, nu=12, nc=16):

- :func:`solve_parts` is the entry point.  A CUDA tensor goes to the kernel
  (``hector_torch/csrc/fused_riccati.cu``, built with nvcc at first use into
  ``hector_torch/_build/``), a CPU tensor to :func:`solve_parts_plain`.
  Nothing falls back from one to the other.
- :func:`solve_parts_plain` is the same algorithm in batched PyTorch ops on
  (B, ...) tensors, with the kernel's policies: one-sided rows, the pivot
  floor, s_floor, d_cap, the 1e8 clip, the rate form of the primal step and
  the skip rule.  It runs in float32 and float64.  Its one departure: the
  complementarity freeze ``mu_floor`` is max(1e-14, 10 eps), which is the
  kernel's 10 eps in float32 and the JAX Riccati solver's 1e-14 in float64.

``launches`` counts kernel launches (the plain version never touches it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..config import SolverConfig

H = 10      # horizon / gait segments
NX = 13     # state dim  [rpy, p, omega, v, g]
NU = 12     # input dim  [F_L, F_R, M_L, M_R]
NC = 16     # constraint rows per stage
# one-sided rows: a lower bound can only be finite on the friction/Mx/Fz
# rows of each leg, an upper bound only on the Mx/line-contact/Fz rows
# (hector/constraints.py; pallas_riccati.py:102-114)
LR = (0, 1, 2, 3, 4, 7, 8, 9, 10, 11, 12, 15)
UR = (4, 5, 6, 7, 12, 13, 14, 15)
# batch-minor scratch per scenario: K_k (NU x NX) and kff_k (NU) per stage
SCRATCH_PER_SCENARIO = H * NU * (NX + 1)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / 'csrc' / 'fused_riccati.cu'
BUILD_ROOT = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

launches = 0            # kernel launches since import (or the caller's reset)
build_info = {}         # nvcc command, seconds and ptxas report of this process
_lib = None


class QPSolution(NamedTuple):
    """Solver output, as hector/qp/pdip.QPSolution: u flattened (B, 12h)."""

    u: torch.Tensor       # (B, h*12)
    mu: torch.Tensor      # (B,) final complementarity
    r_dual: torch.Tensor  # (B,) max |dual residual|
    r_prim: torch.Tensor  # (B,) max primal violation


def _weights(scfg: SolverConfig, q_diag, r_diag):
    """The objective's factor 2 (H = 2(B'SB + alpha), SolverMPC.cpp:569)
    folded into the weights, in double precision as the JAX kernel does."""
    q2 = [2.0 * float(v) for v in q_diag]
    r2 = [2.0 * float(v) for v in r_diag]
    r2reg = [v + float(scfg.kkt_reg) for v in r2]
    if len(q2) != NX or len(r2) != NU:
        raise ValueError(f'q_diag needs {NX} and r_diag {NU} entries, got '
                         f'{len(q2)} and {len(r2)}')
    return q2, r2, r2reg


def _check_polish(scfg: SolverConfig):
    if scfg.polish_rounds > 0:
        raise NotImplementedError(
            'polish_rounds > 0: the PDAS polish of the fused solver is not '
            'ported yet (ROADMAP.md queue B item 1(b))')


def solve_parts(parts, scfg: SolverConfig, q_diag, r_diag) -> QPSolution:
    """Solve a batch of stage QPs given as ``StageQPParts`` (leading batch
    dim B on every field).  CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _check_polish(scfg)
    dev = parts.x0.device
    if dev.type == 'cuda':
        return solve_parts_cuda(parts, scfg, q_diag, r_diag)
    if dev.type == 'cpu':
        return solve_parts_plain(parts, scfg, q_diag, r_diag)
    raise ValueError(f'fused_riccati runs on cuda or cpu tensors, not {dev}')


# --------------------------------------------------------------------------
# plain PyTorch version


def _dense_dynamics(s69, scal):
    """A = I + E and the stage-independent parts of B from the compact
    slices (builder.StageQPParts)."""
    bsz = s69.shape[0]
    eye = torch.eye(NX, dtype=s69.dtype, device=s69.device)
    a = eye.expand(bsz, NX, NX).clone()
    a[:, 0:3, 6:9] = s69
    for r in range(3):
        a[:, 3 + r, 9 + r] = scal[:, 0]
    a[:, 11, 12] = scal[:, 1]
    return a


def _dense_input(b69, scal):
    bsz = b69.shape[0]
    bm = torch.zeros((bsz, NX, NU), dtype=b69.dtype, device=b69.device)
    bm[:, 6:9, :] = b69
    for a in range(3):
        bm[:, 9 + a, a] = scal[:, 2]
        bm[:, 9 + a, 3 + a] = scal[:, 2]
    return bm


def _cholesky(re):
    """Lower Cholesky of (B, n, n) reading the lower triangle only, with the
    kernel's pivot floor sqrt(max(pivot, 1e-30)); returns (L, 1/diag)."""
    n = re.shape[-1]
    ell = torch.zeros_like(re)
    rinv = torch.empty(re.shape[:-1], dtype=re.dtype, device=re.device)
    for j in range(n):
        lj = ell[:, j, :j]
        ljj = torch.sqrt(torch.clamp(re[:, j, j] - (lj * lj).sum(-1),
                                     min=1e-30))
        rj = 1.0 / ljj
        ell[:, j, j] = ljj
        rinv[:, j] = rj
        if j + 1 < n:
            v = re[:, j + 1:, j] - (ell[:, j + 1:, :j] * lj[:, None, :]).sum(-1)
            ell[:, j + 1:, j] = v * rj[:, None]
    return ell, rinv


def _forward_sub(ell, rinv, x):
    """L^-1 x row by row; x (B, n, m) is overwritten."""
    for i in range(x.shape[1]):
        if i:
            x[:, i] -= (ell[:, i, :i, None] * x[:, :i]).sum(1)
        x[:, i] *= rinv[:, i, None]
    return x


def _back_sub(ell, rinv, x):
    """L^-T x row by row; x (B, n, m) is overwritten."""
    n = x.shape[1]
    for i in range(n - 1, -1, -1):
        if i + 1 < n:
            x[:, i] -= (ell[:, i + 1:, i, None] * x[:, i + 1:]).sum(1)
        x[:, i] *= rinv[:, i, None]
    return x


def solve_parts_plain(parts, scfg: SolverConfig, q_diag, r_diag
                      ) -> QPSolution:
    """The kernel's algorithm in batched PyTorch ops (float32 or float64)."""
    _check_polish(scfg)
    s69, scal, b69, umask, x0, xd, cm, lb, ub = parts
    dtype, dev = x0.dtype, x0.device
    bsz = x0.shape[0]

    def const(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    q2_l, r2_l, r2reg_l = _weights(scfg, q_diag, r_diag)
    q2, r2, r2reg = const(q2_l), const(r2_l), const(r2reg_l)
    q2_mat = torch.diag(q2)
    r2reg_mat = torch.diag(r2reg)
    eps = torch.finfo(dtype).eps
    mu_floor = max(1e-14, 10.0 * eps)
    s_floor = 10.0 * eps
    d_cap = 0.1 / eps
    sl_cap = 1e8
    sigma, frac = scfg.sigma_fixed, scfg.frac_to_boundary
    big = scfg.big_threshold
    inf = const(float('inf'))

    a = _dense_dynamics(s69, scal)
    bmat = _dense_input(b69, scal)
    at = a.transpose(1, 2)
    lr = torch.tensor(LR, device=dev)
    ur = torch.tensor(UR, device=dev)

    mask_l = lb > -big
    mask_u = ub < big
    lb_c = torch.where(mask_l, lb, 0.0)
    ub_c = torch.where(mask_u, ub, 0.0)
    mlr, mur = mask_l[..., lr], mask_u[..., ur]
    flr, fur = mlr.to(dtype), mur.to(dtype)
    lb_r, ub_r = lb_c[..., lr], ub_c[..., ur]
    n_act = torch.clamp(flr.sum((1, 2)) + fur.sum((1, 2)), min=1.0)
    cmt = cm.transpose(1, 2)

    def apply_c(u):                   # (B,H,NU) -> (B,H,NC)
        return u @ cmt

    def apply_ct(y):                  # (B,H,NC) -> (B,H,NU)
        return y @ cm

    def full_rows(x_l, x_u):
        out = torch.zeros(x_l.shape[:-1] + (NC,), dtype=dtype, device=dev)
        out[..., lr] = x_l
        out[..., ur] += x_u
        return out

    def rollout(u):
        x = x0
        xs = []
        for k in range(H):
            x = (a @ x[..., None])[..., 0] + (
                bmat @ (umask[:, k] * u[:, k])[..., None])[..., 0]
            xs.append(x)
        return torch.stack(xs, dim=1)

    def newton_dir(d_row, q_lin, r_lin):
        p_mat = q2_mat.expand(bsz, NX, NX)
        p_vec = q_lin[:, H - 1]
        ks, kffs = [None] * H, [None] * H
        for k in range(H - 1, -1, -1):
            bk = bmat * umask[:, k, None, :]                       # (B,NX,NU)
            re = (cmt * d_row[:, k, None, :]) @ cm + r2reg_mat     # C^T D C + R
            bp = bk.transpose(1, 2) @ p_mat                        # (B,NU,NX)
            re = re + bp @ bk
            ell, rinv = _cholesky(re)
            g = bp @ a
            beta = (bk.transpose(1, 2) @ p_vec[..., None]) + r_lin[:, k, :, None]
            wz = _forward_sub(ell, rinv, torch.cat([g, beta], dim=-1))
            w, z = wz[..., :NX], wz[..., NX]
            p_vec = (at @ p_vec[..., None])[..., 0] - (
                w.transpose(1, 2) @ z[..., None])[..., 0]
            if k >= 1:
                p_vec = p_vec + q_lin[:, k - 1]
            p_new = at @ p_mat @ a - w.transpose(1, 2) @ w + q2_mat
            low = torch.tril(p_new)
            p_mat = low + torch.tril(p_new, -1).transpose(1, 2)
            kk = _back_sub(ell, rinv, wz)
            ks[k], kffs[k] = kk[..., :NX], kk[..., NX]
        dx = torch.zeros_like(x0)
        dus = []
        for k in range(H):
            du = -((ks[k] @ dx[..., None])[..., 0] + kffs[k])
            dus.append(du)
            dx = (a @ dx[..., None])[..., 0] + (
                bmat @ (umask[:, k] * du)[..., None])[..., 0]
        return torch.stack(dus, dim=1)

    # ---- scale-aware start from the unconstrained solution ----
    zero_u = torch.zeros((bsz, H, NU), dtype=dtype, device=dev)
    q_lin0 = (rollout(zero_u) - xd) * q2
    u_unc = newton_dir(torch.zeros((bsz, H, NC), dtype=dtype, device=dev),
                       q_lin0, zero_u)
    cu0 = apply_c(u_unc)
    sh_l = torch.where(mlr, cu0[..., lr] - lb_r, 1.0)
    sh_u = torch.where(mur, ub_r - cu0[..., ur], 1.0)
    s_min = torch.minimum(torch.where(mlr, sh_l, inf).amin((1, 2)),
                          torch.where(mur, sh_u, inf).amin((1, 2)))
    shift = (scfg.init_slack + torch.clamp(-1.5 * s_min, min=0.0))[:, None, None]
    s_l = torch.where(mlr, sh_l + shift, 1.0)
    s_u = torch.where(mur, sh_u + shift, 1.0)
    lam_l = torch.where(mlr, scfg.init_dual / s_l, 0.0)
    lam_u = torch.where(mur, scfg.init_dual / s_u, 0.0)
    u = zero_u

    def clip(x):
        return torch.clamp(x, 0.0, sl_cap)

    for _ in range(scfg.iterations):
        cu = apply_c(u)
        cu_l, cu_u = cu[..., lr], cu[..., ur]
        q_lin = (rollout(u) - xd) * q2
        r_pl = torch.where(mlr, cu_l - lb_r - s_l, 0.0)
        r_pu = torch.where(mur, ub_r - cu_u - s_u, 0.0)
        inv_sl = 1.0 / torch.clamp(s_l, min=s_floor)
        inv_su = 1.0 / torch.clamp(s_u, min=s_floor)
        d_l = torch.where(mlr, torch.clamp(lam_l * inv_sl, max=d_cap), 0.0)
        d_u = torch.where(mur, torch.clamp(lam_u * inv_su, max=d_cap), 0.0)
        mu = ((s_l * lam_l * flr).sum((1, 2))
              + (s_u * lam_u * fur).sum((1, 2))) / n_act
        smu = (sigma * mu)[:, None, None]
        tls = torch.where(mlr, smu * inv_sl, 0.0)
        tus = torch.where(mur, smu * inv_su, 0.0)
        # C^T ((lam_u - lam_l) + v): the (lam_u - lam_l) terms cancel
        arg_l = d_l * r_pl - tls
        arg_u = tus - d_u * r_pu
        r_lin = r2 * u + apply_ct(full_rows(arg_l, arg_u))

        du = newton_dir(full_rows(d_l, d_u), q_lin, r_lin)
        cdu = apply_c(du)
        t_l = cdu[..., lr] + r_pl
        t_u = -cdu[..., ur] + r_pu
        ds_l = torch.where(mlr, t_l, 0.0)
        ds_u = torch.where(mur, t_u, 0.0)
        dl_l = torch.where(mlr, tls - lam_l - d_l * t_l, 0.0)
        dl_u = torch.where(mur, tus - lam_u - d_u * t_u, 0.0)

        # primal step through the slack reciprocals (rate form)
        rate_p = torch.maximum(
            torch.where(mlr & (ds_l < 0), -ds_l * inv_sl, 0.0).amax((1, 2)),
            torch.where(mur & (ds_u < 0), -ds_u * inv_su, 0.0).amax((1, 2)))
        a_p = (frac / torch.clamp(rate_p, min=frac))[:, None, None]
        ratio = torch.minimum(
            torch.where(mlr & (dl_l < 0),
                        lam_l / torch.clamp(-dl_l, min=1e-30), inf).amin((1, 2)),
            torch.where(mur & (dl_u < 0),
                        lam_u / torch.clamp(-dl_u, min=1e-30), inf).amin((1, 2)))
        a_d = torch.clamp(frac * ratio, max=1.0)[:, None, None]

        finite = (torch.isfinite(du).all(2).all(1)
                  & (torch.isfinite(ds_l) & torch.isfinite(dl_l)).all(2).all(1)
                  & (torch.isfinite(ds_u) & torch.isfinite(dl_u)).all(2).all(1))
        skip = ((mu < mu_floor) | ~finite)[:, None, None]
        u = torch.where(skip, u, u + a_p * du)
        s_l = torch.where(skip | ~mlr, s_l, clip(s_l + a_p * ds_l))
        s_u = torch.where(skip | ~mur, s_u, clip(s_u + a_p * ds_u))
        lam_l = torch.where(skip | ~mlr, lam_l, clip(lam_l + a_d * dl_l))
        lam_u = torch.where(skip | ~mur, lam_u, clip(lam_u + a_d * dl_u))

    # ---- final residuals ----
    cu = apply_c(u)
    q_lin = (rollout(u) - xd) * q2
    ct_dl = apply_ct(full_rows(-lam_l, lam_u))
    nu = q_lin[:, H - 1]
    r_d_max = torch.zeros(bsz, dtype=dtype, device=dev)
    for k in range(H - 1, -1, -1):
        bt_nu = (bmat.transpose(1, 2) @ nu[..., None])[..., 0] * umask[:, k]
        r_d_k = r2 * u[:, k] + bt_nu + ct_dl[:, k]
        r_d_max = torch.maximum(r_d_max, r_d_k.abs().amax(-1))
        if k >= 1:
            nu = (at @ nu[..., None])[..., 0] + q_lin[:, k - 1]
    r_pl = torch.where(mask_l, torch.clamp(lb_c - cu, min=0.0), 0.0)
    r_pu = torch.where(mask_u, torch.clamp(cu - ub_c, min=0.0), 0.0)
    mu = ((s_l * lam_l * flr).sum((1, 2))
          + (s_u * lam_u * fur).sum((1, 2))) / n_act
    r_prim = torch.maximum(r_pl.amax((1, 2)), r_pu.amax((1, 2)))
    return QPSolution(u=u.reshape(bsz, H * NU), mu=mu, r_dual=r_d_max,
                      r_prim=r_prim)


# --------------------------------------------------------------------------
# the CUDA kernel


class _Params(ctypes.Structure):
    """Mirror of ``Params`` in csrc/fused_riccati.cu."""

    _fields_ = [('q2', ctypes.c_float * NX), ('r2', ctypes.c_float * NU),
                ('r2reg', ctypes.c_float * NU), ('sigma', ctypes.c_float),
                ('frac', ctypes.c_float), ('big', ctypes.c_float),
                ('init_slack', ctypes.c_float), ('init_dual', ctypes.c_float),
                ('iters', ctypes.c_int)]


def _find_nvcc():
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        cand = Path(home) / 'bin' / 'nvcc'
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin): the fused Riccati kernel '
                           'is built from source at first use')
    return nvcc


def build():
    """Compile csrc/fused_riccati.cu for sm_90a into
    ``_build/<hash of source and flags>/`` (once) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / tag
    so = out_dir / 'libfused_riccati.so'
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f'libfused_riccati.{os.getpid()}.so'
        cmd = [_find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{proc.stdout}\n{proc.stderr}')
        os.replace(tmp, so)
        (out_dir / 'ptxas.txt').write_text(proc.stdout + proc.stderr)
        build_info.update(command=cmd, seconds=seconds,
                          ptxas=proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_riccati_solve
    fn.argtypes = ([ctypes.c_void_p] * 12
                   + [ctypes.c_int, ctypes.POINTER(_Params), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fused_riccati_error_string.argtypes = [ctypes.c_int]
    lib.fused_riccati_error_string.restype = ctypes.c_char_p
    lib.fused_riccati_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.fused_riccati_attributes.restype = ctypes.c_int
    _lib = lib
    return lib


def kernel_attributes():
    """(registers per thread, local bytes per thread, max threads/block)
    of the compiled kernel, from cudaFuncGetAttributes."""
    lib = build()
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.fused_riccati_attributes(*[ctypes.byref(v) for v in vals])
    if rc != 0:
        raise RuntimeError('cudaFuncGetAttributes failed: '
                           + lib.fused_riccati_error_string(rc).decode())
    return dict(registers=vals[0].value, local_bytes=vals[1].value,
                max_threads_per_block=vals[2].value)


_SHAPES = dict(s69=(3, 3), scal=(3,), b69=(3, NU), u_mask=(H, NU), x0=(NX,),
               xd=(H, NX), c_block=(NC, NU), lb=(H, NC), ub=(H, NC))


def check_parts(parts):
    """Raise on anything the kernel does not take: float32, one CUDA
    device, the h=10 / nx=13 / nu=12 / nc=16 shapes, one batch size."""
    bsz = parts.x0.shape[0]
    dev = parts.x0.device
    fields = list(zip(parts._fields, parts))
    for name, t in fields:
        if t.dtype != torch.float32:
            raise TypeError(f'fused_riccati: {name} must be float32, '
                            f'got {t.dtype}')
    for name, t in fields:
        if tuple(t.shape) != (bsz,) + _SHAPES[name]:
            raise ValueError(
                f'fused_riccati: {name} has shape {tuple(t.shape)}, the '
                f'kernel takes {(bsz,) + _SHAPES[name]} (h={H}, nx={NX}, '
                f'nu={NU}, nc={NC})')
    for name, t in fields:
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'fused_riccati: {name} on {t.device}, all '
                             f'parts must be on one CUDA device')


def solve_parts_cuda(parts, scfg: SolverConfig, q_diag, r_diag
                     ) -> QPSolution:
    """Launch the kernel on the current stream; no synchronisation."""
    global launches
    _check_polish(scfg)
    check_parts(parts)
    q2, r2, r2reg = _weights(scfg, q_diag, r_diag)
    prm = _Params((ctypes.c_float * NX)(*q2), (ctypes.c_float * NU)(*r2),
                  (ctypes.c_float * NU)(*r2reg), scfg.sigma_fixed,
                  scfg.frac_to_boundary, scfg.big_threshold,
                  scfg.init_slack, scfg.init_dual, int(scfg.iterations))
    bsz = parts.x0.shape[0]
    dev = parts.x0.device
    # batch-minor copies: element-major, scenario-minor
    ins = [t.reshape(bsz, -1).t().contiguous() for t in parts]
    for t in ins:
        if not t.is_contiguous():
            raise ValueError('fused_riccati: input not contiguous')
    u_t = torch.empty((H * NU, bsz), dtype=torch.float32, device=dev)
    stats_t = torch.empty((3, bsz), dtype=torch.float32, device=dev)
    scratch = torch.empty((SCRATCH_PER_SCENARIO, bsz), dtype=torch.float32,
                          device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_riccati_solve(
            *[t.data_ptr() for t in ins], u_t.data_ptr(), stats_t.data_ptr(),
            scratch.data_ptr(), bsz, ctypes.byref(prm), stream)
    if rc != 0:
        raise RuntimeError('fused_riccati launch failed: CUDA error '
                           f'{rc} ({lib.fused_riccati_error_string(rc).decode()})')
    launches += 1
    stats = stats_t.t()
    return QPSolution(u=u_t.t().contiguous(), mu=stats[:, 0],
                      r_dual=stats[:, 1], r_prim=stats[:, 2])


# --------------------------------------------------------------------------
# work of one solve, counted from csrc/fused_riccati.cu


def bytes_per_scenario():
    """Bytes one solve must move: every input read once, u and stats
    written once (the K/kff scratch is not counted: it is the kernel's
    choice, not the function's)."""
    n_in = sum(int(torch.tensor(s).prod()) for s in _SHAPES.values())
    return 4 * (n_in + H * NU + 3)


def op_count(iterations: int):
    """FP32 operations of one solve, per scenario, counted from the kernel
    source: 'flop' counts each multiply and each add (an FMA is 2),
    divides and square roots are counted apart.  The dual-step ratio
    divides, taken only on rows whose dual direction is negative, are left
    out, so the count is a lower bound of the kernel's work."""
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
    return dict(
        flop=start + iterations * per_iter + final,
        div=(iterations + 1) * H * NU + rows + iterations * (rows + 1) + 1,
        sqrt=(iterations + 1) * H * NU)
