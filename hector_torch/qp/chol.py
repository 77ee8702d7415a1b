"""Batched Cholesky factor and solve: the CUDA kernels' wrappers and their
plain PyTorch versions.

Replaces the two Pallas TPU kernels of ``hector/qp/pallas_chol.py``:
``_chol_kernel`` (``:48``, through ``cholesky_nnb``) and ``_solve_kernel``
(``:77``, through ``cholesky_solve_nnb``).  The dense interior point
(hector_torch/qp/pdip.py) factors one 120 x 120 KKT matrix and solves twice
per iteration.

- :func:`cholesky_nnb` and :func:`cholesky_solve_nnb` keep the TPU
  wrappers' names, shapes and contract: matrices ``(n, n, B)`` with the
  batch minor, L in the lower triangle, zeros above it.
- :func:`cholesky_bnn` and :func:`cholesky_solve_bnn` are the same kernels
  on ``(B, n, n)`` / ``(B, n)``, the layout the interior point holds and the
  one in which a block's loads are contiguous.  The kernels take strides, so
  the ``nnb`` functions are views of these, not copies.
- A CUDA tensor launches the kernel (``hector_torch/csrc/chol.cu``, built
  with nvcc at first use into ``hector_torch/_build/``) or raises; a CPU
  tensor runs the plain version.  Nothing falls back from one to the other.
- Each kernel is chosen by n in the C entry point (:func:`route`): the
  factor and the solve on register tiles up to ``tile_max_n()`` (248; the
  interior point's n = 120); above it (up to 339; n = 288 at horizon 24)
  the factor on register tiles over a cluster of two blocks, the solve
  streaming L through shared memory a panel at a time.
  :func:`factor_shared_cuda` and :func:`solve_shared_cuda` launch the
  shared-memory kernels, off the route, at any n, to hold the others to
  them on the same matrices; :func:`factor_cluster_cuda` and
  :func:`solve_stream_cuda` launch the cluster factor and the streaming
  solve at any n, to hold them to the tile kernels.
- :func:`cholesky_nnb_plain` and :func:`cholesky_solve_nnb_plain` are the
  textbook loops of the TPU kernels over the batch, in any float type.

``factor_launches`` and ``solve_launches`` count kernel launches (the plain
versions never touch them); ``factor_shared_launches``,
``factor_cluster_launches``, ``solve_shared_launches`` and
``solve_stream_launches`` count those of them that went to the
shared-triangle factor, the cluster factor, the shared-memory solve and the
streaming solve.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _nvcc

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / 'csrc' / 'chol.cu'
BUILD_ROOT = _PKG / '_build'
NVCC_FLAGS = _nvcc.NVCC_FLAGS

# the kernels of csrc/chol.cu, numbered as its KernelId
KERNELS = ('factor_tile', 'factor_shared', 'solve_tile', 'solve_shared',
           'factor_cluster', 'solve_stream')

factor_launches = 0     # launches of a factor kernel since import or reset
factor_shared_launches = 0  # of which the shared-triangle factor kernel's
factor_cluster_launches = 0  # of which the cluster factor kernel's
solve_launches = 0      # launches of a solve kernel since import or reset
solve_shared_launches = 0   # of which the shared-memory solve kernel's
solve_stream_launches = 0   # of which the streaming solve kernel's
build_info = {}         # ptxas report; nvcc command and seconds if built here
_lib = None
_max_n = None
_tile_max_n = None


# --------------------------------------------------------------------------
# plain PyTorch versions


def cholesky_nnb_plain(m):
    """Right-looking Cholesky of ``(n, n, B)`` SPD matrices, column by
    column over the whole batch.  Reads the lower triangle only; returns L
    in the lower triangle and zeros above.  No pivot floor: a non-positive
    pivot gives inf or NaN in its own lane only."""
    n = m.shape[0]
    a = m.clone()
    for j in range(n):
        inv = 1.0 / torch.sqrt(a[j, j])                  # (B,)
        col = a[j:, j] * inv                             # (n-j, B)
        a[j:, j] = col
        if j + 1 < n:
            a[j + 1:, j + 1:] -= col[1:, None, :] * col[None, 1:, :]
    keep = torch.tril(torch.ones((n, n), dtype=torch.bool, device=m.device))
    return torch.where(keep[:, :, None], a, torch.zeros_like(a))


def cholesky_solve_nnb_plain(l, rhs):
    """Solve L L^T x = rhs with L ``(n, n, B)`` lower and rhs ``(n, B)``:
    forward then back substitution in column (axpy) order."""
    n = l.shape[0]
    x = rhs.clone()
    for j in range(n):
        xj = x[j] / l[j, j]
        x[j] = xj
        if j + 1 < n:
            x[j + 1:] -= l[j + 1:, j] * xj
    for j in range(n - 1, -1, -1):
        xj = x[j] / l[j, j]
        x[j] = xj
        if j:
            x[:j] -= l[j, :j] * xj
    return x


# --------------------------------------------------------------------------
# the CUDA kernels


def build():
    """Compile csrc/chol.cu for sm_90a (once) and load it."""
    global _lib, _max_n, _tile_max_n
    if _lib is not None:
        return _lib
    so, info = _nvcc.compile_shared(SOURCE, BUILD_ROOT, NVCC_FLAGS)
    build_info.update(info)
    _lib = _load(so)
    _max_n = _lib.chol_max_n()
    _tile_max_n = _lib.chol_factor_tile_max_n()
    return _lib


def kernel_variant(defines=()):
    """csrc/chol.cu built with extra ``-D`` flags (the profiling switches
    CHOL_PHASE_CLOCKS, CHOL_STEP_CLOCKS and CHOL_EXTRA_SMEM) and loaded: (library, build
    record).  Install the library as ``_lib`` (after :func:`build`) to
    launch it through the wrappers."""
    so, info = _nvcc.compile_shared(SOURCE, BUILD_ROOT,
                                    NVCC_FLAGS + tuple(defines))
    return _load(so), info


def _load(so):
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.chol_factor, lib.chol_factor_shared,
               lib.chol_factor_cluster):
        fn.argtypes = [ptr, ptr, i32, i32] + [i64] * 6 + [ptr]
        fn.restype = i32
    for fn in (lib.chol_solve, lib.chol_solve_shared, lib.chol_solve_stream):
        fn.argtypes = [ptr, ptr, ptr, i32, i32] + [i64] * 7 + [ptr]
        fn.restype = i32
    lib.chol_error_string.argtypes = [i32]
    lib.chol_error_string.restype = ctypes.c_char_p
    for fn in (lib.chol_max_n, lib.chol_factor_tile_max_n):
        fn.argtypes = []
        fn.restype = i32
    for fn in (lib.chol_factor_route, lib.chol_solve_route):
        fn.argtypes = [i32]
        fn.restype = i32
    lib.chol_kernel_attributes.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.chol_kernel_attributes.restype = i32
    return lib


def _check(dev, *args):
    """Raise on what the kernels do not take: float32, the expected shape,
    dense storage (any permutation of a contiguous tensor: the kernels take
    strides, not gaps or overlaps), one CUDA device.  ``args`` are (name,
    tensor, shape) triples."""
    for name, t, _ in args:
        if t.dtype != torch.float32:
            raise TypeError(f'chol: {name} must be float32, got {t.dtype}')
    for name, t, shape in args:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'chol: {name} has shape {tuple(t.shape)}, '
                             f'expected {tuple(shape)}')
    for name, t, _ in args:
        order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
        if not t.permute(order).is_contiguous():
            raise ValueError(f'chol: {name} is not contiguous (strides '
                             f'{t.stride()}): pass a contiguous tensor or a '
                             f'permutation of one')
    for name, t, _ in args:
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'chol: {name} on {t.device}, all arguments '
                             f'must be on one CUDA device')


def _dims(t_bnn):
    """(B, n) of a batch of square matrices (B, n, n)."""
    if t_bnn.dim() != 3 or t_bnn.shape[1] != t_bnn.shape[2]:
        raise ValueError(f'chol: matrices must be square, got '
                         f'{tuple(t_bnn.shape)}')
    return t_bnn.shape[0], t_bnn.shape[1]


def _library(n):
    """The kernels' library, built at first use; raises if an n x n matrix
    does not fit a block's shared memory."""
    lib = build()
    if n > _max_n:
        raise ValueError(f'chol: n = {n} exceeds {_max_n}, the largest '
                         f'matrix that fits a block\'s shared memory and '
                         f'the cluster factor\'s tiles')
    return lib


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f'chol {what} launch failed: CUDA error {rc} '
                           f'({_lib.chol_error_string(rc).decode()})')


def tile_max_n():
    """The largest n the factor and the solve give their register-tile
    kernels (the library is built at first use)."""
    build()
    return _tile_max_n


def route(n: int, op: str = 'factor'):
    """The kernel (a name of :data:`KERNELS`) that the C entry point of
    ``op`` ('factor' or 'solve') launches at n: the one it decides by."""
    if op not in ('factor', 'solve'):
        raise ValueError(f"op is 'factor' or 'solve', not {op!r}")
    lib = build()
    fn = lib.chol_factor_route if op == 'factor' else lib.chol_solve_route
    return KERNELS[fn(n)]


def _factor_launch(entry, m_bnn, l_bnn):
    bsz, n = _dims(m_bnn)
    dev = m_bnn.device
    _check(dev, ('m', m_bnn, (bsz, n, n)), ('l', l_bnn, (bsz, n, n)))
    lib = _library(n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            m_bnn.data_ptr(), l_bnn.data_ptr(), n, bsz,
            m_bnn.stride(1), m_bnn.stride(2), m_bnn.stride(0),
            l_bnn.stride(1), l_bnn.stride(2), l_bnn.stride(0), stream)
    _raise_on(rc, 'factor')
    return n


def factor_cuda(m_bnn, l_bnn):
    """Launch the factor on (B, n, n) views of any dense strides: the kernel
    of ``route(n)`` (the C entry point chooses by n)."""
    global factor_launches, factor_shared_launches, factor_cluster_launches
    n = _factor_launch('chol_factor', m_bnn, l_bnn)
    kernel = KERNELS[_lib.chol_factor_route(n)]
    factor_launches += 1
    factor_shared_launches += kernel == 'factor_shared'
    factor_cluster_launches += kernel == 'factor_cluster'
    return l_bnn


def factor_shared_cuda(m_bnn, l_bnn):
    """Launch the shared-triangle factor kernel at any n (it computes what
    :func:`factor_cuda` computes, bit for bit)."""
    global factor_launches, factor_shared_launches
    _factor_launch('chol_factor_shared', m_bnn, l_bnn)
    factor_launches += 1
    factor_shared_launches += 1
    return l_bnn


def factor_cluster_cuda(m_bnn, l_bnn):
    """Launch the cluster factor kernel at any n (at n <= ``tile_max_n()``
    it computes what the tile kernel computes, bit for bit)."""
    global factor_launches, factor_cluster_launches
    _factor_launch('chol_factor_cluster', m_bnn, l_bnn)
    factor_launches += 1
    factor_cluster_launches += 1
    return l_bnn


def kernel_attributes(n: int = 120, kernel: str = 'factor_tile'):
    """What cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor report for ``kernel`` (a
    name of :data:`KERNELS`) launched at n as its entry point launches it
    (threads, dynamic shared memory); ``cluster_size``, the blocks a matrix
    (2 for the cluster factor, 1 for the others), and for the cluster
    factor ``clusters_per_device``, the matrices the device runs at once
    (cudaOccupancyMaxActiveClusters)."""
    if kernel not in KERNELS:
        raise ValueError(f'kernel is one of {KERNELS}, not {kernel!r}')
    lib = _library(n)
    vals = (ctypes.c_int * 8)()
    rc = lib.chol_kernel_attributes(KERNELS.index(kernel), n, vals)
    if rc != 0:
        raise RuntimeError(f'chol_kernel_attributes failed: CUDA error {rc} '
                           f'({lib.chol_error_string(rc).decode()})')
    regs, local, static, dynamic, threads, blocks, csize, clusters = list(vals)
    out = dict(kernel=kernel, n=n, registers=regs, local_bytes=local,
               static_smem_bytes=static, dynamic_smem_bytes=dynamic,
               threads_per_block=threads, blocks_per_sm=blocks,
               warps_per_sm=blocks * threads // 32, cluster_size=csize)
    if csize > 1:
        out['clusters_per_device'] = clusters
    return out


def _solve_launch(entry, l_bnn, rhs_bn, x_bn):
    bsz, n = _dims(l_bnn)
    dev = l_bnn.device
    _check(dev, ('l', l_bnn, (bsz, n, n)), ('rhs', rhs_bn, (bsz, n)),
           ('x', x_bn, (bsz, n)))
    lib = _library(n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            l_bnn.data_ptr(), rhs_bn.data_ptr(), x_bn.data_ptr(), n, bsz,
            l_bnn.stride(1), l_bnn.stride(2), l_bnn.stride(0),
            rhs_bn.stride(1), rhs_bn.stride(0),
            x_bn.stride(1), x_bn.stride(0), stream)
    _raise_on(rc, 'solve')
    return n


def solve_cuda(l_bnn, rhs_bn, x_bn):
    """Launch the solve on (B, n, n) / (B, n) views: the kernel of
    ``route(n, 'solve')``."""
    global solve_launches, solve_stream_launches
    n = _solve_launch('chol_solve', l_bnn, rhs_bn, x_bn)
    solve_launches += 1
    solve_stream_launches += (KERNELS[_lib.chol_solve_route(n)]
                              == 'solve_stream')
    return x_bn


def solve_stream_cuda(l_bnn, rhs_bn, x_bn):
    """Launch the streaming solve kernel at any n (at n <= ``tile_max_n()``
    it computes what the tile kernel computes, bit for bit)."""
    global solve_launches, solve_stream_launches
    _solve_launch('chol_solve_stream', l_bnn, rhs_bn, x_bn)
    solve_launches += 1
    solve_stream_launches += 1
    return x_bn


def solve_shared_cuda(l_bnn, rhs_bn, x_bn):
    """Launch the shared-memory solve kernel at any n (it computes what
    :func:`solve_cuda` computes, bit for bit)."""
    global solve_launches, solve_shared_launches
    _solve_launch('chol_solve_shared', l_bnn, rhs_bn, x_bn)
    solve_launches += 1
    solve_shared_launches += 1
    return x_bn


def _route(t, name):
    if t.device.type in ('cuda', 'cpu'):
        return t.device.type
    raise ValueError(f'chol: {name} runs on cuda or cpu tensors, '
                     f'not {t.device}')


def cholesky_bnn(m):
    """Lower Cholesky factors of ``(B, n, n)`` SPD matrices (lower triangle
    read; zeros above the diagonal of the result)."""
    if _route(m, 'cholesky_bnn') == 'cuda':
        return factor_cuda(m, torch.empty(m.shape, dtype=m.dtype,
                                           device=m.device))
    return cholesky_nnb_plain(m.permute(1, 2, 0)).permute(2, 0, 1)


def cholesky_solve_bnn(l, rhs):
    """Solve L L^T x = rhs with L ``(B, n, n)`` from :func:`cholesky_bnn`
    and rhs ``(B, n)``."""
    if _route(l, 'cholesky_solve_bnn') == 'cuda':
        return solve_cuda(l, rhs, torch.empty(rhs.shape, dtype=rhs.dtype,
                                               device=rhs.device))
    return cholesky_solve_nnb_plain(l.permute(1, 2, 0), rhs.t()).t()


def cholesky_nnb(m):
    """Batched Cholesky of ``(n, n, B)`` SPD matrices (batch minor), as
    ``hector.qp.pallas_chol.cholesky_nnb``: L in the lower triangle, zeros
    above.  Any batch size: the kernel has no padding lanes."""
    if _route(m, 'cholesky_nnb') == 'cuda':
        out = torch.empty(m.shape, dtype=m.dtype, device=m.device)
        factor_cuda(m.permute(2, 0, 1), out.permute(2, 0, 1))
        return out
    return cholesky_nnb_plain(m)


def cholesky_solve_nnb(l, rhs):
    """Solve L L^T x = rhs with L ``(n, n, B)`` from :func:`cholesky_nnb`
    and rhs ``(n, B)``, as ``hector.qp.pallas_chol.cholesky_solve_nnb``."""
    if _route(l, 'cholesky_solve_nnb') == 'cuda':
        out = torch.empty(rhs.shape, dtype=rhs.dtype, device=rhs.device)
        solve_cuda(l.permute(2, 0, 1), rhs.t(), out.t())
        return out
    return cholesky_solve_nnb_plain(l, rhs)


# --------------------------------------------------------------------------
# work of one matrix


def factor_bytes(n: int):
    """Bytes one factorization must move (float32): the lower triangle of
    the matrix read once, the whole n x n result written once (L below the
    diagonal, the zeros above it)."""
    return 4 * (n * (n + 1) // 2 + n * n)


def solve_bytes(n: int):
    """Bytes one solve must move (float32): the lower triangle of L and rhs
    read once, x written once."""
    return 4 * (n * (n + 1) // 2 + 2 * n)


def factor_op_count(n: int):
    """FP32 operations of one factorization, counted from the kernel: per
    column one square root, one divide, n - j scalings, and a multiply and
    a subtract for each entry of the trailing lower triangle."""
    flop = sum((n - j) + (n - j - 1) * (n - j) for j in range(n))
    return dict(flop=flop, div=n, sqrt=n)


def solve_op_count(n: int):
    """FP32 operations of one solve: per step of either pass one divide and
    a multiply and a subtract for each remaining entry."""
    return dict(flop=2 * n * (n - 1), div=2 * n, sqrt=0)
