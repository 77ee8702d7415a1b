"""The CUDA source of the Cholesky kernels, compiled for the host and run on
the CPU.

``hector_torch/csrc/chol.cu`` runs only on the card, where chip_smoke.py
holds it to its plain versions.  Here g++ builds the same source against
``tests/host_cuda/cuda_runtime.h`` (threads of a block as std::threads,
barriers as std::barrier), so that the register-tile factor's tile mapping,
panel order, barrier counts, ragged edges, strides and aliasing are checked
on every run: against ``chol.cholesky_nnb_plain`` lane by lane, and against
the shared-memory factor kernel bit for bit (both take the same FMAs in the
same order).  Speed says nothing here.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hector_torch.qp import chol

torch.set_num_threads(1)

SHIM = Path(__file__).resolve().parent / 'host_cuda'
# max |L_k - L_p| over max |L_p| on every lane: chip_smoke.CHOL_FACTOR_TOL
FACTOR_TOL = 1e-4


def _host_source():
    """chol.cu with the three device-only constructs rewritten for the
    stand-in: dynamic shared memory, the kernel launch, the counting
    barrier."""
    src = chol.SOURCE.read_text()
    src = src.replace('extern __shared__ float smem[];',
                      'float* smem = host_smem();')
    src = re.sub(r'(\w+)<<<(.+?)>>>\(',
                 lambda m: f'host_launch({m.group(1)}, {m.group(2)}, ', src,
                 flags=re.S)
    src = src.replace('asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");',
                      'host_bar_sync(count);')
    assert 'asm volatile' not in src and '<<<' not in src
    return src


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build the host stand-in')
    out = tmp_path_factory.mktemp('chol_host')
    cpp = out / 'chol_host.cpp'
    cpp.write_text(_host_source())
    so = out / 'libchol_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared',
                    '-fPIC', '-pthread', f'-I{SHIM}', '-o', str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.chol_factor, lib.chol_factor_shared):
        fn.argtypes = [ptr, ptr, i32, i32] + [i64] * 6 + [ptr]
        fn.restype = i32
    lib.chol_solve.argtypes = [ptr, ptr, ptr, i32, i32] + [i64] * 7 + [ptr]
    lib.chol_solve.restype = i32
    lib.chol_factor_tile_max_n.argtypes = []
    lib.chol_factor_tile_max_n.restype = i32
    return lib


def _factor(fn, m_bnn, l_bnn):
    bsz, n, _ = m_bnn.shape
    assert fn(m_bnn.data_ptr(), l_bnn.data_ptr(), n, bsz,
              m_bnn.stride(1), m_bnn.stride(2), m_bnn.stride(0),
              l_bnn.stride(1), l_bnn.stride(2), l_bnn.stride(0), None) == 0
    return l_bnn


def _spd(bsz, n, seed):
    """Seeded SPD matrices (B, n, n) with a spread spectrum, and junk above
    the diagonal, which the kernels must not read."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((bsz, n, n))
    m = g @ g.transpose(0, 2, 1) / n + 1e-3 * np.eye(n)
    m = np.tril(m) + 1e3 * np.triu(rng.standard_normal((bsz, n, n)), 1)
    return torch.tensor(m, dtype=torch.float32)


def _lane_rel(l_k, l_p):
    n = l_p.shape[1]
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool))
    d = ((l_k - l_p) * lower).abs().amax((1, 2))
    return float((d / l_p.abs().amax((1, 2))).max())


# 1 and 8: one tile; 7, 17, 117: ragged tile grids; 64: two full warps;
# 120: the interior point's n; 249: above the tile kernel's 248, the
# shared-memory kernel
@pytest.mark.parametrize('n', [1, 7, 8, 17, 64, 117, 120, 249])
def test_factor_matches_plain_and_the_shared_kernel(lib, n):
    m = _spd(3, n, seed=n)
    l_k = _factor(lib.chol_factor, m, torch.full_like(m, float('nan')))
    l_s = _factor(lib.chol_factor_shared, m, torch.full_like(m, float('nan')))
    l_p = chol.cholesky_nnb_plain(m.permute(1, 2, 0)).permute(2, 0, 1)
    assert torch.isfinite(l_k).all()
    assert _lane_rel(l_k, l_p) <= FACTOR_TOL
    upper = ~torch.tril(torch.ones((n, n), dtype=torch.bool))
    assert not l_k[:, upper].any()
    assert torch.equal(l_k, l_s)


def test_factor_views_aliasing_and_a_bad_lane(lib):
    """The batch-minor (n, n, B) view (strided, element by element) gives
    the (B, n, n) result bit for bit; m and l may alias; a matrix that is not
    positive definite goes non-finite alone."""
    n = 40
    assert lib.chol_factor_tile_max_n() == 248
    m = _spd(4, n, seed=1)
    l_k = _factor(lib.chol_factor, m, torch.empty_like(m))
    m_nnb = m.permute(1, 2, 0).contiguous()
    l_nnb = torch.full_like(m_nnb, float('nan'))
    _factor(lib.chol_factor, m_nnb.permute(2, 0, 1), l_nnb.permute(2, 0, 1))
    assert torch.equal(l_nnb.permute(2, 0, 1), l_k)
    both = m.clone()
    _factor(lib.chol_factor, both, both)
    assert torch.equal(both, l_k)
    bad = m.clone()
    bad[2, 5, 5] = -1.0
    l_bad = _factor(lib.chol_factor, bad, torch.empty_like(bad))
    assert not torch.isfinite(l_bad[2]).all()
    assert torch.equal(l_bad[[0, 1, 3]], l_k[[0, 1, 3]])


def test_solve_matches_plain(lib):
    n = 120
    l = chol.cholesky_nnb_plain(_spd(3, n, seed=2).permute(1, 2, 0))
    rhs = torch.tensor(np.random.default_rng(3).standard_normal((n, 3)),
                       dtype=torch.float32)
    x = torch.empty_like(rhs)
    l_bnn, rhs_bn, x_bn = l.permute(2, 0, 1), rhs.t(), x.t()
    assert lib.chol_solve(l_bnn.data_ptr(), rhs_bn.data_ptr(),
                          x_bn.data_ptr(), n, 3, l_bnn.stride(1),
                          l_bnn.stride(2), l_bnn.stride(0), rhs_bn.stride(1),
                          rhs_bn.stride(0), x_bn.stride(1), x_bn.stride(0),
                          None) == 0
    x_p = chol.cholesky_solve_nnb_plain(l, rhs)
    rel = ((x - x_p).abs().amax(0) / x_p.abs().amax(0)).max()
    assert float(rel) <= 1e-4
