"""The CUDA source of the Cholesky kernels, compiled for the host and run on
the CPU.

``hector_torch/csrc/chol.cu`` runs only on the card, where chip_smoke.py
holds it to its plain versions.  Here g++ builds the same source against
``tests/host_cuda/cuda_runtime.h`` (threads of a block as std::threads,
barriers as std::barrier, a cluster's blocks run together with one cluster
barrier and each other's shared memory, cp.async as a copy made at the
issuing thread's wait, its destination NaN until then), so that the tile,
cluster and streaming kernels' tile mapping, panel order, barrier counts,
panel buffers and copies, ragged edges, strides, aliasing and routes by n
are checked on every run: against
``chol.cholesky_nnb_plain`` and ``chol.cholesky_solve_nnb_plain`` lane by
lane, and against the shared-memory kernels bit for bit (each pair takes the
same FMAs in the same order; ``-ffp-contract=off`` keeps g++ from fusing any
other).  Speed says nothing here.
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
# Appended to the host build of chol.cu (the same translation unit, so it
# reaches the solve's fast_divide): every significand of d in [1, 2) at two
# exponents, against 4 seeded dividends each in and around the fast range,
# plus signed zeros and subnormals.  Counts the pairs the fast path takes,
# those where its quotient is not the IEEE divide's, and the pairs it must
# refuse (-0, subnormal, out of range) but takes.
FAST_DIVIDE_CHECK = r"""
#include <cstdint>
#include <cstring>
extern "C" void fast_divide_check(long long* out) {
  auto bits = [](uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; };
  auto same = [](float a, float b) { return std::memcmp(&a, &b, 4) == 0; };
  uint64_t state = 12345;
  auto next = [&]() { state = state * 6364136223846793005ULL + 1442695040888963407ULL;
                      return static_cast<uint32_t>(state >> 33); };
  long long taken = 0, wrong = 0, unsafe = 0;
  for (uint32_t m = 0; m < (1u << 23); ++m) {
    for (int e : {-40, 7}) {
      const float d = std::ldexp(bits(0x3f800000u | m), e);
      const float r = 1.0f / d;
      for (int k = 0; k < 4; ++k) {
        const float x = std::ldexp(bits(0x3f800000u | (next() & 0x7fffff)),
                                   static_cast<int>(next() % 120) - 60);
        for (float xs : {x, -x}) {
          bool ok = true;
          const float q = fast_divide(xs, d, r, ok);
          if (!ok) continue;
          ++taken;
          if (!same(q, xs / d)) ++wrong;
        }
      }
      for (float xs : {0.0f, -0.0f, 1e-40f, 0x1p61f}) {
        bool ok = true;
        const float q = fast_divide(xs, d, r, ok);
        if (ok && !same(q, xs / d)) ++wrong;
        if (ok && xs != 0.0f) ++unsafe;
        if (ok && std::signbit(xs)) ++unsafe;
      }
    }
  }
  out[0] = taken; out[1] = wrong; out[2] = unsafe;
}
"""
# max |L_k - L_p| over max |L_p| on every lane: chip_smoke.CHOL_FACTOR_TOL
FACTOR_TOL = 1e-4
# max |x_k - x_p| over max |x_p| on every lane: chip_smoke's bar on the
# first KKT matrices
SOLVE_TOL = 1e-4
TILE_MAX_N = 248


def _host_source():
    """chol.cu with the device-only constructs rewritten for the stand-in:
    dynamic shared memory, the kernel launch, the counting barrier, the
    cluster barrier, the map into the partner block's shared memory and the
    asynchronous copies (16 and 4 bytes, commit, wait)."""
    src = chol.SOURCE.read_text()
    src = re.sub(r'extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];',
                 r'float* \1 = host_smem();', src)
    src = re.sub(r'(\w+)<<<(.+?)>>>\(',
                 lambda m: f'host_launch({m.group(1)}, {m.group(2)}, ', src,
                 flags=re.S)
    for asm, host in (
            ('asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");',
             'host_bar_sync(count);'),
            ('asm volatile("barrier.cluster.arrive;\\n\\tbarrier.cluster.wait;" '
             '::: "memory");', 'host_cluster_sync();'),
            ('asm volatile("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(p), '
             '"r"(rank));', 'r = host_map_shared(p, rank);'),
            ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"\n'
             '               ::"r"(smem_address(dst)), "l"(src) : "memory");',
             'host_cp_async(dst, src, 16);'),
            ('asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"\n'
             '               ::"r"(smem_address(dst)), "l"(src) : "memory");',
             'host_cp_async(dst, src, 4);'),
            ('asm volatile("cp.async.commit_group;" ::: "memory");',
             'host_cp_async_commit();'),
            ('asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : '
             '"memory");', 'host_cp_async_wait(Pending);')):
        assert src.count(asm) == 1, asm
        src = src.replace(asm, host)
    assert ('asm volatile' not in src and 'asm(' not in src
            and '<<<' not in src and 'extern __shared__' not in src)
    return src


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build the host stand-in')
    out = tmp_path_factory.mktemp('chol_host')
    cpp = out / 'chol_host.cpp'
    cpp.write_text(_host_source() + FAST_DIVIDE_CHECK)
    so = out / 'libchol_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared',
                    '-fPIC', '-pthread', f'-I{SHIM}', '-o', str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.chol_factor, lib.chol_factor_shared,
               lib.chol_factor_cluster):
        fn.argtypes = [ptr, ptr, i32, i32] + [i64] * 6 + [ptr]
        fn.restype = i32
    for fn in (lib.chol_solve, lib.chol_solve_shared, lib.chol_solve_stream):
        fn.argtypes = [ptr, ptr, ptr, i32, i32] + [i64] * 7 + [ptr]
        fn.restype = i32
    for fn in (lib.chol_factor_tile_max_n, lib.chol_max_n):
        fn.argtypes = []
        fn.restype = i32
    for fn in (lib.chol_factor_route, lib.chol_solve_route):
        fn.argtypes = [i32]
        fn.restype = i32
    lib.fast_divide_check.argtypes = [ptr]
    lib.fast_divide_check.restype = None
    return lib


def _factor(fn, m_bnn, l_bnn):
    bsz, n, _ = m_bnn.shape
    assert fn(m_bnn.data_ptr(), l_bnn.data_ptr(), n, bsz,
              m_bnn.stride(1), m_bnn.stride(2), m_bnn.stride(0),
              l_bnn.stride(1), l_bnn.stride(2), l_bnn.stride(0), None) == 0
    return l_bnn


def _solve(fn, l_bnn, rhs_bn, x_bn):
    bsz, n, _ = l_bnn.shape
    assert fn(l_bnn.data_ptr(), rhs_bn.data_ptr(), x_bn.data_ptr(), n, bsz,
              l_bnn.stride(1), l_bnn.stride(2), l_bnn.stride(0),
              rhs_bn.stride(1), rhs_bn.stride(0), x_bn.stride(1),
              x_bn.stride(0), None) == 0
    return x_bn


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
# 120: the interior point's n; above the tile kernel's 248, the cluster
# kernel: 249 (a ragged edge of one row, element by element), 288 (horizon
# 24, whole rows as float4), 300 (horizon 25, a ragged tile grid, half rows)
# and 339 (the ceiling, 16 warps in block 0, element by element)
@pytest.mark.parametrize('n', [1, 7, 8, 17, 64, 117, 120, 249, 288, 300, 339])
def test_factor_matches_plain_and_the_shared_kernel(lib, n):
    want = 'factor_tile' if n <= TILE_MAX_N else 'factor_cluster'
    assert chol.KERNELS[lib.chol_factor_route(n)] == want
    m = _spd(3 if n < 300 else 2, n, seed=n)
    l_k = _factor(lib.chol_factor, m, torch.full_like(m, float('nan')))
    l_s = _factor(lib.chol_factor_shared, m, torch.full_like(m, float('nan')))
    l_p = chol.cholesky_nnb_plain(m.permute(1, 2, 0)).permute(2, 0, 1)
    assert torch.isfinite(l_k).all()
    assert _lane_rel(l_k, l_p) <= FACTOR_TOL
    upper = ~torch.tril(torch.ones((n, n), dtype=torch.bool))
    assert not l_k[:, upper].any()
    assert torch.equal(l_k, l_s)


# the cluster kernel below its route: one tile (block 1 holds none), a
# ragged grid, the interior point's n
@pytest.mark.parametrize('n', [8, 117, 120])
def test_cluster_factor_is_the_tile_kernel(lib, n):
    m = _spd(3, n, seed=n + 7)
    l_t = _factor(lib.chol_factor, m, torch.full_like(m, float('nan')))
    l_c = _factor(lib.chol_factor_cluster, m, torch.full_like(m, float('nan')))
    assert torch.equal(l_c, l_t)


def _factor_views_aliasing_and_a_bad_lane(lib, n, fn=None):
    """The batch-minor (n, n, B) view (strided, element by element) gives
    the (B, n, n) result bit for bit; m and l may alias; a matrix that is not
    positive definite goes non-finite alone.  ``fn``: the entry point
    (default chol_factor, the route's kernel)."""
    fn = fn or lib.chol_factor
    m = _spd(4, n, seed=1)
    l_k = _factor(fn, m, torch.empty_like(m))
    m_nnb = m.permute(1, 2, 0).contiguous()
    l_nnb = torch.full_like(m_nnb, float('nan'))
    _factor(fn, m_nnb.permute(2, 0, 1), l_nnb.permute(2, 0, 1))
    assert torch.equal(l_nnb.permute(2, 0, 1), l_k)
    both = m.clone()
    _factor(fn, both, both)
    assert torch.equal(both, l_k)
    bad = m.clone()
    bad[2, 5, 5] = -1.0
    l_bad = _factor(fn, bad, torch.empty_like(bad))
    assert not torch.isfinite(l_bad[2]).all()
    assert torch.equal(l_bad[[0, 1, 3]], l_k[[0, 1, 3]])


def test_factor_views_aliasing_and_a_bad_lane(lib):
    assert lib.chol_factor_tile_max_n() == TILE_MAX_N
    _factor_views_aliasing_and_a_bad_lane(lib, 40)       # register tiles


def test_shared_factor_views_aliasing_and_a_bad_lane(lib):
    # the packed triangle, off the route: the yardstick the tile and
    # cluster kernels are held to
    assert chol.KERNELS[lib.chol_factor_route(249)] != 'factor_shared'
    _factor_views_aliasing_and_a_bad_lane(lib, 249, lib.chol_factor_shared)


def test_cluster_factor_views_aliasing_and_a_bad_lane(lib):
    # n = 252 (horizon 21): half rows as float4 in (B, n, n), up to a
    # ragged edge, element by element in the views; the route's kernel up
    # to chol_max_n() (at least 339)
    assert lib.chol_max_n() >= 339
    assert all(chol.KERNELS[lib.chol_factor_route(n)] == 'factor_cluster'
               for n in range(TILE_MAX_N + 1, lib.chol_max_n() + 1))
    _factor_views_aliasing_and_a_bad_lane(lib, 252)


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


def _solve_case(n):
    """Seeded (B, n, n) factors (contiguous), right-hand sides, and the
    factors with junk above the diagonal, which no solve may read; 3 lanes,
    2 above the tile solve's n (the shared-memory solve is slow here)."""
    bsz = 3 if n <= TILE_MAX_N else 2
    l_bnn = chol.cholesky_nnb_plain(
        _spd(bsz, n, seed=n + 1).permute(1, 2, 0)).permute(2, 0, 1)
    l_bnn = l_bnn.contiguous()
    rng = np.random.default_rng(n)
    rhs = torch.tensor(rng.standard_normal((bsz, n)), dtype=torch.float32)
    junk = torch.tensor(np.triu(rng.standard_normal((bsz, n, n)), 1),
                        dtype=torch.float32)
    return l_bnn, rhs, l_bnn + 1e3 * junk


def _edge(l_bnn, rhs):
    """Factors and right-hand sides of four lanes: +0, -0, subnormal and
    huge entries.  The fast divides of the tile and streaming solves take +0
    and fall back to IEEE divides on the others (below 2^-60 and above
    2^60); the signs of zeros count too."""
    zero = torch.zeros(rhs.shape[1])
    return (l_bnn[[0, 1, 0, 1]],
            torch.stack([zero, -zero, rhs[0] * 1e-40, rhs[1] * 1e25]))


# 1 and 8: one tile; 7, 17, 117: ragged tile grids (the back sweep skips
# the columns past the edge); 120: the interior point's n; above the
# register tiles, the streaming solve: 249 and 339 (the ceiling) element by
# element, 252 and 300 (horizons 21 and 25, ragged tile grids) and 288
# (horizon 24) in 16-byte copies
@pytest.mark.parametrize('n', [1, 7, 8, 17, 117, 120, 249, 252, 288, 300,
                               339])
def test_solve_matches_plain_and_the_shared_kernel(lib, n):
    """The solve against its plain version on every lane and against the
    shared-memory solve bit for bit; the batch-minor views give the
    (B, n, n) result bit for bit; x may alias rhs; junk above the diagonal
    of L changes nothing; a matrix with a zero pivot goes non-finite
    alone."""
    want = 'solve_tile' if n <= TILE_MAX_N else 'solve_stream'
    assert chol.KERNELS[lib.chol_solve_route(n)] == want
    l_bnn, rhs, l_junk = _solve_case(n)
    x_k = _solve(lib.chol_solve, l_bnn, rhs, torch.full_like(rhs, np.nan))
    x_s = _solve(lib.chol_solve_shared, l_bnn, rhs,
                 torch.full_like(rhs, np.nan))
    x_p = chol.cholesky_solve_nnb_plain(l_bnn.permute(1, 2, 0), rhs.t()).t()
    assert torch.isfinite(x_k).all()
    rel = (x_k - x_p).abs().amax(1) / x_p.abs().amax(1)
    assert float(rel.max()) <= SOLVE_TOL
    assert torch.equal(x_k.view(torch.int32), x_s.view(torch.int32))
    x_j = _solve(lib.chol_solve, l_junk, rhs, torch.full_like(rhs, np.nan))
    assert torch.equal(x_j.view(torch.int32), x_k.view(torch.int32))
    # (n, n, B) and (n, B) views: strided, element by element
    l_nnb = l_bnn.permute(1, 2, 0).contiguous()
    rhs_nb = rhs.t().contiguous()
    x_nb = torch.full_like(rhs_nb, np.nan)
    _solve(lib.chol_solve, l_nnb.permute(2, 0, 1), rhs_nb.t(), x_nb.t())
    assert torch.equal(x_nb.t(), x_k)
    both = rhs.clone()
    _solve(lib.chol_solve, l_bnn, both, both)
    assert torch.equal(both, x_k)
    bad = l_bnn.clone()
    bad[1, n // 2, n // 2] = 0.0
    x_bad = _solve(lib.chol_solve, bad, rhs, torch.empty_like(rhs))
    others = [i for i in range(len(rhs)) if i != 1]
    assert not torch.isfinite(x_bad[1]).all()
    assert torch.equal(x_bad[others], x_k[others])
    l_e, odd = _edge(l_bnn, rhs)
    x_k = _solve(lib.chol_solve, l_e, odd, torch.empty_like(odd))
    x_s = _solve(lib.chol_solve_shared, l_e, odd, torch.empty_like(odd))
    assert torch.equal(x_k.view(torch.int32), x_s.view(torch.int32))


# the streaming solve below its route: one tile (no forward step, the
# diagonal step forward and back at once), a ragged grid, the interior
# point's n (16-byte copies)
@pytest.mark.parametrize('n', [8, 117, 120])
def test_stream_solve_is_the_tile_solve(lib, n):
    l_bnn, rhs, l_junk = _solve_case(n)
    l_e, odd = _edge(l_bnn, rhs)
    for ell, ell_m, r in ((l_bnn, l_bnn, rhs), (l_bnn, l_junk, rhs),
                          (l_e, l_e, odd)):
        x_t = _solve(lib.chol_solve, ell, r, torch.full_like(r, np.nan))
        x_m = _solve(lib.chol_solve_stream, ell_m, r, torch.full_like(r, np.nan))
        assert torch.equal(x_m.view(torch.int32), x_t.view(torch.int32))


def test_solve_route(lib):
    # the tile solve up to 248, the streaming one above, up to chol_max_n();
    # the shared-memory solve on no n
    assert chol.KERNELS[lib.chol_solve_route(TILE_MAX_N)] == 'solve_tile'
    assert chol.KERNELS[lib.chol_solve_route(TILE_MAX_N + 1)] == 'solve_stream'
    assert all(chol.KERNELS[lib.chol_solve_route(n)] == 'solve_stream'
               for n in range(TILE_MAX_N + 1, lib.chol_max_n() + 1))
    assert all(chol.KERNELS[lib.chol_solve_route(n)] != 'solve_shared'
               for n in range(1, lib.chol_max_n() + 1))


def test_fast_divide_is_the_ieee_divide(lib):
    """The register-tile solve's divide (a Markstein correction of x / d
    from r = 1 / d) gives the IEEE quotient bit for bit wherever it does not
    refuse the operands, over every significand of d; it refuses -0,
    subnormal and out-of-range dividends."""
    out = (ctypes.c_longlong * 3)()
    lib.fast_divide_check(out)
    taken, wrong, unsafe = list(out)
    assert taken > 60_000_000
    assert wrong == 0 and unsafe == 0
