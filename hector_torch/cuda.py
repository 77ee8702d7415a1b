"""The port's kernel layer: the CUDA sources under ``csrc/``, built with
nvcc and loaded with ctypes, and the launch counts of their wrappers.

Each source is declared once here, as a :class:`Library`: its path, its
nvcc flags, the entry point that turns a return code into CUDA's message,
and the argument and return types of the entry points the wrappers call.
The mirrors of the sources' C structs sit beside their declarations, so
this module holds the whole C interface of ``csrc/``; the wrappers
(``qp/chol.py``, ``qp/fused_riccati.py``, ``plant/srb.py``,
``plant/rnea.py`` and ``kinematics.py``) fill in argument values, launch
and count.  The kernels
have a plain C interface, so a build takes seconds and needs nothing of
PyTorch's headers.  Nothing here runs at import: a library is built
(``_native.build``, into ``_native.BUILD_ROOT``) and loaded at its first
use.

:data:`counts` is the registry of launch counts, one name of
:data:`COUNTERS` a kernel, moved by the wrappers after each launch and
never by the plain versions; ``graph`` carries it over replays, and
``graph.kernel_counters`` hands it to the benchmark.  A new kernel adds its
entry points to its source's declaration and one name to
:data:`COUNTERS`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from pathlib import Path

import torch

from . import _native

CSRC = Path(__file__).resolve().parent / 'csrc'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# the launch counts, since import or the caller's reset:
#   launches, polish_launches: fused_riccati_warp_kernel<false>, <true>
#   factor_launches: every factor of chol.cu, of which
#     factor_shared_launches and factor_cluster_launches went to the
#     shared-triangle and the cluster kernel
#   solve_launches: every solve of chol.cu, of which solve_shared_launches
#     and solve_stream_launches went to the shared-memory and the streaming
#     kernel
#   plant_launches: srb_plant_step_kernel; legs_launches: tick_legs_kernel
#   wb_dynamics_launches: wb_dynamics_kernel
COUNTERS = ('launches', 'polish_launches', 'factor_launches',
            'factor_shared_launches', 'factor_cluster_launches',
            'solve_launches', 'solve_shared_launches',
            'solve_stream_launches', 'plant_launches', 'legs_launches',
            'wb_dynamics_launches')


class Counts:
    """The registry: one int attribute a name of :data:`COUNTERS`."""

    __slots__ = COUNTERS

    def __init__(self):
        self.reset()

    def reset(self):
        self.write(dict.fromkeys(COUNTERS, 0))

    def read(self):
        return {name: getattr(self, name) for name in COUNTERS}

    def write(self, values):
        for name, v in values.items():
            setattr(self, name, v)

    def add(self, *names):
        """One more launch of each of ``names``."""
        for name in names:
            setattr(self, name, getattr(self, name) + 1)


counts = Counts()


def find_nvcc():
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        cand = Path(home) / 'bin' / 'nvcc'
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin): the CUDA kernels are '
                           'built from source at first use')
    return nvcc


class Library:
    """One source of ``csrc/``, built with ``flags`` and loaded at first
    use (:meth:`load`).

    ``entries``: each entry point the wrappers call, with its (argtypes,
    restype); ``error_string``: the entry point that names a CUDA error.
    ``handle``: the loaded library, None until the first use; the wrappers
    launch whatever is installed there, so a profiling variant can take
    its place.  ``build_info``: per build (the source's name and its extra
    ``-D`` flags), nvcc's ptxas report, and the command and its seconds
    when this process ran it (the report of a library found built is the
    one kept beside it)."""

    def __init__(self, source, flags, error_string, entries):
        self.source = CSRC / source
        self.flags = tuple(flags)
        self.error_string = error_string
        self.entries = {error_string: ([ctypes.c_int], ctypes.c_char_p),
                        **entries}
        self.handle = None
        self.build_info = {}

    def load(self):
        if self.handle is None:
            self.handle = self.variant()[0]
        return self.handle

    def variant(self, defines=()):
        """The source built with extra ``-D`` flags (the profiling
        switches) and loaded, with none the production build: (library,
        its build record)."""
        so, info = _native.build(find_nvcc(), [self.source],
                                 self.source.stem, self.flags + tuple(defines),
                                 _native.BUILD_ROOT)
        info['ptxas'] = info.pop('log')
        self.build_info[' '.join((self.source.name, *defines))] = info
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in self.entries.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        return lib, info

    def call(self, entry, *args):
        """``entry(*args)``; raises on a non-zero return code, with the
        source's name for it."""
        lib = self.load()
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            err = getattr(lib, self.error_string)(rc).decode()
            raise RuntimeError(f'{entry} failed: CUDA error {rc} ({err})')

    def launch(self, entry, device, *args, counted=()):
        """``entry(*args, stream)`` on ``device``'s current stream, no
        synchronisation (:meth:`call`); then one more launch of each
        registry name of ``counted``."""
        with torch.cuda.device(device):
            self.call(entry, *args,
                      torch.cuda.current_stream(device).cuda_stream)
        counts.add(*counted)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(_I)

# --------------------------------------------------------------------------
# csrc/chol.cu: the batched Cholesky factor and solve (qp/chol.py)

_FACTOR = ([_P, _P, _I, _I] + [_LL] * 6 + [_P], _I)
_SOLVE = ([_P, _P, _P, _I, _I] + [_LL] * 7 + [_P], _I)
CHOL = Library('chol.cu', NVCC_FLAGS, 'chol_error_string', {
    'chol_factor': _FACTOR, 'chol_factor_shared': _FACTOR,
    'chol_factor_cluster': _FACTOR, 'chol_solve': _SOLVE,
    'chol_solve_shared': _SOLVE, 'chol_solve_stream': _SOLVE,
    'chol_max_n': ([], _I), 'chol_factor_tile_max_n': ([], _I),
    'chol_factor_route': ([_I], _I), 'chol_solve_route': ([_I], _I),
    'chol_kernel_attributes': ([_I, _I, _IP], _I)})

# --------------------------------------------------------------------------
# csrc/fused_riccati_warp.cu: the fused Riccati interior point and its
# polish (qp/fused_riccati.py)


class FusedRiccatiParams(ctypes.Structure):
    _fields_ = [('q2', ctypes.c_float * 13), ('r2', ctypes.c_float * 12),
                ('r2reg', ctypes.c_float * 12), ('sigma', ctypes.c_float),
                ('frac', ctypes.c_float), ('big', ctypes.c_float),
                ('init_slack', ctypes.c_float), ('init_dual', ctypes.c_float),
                ('iters', ctypes.c_int), ('polish_rounds', ctypes.c_int),
                ('polish_iters', ctypes.c_int), ('polish_rho', ctypes.c_float),
                ('polish_tol', ctypes.c_float)]


FUSED = Library('fused_riccati_warp.cu', NVCC_FLAGS,
                'fused_riccati_warp_error_string', {
    'fused_riccati_warp_solve': (
        [_P] * 11 + [_I, ctypes.POINTER(FusedRiccatiParams), _P, _P], _I),
    'fused_riccati_warp_attributes': ([_I] + [_IP] * 6, _I),
    'fused_riccati_warp_polish_counts': (
        [ctypes.POINTER(ctypes.c_ulonglong)], _I),
    'fused_riccati_warp_polish_steps': (
        [ctypes.POINTER(ctypes.c_ulonglong)], _I)})

# --------------------------------------------------------------------------
# csrc/srb_plant.cu: the tier-1 plant step (plant/srb.py) and the tick's
# leg data (kinematics.leg_data), with the device functions both share


class SrbIn(ctypes.Structure):
    """A tensor's data and its strides in elements."""

    _fields_ = [('p', _P), ('s0', _LL), ('s1', _LL), ('s2', _LL)]


def tensor_in(where, name, t, shape, dtype, device):
    """``t`` broadcast to ``shape`` (a view: strides 0 where it broadcasts,
    nothing copied) as a kernel's ``SrbIn``; raises, naming the caller
    ``where``, on a dtype, a device or a shape the kernel does not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{where}: {name} must be a tensor, got {type(t)}')
    if t.dtype != dtype:
        raise TypeError(f'{where}: {name} must be {dtype}, got {t.dtype}')
    if t.device != device:
        raise ValueError(f'{where}: {name} on {t.device}, the state on '
                         f'{device}')
    try:
        v = t.expand(shape)
    except RuntimeError:
        raise ValueError(f'{where}: {name} has shape {tuple(t.shape)}, the '
                         f'kernel takes {shape}') from None
    strides = list(v.stride()) + [0] * (3 - v.dim())
    return SrbIn(v.data_ptr(), *strides)


SRB_INPUTS = ('position', 'quat', 'v_world', 'omega_world', 'q', 'qd',
              'foot_anchor', 'contact', 'kp', 'kd', 'q_des', 'wrench',
              'sched', 'disturbance', 'terrain_h', 'terrain_len')


class SrbArgs(ctypes.Structure):
    _fields_ = ([(name, SrbIn) for name in SRB_INPUTS]
                + [('out', _P * 8), ('batch', _I)])


class LegsArgs(ctypes.Structure):
    """q's data and its strides in elements (the fields of its ``SrbIn``),
    the three outputs, the batch."""

    _fields_ = [('q', _P), ('s0', _LL), ('s1', _LL), ('s2', _LL),
                ('out', _P * 3), ('batch', _I)]


# SrbParams<T>: (name, length) in the struct's order
SRB_PARAM_FIELDS = (
    ('dt', 1), ('mass', 1), ('gravity', 1), ('torque_limit', 1),
    ('contact_kp', 1), ('contact_kd', 1), ('trunk_radius', 1),
    ('ground_mu', 1), ('joint_vel_limit', 1), ('joint_tracking_tau', 1),
    ('swing_joint_inertia', 1), ('inertia', 3), ('offsets', 5),
    ('hip_yaw', 6), ('hip_width', 6), ('fk_a_x', 1), ('fk_a_y', 2),
    ('fk_a_z', 1), ('fk_b_y', 2), ('fk_l', 3), ('jac_a_x', 1),
    ('jac_a_y', 2), ('jac_b_y', 2), ('jac_l', 3), ('ik_hip_x', 1),
    ('ik_hip_z', 1), ('ik_dh', 1), ('ik_dh2', 1), ('ik_eps', 1),
    ('ik_two_l', 1), ('ik_side', 2), ('pi', 1))


@functools.cache
def _params_type(name, fields, ctype):
    return type(f'{name}_{ctype.__name__}', (ctypes.Structure,),
                {'_fields_': [(n, ctype * k if k > 1 else ctype)
                              for n, k in fields]})


def _make_params(name, fields, dtype, values):
    """The parameter struct ``name<T>`` of ``fields`` for a state of
    ``dtype`` (float32 or float64) from ``values``, each field's number or
    flat list of numbers."""
    ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    return _params_type(name, fields, ctype)(**{
        n: (ctype * k)(*values[n]) if k > 1 else values[n]
        for n, k in fields})


def make_srb_params(dtype, values):
    """``SrbParams<T>`` for a state of ``dtype`` from ``values``."""
    return _make_params('SrbParams', SRB_PARAM_FIELDS, dtype, values)


_SRB_ATTRIBUTES = ([_I] + [_IP] * 4, _I)
# -fmad=false: a product and a sum round apart, as the plain versions' ops do
SRB = Library('srb_plant.cu', NVCC_FLAGS + ('-fmad=false',),
              'srb_plant_error_string', {
    'srb_plant_step': ([_I, ctypes.POINTER(SrbArgs), _P, _P], _I),
    'tick_legs': ([_I, _P, _P, _P], _I),
    'srb_plant_attributes': _SRB_ATTRIBUTES,
    'tick_legs_attributes': _SRB_ATTRIBUTES})

# --------------------------------------------------------------------------
# csrc/wb_dynamics.cu: the articulated plant's dynamics terms (plant/rnea.py)

WB_INPUTS = ('position', 'quat', 'v_world', 'omega_world', 'q', 'qd', 'cps')


class WbArgs(ctypes.Structure):
    """Each input's ``SrbIn`` (its data and strides; the source's ``WbIn``
    has the same layout), the five outputs, the batch, include_body."""

    _fields_ = ([(name, SrbIn) for name in WB_INPUTS]
                + [('out', _P * 5), ('batch', _I), ('include_body', _I)])


# WbParams<T>: (name, length) in the struct's order
WB_PARAM_FIELDS = (
    ('offset', 30), ('pre', 90), ('axis', 30), ('mass', 10), ('com', 30),
    ('inertia', 90), ('trunk_inertia', 9), ('corners', 24),
    ('trunk_mass', 1), ('gravity', 1))


def make_wb_params(dtype, values):
    """``WbParams<T>`` for a state of ``dtype`` from ``values``."""
    return _make_params('WbParams', WB_PARAM_FIELDS, dtype, values)


WB = Library('wb_dynamics.cu', NVCC_FLAGS, 'wb_dynamics_error_string', {
    'wb_dynamics': ([_I, ctypes.POINTER(WbArgs), _P, _P], _I),
    'wb_dynamics_attributes': ([_I] + [_IP] * 5, _I)})
