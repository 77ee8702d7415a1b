"""Build a CUDA source into a shared library with nvcc, once per content.

The kernels of this package have a plain C interface and are loaded with
ctypes, so a build takes seconds and needs nothing of PyTorch's headers.
Nothing here runs at import: the wrappers call :func:`compile_shared` at
first use, which builds through ``hector_torch._native``.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

from .. import _native

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


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


def compile_shared(source: Path, build_root: Path, flags=NVCC_FLAGS):
    """Compile ``source`` with nvcc into ``build_root/<hash of source and
    flags>/lib<stem>.so`` unless it is there already (``_native.build``).
    Returns (path of the library, build record); the record holds the
    ptxas report, and the nvcc command and its seconds when this call ran
    it (the report of a library found built is the one kept beside it)."""
    so, info = _native.build(find_nvcc(), [source], source.stem, flags,
                             build_root)
    info['ptxas'] = info.pop('log')
    return so, info
