"""Build a CUDA source into a shared library with nvcc, once per content.

The kernels of this package have a plain C interface and are loaded with
ctypes, so a build takes seconds and needs nothing of PyTorch's headers.
Nothing here runs at import: the wrappers call :func:`compile_shared` at
first use.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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
    """Compile ``source`` into ``build_root/<hash of source and flags>/
    lib<stem>.so`` unless it is there already.  Returns (path of the
    library, build record); the record holds the ptxas report, and the nvcc
    command and its seconds when this call ran it (the report of a library
    found built is the one kept beside it)."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + ' '.join(flags).encode()).hexdigest()[:16]
    out_dir = build_root / tag
    so = out_dir / f'lib{source.stem}.so'
    log = out_dir / 'ptxas.txt'
    if so.exists():
        info = dict(ptxas=log.read_text() if log.exists() else '')
    else:
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f'lib{source.stem}.{os.getpid()}.so'
        cmd = [nvcc, *flags, '-o', str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{proc.stdout}\n{proc.stderr}')
        report = proc.stdout + proc.stderr
        log.write_text(report)
        os.replace(tmp, so)
        info = dict(command=cmd, seconds=seconds, ptxas=report)
    return so, info
