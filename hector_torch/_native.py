"""Build native sources into a shared library, once per content.

Every library of this package is built here at first use, never at
import: the CUDA kernels with nvcc (``qp/_nvcc.py`` gives the compiler and
its flags), and the host libraries (the float64 QP oracle, the qpOASES
bridge and the scenario generator) with g++ from the sources under the
repository's ``native/`` (and, for qpOASES, from sources outside it), with
the flags the JAX package builds them with, so that both packages run the
same object code.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / 'native'
BUILD_ROOT = Path(__file__).resolve().parent / '_build'
GXX_FLAGS = ('-O2', '-shared', '-fPIC')


def build(compiler: str, sources, name: str, flags,
          build_root: Path = BUILD_ROOT):
    """Compile ``sources`` (paths, the first one the library's own) with
    ``<compiler> <flags>`` into ``build_root/<hash of flags and sources>/
    lib<name>.so`` unless it is there already.  Returns (path of the
    library, build record): the record holds the compiler's output (kept
    beside the library as ``build.log``), and the command and its seconds
    when this call ran it.  The library is written under a name of its
    own process and thread and moved into place, so a concurrent build
    never loads half a file."""
    sources = [Path(s) for s in sources]
    digest = hashlib.sha256(' '.join(flags).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    out_dir = build_root / digest.hexdigest()[:16]
    so = out_dir / f'lib{name}.so'
    log = out_dir / 'build.log'
    if so.exists():
        return so, dict(log=log.read_text() if log.exists() else '')
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f'lib{name}.{os.getpid()}.{threading.get_ident()}.so'
    cmd = [compiler, *flags, '-o', str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f'{compiler} failed ({proc.returncode}) building '
                           f'{name}:\n{proc.stdout}\n{proc.stderr}')
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, so)
    return so, dict(command=cmd, seconds=seconds, log=report)
