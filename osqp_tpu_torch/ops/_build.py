"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``build/kernels/`` at the root of the
checkout, named by a hash of the source so an edited kernel is rebuilt.  The
library is loaded with ``ctypes``.  Nothing is built when the package is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built with the CUDA toolkit')


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for this source exists;
    returns the library's path.  nvcc's report (registers, shared memory,
    spills) goes to the ``.log`` beside it.  Raises with nvcc's output on
    failure."""
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f'lib{name}-{digest}.so'
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}')
    lib.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_all(names) -> list[Path]:
    """``build`` for each name, all nvcc processes started together."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(build, names))


def load_library(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use in this process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
