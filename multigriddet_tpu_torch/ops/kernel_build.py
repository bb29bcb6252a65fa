"""Build the package's CUDA sources into shared libraries and load them.

Each source under ``multigriddet_tpu_torch/csrc/`` compiles with ``nvcc``
for Hopper (``sm_90a``) into a library with a plain C interface, loaded
with ``ctypes``.  The build runs at first use, into ``build/kernels/`` of
the checkout (listed in ``.gitignore``), and is keyed by the hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)),
                         'build', 'kernels')

# -fmad=false: the NMS overlap arithmetic must round like the float32
# reference, one operation at a time (no contraction into FMA).
NVCC_FLAGS: List[str] = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-fmad=false', '-Xptxas=-v', '-shared', '-Xcompiler', '-fPIC']

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'are built from source at first use')


def library_path(source: str) -> str:
    """Where the library of ``source`` (a file name in ``csrc/``) lives."""
    with open(os.path.join(CSRC_DIR, source), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f'lib{stem}-{digest.hexdigest()[:16]}.so')


def build(source: str) -> dict:
    """Compile ``csrc/<source>`` unless its library exists.

    Returns ``{'path', 'seconds', 'log'}``; ``log`` holds nvcc's output
    (``-Xptxas=-v`` lists registers and shared memory per kernel).
    """
    out = library_path(source)
    if os.path.exists(out):
        return {'path': out, 'seconds': 0.0, 'log': ''}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp,
           os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source}:\n{log}')
    os.replace(tmp, out)
    with open(out + '.log', 'w') as f:
        f.write(log)
    return {'path': out, 'seconds': seconds, 'log': log}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(build(source)['path'])
    return _LOADED[source]
