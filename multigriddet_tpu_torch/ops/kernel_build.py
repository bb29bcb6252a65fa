"""Build the package's CUDA sources into shared libraries and load them.

Each source under ``multigriddet_tpu_torch/csrc/`` compiles with ``nvcc``
for Hopper (``sm_90a``) into a library with a plain C interface, loaded
with ``ctypes``.  The build runs at first use, into ``build/kernels/`` of
the checkout (listed in ``.gitignore``), and is keyed by the hash of the
source, the flags and the source's link flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  A source that links a
CUDA library (``jpeg.cu``: nvJPEG) names the headers and libraries it
needs; where one is missing, the build raises and names the path.  Nothing
is built when a module is imported.  Threads that ask for a library at once
(a loader's decoder threads at their first batch) wait for one build under
a lock.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)),
                         'build', 'kernels')

# -fmad=false: the NMS overlap arithmetic must round like the float32
# reference, one operation at a time (no contraction into FMA).
NVCC_FLAGS: List[str] = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-fmad=false', '-Xptxas=-v', '-shared', '-Xcompiler', '-fPIC']

# per source: (headers under the toolkit's include/, libraries under its
# lib64/, nvcc's link flags)
LINKS: Dict[str, Tuple[List[str], List[str], List[str]]] = {
    'nms.cu': ([], [], []),
    'jpeg.cu': (['nvjpeg.h'], ['libnvjpeg.so'], ['-lnvjpeg']),
}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'are built from source at first use')


def link_flags(source: str, cuda_home: str) -> List[str]:
    """nvcc's link flags for ``source``, after checking that the toolkit
    under ``cuda_home`` holds its headers and libraries (raises naming the
    first missing path).  The libraries' directory goes into the rpath."""
    headers, libs, flags = LINKS[source]
    for h in headers:
        path = os.path.join(cuda_home, 'include', h)
        if not os.path.isfile(path):
            raise RuntimeError(f'{source} needs {path}, which is missing')
    lib_dir = os.path.join(cuda_home, 'lib64')
    for lib in libs:
        path = os.path.join(lib_dir, lib)
        if not glob.glob(path + '*'):
            raise RuntimeError(f'{source} needs {path}, which is missing')
    return flags + ([f'-Xlinker=-rpath={lib_dir}', f'-L{lib_dir}']
                    if libs else [])


def library_path(source: str) -> str:
    """Where the library of ``source`` (a file name in ``csrc/``) lives."""
    with open(os.path.join(CSRC_DIR, source), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(
            NVCC_FLAGS + LINKS[source][2]).encode())
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
    nvcc = nvcc_path()
    link = link_flags(source, os.path.dirname(os.path.dirname(nvcc)))
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
    cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC_DIR, source),
           *link]
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


def load(source: str,
         bind: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed.

    ``bind`` (given the library) sets its functions' ctypes signatures; it
    runs once, before any caller gets the library.  The first call builds
    and loads under a lock, so concurrent first calls run ``nvcc`` once."""
    lib = _LOADED.get(source)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(source)
            if lib is None:
                lib = ctypes.CDLL(build(source)['path'])
                if bind is not None:
                    bind(lib)
                _LOADED[source] = lib
    return lib
