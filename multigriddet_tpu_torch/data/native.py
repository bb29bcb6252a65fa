"""ctypes bindings of the port to the repository's native host code.

Counterpart of ``multigriddet_tpu/data/native.py`` and of the matcher
binding in ``multigriddet_tpu/evaluation/metrics.py:201-248``.  The
sources are the repository's ``native/*.cpp``; the port builds them with
``g++`` into ``build/native/`` of the checkout (listed in ``.gitignore``)
and never writes into ``native/``.  Two libraries:

* the matcher, ``native/matcher.cpp`` alone: the greedy mAP matching of
  every IoU threshold in one pass.  It links nothing but the C++ runtime,
  so mAP never depends on libjpeg;
* the fast loader, ``native/fastloader.cpp`` with ``-ljpeg``: JPEG decode
  with DCT-domain downscaling and letterboxing on native threads.

Each library builds at first use with the flags of ``native/Makefile``
(``-march=native``, so its file name carries the host's name besides the
hash of the source and flags), compiled to a temporary name and moved
into place with ``os.replace``: processes that build at once each leave
a whole library.  Both are host code.  Where one cannot be built or
loaded, its callers fall back as the JAX package does (the loader to
PIL, the matcher to numpy) and one printed line says so;
:func:`native_available` and :func:`matcher_available` report which path
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO_DIR, 'native')
BUILD_DIR = os.path.join(REPO_DIR, 'build', 'native')

CXX_FLAGS: List[str] = ['-O3', '-march=native', '-fPIC', '-std=c++17',
                        '-Wall', '-shared']
# library stem -> (source in native/, link flags)
LIBRARIES: Dict[str, Tuple[str, List[str]]] = {
    'mgdmatcher': ('matcher.cpp', []),
    'mgdfastloader': ('fastloader.cpp', ['-ljpeg', '-lpthread']),
}

_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)
_f64p = ctypes.POINTER(ctypes.c_double)


def library_path(stem: str, build_dir: str = BUILD_DIR) -> str:
    """Where the library ``stem`` (a key of ``LIBRARIES``) lives."""
    source, link = LIBRARIES[stem]
    with open(os.path.join(NATIVE_DIR, source), 'rb') as f:
        digest = hashlib.sha256(f.read())
    digest.update(' '.join(CXX_FLAGS + link).encode())
    digest.update(os.uname().nodename.encode())
    return os.path.join(build_dir, f'lib{stem}-{digest.hexdigest()[:16]}.so')


def build_library(stem: str, build_dir: str = BUILD_DIR) -> str:
    """Compile the library ``stem`` unless it exists; returns its path.

    Raises ``RuntimeError`` with the compiler's output when the build
    fails (no compiler, no libjpeg headers)."""
    source, link = LIBRARIES[stem]
    out = library_path(stem, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
    cmd = [os.environ.get('CXX', 'g++'), *CXX_FLAGS,
           os.path.join(NATIVE_DIR, source), '-o', tmp, *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f'cannot build {source}: {exc}') from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'cannot build {source}:\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return out


def _declare(stem: str, lib: ctypes.CDLL) -> None:
    if stem == 'mgdmatcher':
        fn = lib.mgd_match_all_thresholds
        fn.argtypes = [_f32p, ctypes.c_int, _f32p, ctypes.c_int, _f64p,
                       ctypes.c_int, _u8p]
        fn.restype = None
        return
    fn = lib.mgd_load_letterbox_batch
    fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _u8p, _f32p, _i32p,
                   ctypes.c_int]
    fn.restype = None
    fn = lib.mgd_load_letterbox_yuv_batch
    fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _u8p, _u8p, _u8p, _f32p,
                   _i32p, ctypes.c_int]
    fn.restype = None


_FALLBACK = {'mgdmatcher': 'mAP matching runs in numpy',
             'mgdfastloader': 'images load through PIL'}


def _library(stem: str) -> Optional[ctypes.CDLL]:
    """The loaded library ``stem``, built first if needed; None (after
    one printed line) when it cannot be built or loaded."""
    with _lock:
        if stem not in _loaded:
            try:
                lib = ctypes.CDLL(build_library(stem))
                _declare(stem, lib)
            except (OSError, RuntimeError, AttributeError) as exc:
                first = str(exc).strip().splitlines()[:1]
                print(f'native {LIBRARIES[stem][0]} unavailable '
                      f'({first[0] if first else type(exc).__name__}); '
                      f'{_FALLBACK[stem]}')
                lib = None
            _loaded[stem] = lib
        return _loaded[stem]


def native_available() -> bool:
    """Whether the native JPEG loader is built and loaded."""
    return _library('mgdfastloader') is not None


def matcher_available() -> bool:
    """Whether the native mAP matcher is built and loaded."""
    return _library('mgdmatcher') is not None


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode('utf-8')
                                            for p in paths])


def load_letterbox_batch(paths: Sequence[str], target_hw: Tuple[int, int],
                         nthreads: int = 8):
    """Decode and letterbox JPEG files natively.

    Returns (images [N, th, tw, 3] u8, metas [N, 5] f32 (scale, pad_x,
    pad_y, full_w, full_h), ok [N] bool); a failed slot is gray (128).
    Raises ``RuntimeError`` if the library is unavailable.
    """
    lib = _library('mgdfastloader')
    if lib is None:
        raise RuntimeError('native fastloader unavailable')
    th, tw = target_hw
    n = len(paths)
    # zeros (calloc), not empty: first-touch faults of fresh pages inside
    # the C call are slow (native/fastloader.cpp)
    images = np.zeros((n, th, tw, 3), np.uint8)
    metas = np.zeros((n, 5), np.float32)
    status = np.zeros((n,), np.int32)
    lib.mgd_load_letterbox_batch(
        _paths(paths), n, th, tw, images.ctypes.data_as(_u8p),
        metas.ctypes.data_as(_f32p), status.ctypes.data_as(_i32p), nthreads)
    return images, metas, status == 0


def load_letterbox_yuv_batch(paths: Sequence[str],
                             target_hw: Tuple[int, int], nthreads: int = 8):
    """Decode, letterbox and convert to planar YCbCr 4:2:0 natively.

    Returns (y [N, th, tw] u8, cb [N, th/2, tw/2] u8, cr u8, metas [N, 5]
    f32, ok [N] bool).  ``th`` and ``tw`` must be even.
    """
    lib = _library('mgdfastloader')
    if lib is None:
        raise RuntimeError('native fastloader unavailable')
    th, tw = target_hw
    if th % 2 or tw % 2:
        raise ValueError(f'canvas must be even for 4:2:0, got {th}x{tw}')
    n = len(paths)
    ys = np.zeros((n, th, tw), np.uint8)
    cbs = np.zeros((n, th // 2, tw // 2), np.uint8)
    crs = np.zeros((n, th // 2, tw // 2), np.uint8)
    metas = np.zeros((n, 5), np.float32)
    status = np.zeros((n,), np.int32)
    lib.mgd_load_letterbox_yuv_batch(
        _paths(paths), n, th, tw, ys.ctypes.data_as(_u8p),
        cbs.ctypes.data_as(_u8p), crs.ctypes.data_as(_u8p),
        metas.ctypes.data_as(_f32p), status.ctypes.data_as(_i32p), nthreads)
    return ys, cbs, crs, metas, status == 0


def match_all_thresholds(scores: np.ndarray, ious: np.ndarray,
                         thresholds: np.ndarray) -> np.ndarray:
    """Greedy confidence-ordered matching at every threshold, natively:
    ``[T, N]`` bool TP flags, the semantics of
    ``evaluation.metrics._match_all_thresholds_np``.  Raises
    ``RuntimeError`` if the library is unavailable."""
    lib = _library('mgdmatcher')
    if lib is None:
        raise RuntimeError('native matcher unavailable')
    scores32 = np.ascontiguousarray(scores, np.float32).reshape(-1)
    ious32 = np.ascontiguousarray(ious, np.float32)
    thr64 = np.ascontiguousarray(thresholds, np.float64).reshape(-1)
    n, m = ious32.shape
    if len(scores32) != n:
        raise ValueError(f'{len(scores32)} scores for {n} IoU rows')
    tp = np.empty((len(thr64), n), np.uint8)
    lib.mgd_match_all_thresholds(
        scores32.ctypes.data_as(_f32p), n, ious32.ctypes.data_as(_f32p), m,
        thr64.ctypes.data_as(_f64p), len(thr64), tp.ctypes.data_as(_u8p))
    return tp.astype(bool)
