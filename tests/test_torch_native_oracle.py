"""The JAX oracle's native library, for the port's tests that compare
against the JAX loader and matcher.

The JAX package builds ``native/libmgdfastloader.so`` in place with
``make`` at first use and tries once per process
(``multigriddet_tpu/data/native.py`` ``get_lib``): a test process that
starts while another one is still writing that file gets ``None`` and
stays on PIL (and its matcher on numpy) for the rest of its life, while
the port, which builds to a temporary name and renames it, decodes
natively.  The two sides then see different pixels.

:func:`jax_native_oracle` gives the JAX side a whole library instead: the
Makefile's library (``fastloader.cpp`` + ``matcher.cpp``, the Makefile's
flags, ``-ljpeg -lpthread``) built into ``build/native/`` (never into
``native/``) under an ``fcntl.flock`` and moved into place with
``os.replace``.  It points the JAX module at it, resets the JAX module's
cached handles, and holds both packages to the same loader path before
any comparison runs.  Test modules use it with
``from test_torch_native_oracle import jax_native_oracle  # noqa: F401``
(it is ``autouse``, module-scoped).
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys

import pytest

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO_DIR, 'native')
BUILD_DIR = os.path.join(REPO_DIR, 'build', 'native')
SOURCES = ('fastloader.cpp', 'matcher.cpp')
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ['-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall']
LD_FLAGS = ['-shared', '-ljpeg', '-lpthread']


def jax_library_path(build_dir: str = BUILD_DIR) -> str:
    """The oracle library's file: keyed by the sources, the flags and the
    host's name (``-march=native``)."""
    digest = hashlib.sha256()
    for src in SOURCES:
        with open(os.path.join(NATIVE_DIR, src), 'rb') as f:
            digest.update(f.read())
    digest.update(' '.join(CXX_FLAGS + LD_FLAGS).encode())
    digest.update(os.uname().nodename.encode())
    return os.path.join(build_dir,
                        f'libmgdfastloader-jax-{digest.hexdigest()[:16]}.so')


def build_jax_library(build_dir: str = BUILD_DIR) -> str:
    """Build the Makefile's library into ``build_dir`` unless it is there;
    returns its path.  One process builds under the directory's lock while
    the others wait, and the file appears whole (``os.replace``).  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = jax_library_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, '.jax-oracle.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [os.environ.get('CXX', 'g++'), *CXX_FLAGS,
               *(os.path.join(NATIVE_DIR, s) for s in SOURCES), '-o', tmp,
               *LD_FLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f'cannot build the JAX oracle library: '
                               f'{exc}') from exc
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f'cannot build the JAX oracle library:\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    return out


@pytest.fixture(scope='module', autouse=True)
def jax_native_oracle():
    """Point the JAX package's native loader and matcher at a whole
    library in ``build/native/``, and check that the JAX and the port's
    loaders take the same path (native, or PIL on both) before any test
    of the module compares them."""
    try:
        from multigriddet_tpu.data import native as jax_native
        from multigriddet_tpu.evaluation import metrics as jax_metrics
    except ImportError:
        # no JAX in this process (the card's host): no oracle to align
        yield None
        return
    from multigriddet_tpu_torch.data import native

    try:
        path = build_jax_library()
    except RuntimeError:
        # no compiler or no libjpeg: the JAX side stays on PIL, and never
        # runs make in native/
        path = os.path.join(BUILD_DIR, 'unbuildable-jax-oracle.so')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, '_LIB_PATH', path)
        mp.setattr(jax_native, '_build', lambda: False)
        mp.setattr(jax_native, '_lib', None)
        mp.setattr(jax_native, '_tried', False)
        mp.setattr(jax_metrics, '_native_matcher', None)
        jax_side, port_side = (jax_native.native_available(),
                               native.native_available())
        if jax_side != port_side:
            raise AssertionError(
                f'the JAX oracle and the port take different loader paths: '
                f'JAX native={jax_side} from {path}, port native='
                f'{port_side} from '
                f'{native.library_path("mgdfastloader")}')
        yield path


_CHILD = """
import ctypes, sys
sys.path.insert(0, {tests!r})
from test_torch_native_oracle import build_jax_library
lib = ctypes.CDLL(build_jax_library({out!r}))
assert lib.mgd_load_letterbox_batch and lib.mgd_load_letterbox_yuv_batch
assert lib.mgd_match_all_thresholds
print('loaded')
"""


def test_concurrent_first_builds_all_load(tmp_path):
    """Six processes started at once on an empty build directory each build
    or wait for the oracle library, and every one of them loads it (the
    JAX package's in-place ``make`` left 1 of 6 such processes without
    a library).  One library and the lock file are left, no temporary."""
    if not os.path.exists(jax_library_path()):
        pytest.fail('the oracle library did not build in this checkout')
    out = str(tmp_path / 'native')
    code = _CHILD.format(tests=os.path.dirname(os.path.abspath(__file__)),
                         out=out)
    procs = [subprocess.Popen([sys.executable, '-c', code],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0 and stdout.strip() == 'loaded', stderr
    assert sorted(os.listdir(out)) == sorted(
        ['.jax-oracle.lock', os.path.basename(jax_library_path(out))])
    assert ctypes.CDLL(jax_library_path(out)).mgd_match_all_thresholds
