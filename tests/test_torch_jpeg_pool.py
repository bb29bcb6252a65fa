"""The card's JPEG decoder pool (``data/jpeg_cuda.py`` ``decode_files`` on
the calling thread and a pool's, fastloader's ``nthreads`` in
``native/fastloader.cpp``), the kernels' build under concurrent first use
(``ops/kernel_build.py``) and the batched ``ycc_to_rgb``
(``ops/cuda_jpeg.py``).

On the CPU:

* with the per-file decode stubbed (Pillow's YCbCr planes after a sleep
  drawn from a seed, so that the workers finish out of order),
  ``decode_files`` returns the same slots and sizes, and prints the same
  lines in file order, on pools of 1, 3 and 8 threads (never more decodes
  at once than the pool has threads), over readable, unreadable, corrupt,
  PNG-named and truncated files; the letterboxed batch's metas and ok
  flags equal the JAX package's fastloader's;
* a worker's error is raised in the caller;
* ``num_workers`` reaches the card's route of ``detect_files`` as a pool
  of that many threads, kept for the call;
* threads that load a kernel library at once build it once;
* the batched plain version (views of one packed buffer) equals
  ``ycc_to_rgb_plain`` image by image, for every chroma layout and gray,
  the divisors 1, 2, 4 and 8 and odd sizes.

On the card (``python -m pytest --noconftest -m cuda
tests/test_torch_jpeg_pool.py``): the pool at 8 threads equals the pool
at 1 bit for bit on every fixture, for both links, at ``CANVASES`` and
256; the batched ``ycc_to_rgb`` kernel equals its plain version on a mixed
batch in one launch; both letterbox kernels equal their plain versions
on nvJPEG's pixels; a worker's fatal error raises in the caller; a fresh
process with no built kernels decodes its first batch on 8 threads.
"""

import io
import textwrap
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from multigriddet_tpu_torch.data import jpeg_cuda
from multigriddet_tpu_torch.ops import cuda_jpeg
from test_torch_jpeg import (CANVASES, GOOD, LAYOUTS, REJECTED, TRUNCATED,
                             fixture_path)
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

THREADS = (1, 3, 8)
MISSING = 'no_such_file.jpg'
# readable, unreadable, rejected (corrupt, a PNG) and truncated files
POOL_FILES = ('photo_420_q90.jpg', MISSING, 'corrupt.jpg', 'photo_gray.jpg',
              'png_named.jpg', TRUNCATED, 'odd_97x61.jpg', 'tie_73x128.jpg',
              'photo_422.jpg', 'odd_333x251.jpg')


def pool_paths(tmp_path):
    return [str(tmp_path / MISSING) if n == MISSING else fixture_path(n)
            for n in POOL_FILES]


class _SleepyDecoder:
    """Stands in for nvJPEG in a worker: Pillow's YCbCr planes at factors
    (1, 1) (a gray file's one plane), after a sleep drawn from the file's
    bytes; not a JPEG, or unreadable by Pillow: rejected.  Counts the
    decoders taken and the most decodes running at once."""

    lock = threading.Lock()

    def __init__(self, stats, fail=None):
        self.stats, self.fail = stats, fail

    def __enter__(self):
        with self.lock:
            self.stats['decoders'] += 1
        return self

    def __exit__(self, *exc):
        return False

    def planes(self, data, stream=None):
        from PIL import Image
        with self.lock:
            self.stats['running'] += 1
            self.stats['most'] = max(self.stats['most'],
                                     self.stats['running'])
        try:
            time.sleep(np.random.RandomState(zlib.crc32(data)).uniform(
                0.002, 0.03))
            if data == self.fail:
                raise RuntimeError('nvJPEG failed: EXECUTION_FAILED')
            try:
                with Image.open(io.BytesIO(data)) as im:
                    if im.format != 'JPEG':
                        return None, None, None, 'BAD_JPEG'
                    size = im.size
                    if im.mode == 'L':
                        return ((torch.from_numpy(np.array(im)),), None,
                                size, None)
                    im.draft('YCbCr', size)
                    ycc = np.array(im)
            except (OSError, ValueError):
                return None, None, None, 'BAD_JPEG'
            return (tuple(torch.from_numpy(ycc[..., c].copy())
                          for c in range(3)), (1, 1), size, None)
        finally:
            with self.lock:
                self.stats['running'] -= 1


def sleepy(monkeypatch, fail=None):
    stats = {'decoders': 0, 'running': 0, 'most': 0}
    monkeypatch.setattr(cuda_jpeg, 'decoder',
                        lambda device: _SleepyDecoder(stats, fail))
    return stats


def expected_lines(paths):
    """The printed line of each file that prints one, in file order."""
    kinds = {MISSING: 'cannot read', 'corrupt.jpg': 'nvJPEG rejected',
             'png_named.jpg': 'nvJPEG rejected', TRUNCATED: 'truncated'}
    return [(p, kinds[n]) for n, p in zip(POOL_FILES, paths) if n in kinds]


@pytest.mark.parametrize('hw', [None, (128, 128)], ids=['full', '128'])
def test_pool_returns_slots_and_lines_in_file_order(monkeypatch, capsys,
                                                    tmp_path, hw):
    paths = pool_paths(tmp_path)
    want_lines = expected_lines(paths)
    runs = {}
    for nthreads in THREADS:
        stats = sleepy(monkeypatch)
        with ThreadPoolExecutor(nthreads) as pool:
            images, sizes = jpeg_cuda.decode_files(paths, 'cpu', hw, pool)
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == len(want_lines)
        for line, (path, kind) in zip(lines, want_lines):
            assert line.startswith('WARNING') and path in line \
                and kind in line, (nthreads, line)
        assert 1 <= stats['decoders'] <= nthreads
        assert stats['most'] <= nthreads
        if nthreads > 1:
            assert stats['most'] > 1      # the workers overlapped
        runs[nthreads] = images, sizes, lines
    images, sizes, lines = runs[1]
    decoded = [n not in (MISSING, 'corrupt.jpg', 'png_named.jpg')
               for n in POOL_FILES]
    assert [im is not None for im in images] == decoded
    assert [s is not None for s in sizes] == decoded
    assert sizes[POOL_FILES.index('odd_97x61.jpg')] == (97, 61)
    assert images[POOL_FILES.index('photo_gray.jpg')].shape[-1] == 1
    for nthreads in THREADS[1:]:
        got_images, got_sizes, got_lines = runs[nthreads]
        assert got_sizes == sizes and got_lines == lines
        for a, b in zip(got_images, images):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_pool_metas_and_ok_equal_fastloader(monkeypatch, tmp_path, link):
    """The letterboxed batch through the pool (8 threads, a pool kept by
    the caller) against fastloader on the same paths: metas and ok equal,
    and equal to the serial decode's canvases."""
    from multigriddet_tpu.data import native as jax_native
    paths = pool_paths(tmp_path)
    hw = (128, 128)
    load = (jpeg_cuda.load_letterbox_yuv_batch_cuda if link == 'yuv420'
            else jpeg_cuda.load_letterbox_batch_cuda)
    sleepy(monkeypatch)
    with ThreadPoolExecutor(8) as pool:
        got = load(paths, hw, 'cpu', pool=pool)
        again = load(paths, hw, 'cpu', pool=pool)
    serial = load(paths, hw, 'cpu')
    want_metas, want_ok = jax_native.load_letterbox_batch(paths, hw)[1:]
    for run in (got, again):
        np.testing.assert_array_equal(run[-2], want_metas)
        np.testing.assert_array_equal(run[-1], want_ok)
        for a, b in zip(run[:-2], serial[:-2]):
            assert torch.equal(a, b)


def test_worker_error_raises_in_the_caller(monkeypatch, tmp_path):
    paths = pool_paths(tmp_path)
    with open(fixture_path('odd_97x61.jpg'), 'rb') as f:
        fail = f.read()
    for nthreads in THREADS:
        sleepy(monkeypatch, fail)
        with ThreadPoolExecutor(nthreads) as pool, \
                pytest.raises(RuntimeError, match='EXECUTION_FAILED'):
            jpeg_cuda.decode_files(paths, 'cpu', (64, 64), pool)


def test_detect_files_sends_num_workers_to_the_card_route(monkeypatch):
    """``detect_files`` on the card hands the card's loader a pool of
    ``num_workers`` threads, the same one for every batch of a call, shut
    down when the call returns.  Here the engine is told it is on the card
    and the card's loader is fastloader on the CPU: the detections equal
    the CPU route's."""
    from multigriddet_tpu_torch.data import native
    from multigriddet_tpu_torch.inference import MultiGridInference
    model = {'type': 'preset', 'preset': {
        'architecture': 'multigriddet_tiny', 'num_classes': 2,
        'input_shape': [64, 64, 3]}}
    engine = MultiGridInference(
        {'model': model, 'environment': {'mixed_precision': False},
         'input': {'input_shape': [64, 64, 3]},
         'detection': {'confidence_threshold': 0.0, 'max_boxes': 5,
                       'nms_backend': 'pallas_fused'}}, device='cpu')
    paths = [fixture_path(n) for n in ('photo_420_q90.jpg', 'odd_97x61.jpg',
                                       'tie_73x128.jpg')]
    want = engine.detect_files(paths, batch_size=2, num_workers=5)
    pools = []

    def card_loader(batch, hw, device, pool):
        assert not pool._shutdown
        pools.append(pool)
        images, metas, ok = native.load_letterbox_batch(batch, hw)
        return torch.from_numpy(images), metas, ok

    monkeypatch.setattr(jpeg_cuda, 'load_letterbox_batch_cuda', card_loader)
    engine.on_card = True
    got = engine.detect_files(paths, batch_size=2, num_workers=5)
    again = engine.detect_files(paths, batch_size=2, num_workers=3)
    assert all(isinstance(p, ThreadPoolExecutor) for p in pools)
    assert [p._max_workers for p in pools] == [5, 5, 3, 3]
    assert pools[0] is pools[1] and pools[2] is pools[3]
    assert pools[0] is not pools[2]
    assert all(p._shutdown for p in pools)
    for run in (got, again):
        for gr, wr in zip(run, want):
            for g, w in zip(gr, wr):
                np.testing.assert_array_equal(g, w)


def test_concurrent_first_loads_build_once(monkeypatch):
    """Threads that ask for a kernel library at once (a loader's decoder
    threads at their first batch) wait for one build, and each gets the
    library with its signatures bound."""
    from multigriddet_tpu_torch.ops import kernel_build
    builds, binds = [], []
    barrier = threading.Barrier(8)

    def slow_build(source):
        builds.append(source)
        time.sleep(0.05)
        return {'path': f'lib{source}.so', 'seconds': 0.05, 'log': ''}

    class FakeLibrary:
        def __init__(self, path):
            self.path = path

    def bind(lib):
        binds.append(lib)
        time.sleep(0.01)
        lib.bound = True

    def first_use():
        barrier.wait()
        lib = kernel_build.load('jpeg.cu', bind)
        return lib, getattr(lib, 'bound', False)

    monkeypatch.setattr(kernel_build, '_LOADED', {})
    monkeypatch.setattr(kernel_build, 'build', slow_build)
    monkeypatch.setattr(kernel_build.ctypes, 'CDLL', FakeLibrary)
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda _: first_use(), range(8)))
    assert builds == ['jpeg.cu'] and len(binds) == 1
    assert all(lib is binds[0] and bound for lib, bound in got)
    assert kernel_build.load('jpeg.cu', bind) is binds[0]
    assert builds == ['jpeg.cu'] and len(binds) == 1


def random_slot(rng, layout, h, w, d):
    y = torch.from_numpy(rng.randint(0, 256, (h, w)).astype(np.uint8))
    if layout == 'gray':
        return (y,), None, d
    hs, vs = cuda_jpeg.FACTORS[layout]
    chroma = tuple(torch.from_numpy(rng.randint(
        0, 256, (-(-h // vs), -(-w // hs))).astype(np.uint8))
        for _ in range(2))
    return (y, *chroma), (hs, vs), d


@pytest.mark.parametrize('d', [1, 2, 4, 8])
@pytest.mark.parametrize('size', [(9, 13), (480, 640), (61, 97), (7, 5)],
                         ids=lambda s: f'{s[0]}x{s[1]}')
def test_batched_plain_equals_per_image(size, d):
    rng = np.random.RandomState(size[0] * d)
    layouts = sorted(LAYOUTS) + ['444', 'gray']
    slots = [random_slot(rng, layout, *size, d) for layout in layouts]
    slots.append(random_slot(rng, '420', size[1], size[0], d))
    outs = cuda_jpeg.ycc_to_rgb_batch(slots)
    storage = outs[0].untyped_storage().data_ptr()
    for (planes, factors, dd), out in zip(slots, outs):
        assert out.untyped_storage().data_ptr() == storage
        assert out.data_ptr() % 16 == 0 and out.is_contiguous()
        if factors is None:
            want = cuda_jpeg.block_mean_plain(planes[0], dd, dd)[..., None]
        else:
            want = cuda_jpeg.ycc_to_rgb_plain(*planes, factors, dd)
        assert out.shape == (-(-planes[0].shape[0] // d),
                             -(-planes[0].shape[1] // d), want.shape[-1])
        assert torch.equal(out, want)
    single = cuda_jpeg.ycc_to_rgb(*slots[0][0], slots[0][1], d)
    assert torch.equal(single, outs[0])
    with pytest.raises(ValueError, match='gray slot'):
        cuda_jpeg.ycc_to_rgb_batch([(slots[0][0], None, d)])
    assert cuda_jpeg.ycc_to_rgb_batch([]) == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda')


ALL_FILES = GOOD + REJECTED + (TRUNCATED, 'dog.jpg')


@pytest.mark.cuda
@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
@pytest.mark.parametrize('hw', CANVASES + ((256, 256),),
                         ids=lambda hw: str(hw[0]))
def test_pool_equals_serial_on_the_card(cuda_device, capsys, hw, link):
    paths = [fixture_path(n) for n in ALL_FILES]
    load = (jpeg_cuda.load_letterbox_yuv_batch_cuda if link == 'yuv420'
            else jpeg_cuda.load_letterbox_batch_cuda)
    runs = []
    with ThreadPoolExecutor(1) as one, ThreadPoolExecutor(8) as eight:
        for pool in (one, eight, eight, one):
            runs.append((load(paths, hw, cuda_device, pool=pool),
                         capsys.readouterr().out))
    (want, lines) = runs[0]
    assert lines.count('WARNING') == len(REJECTED) + 1
    for got, got_lines in runs[1:]:
        assert got_lines == lines
        for a, b in zip(got[:-2], want[:-2]):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(got[-2], want[-2])
        np.testing.assert_array_equal(got[-1], want[-1])


@pytest.mark.cuda
def test_batched_ycc_kernel_on_a_mixed_batch(cuda_device):
    """4:2:0, 4:2:2, 4:4:0, 4:4:4, gray, a Pillow-route slot (libjpeg's
    upsampled planes, factors (1, 1)) and odd sizes at every divisor, in
    one launch each, against the plain version."""
    rng = np.random.RandomState(3)
    with open(fixture_path('photo_420_q90.jpg'), 'rb') as f:
        pillow, factors, _ = jpeg_cuda.libjpeg_planes(f.read())
    for d in (1, 2, 4, 8):
        slots = [random_slot(rng, layout, h, w, d) for layout, (h, w) in (
            ('420', (480, 640)), ('422', (61, 97)), ('440', (9, 13)),
            ('444', (7, 5)), ('gray', (333, 251)), ('420', (1, 1)),
            ('422', (2, 3)), ('440', (17, 600)))]
        slots.append((tuple(torch.from_numpy(p) for p in pillow), factors,
                      d))
        before = cuda_jpeg.ycc_to_rgb_batch.launches
        got = cuda_jpeg.ycc_to_rgb_batch(
            [(tuple(p.to(cuda_device) for p in planes), f, dd)
             for planes, f, dd in slots])
        torch.cuda.synchronize()
        assert cuda_jpeg.ycc_to_rgb_batch.launches == before + 1
        for g, w in zip(got, cuda_jpeg.ycc_to_rgb_batch_plain(slots)):
            assert torch.equal(g.cpu(), w), d


@pytest.mark.cuda
@pytest.mark.parametrize('hw', CANVASES + ((256, 256),),
                         ids=lambda hw: str(hw[0]))
def test_staged_letterbox_equals_plain(cuda_device, hw):
    """Both letterbox kernels on nvJPEG's pixels as the loader gives them
    (reduced by the divisor, gray included), against their plain
    versions."""
    paths = [fixture_path(n) for n in ALL_FILES]
    with ThreadPoolExecutor(4) as pool:
        images, sizes = jpeg_cuda.decode_files(paths, cuda_device, hw, pool)
    host = [None if im is None else im.cpu() for im in images]
    canvas, metas, ok = cuda_jpeg.letterbox_rgb(images, hw, cuda_device,
                                                sizes)
    y, cb, cr, metas2, ok2 = cuda_jpeg.letterbox_yuv420(
        images, hw, cuda_device, sizes)
    want, want_metas, want_ok = cuda_jpeg.letterbox_rgb(host, hw, 'cpu',
                                                        sizes)
    wy, wcb, wcr, _, _ = cuda_jpeg.letterbox_yuv420(host, hw, 'cpu', sizes)
    assert np.array_equal(metas, want_metas) and np.array_equal(
        metas2, want_metas)
    assert np.array_equal(ok, want_ok) and np.array_equal(ok2, want_ok)
    assert torch.equal(canvas.cpu(), want)
    for g, w in zip((y, cb, cr), (wy, wcb, wcr)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_worker_fatal_error_raises_on_the_card(cuda_device, monkeypatch):
    paths = [fixture_path(n) for n in GOOD]
    with open(paths[3], 'rb') as f:
        fail = f.read()
    planes = cuda_jpeg.Decoder.planes

    def failing(self, data, stream=None):
        if data == fail:
            self._rejected(6)          # EXECUTION_FAILED: raises
        return planes(self, data, stream)

    monkeypatch.setattr(cuda_jpeg.Decoder, 'planes', failing)
    for nthreads in (1, 4):
        with ThreadPoolExecutor(nthreads) as pool, \
                pytest.raises(RuntimeError, match='EXECUTION_FAILED'):
            jpeg_cuda.decode_files(paths, cuda_device, (416, 416), pool)


@pytest.mark.cuda
def test_first_batch_on_eight_threads_builds_the_kernels_once(cuda_device,
                                                              tmp_path):
    """A fresh process with no built kernels (an empty build directory)
    decodes its first batch on 8 threads: one build, and the canvases
    equal those of the kernels built before."""
    import os
    import subprocess
    import sys
    paths = [fixture_path(n) for n in ALL_FILES]
    code = textwrap.dedent(f'''
        import os
        from concurrent.futures import ThreadPoolExecutor
        import torch
        from multigriddet_tpu_torch.data import jpeg_cuda
        from multigriddet_tpu_torch.ops import kernel_build
        build = {str(tmp_path)!r}
        kernel_build.BUILD_DIR = build
        with ThreadPoolExecutor(8) as pool:
            y, cb, cr, metas, ok = jpeg_cuda.load_letterbox_yuv_batch_cuda(
                {paths!r}, (416, 416), 'cuda', pool)
        torch.save([t.cpu() for t in (y, cb, cr)],
                   os.path.join(build, 'out.pt'))
        print('built', sorted(n for n in os.listdir(build)
                              if n.endswith('.so')))
    ''')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=900, cwd=repo)
    assert out.returncode == 0, out.stderr[-4000:]
    built = [ln for ln in out.stdout.splitlines() if ln.startswith('built')]
    assert built and 'libjpeg-' in built[-1], out.stdout
    assert not [n for n in os.listdir(tmp_path) if n.endswith('.tmp')]
    got = torch.load(str(tmp_path / 'out.pt'))
    want = jpeg_cuda.load_letterbox_yuv_batch_cuda(paths, (416, 416),
                                                   cuda_device)
    for g, w in zip(got, want[:3]):
        assert torch.equal(g, w.cpu())
