"""The port's annotation parsing, letterboxing and ``HostImageLoader``
against the JAX package's, on PIL-written JPEG and PNG files.

Tolerance zero: parsed boxes, letterboxed canvases, YCbCr planes and
canvas-pixel boxes are byte-equal to the JAX loader's, through the native
JPEG path, the PIL path, the in-memory and on-disk caches, and with
unreadable files.  Both loaders build the same ``native/fastloader.cpp``
with the same flags (``native/Makefile``), the port into
``build/native/``.
"""

import os
import threading

import numpy as np
import pytest
from PIL import Image

from multigriddet_tpu.data import annotations as jax_ann
from multigriddet_tpu_torch.data import annotations, native
from test_torch_native_oracle import jax_native_oracle  # noqa: F401


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """JPEG and PNG files of several sizes, one corrupt file, one missing
    file, and annotation lines for each."""
    root = tmp_path_factory.mktemp('loader')
    rng = np.random.RandomState(0)
    jpg, png = [], []
    for i, (h, w) in enumerate([(48, 80), (70, 30), (64, 64), (33, 97)]):
        low = rng.randint(0, 256, (h // 4 + 1, w // 4 + 1, 3)).astype(
            np.uint8)
        img = Image.fromarray(low).resize((w, h), Image.BICUBIC)
        box = f'{w // 5},{h // 6},{w // 2},{h // 2},{i % 3}'
        p = root / f'{i}.jpg'
        img.save(p, quality=92)
        jpg.append(f'{p} {box} 1,2,{w - 1},{h - 2},1')
        q = root / f'{i}.png'
        img.save(q)
        png.append(f'{q} {box}')
    bad = root / 'corrupt.jpg'
    bad.write_bytes(b'not a jpeg')
    disguised = root / 'png_named.jpg'
    Image.fromarray(rng.randint(0, 256, (40, 56, 3)).astype(
        np.uint8)).save(disguised, format='PNG')
    broken = [f'{bad} 1,1,5,5,0', f'{root / "missing.jpg"} 2,2,9,9,1',
              f'{disguised} 3,3,20,30,2']
    return jpg, png, broken


def _same(a, b):
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_parse_and_load_annotation_lines(files, tmp_path):
    jpg, png, broken = files
    for line in jpg + png + broken + ['x.jpg', 'y.jpg 1,2,3 4,5,6,7,8']:
        _same(annotations.parse_annotation_line(line)[1],
              jax_ann.parse_annotation_line(line)[1])
        assert (annotations.parse_annotation_line(line)[0]
                == jax_ann.parse_annotation_line(line)[0])
    ann = tmp_path / 'ann.txt'
    ann.write_text('\n'.join(jpg + [''] + png) + '\n\n')
    for shuffle in (False, True):
        assert (annotations.load_annotation_lines(str(ann), shuffle, 3)
                == jax_ann.load_annotation_lines(str(ann), shuffle, 3))


@pytest.mark.parametrize('hw', [(64, 64), (48, 80)])
@pytest.mark.parametrize('max_boxes', [1, 3])
def test_load_and_letterbox(files, hw, max_boxes):
    jpg, png, _ = files
    for line in jpg + png:
        _same(annotations.load_and_letterbox(line, hw, max_boxes),
              jax_ann.load_and_letterbox(line, hw, max_boxes))


@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
@pytest.mark.parametrize('use_native', [True, False])
@pytest.mark.parametrize('kind', ['jpeg', 'png', 'mixed', 'broken'])
def test_host_loader_equals_jax(files, link, use_native, kind):
    jpg, png, broken = files
    lines = {'jpeg': jpg, 'png': png, 'mixed': jpg[:2] + png[2:],
             'broken': jpg[:1] + broken}[kind]
    ours = annotations.HostImageLoader(lines, (64, 64), max_boxes=3,
                                       num_workers=2, use_native=use_native,
                                       link_format=link)
    theirs = jax_ann.HostImageLoader(lines, (64, 64), max_boxes=3,
                                     num_workers=2, use_native=use_native,
                                     link_format=link)
    assert ours.use_native == theirs.use_native == use_native
    try:
        got, want = ours.load_batch(lines), theirs.load_batch(lines)
        _same(got, want)
        images = got[0]
        assert isinstance(images, tuple) == (link == 'yuv420')
        if kind == 'broken':    # corrupt and missing files: gray, no boxes
            gray = images[0] if link == 'yuv420' else images
            assert (gray[1:3] == 128).all() and (got[1][1:3] == 0).all()
            assert got[1][3, 0, 2] > 0      # the disguised PNG decodes
        _same(ours.load_batch(lines[:2], (32, 48)),
              theirs.load_batch(lines[:2], (32, 48)))
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_host_loader_caches(files, tmp_path, link):
    jpg, png, broken = files
    lines = jpg[:2] + png[:2] + broken[:1]
    want = jax_ann.HostImageLoader(lines, (64, 64), max_boxes=2,
                                   num_workers=2, link_format=link)
    expected = want.load_batch(lines)
    want.close()
    mem = annotations.HostImageLoader(lines, (64, 64), max_boxes=2,
                                      num_workers=2, cache_images=True,
                                      link_format=link)
    _same(mem.load_batch(lines), expected)
    _same(mem.load_batch(lines), expected)          # from the cache
    mem.close()
    cache_dir = tmp_path / 'npy'
    for _ in range(2):                               # miss, then hit
        disk = annotations.HostImageLoader(
            lines, (64, 64), max_boxes=2, num_workers=2,
            disk_cache_dir=str(cache_dir), link_format=link)
        _same(disk.load_batch(lines), expected)
        disk.close()
    names = os.listdir(cache_dir)
    assert not [n for n in names if '.tmp' in n]
    parts = 3 if link == 'yuv420' else 1
    assert len(names) == len(lines) * (parts + 1)


def test_native_loader_functions_equal_jax(files):
    from multigriddet_tpu.data import native as jax_native
    jpg, _, broken = files
    paths = [l.split()[0] for l in jpg + broken]
    _same(native.load_letterbox_batch(paths, (64, 96), 2),
          jax_native.load_letterbox_batch(paths, (64, 96), 2))
    _same(native.load_letterbox_yuv_batch(paths, (64, 96), 2),
          jax_native.load_letterbox_yuv_batch(paths, (64, 96), 2))
    with pytest.raises(ValueError):
        native.load_letterbox_yuv_batch(paths, (63, 96))


def test_native_build_into_build_dir_is_atomic(tmp_path):
    """Two threads build the matcher into an empty directory at once: one
    whole library results, no temporary file is left, and it loads; a
    second call reuses it.  The port's libraries live in build/native/,
    never in native/."""
    out = str(tmp_path / 'native')
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_library('mgdmatcher', out))
        except RuntimeError as exc:      # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not errors and len(paths) == 2 and paths[0] == paths[1]
    assert os.listdir(out) == [os.path.basename(paths[0])]
    import ctypes
    assert ctypes.CDLL(paths[0]).mgd_match_all_thresholds
    mtime = os.stat(paths[0]).st_mtime_ns
    assert native.build_library('mgdmatcher', out) == paths[0]
    assert os.stat(paths[0]).st_mtime_ns == mtime
    assert native.library_path('mgdmatcher').startswith(
        os.path.join(native.REPO_DIR, 'build', 'native'))
    assert native.matcher_available() and native.native_available()
