#!/usr/bin/env python3
"""Write the JPEG fixtures of ``tests/fixtures/jpeg/`` and record the JAX
package's native loader (``native/fastloader.cpp``, libjpeg) on them.

    JAX_PLATFORMS=cpu python tests/record_jpeg_fixtures.py

Runs on a host with Pillow, libjpeg's headers and the JAX package (the CPU
host), never on the card.  Every image is made from a fixed seed, so a run
rewrites the same files.  The fixtures:

* ``photo_*.jpg``: 640x480 photo-like pictures (smooth shading, hard-edged
  shapes, texture, blur) as 4:2:0 at quality 90 and 75, 4:2:2, 4:4:4,
  grayscale, progressive, and 4:2:0 with restart markers every 4 MCUs;
* ``odd_333x251.jpg`` (4:2:0) and ``odd_97x61.jpg`` (4:2:2): sizes whose
  MCUs overhang the image;
* ``tie_73x128.jpg``: a flat 73x128 image whose content width at 64x64 is
  an exact .5 tie (36.5 -> 36 half to even, as
  ``tests/test_native_loader.py`` checks);
* ``corrupt.jpg`` (a JPEG start marker and seeded junk) and
  ``png_named.jpg`` (PNG content): files the decoders reject.

``letterbox_ref.npz`` (uncompressed) holds, for each fixture and for
``examples/images/dog.jpg`` (read where it lies), at each canvas of
``CANVASES``: fastloader's metas and ok flag, and its pixels at the
positions :func:`positions` gives for that slot: ``SAMPLES`` seeded ones
inside the content, then every pixel of the content's first and last rows
and columns (where odd sizes and MCU overhang show), RGB and Y in ``rgb``
and ``y``, and the same for the chroma planes in chroma coordinates
(``cbcr``).  Each slot's values are the run ``at[file, canvas, 0]`` of
``n[file, canvas, 0]`` entries of ``rgb`` and ``y`` (index 1: ``cbcr``).
Full canvases of a dozen files at 608 would be tens of megabytes; the
positions are derived, not stored, to keep the file under 1 MB.
Readers import :func:`positions` from here (Pillow is imported only to
write the fixtures).
"""

from __future__ import annotations

import io
import os
import sys
import zlib

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
OUT = os.path.join(TESTS, 'fixtures', 'jpeg')
DOG = os.path.join(REPO, 'examples', 'images', 'dog.jpg')
CANVASES = ((608, 608), (416, 416), (128, 128), (64, 64))
SAMPLES = 1024


def photo(seed: int, size=(640, 480)):
    """A photo-like RGB picture: shaded background, shapes, texture."""
    from PIL import Image, ImageDraw, ImageFilter

    rng = np.random.RandomState(seed)
    w, h = size
    low = rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)
    img = Image.fromarray(low).resize((w, h), Image.BICUBIC)
    draw = ImageDraw.Draw(img)
    for _ in range(14):
        x0, y0 = rng.randint(0, w), rng.randint(0, h)
        x1, y1 = x0 + rng.randint(20, 200), y0 + rng.randint(20, 160)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        if rng.rand() < 0.5:
            draw.ellipse((x0, y0, x1, y1), fill=color)
        else:
            draw.rectangle((x0, y0, x1, y1), fill=color)
    for _ in range(10):
        pts = [(int(rng.randint(0, w)), int(rng.randint(0, h)))
               for _ in range(2)]
        draw.line(pts, fill=tuple(int(v) for v in rng.randint(0, 256, 3)),
                  width=int(rng.randint(1, 4)))
    img = img.filter(ImageFilter.GaussianBlur(0.8))
    arr = np.asarray(img).astype(np.int16)
    arr += rng.randint(-6, 7, arr.shape).astype(np.int16)     # texture
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def write_fixtures() -> list:
    from PIL import Image

    os.makedirs(OUT, exist_ok=True)
    files = []

    def save(name, img, **kw):
        path = os.path.join(OUT, name)
        img.save(path, format='JPEG', **kw)
        files.append(path)

    save('photo_420_q90.jpg', photo(1), quality=90, subsampling=2)
    save('photo_420_q75.jpg', photo(2), quality=75, subsampling=2)
    save('photo_422.jpg', photo(3), quality=90, subsampling=1)
    save('photo_444.jpg', photo(4), quality=90, subsampling=0)
    save('photo_gray.jpg', photo(5).convert('L'), quality=90)
    save('photo_progressive.jpg', photo(6), quality=90, subsampling=2,
         progressive=True)
    save('photo_restart.jpg', photo(7), quality=90, subsampling=2,
         restart_marker_blocks=4)
    save('odd_333x251.jpg', photo(8, (333, 251)), quality=90, subsampling=2)
    save('odd_97x61.jpg', photo(9, (97, 61)), quality=90, subsampling=1)
    save('tie_73x128.jpg', Image.new('RGB', (73, 128), (200, 200, 200)),
         quality=95)
    rng = np.random.RandomState(10)
    path = os.path.join(OUT, 'corrupt.jpg')
    with open(path, 'wb') as f:
        f.write(b'\xff\xd8' + rng.randint(0, 256, 2000).astype(
            np.uint8).tobytes())
    files.append(path)
    buf = io.BytesIO()
    photo(11, (64, 48)).save(buf, format='PNG')
    path = os.path.join(OUT, 'png_named.jpg')
    with open(path, 'wb') as f:
        f.write(buf.getvalue())
    files.append(path)
    return files


def content_box(meta, hw):
    """(px, py, nw, nh) of a slot's content from fastloader's metas."""
    scale, px, py, fw, fh = (float(v) for v in meta)
    dscale = min(hw[1] / fw, hw[0] / fh)
    return (int(px), int(py), int(round(fw * dscale)),
            int(round(fh * dscale)))


def _border(y0: int, x0: int, h: int, w: int):
    """Rows and columns of every pixel on the edge of a box, row-major."""
    yy, xx = np.mgrid[y0:y0 + h, x0:x0 + w]
    edge = ((yy == y0) | (yy == y0 + h - 1) | (xx == x0)
            | (xx == x0 + w - 1))
    return yy[edge], xx[edge]


def positions(name: str, hw, meta):
    """The recorded positions of the slot of fixture ``name`` (its path
    relative to the repo) at canvas ``hw`` with fastloader's ``meta``:
    ``(yy, xx)`` on the canvas and ``(cy, cx)`` on the chroma planes, each
    ``SAMPLES`` (a quarter of them for chroma) seeded positions inside the
    content followed by the content's border."""
    px, py, nw, nh = content_box(meta, hw)
    rng = np.random.RandomState(zlib.crc32(
        f'{name}@{hw[0]}x{hw[1]}'.encode()))
    yy = rng.randint(py, py + nh, SAMPLES)
    xx = rng.randint(px, px + nw, SAMPLES)
    cy0, cy1 = py // 2, (py + nh - 1) // 2 + 1
    cx0, cx1 = px // 2, (px + nw - 1) // 2 + 1
    cy = rng.randint(cy0, cy1, SAMPLES // 4)
    cx = rng.randint(cx0, cx1, SAMPLES // 4)
    ey, ex = _border(py, px, nh, nw)
    ecy, ecx = _border(cy0, cx0, cy1 - cy0, cx1 - cx0)
    return ((np.concatenate([yy, ey]), np.concatenate([xx, ex])),
            (np.concatenate([cy, ecy]), np.concatenate([cx, ecx])))


def record(files) -> dict:
    sys.path[:0] = [TESTS, REPO]
    from test_torch_native_oracle import build_jax_library
    from multigriddet_tpu.data import native as jax_native
    jax_native._LIB_PATH = build_jax_library()
    jax_native._build = lambda: False
    jax_native._lib, jax_native._tried = None, False
    if not jax_native.native_available():
        raise SystemExit('the JAX native loader did not build')
    paths = files + [DOG]
    names = [os.path.relpath(p, REPO) for p in paths]
    nf, nc = len(paths), len(CANVASES)
    ref = {'files': np.asarray(names),
           'canvases': np.asarray(CANVASES, np.int32),
           'metas': np.zeros((nf, nc, 5), np.float32),
           'ok': np.zeros((nf, nc), bool),
           'at': np.zeros((nf, nc, 2), np.int32),
           'n': np.zeros((nf, nc, 2), np.int32)}
    rgb, y, cbcr = [], [], []
    for fi, name in enumerate(names):
        for ci, hw in enumerate(CANVASES):
            imgs, metas, ok = jax_native.load_letterbox_batch(
                [paths[fi]], hw)
            ys, cbs, crs, metas2, ok2 = jax_native.load_letterbox_yuv_batch(
                [paths[fi]], hw)
            assert np.array_equal(metas, metas2) and np.array_equal(ok, ok2)
            ref['metas'][fi, ci], ref['ok'][fi, ci] = metas[0], ok[0]
            ref['at'][fi, ci] = sum(map(len, rgb)), sum(map(len, cbcr))
            if not ok[0]:
                continue
            (yy, xx), (cy, cx) = positions(name, hw, metas[0])
            ref['n'][fi, ci] = len(yy), len(cy)
            rgb.append(imgs[0, yy, xx])
            y.append(ys[0, yy, xx])
            cbcr.append(np.stack([cbs[0, cy, cx], crs[0, cy, cx]], -1))
    ref['rgb'] = np.concatenate(rgb)
    ref['y'] = np.concatenate(y)
    ref['cbcr'] = np.concatenate(cbcr)
    np.savez(os.path.join(OUT, 'letterbox_ref.npz'), **ref)
    return ref


def main():
    files = write_fixtures()
    ref = record(files)
    total = sum(os.path.getsize(os.path.join(OUT, f))
                for f in os.listdir(OUT))
    for name, ok in zip(ref['files'], ref['ok']):
        print(f'{name}: ok at {[int(v) for v in ok]}')
    print(f'{len(os.listdir(OUT))} files, {total} bytes in {OUT}')


if __name__ == '__main__':
    main()
