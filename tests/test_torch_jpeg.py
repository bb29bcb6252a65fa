"""The port's JPEG letterbox (``ops/cuda_jpeg.py``, ``data/jpeg_cuda.py``)
against the JAX package's native loader (``native/fastloader.cpp``).

The fixtures are ``tests/fixtures/jpeg/`` (written by
``tests/record_jpeg_fixtures.py``) and ``examples/images/dog.jpg``, at the
canvases 608, 416, 128 and 64 (divisors 1, 1, 2 and 4 for a 640x480
file).  On the CPU the wrappers run their plain versions:

* on libjpeg's own scaled pixels (PIL ``draft``, the decode fastloader
  does), the plain RGB and 4:2:0 letterboxes equal fastloader's canvases
  to 1 level, on at most 0.1% of values (fastloader is built with
  ``-march=native`` and may contract into FMA); metas and geometry are
  exact, the 73x128 rounding tie included;
* on full-size pixels reduced by the d x d mean (what the card does, since
  nvJPEG decodes at full size), the mean |dRGB| over the content stays
  under 6.0, the JAX package's own bound between its two decode paths
  (``tests/test_native_loader.py``);
* the 4:2:0 conversion of a canvas is within 1 level of the JAX package's
  ``rgb_to_yuv420_np`` on at most 0.1% of values;
* the chroma upsampling equals libjpeg-turbo's loops (``jdsample.c``,
  transcribed here), the YCbCr -> RGB tables turn libjpeg's own YCbCr
  output into its RGB output exactly, and at a divisor each plane is
  reduced and upsampled as libjpeg's scaled decode does, block means
  standing in for its reduced IDCT (a 4:4:4 file, whose planes libjpeg
  gives, then lies within the bound of fastloader);
* ``HostImageLoader(device='cpu')`` gives the JAX loader's batches; on
  the card it sends every path, JPEG or not, to the card's decoder;
* ``letterbox_ref.npz`` (the card's reference) is fastloader's output at
  the recorded positions, the content's border included;
* the evaluator's file batches and ``detect_files`` run without Pillow,
  reading sizes from the loader's metas;
* the new modules import neither JAX nor the JAX package and build
  nothing at import.

The card's test (``python -m pytest --noconftest -m cuda
tests/test_torch_jpeg.py``) decodes the fixtures with nvJPEG, holds
the three kernels bit-equal to their plain versions, and runs a batch of
JPEGs and a PNG through the loader and ``detect_files``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from multigriddet_tpu_torch.data import HostImageLoader
from multigriddet_tpu_torch.ops import cuda_jpeg
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, 'tests', 'fixtures', 'jpeg')
GOOD = ('photo_420_q90.jpg', 'photo_420_q75.jpg', 'photo_422.jpg',
        'photo_444.jpg', 'photo_gray.jpg', 'photo_progressive.jpg',
        'photo_restart.jpg', 'odd_333x251.jpg', 'odd_97x61.jpg',
        'tie_73x128.jpg')
REJECTED = ('corrupt.jpg', 'png_named.jpg')
CANVASES = ((608, 608), (416, 416), (128, 128), (64, 64))
MEAN_BOUND = 6.0          # tests/test_native_loader.py's mean |dRGB|
STRAY_SHARE = 1e-3        # values one level off (FMA in fastloader)


def fixture_path(name):
    if name == 'dog.jpg':
        return os.path.join(REPO, 'examples', 'images', 'dog.jpg')
    return os.path.join(FIXTURES, name)


def jax_canvases(path, hw):
    from multigriddet_tpu.data import native as jax_native
    assert jax_native.native_available()
    img, metas, ok = jax_native.load_letterbox_batch([path], hw)
    ys, cbs, crs, metas2, ok2 = jax_native.load_letterbox_yuv_batch([path],
                                                                     hw)
    assert np.array_equal(metas, metas2) and np.array_equal(ok, ok2)
    return img[0], (ys[0], cbs[0], crs[0]), metas[0], bool(ok[0])


def pil_pixels(path, hw=None):
    """RGB pixels through Pillow; with ``hw``, libjpeg's DCT-scaled decode
    for that canvas (``draft``), as fastloader decodes."""
    from PIL import Image
    with Image.open(path) as im:
        if hw is not None:
            im.draft('RGB', (hw[1], hw[0]))
        return torch.from_numpy(np.array(im.convert('RGB')))


def assert_within_one(got, want, label):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, (label, diff.max())
    assert (diff > 0).mean() <= STRAY_SHARE, (label, (diff > 0).mean())


@pytest.mark.parametrize('hw', CANVASES, ids=lambda hw: str(hw[0]))
@pytest.mark.parametrize('name', GOOD + ('dog.jpg',))
def test_plain_on_libjpeg_pixels_equals_fastloader(name, hw):
    path = fixture_path(name)
    want_rgb, want_yuv, want_meta, ok = jax_canvases(path, hw)
    assert ok
    full = pil_pixels(path)
    fh, fw = full.shape[:2]
    assert np.array_equal(cuda_jpeg.metas_of(fw, fh, hw), want_meta)
    scaled = pil_pixels(path, hw)
    d = cuda_jpeg.divisor(fw, fh, hw)
    assert tuple(scaled.shape[:2]) == (-(-fh // d), -(-fw // d))
    rgb = cuda_jpeg.letterbox_rgb_plain(scaled, hw, 1, full_size=(fw, fh))
    assert_within_one(rgb.numpy(), want_rgb, 'rgb')
    _, nw, nh, px, py = cuda_jpeg.geometry(fw, fh, hw)
    inside = np.zeros(hw, bool)
    inside[py:py + nh, px:px + nw] = True
    assert (rgb.numpy()[~inside] == 128).all()
    assert (want_rgb[~inside] == 128).all()
    for got, want, plane in zip(
            cuda_jpeg.letterbox_yuv420_plain(scaled, hw, 1, (fw, fh)),
            want_yuv, ('y', 'cb', 'cr')):
        assert_within_one(got.numpy(), want, plane)


@pytest.mark.parametrize('hw', CANVASES, ids=lambda hw: str(hw[0]))
@pytest.mark.parametrize('name', GOOD + ('dog.jpg',))
def test_full_decode_with_block_mean_within_bound(name, hw):
    """What the card computes: full-size pixels, the d x d mean, then the
    letterbox, through the batched wrapper (its plain path)."""
    path = fixture_path(name)
    want_rgb, _, want_meta, _ = jax_canvases(path, hw)
    full = pil_pixels(path)
    canvas, metas, ok = cuda_jpeg.letterbox_rgb([full], hw, 'cpu')
    assert ok.tolist() == [True]
    assert np.array_equal(metas[0], want_meta)
    fh, fw = full.shape[:2]
    _, nw, nh, px, py = cuda_jpeg.geometry(fw, fh, hw)
    diff = np.abs(canvas[0].numpy().astype(np.int32)
                  - want_rgb.astype(np.int32))
    assert diff.mean() < MEAN_BOUND
    assert diff[py:py + nh, px:px + nw].mean() < MEAN_BOUND
    if cuda_jpeg.divisor(fw, fh, hw) == 1:     # same pixels: the resize alone
        assert_within_one(canvas[0].numpy(), want_rgb, 'rgb at d = 1')


# libjpeg-turbo's fancy upsampling loops (jdsample.c), transcribed one
# statement at a time: the reference for ycc_to_rgb's vectorised plain
# version

def libjpeg_h2v2(p, h, w):
    ch, cw = p.shape
    p = p.astype(int)
    out = np.zeros((2 * ch, 2 * cw), int)
    for r in range(ch):
        for v in range(2):
            near = p[r]
            far = p[max(r - 1, 0)] if v == 0 else p[min(r + 1, ch - 1)]
            o = out[2 * r + v]
            this = near[0] * 3 + far[0]
            nxt = near[1] * 3 + far[1]
            o[0] = (this * 4 + 8) >> 4
            o[1] = (this * 3 + nxt + 7) >> 4
            last, this = this, nxt
            for col in range(1, cw - 1):
                nxt = near[col + 1] * 3 + far[col + 1]
                o[2 * col] = (this * 3 + last + 8) >> 4
                o[2 * col + 1] = (this * 3 + nxt + 7) >> 4
                last, this = this, nxt
            o[2 * cw - 2] = (this * 3 + last + 8) >> 4
            o[2 * cw - 1] = (this * 4 + 7) >> 4
    return out[:h, :w]


def libjpeg_h2v1(p, h, w):
    ch, cw = p.shape
    p = p.astype(int)
    out = np.zeros((ch, 2 * cw), int)
    for r in range(ch):
        i, o = p[r], out[r]
        o[0] = i[0]
        o[1] = (i[0] * 3 + i[1] + 2) >> 2
        for col in range(1, cw - 1):
            o[2 * col] = (i[col] * 3 + i[col - 1] + 1) >> 2
            o[2 * col + 1] = (i[col] * 3 + i[col + 1] + 2) >> 2
        o[2 * cw - 2] = (i[cw - 1] * 3 + i[cw - 2] + 1) >> 2
        o[2 * cw - 1] = i[cw - 1]
    return out[:h, :w]


def libjpeg_h1v2(p, h, w):
    ch, cw = p.shape
    p = p.astype(int)
    out = np.zeros((2 * ch, cw), int)
    for r in range(ch):
        for v in range(2):
            far = p[max(r - 1, 0)] if v == 0 else p[min(r + 1, ch - 1)]
            out[2 * r + v] = (p[r] * 3 + far + (1 if v == 0 else 2)) >> 2
    return out[:h, :w]


LAYOUTS = {'420': ((2, 2), libjpeg_h2v2), '422': ((2, 1), libjpeg_h2v1),
           '440': ((1, 2), libjpeg_h1v2)}


@pytest.mark.parametrize('size', [(9, 13), (10, 14), (61, 97), (7, 5)],
                         ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_fancy_upsampling_matches_libjpeg_loops(layout, size):
    (hs, vs), loops = LAYOUTS[layout]
    h, w = size
    rng = np.random.RandomState(h * w)
    planes = [rng.randint(0, 256, shape).astype(np.uint8) for shape in
              ((h, w), (-(-h // vs), -(-w // hs)), (-(-h // vs), -(-w // hs)))]
    for p in planes[1:]:
        got = cuda_jpeg._upsample_plain(torch.from_numpy(p), hs, vs, h, w)
        np.testing.assert_array_equal(got.numpy(), loops(p, h, w))
    rgb = cuda_jpeg.ycc_to_rgb(*(torch.from_numpy(p) for p in planes),
                               (hs, vs))
    assert rgb.shape == (h, w, 3) and rgb.dtype == torch.uint8


def block_means(p, bh, bw):
    out = np.zeros((-(-p.shape[0] // bh), -(-p.shape[1] // bw)), int)
    for r in range(out.shape[0]):
        for c in range(out.shape[1]):
            block = p[r * bh:(r + 1) * bh, c * bw:(c + 1) * bw]
            out[r, c] = (int(block.sum()) + block.size // 2) // block.size
    return out


@pytest.mark.parametrize('d', [2, 4, 8])
@pytest.mark.parametrize('layout', sorted(LAYOUTS) + ['444'])
def test_ycc_reduction_follows_libjpeg_scaled_decode(layout, d):
    """At a divisor, luma is reduced by its d x d block means and the
    chroma by the scale libjpeg's IDCT gives it, then upsampled as libjpeg
    does there (fancy unless d = 8), edge blocks cut."""
    hs, vs = cuda_jpeg.FACTORS[layout]
    r, uh, uv, fancy = cuda_jpeg.scaled_chroma(hs, vs, d)
    assert (r, uh, uv) == {
        '420': (d // 2, 1, 1), '444': (d, 1, 1), '422': (d, 2, 1),
        '440': (d, 1, 2)}[layout]
    h, w = 61, 97
    rng = np.random.RandomState(d)
    planes = [rng.randint(0, 256, shape).astype(np.uint8) for shape in
              ((h, w), (-(-h // vs), -(-w // hs)), (-(-h // vs), -(-w // hs)))]
    luma = block_means(planes[0], d, d)
    oh, ow = luma.shape

    def up(p):
        if (uh, uv) == (1, 1):
            return p
        if not fancy:
            return p[np.arange(oh) // uv][:, np.arange(ow) // uh]
        loops = {(2, 1): libjpeg_h2v1, (1, 2): libjpeg_h1v2}[(uh, uv)]
        return loops(p, oh, ow)
    want = cuda_jpeg.ycc_to_rgb(*(torch.from_numpy(m.astype(np.uint8)) for m
                                  in (luma, up(block_means(planes[1], r, r)),
                                      up(block_means(planes[2], r, r)))),
                                (1, 1))
    got = cuda_jpeg.ycc_to_rgb(*(torch.from_numpy(p) for p in planes),
                               (hs, vs), d)
    assert got.shape == (oh, ow, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize('hw', ((128, 128), (64, 64)), ids=('128', '64'))
def test_reduced_444_decode_within_bound(hw):
    """The card's route at a divisor on a 4:4:4 file, whose YCbCr planes
    libjpeg gives at their own resolution: planes reduced by their block
    means, then the letterbox of the reduced pixels, against fastloader."""
    from PIL import Image
    path = fixture_path('photo_444.jpg')
    want_rgb, _, want_meta, _ = jax_canvases(path, hw)
    with Image.open(path) as im:
        im.draft('YCbCr', im.size)
        ycc = np.array(im)
    h, w = ycc.shape[:2]
    d = cuda_jpeg.divisor(w, h, hw)
    assert d > 1
    reduced = cuda_jpeg.ycc_to_rgb(*(torch.from_numpy(ycc[..., k].copy())
                                     for k in range(3)), (1, 1), d)
    canvas, metas, _ = cuda_jpeg.letterbox_rgb([reduced], hw, 'cpu',
                                               [(w, h)])
    assert np.array_equal(metas[0], want_meta)
    diff = np.abs(canvas[0].numpy().astype(np.int32)
                  - want_rgb.astype(np.int32))
    assert diff.mean() < MEAN_BOUND
    with pytest.raises(ValueError, match='neither'):
        cuda_jpeg.letterbox_rgb([reduced[1:]], hw, 'cpu', [(w, h)])


@pytest.mark.parametrize('name', ('photo_444.jpg', 'photo_420_q90.jpg',
                                  'dog.jpg'))
def test_ycc_to_rgb_matches_libjpeg_colour_conversion(name):
    """libjpeg's own YCbCr output (upsampled), converted by the port's
    tables, is libjpeg's RGB output exactly."""
    from PIL import Image
    with Image.open(fixture_path(name)) as im:
        im.draft('YCbCr', im.size)
        ycc = np.array(im)
    want = pil_pixels(fixture_path(name)).numpy()
    got = cuda_jpeg.ycc_to_rgb(*(torch.from_numpy(ycc[..., k].copy())
                                 for k in range(3)), (1, 1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ycc_to_rgb_checks_planes():
    y = torch.zeros(9, 13, dtype=torch.uint8)
    with pytest.raises(ValueError, match='subsampling'):
        cuda_jpeg.ycc_to_rgb(y, torch.zeros(5, 6, dtype=torch.uint8),
                             torch.zeros(5, 6, dtype=torch.uint8), (2, 2))
    with pytest.raises(ValueError, match='subsampling'):
        cuda_jpeg.ycc_to_rgb(y, torch.zeros(3, 4, dtype=torch.uint8),
                             torch.zeros(3, 4, dtype=torch.uint8), (4, 4))


def test_block_mean_cuts_edge_blocks():
    """An odd-sized source: the last row and column average only the
    pixels that exist (libjpeg's ceil(w / d) output), rounded."""
    img = torch.arange(5 * 7 * 3, dtype=torch.int32).reshape(5, 7, 3)
    img = (img * 37 % 256).to(torch.uint8)
    red = cuda_jpeg.reduce_plain(img, 4)
    assert tuple(red.shape) == (2, 2, 3)
    block = img[4:5, 4:7].to(torch.int32)
    want = (block.sum((0, 1)) + block.shape[0] * block.shape[1] // 2) \
        // (block.shape[0] * block.shape[1])
    assert red[1, 1].tolist() == want.tolist()
    full = img[:4, :4].to(torch.int32)
    assert red[0, 0].tolist() == ((full.sum((0, 1)) + 8) // 16).tolist()


def test_divisor_and_tie_geometry():
    """libjpeg's divisor rule, and the 73x128 tie at 64x64: content width
    73 * 0.5 = 36.5 rounds half to even to 36, pad 14 (lround gives 37)."""
    assert cuda_jpeg.divisor(640, 480, (608, 608)) == 1
    assert cuda_jpeg.divisor(640, 480, (128, 128)) == 2
    assert cuda_jpeg.divisor(640, 480, (64, 64)) == 4
    assert cuda_jpeg.divisor(640, 480, (32, 32)) == 8
    assert cuda_jpeg.divisor(640, 480, (240, 321)) == 1
    scale, nw, nh, px, py = cuda_jpeg.geometry(73, 128, (64, 64))
    assert (nw, nh, px, py) == (36, 64, 14, 0) and scale == 0.5


@pytest.mark.parametrize('name', ('photo_420_q90.jpg', 'dog.jpg'))
def test_yuv_of_a_canvas_matches_jax(name):
    from multigriddet_tpu.ops.yuv import rgb_to_yuv420_np
    want_rgb, _, _, _ = jax_canvases(fixture_path(name), (608, 608))
    got = cuda_jpeg.rgb_to_yuv420_plain(torch.from_numpy(want_rgb))
    for g, w, plane in zip(got, rgb_to_yuv420_np(want_rgb),
                           ('y', 'cb', 'cr')):
        assert_within_one(g.numpy(), w, plane)


def test_rejected_slots_are_gray():
    """A slot without a decoded image: gray canvas, zero metas, not ok;
    the others unchanged, in both wrappers."""
    full = pil_pixels(fixture_path('odd_97x61.jpg'))
    canvas, metas, ok = cuda_jpeg.letterbox_rgb([None, full], (64, 64),
                                                'cpu')
    assert ok.tolist() == [False, True]
    assert (canvas[0] == 128).all() and not metas[0].any()
    assert torch.equal(canvas[1], cuda_jpeg.letterbox_rgb_plain(
        full, (64, 64)))
    y, cb, cr, metas2, ok2 = cuda_jpeg.letterbox_yuv420([full, None],
                                                        (64, 64), 'cpu')
    assert ok2.tolist() == [True, False]
    assert all((p[1] == 128).all() for p in (y, cb, cr))
    assert np.array_equal(metas2[0], metas[1])


@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_host_loader_on_cpu_equals_jax(link):
    from multigriddet_tpu.data import HostImageLoader as JaxLoader
    lines = [f'{fixture_path(n)} 10,12,60,40,1 5,5,30,30,0'
             for n in GOOD + REJECTED + ('dog.jpg',)]
    ours = HostImageLoader(lines, (128, 128), max_boxes=4, num_workers=2,
                           link_format=link, device='cpu')
    theirs = JaxLoader(lines, (128, 128), max_boxes=4, num_workers=2,
                       link_format=link)
    try:
        got, got_boxes = ours.load_batch(lines)
        want, want_boxes = theirs.load_batch(lines)
    finally:
        ours.close()
        theirs.close()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(isinstance(g, np.ndarray) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_boxes, want_boxes)


def test_host_loader_metas():
    lines = [f'{fixture_path(n)} 1,1,9,9,0'
             for n in ('odd_333x251.jpg', 'corrupt.jpg', 'png_named.jpg')]
    loader = HostImageLoader(lines, (64, 64), max_boxes=2, num_workers=2)
    try:
        _, boxes, metas, ok = loader.load_batch(lines, return_metas=True)
    finally:
        loader.close()
    # the PNG is retried through Pillow; the corrupt file stays gray
    assert ok.tolist() == [True, False, True]
    assert metas[0, 3:].tolist() == [333, 251]
    assert metas[2, 3:].tolist() == [64, 48]
    assert not metas[1].any() and not boxes[1].any()
    cached = HostImageLoader(lines, (64, 64), cache_images=True)
    with pytest.raises(ValueError, match='metas'):
        cached.load_batch(lines, return_metas=True)
    cached.close()


def test_card_loader_sends_every_path_to_the_decoder(monkeypatch, tmp_path):
    """On a CUDA device every path of a batch, JPEG or not, goes to the
    card's decoder, and Pillow sees only the slots it rejected.  Here the
    loader is told it is on the card and its decoder is fastloader on the
    CPU, which rejects a PNG as nvJPEG does."""
    from multigriddet_tpu_torch.data import jpeg_cuda, native
    png = tmp_path / 'not_a_jpeg.png'
    with open(fixture_path('png_named.jpg'), 'rb') as f:
        png.write_bytes(f.read())
    paths = [fixture_path('photo_420_q90.jpg'), str(png),
             fixture_path('odd_97x61.jpg'), fixture_path('corrupt.jpg')]
    lines = [f'{p} 2,2,30,30,1' for p in paths]
    decoded, retried = [], []

    def decode(batch, hw, device):
        decoded.append(list(batch))
        images, metas, ok = native.load_letterbox_batch(batch, hw)
        return torch.from_numpy(images), metas, ok

    monkeypatch.setattr(jpeg_cuda, 'load_letterbox_batch_cuda', decode)
    loader = HostImageLoader(lines, (64, 64), max_boxes=2, num_workers=1)
    loader.on_card = True
    pil = loader._load_batch_pil
    monkeypatch.setattr(loader, '_load_batch_pil',
                        lambda ls, hw: retried.extend(ls) or pil(ls, hw))
    try:
        images, boxes, _, ok = loader.load_batch(lines, return_metas=True)
        jpegs, _ = loader.load_batch(lines[::2])
    finally:
        loader.close()
    assert decoded == [paths, paths[::2]]
    assert retried == [lines[1], lines[3]]
    assert ok.tolist() == [True, True, True, False]
    assert isinstance(images, torch.Tensor)
    assert torch.equal(images[0], jpegs[0]) and torch.equal(images[2],
                                                            jpegs[1])
    assert boxes[1, 0, 4] == 1 and not boxes[3].any()


@pytest.mark.parametrize('name', GOOD + REJECTED + ('dog.jpg',))
def test_recorded_reference_is_fastloaders(name):
    """``letterbox_ref.npz`` holds fastloader's metas and ok flags exactly,
    and its pixels (to the FMA note's one level) at the positions the
    recorder's ``positions`` gives: seeded samples, then every pixel of
    the content's border."""
    from record_jpeg_fixtures import SAMPLES, positions
    ref = np.load(os.path.join(FIXTURES, 'letterbox_ref.npz'))
    assert [tuple(hw) for hw in ref['canvases'].tolist()] == list(CANVASES)
    fi = [os.path.basename(str(n)) for n in ref['files']].index(name)
    for ci, hw in enumerate(CANVASES):
        img, (ys, cbs, crs), metas, ok = jax_canvases(fixture_path(name), hw)
        assert np.array_equal(ref['metas'][fi, ci], metas)
        assert bool(ref['ok'][fi, ci]) == ok
        if not ok:
            assert not ref['n'][fi, ci].any()
            continue
        (yy, xx), (cy, cx) = positions(str(ref['files'][fi]), hw, metas)
        (at, cat), (n, cn) = ref['at'][fi, ci], ref['n'][fi, ci]
        assert (len(yy), len(cy)) == (n, cn)
        assert_within_one(ref['rgb'][at:at + n], img[yy, xx], 'rgb')
        assert_within_one(ref['y'][at:at + n], ys[yy, xx], 'y')
        assert_within_one(ref['cbcr'][cat:cat + cn],
                          np.stack([cbs[cy, cx], crs[cy, cx]], -1), 'cbcr')
        _, nw, nh, px, py = cuda_jpeg.geometry(int(metas[3]), int(metas[4]),
                                               hw)
        border = set(zip(yy[SAMPLES:].tolist(), xx[SAMPLES:].tolist()))
        assert len(border) == n - SAMPLES == 2 * (nw + nh) - 4
        assert {(py, px), (py, px + nw - 1), (py + nh - 1, px),
                (py + nh - 1, px + nw - 1)} <= border
        assert all(y in (py, py + nh - 1) or x in (px, px + nw - 1)
                   for y, x in border)


TRUNCATED = 'truncated_50.jpg'


def truncated_ref():
    from record_jpeg_fixtures import TRUNCATED_CANVASES
    ref = np.load(os.path.join(FIXTURES, 'truncated_ref.npz'))
    assert [tuple(c) for c in ref['canvases'].tolist()] == list(
        TRUNCATED_CANVASES)
    return [(tuple(int(v) for v in ref['canvases'][i]), ref[f'rgb_{i}'],
             ref[f'metas_{i}'], bool(ref[f'ok_{i}']))
            for i in range(len(TRUNCATED_CANVASES))]


def test_truncated_reference_is_fastloaders():
    """``truncated_ref.npz`` is fastloader's output on the file cut to half
    its bytes: ``ok``, the full size in the metas, and the lower part of
    the content gray."""
    for hw, rgb, metas, ok in truncated_ref():
        img, _, want_metas, want_ok = jax_canvases(fixture_path(TRUNCATED),
                                                   hw)
        assert ok and want_ok and np.array_equal(metas, want_metas)
        assert metas[3:].tolist() == [640, 480]
        np.testing.assert_array_equal(rgb, img)
        _, nw, nh, px, py = cuda_jpeg.geometry(640, 480, hw)
        content = rgb[py:py + nh, px:px + nw]
        assert (content[-nh // 3:] == 128).all()
        assert (content[:nh // 4] != 128).any(-1).mean() > 0.9


@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_truncated_file_on_the_cpu_equals_fastloader(link):
    """On the CPU the port reads a truncated JPEG as the JAX package's
    loader does: ``ok``, the metas and the canvas equal."""
    from multigriddet_tpu.data import HostImageLoader as JaxLoader
    lines = [f'{fixture_path(TRUNCATED)} 10,12,300,400,1',
             f'{fixture_path("photo_420_q90.jpg")} 5,5,30,30,0']
    for hw, rgb, _, _ in truncated_ref():
        ours = HostImageLoader(lines, hw, max_boxes=4, num_workers=2,
                               link_format=link, device='cpu')
        theirs = JaxLoader(lines, hw, max_boxes=4, num_workers=2,
                           link_format=link)
        try:
            got, got_boxes, metas, ok = ours.load_batch(lines,
                                                        return_metas=True)
            want, want_boxes = theirs.load_batch(lines)
        finally:
            ours.close()
            theirs.close()
        assert ok.tolist() == [True, True]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got_boxes, want_boxes)
        if link == 'rgb':
            np.testing.assert_array_equal(got[0][0], rgb)


@pytest.mark.parametrize('index', [0, 1], ids=['416', '128'])
def test_truncated_route_equals_fastloader(index):
    """The card's route for a truncated file, run on the CPU: libjpeg
    through Pillow with the EOI marker appended, ``ycc_to_rgb`` on the
    upsampled planes, the letterbox.  At divisor 1 (416) the canvas is
    fastloader's exactly; at divisor 2 (128, block means for libjpeg's
    reduced IDCT) it lies under the mean bound, and the gray part is the
    same to 1% of the canvas.  Only the truncated fixture is detected as
    truncated."""
    from multigriddet_tpu_torch.data import jpeg_cuda
    hw, rgb, metas, _ = truncated_ref()[index]
    with open(fixture_path(TRUNCATED), 'rb') as f:
        data = f.read()
    image, size = jpeg_cuda.decode_libjpeg(data, 'cpu', hw)
    assert size == (640, 480)
    canvas, got_metas, ok = cuda_jpeg.letterbox_rgb([image], hw, 'cpu',
                                                    [size])
    assert ok.tolist() == [True] and np.array_equal(got_metas[0], metas)
    got = canvas[0].numpy()
    diff = np.abs(got.astype(np.int32) - rgb.astype(np.int32))
    if cuda_jpeg.divisor(640, 480, hw) == 1:
        assert not diff.any()
    else:
        assert diff.mean() < MEAN_BOUND
        gray = (got == 128).all(-1) != (rgb == 128).all(-1)
        assert gray.mean() <= 0.01
    names = sorted(os.listdir(FIXTURES))
    flagged = [n for n in names if n.endswith('.jpg') and jpeg_cuda.truncated(
        open(os.path.join(FIXTURES, n), 'rb').read())]
    assert flagged == [TRUNCATED]


class _FillingDecoder:
    """Stands in for nvJPEG, which accepts a truncated file and fills its
    missing part with other pixels (here: Pillow's black)."""

    def __init__(self):
        self.seen = {}          # decodes kept for when Pillow is hidden

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def decode(self, data, hw=None, planes_out=None):
        import io
        if data not in self.seen:
            from PIL import Image, ImageFile
            ImageFile.LOAD_TRUNCATED_IMAGES = True
            try:
                with Image.open(io.BytesIO(data)) as im:
                    self.seen[data] = np.array(im.convert('RGB'))
            finally:
                ImageFile.LOAD_TRUNCATED_IMAGES = False
        arr = self.seen[data]
        d = cuda_jpeg.divisor(arr.shape[1], arr.shape[0], hw) if hw else 1
        return (cuda_jpeg.reduce_plain(torch.from_numpy(arr), d),
                (arr.shape[1], arr.shape[0]), None)


def test_card_decode_routes_a_truncated_file_through_libjpeg(monkeypatch,
                                                             capsys):
    """``decode_files`` on the card (its decoder replaced by one that fills
    the cut part as nvJPEG does): the truncated file goes to libjpeg
    through Pillow, with a printed line naming the route, and gives
    fastloader's canvas; an intact file stays with the card's decoder.
    Without Pillow the truncated slot is rejected (gray, zero metas, ``ok``
    False) with a printed line, never given the card's filled pixels."""
    from multigriddet_tpu_torch.data import jpeg_cuda
    fake = _FillingDecoder()
    monkeypatch.setattr(cuda_jpeg, 'decoder', lambda device: fake)
    hw, rgb, _, _ = truncated_ref()[0]
    paths = [fixture_path(TRUNCATED), fixture_path('photo_420_q90.jpg')]
    images, sizes = jpeg_cuda.decode_files(paths, 'cpu', hw)
    out = capsys.readouterr().out
    assert 'truncated' in out and 'libjpeg through Pillow' in out
    assert out.count('WARNING') == 1
    canvas, _, ok = cuda_jpeg.letterbox_rgb(images, hw, 'cpu', sizes)
    assert ok.tolist() == [True, True]
    np.testing.assert_array_equal(canvas[0].numpy(), rgb)
    intact = fake.decode(open(paths[1], 'rb').read(), hw)[0]
    assert torch.equal(images[1], intact)
    fake.decode(open(paths[0], 'rb').read(), hw)
    hide_pil(monkeypatch)
    images, sizes = jpeg_cuda.decode_files(paths, 'cpu', hw)
    out = capsys.readouterr().out
    assert 'Pillow does not import or read it' in out and 'gray' in out
    assert out.count('WARNING') == 1
    assert images[0] is None and sizes[0] is None
    assert torch.equal(images[1], intact)
    canvas, metas, ok = cuda_jpeg.letterbox_rgb(images, hw, 'cpu', sizes)
    assert ok.tolist() == [False, True]
    assert not metas[0].any() and bool((canvas[0] == 128).all())


def test_truncated_file_evaluator_counts_equal_jax(tmp_path):
    """The evaluator scores a truncated file as the JAX evaluator does
    (neither marks it failed): the same numbers of images, detections and
    ground truth, the same classes, and mAP within 1e-6."""
    from multigriddet_tpu.evaluation import MultiGridEvaluator as JaxEval
    from multigriddet_tpu_torch.evaluation import MultiGridEvaluator
    from multigriddet_tpu_torch.models import (create_model,
                                               random_flax_variables)
    from multigriddet_tpu_torch.training import save_params
    from test_torch_evaluator import eval_config
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=5)
    weights = str(tmp_path / 'weights.msgpack')
    save_params(weights, {'params': params, 'batch_stats': stats})
    annotation = tmp_path / 'ann.txt'
    annotation.write_text(
        f'{fixture_path(TRUNCATED)} 40,30,300,200,0 100,260,400,470,1\n'
        f'{fixture_path("photo_420_q90.jpg")} 10,10,200,200,1\n')
    results = []
    for make in (lambda c: MultiGridEvaluator(c, device='cpu'), JaxEval):
        cfg = eval_config(str(tmp_path), str(annotation), weights,
                          save_results=False)
        ev = make(cfg)
        results.append((ev.evaluate(), ev))
    (got, ours), (want, theirs) = results
    assert got['num_images'] == want['num_images'] == 2
    for img in (0, 1):
        p, q = ours.predictions[img], theirs.predictions[img]
        assert len(p['boxes']) == len(q['boxes']) > 0, img
        np.testing.assert_array_equal(p['classes'], q['classes'])
        assert len(ours.ground_truths[img]['boxes']) == len(
            theirs.ground_truths[img]['boxes'])
    np.testing.assert_array_equal(got['gt_counts'], want['gt_counts'])
    for key in ('mAP', 'mAP50'):
        assert abs(got[key] - want[key]) <= 1e-6, key


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the card tests cover it')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        HostImageLoader([], (64, 64), device='cuda')
    from multigriddet_tpu_torch.data import jpeg_cuda
    with pytest.raises(RuntimeError):
        jpeg_cuda.load_letterbox_batch_cuda(
            [fixture_path('tie_73x128.jpg')], (64, 64), 'cuda')


def test_new_modules_import_no_jax_and_build_nothing():
    code = textwrap.dedent('''
        import os, sys
        from multigriddet_tpu_torch.data import jpeg_cuda
        from multigriddet_tpu_torch.ops import cuda_jpeg, kernel_build
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                            'multigriddet_tpu'))
        assert not bad, bad
        assert not kernel_build._LOADED and not cuda_jpeg._free
        print('ok')
    ''')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
    for mod in ('data/jpeg_cuda.py', 'ops/cuda_jpeg.py'):
        with open(os.path.join(REPO, 'multigriddet_tpu_torch', mod)) as f:
            src = f.read()
        assert 'import jax' not in src and 'multigriddet_tpu.' not in src


def test_link_flags_name_missing_paths(tmp_path):
    from multigriddet_tpu_torch.ops import kernel_build
    assert kernel_build.link_flags('nms.cu', str(tmp_path)) == []
    with pytest.raises(RuntimeError, match='nvjpeg.h'):
        kernel_build.link_flags('jpeg.cu', str(tmp_path))
    (tmp_path / 'include').mkdir()
    (tmp_path / 'include' / 'nvjpeg.h').write_text('')
    with pytest.raises(RuntimeError, match='libnvjpeg.so'):
        kernel_build.link_flags('jpeg.cu', str(tmp_path))
    (tmp_path / 'lib64').mkdir()
    (tmp_path / 'lib64' / 'libnvjpeg.so.12').write_text('')
    flags = kernel_build.link_flags('jpeg.cu', str(tmp_path))
    assert '-lnvjpeg' in flags
    assert kernel_build.library_path('jpeg.cu') != \
        kernel_build.library_path('nms.cu')


# ---------------------------------------------------------------------------
# without Pillow
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tiny_config(tmp_path_factory):
    root = tmp_path_factory.mktemp('jpeg_nopil')
    anchors = root / 'anchors.txt'
    anchors.write_text('40,40 30,50 50,30\n20,20 15,25 25,15\n'
                       '10,10 8,12 12,8\n')
    classes = root / 'classes.txt'
    classes.write_text('a\nb\n')
    model = {'type': 'preset', 'preset': {
        'architecture': 'multigriddet_tiny', 'num_classes': 2,
        'input_shape': [64, 64, 3], 'anchors_path': str(anchors),
        'classes_path': str(classes)}}
    names = ('odd_333x251.jpg', 'corrupt.jpg', 'photo_420_q75.jpg',
             'png_named.jpg', 'tie_73x128.jpg')
    lines = [f'{fixture_path(n)} 2,2,30,30,1' for n in names]
    return root, model, lines


def hide_pil(monkeypatch):
    for name in [m for m in sys.modules if m.split('.')[0] == 'PIL']:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    from multigriddet_tpu_torch.data.annotations import pil_available
    assert not pil_available()


def test_evaluator_file_batches_without_pil(tiny_config, monkeypatch):
    from multigriddet_tpu_torch.evaluation import MultiGridEvaluator
    root, model, lines = tiny_config
    cfg = {'model': model, 'environment': {'mixed_precision': False},
           'evaluation': {'batch_size': 4, 'link_format': 'rgb',
                          'num_workers': 2,
                          'results_dir': str(root / 'results')}}
    ev = MultiGridEvaluator(cfg, device='cpu')
    with_pil = list(ev._file_batches(lines))
    hide_pil(monkeypatch)
    batches = list(ev._file_batches(lines))
    metas = [m for _, ms in batches for m in ms]
    sizes = [(ih, iw) for _, _, ih, iw, _, _ in metas]
    failed = [f for *_, f in metas]
    assert sizes[0] == (251, 333) and sizes[2] == (480, 640)
    assert sizes[4] == (128, 73)
    # without Pillow the PNG under a .jpg name is not retried
    assert failed == [False, True, False, True, False]
    assert [m[5] for _, ms in with_pil for m in ms] == \
        [False, True, False, False, False]
    for parts, _ in batches:
        assert parts[0].shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(batches[0][0][0][[0, 2]],
                                  with_pil[0][0][0][[0, 2]])
    cfg['visualizations'] = {'save_annotated_images': {'enabled': True}}
    with pytest.raises(ImportError, match='Pillow'):
        next(ev._file_batches(lines))


def test_detect_files_without_pil(tiny_config, monkeypatch):
    from multigriddet_tpu_torch.inference import MultiGridInference
    _, model, lines = tiny_config
    paths = [ln.split()[0] for ln in lines]
    cfg = {'model': model, 'environment': {'mixed_precision': False},
           'input': {'input_shape': [64, 64, 3]},
           'detection': {'confidence_threshold': 0.0, 'max_boxes': 5,
                         'nms_backend': 'pallas_fused'}}
    engine = MultiGridInference(cfg, device='cpu')
    want = engine.detect_files(paths, batch_size=4)
    hide_pil(monkeypatch)
    got = engine.detect_files(paths, batch_size=4)
    assert len(got) == len(paths)
    for i in (0, 2, 4):
        assert len(got[i][0]) > 0
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)
    assert len(got[1][0]) == 0 and len(got[3][0]) == 0
    with pytest.raises(ImportError, match='item 17'):
        engine.predict_image(paths[0], output_dir=None, show=False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('d', [1, 2, 8])
@pytest.mark.parametrize('size', [(9, 13), (480, 640), (61, 97), (7, 5)],
                         ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('layout', sorted(LAYOUTS) + ['444'])
def test_ycc_kernel_equals_plain(cuda_device, layout, size, d):
    hs, vs = cuda_jpeg.FACTORS[layout]
    h, w = size
    rng = np.random.RandomState(h + w)
    planes = [torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
              for shape in ((h, w), (-(-h // vs), -(-w // hs)),
                            (-(-h // vs), -(-w // hs)))]
    before = cuda_jpeg.ycc_to_rgb.launches
    got = cuda_jpeg.ycc_to_rgb(*(p.to(cuda_device) for p in planes),
                               (hs, vs), d)
    torch.cuda.synchronize()
    assert cuda_jpeg.ycc_to_rgb.launches == before + 1
    assert torch.equal(got.cpu(), cuda_jpeg.ycc_to_rgb_plain(*planes,
                                                             (hs, vs), d))


@pytest.mark.cuda
@pytest.mark.parametrize('hw', CANVASES, ids=lambda hw: str(hw[0]))
def test_kernels_equal_plain_on_nvjpeg_pixels(cuda_device, hw):
    from multigriddet_tpu_torch.data import jpeg_cuda
    paths = [fixture_path(n) for n in GOOD + REJECTED + ('dog.jpg',)]
    images, sizes = jpeg_cuda.decode_files(paths, cuda_device, hw)
    assert [im is not None for im in images] == \
        [True] * len(GOOD) + [False] * len(REJECTED) + [True]
    before = cuda_jpeg.letterbox_rgb.launches
    canvas, metas, ok = cuda_jpeg.letterbox_rgb(images, hw, cuda_device,
                                                sizes)
    y, cb, cr, metas2, ok2 = cuda_jpeg.letterbox_yuv420(images, hw,
                                                        cuda_device, sizes)
    torch.cuda.synchronize()
    assert cuda_jpeg.letterbox_rgb.launches == before + 1
    assert np.array_equal(metas, metas2) and np.array_equal(ok, ok2)
    host = [None if im is None else im.cpu() for im in images]
    want, want_metas, want_ok = cuda_jpeg.letterbox_rgb(host, hw, 'cpu',
                                                        sizes)
    wy, wcb, wcr, _, _ = cuda_jpeg.letterbox_yuv420(host, hw, 'cpu', sizes)
    assert np.array_equal(metas, want_metas) and np.array_equal(ok, want_ok)
    assert torch.equal(canvas.cpu(), want)
    for g, w in zip((y, cb, cr), (wy, wcb, wcr)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_truncated_file_on_the_card(cuda_device, link, capsys):
    """A JPEG cut to half its bytes, read by the loader on the card: ``ok``
    and the metas as fastloader's, a printed line naming the route (libjpeg
    through Pillow; without Pillow a rejected slot), and the canvas:
    fastloader's exactly at divisor 1 (416), under the mean bound at
    divisor 2 (128)."""
    from multigriddet_tpu_torch.data.annotations import pil_available
    lines = [f'{fixture_path(TRUNCATED)} 10,12,300,400,1']
    for hw, rgb, metas, _ in truncated_ref():
        loader = HostImageLoader(lines, hw, max_boxes=2, num_workers=1,
                                 link_format=link, device=cuda_device)
        try:
            parts, boxes, got_metas, ok = loader.load_batch(
                lines, return_metas=True)
        finally:
            loader.close()
        out = capsys.readouterr().out
        print(out)
        assert 'truncated' in out
        if not pil_available():     # a rejected slot, never nvJPEG's fill
            assert ok.tolist() == [False] and not got_metas[0].any()
            continue
        assert ok.tolist() == [True] and np.array_equal(got_metas[0], metas)
        assert boxes[0, 0, 4] == 1
        assert 'libjpeg through Pillow' in out
        if link == 'yuv420':     # against the 4:2:0 of fastloader's RGB
            for p, w in zip(parts, cuda_jpeg.rgb_to_yuv420_plain(
                    torch.from_numpy(rgb))):
                d = np.abs(p[0].cpu().numpy().astype(np.int32)
                           - w.numpy().astype(np.int32))
                assert d.mean() < MEAN_BOUND
            continue
        got = parts[0].cpu().numpy().astype(np.int32)
        diff = np.abs(got - rgb.astype(np.int32))
        print(f'truncated @{hw[0]}: mean |dRGB| {diff.mean():.4f}, max '
              f'{diff.max()}')
        if cuda_jpeg.divisor(640, 480, hw) == 1:
            assert_within_one(got, rgb, 'truncated rgb')
        else:
            assert diff.mean() < MEAN_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_host_loader_on_the_card(cuda_device, link):
    """The loader on the card: device batches equal to the wrappers' on the
    same files, boxes from the metas, a rejected slot gray without boxes
    unless Pillow imports (then it is retried), and the disk cache filled
    from the device result gives the same batch back."""
    import tempfile
    from multigriddet_tpu_torch.data import jpeg_cuda
    from multigriddet_tpu_torch.data.annotations import pil_available
    names = ('odd_333x251.jpg', 'corrupt.jpg', 'photo_422.jpg',
             'png_named.jpg')
    lines = [f'{fixture_path(n)} 2,2,30,30,1' for n in names]
    loader = HostImageLoader(lines, (64, 64), max_boxes=2, num_workers=1,
                             link_format=link, device=cuda_device)
    parts, boxes, metas, ok = loader.load_batch(lines, return_metas=True)
    parts = parts if isinstance(parts, tuple) else (parts,)
    assert all(p.device.type == 'cuda' for p in parts)
    load = (jpeg_cuda.load_letterbox_yuv_batch_cuda if link == 'yuv420'
            else jpeg_cuda.load_letterbox_batch_cuda)
    want = load([fixture_path(n) for n in names], (64, 64), cuda_device)
    retried = pil_available()
    assert ok.tolist() == [True, False, True, retried]
    for i in (0, 2):
        for p, w in zip(parts, want[:len(parts)]):
            assert torch.equal(p[i], w[i])
        assert boxes[i, 0, 4] == 1
    assert all(bool((p[1] == 128).all()) for p in parts)
    assert not boxes[1].any() and not metas[1].any()
    with tempfile.TemporaryDirectory() as cache:
        cached = HostImageLoader(lines, (64, 64), max_boxes=2,
                                 num_workers=1, link_format=link,
                                 disk_cache_dir=cache, device=cuda_device)
        first, first_boxes = cached.load_batch(lines)
        again, again_boxes = cached.load_batch(lines)
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    for a, b, p in zip(first, again, parts):
        assert torch.equal(a, b) and torch.equal(a, p)
    assert np.array_equal(first_boxes, again_boxes)
    assert np.array_equal(first_boxes, boxes)


def tiny_engine(device, link='rgb'):
    from multigriddet_tpu_torch.inference import MultiGridInference
    model = {'type': 'preset', 'preset': {
        'architecture': 'multigriddet_tiny', 'num_classes': 2,
        'input_shape': [64, 64, 3]}}
    return MultiGridInference(
        {'model': model, 'environment': {'mixed_precision': False},
         'input': {'input_shape': [64, 64, 3]},
         'detection': {'confidence_threshold': 0.0, 'max_boxes': 5,
                       'nms_backend': 'pallas_fused', 'link_format': link}},
        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_mixed_batch_on_the_card(cuda_device, tmp_path, link):
    """JPEGs and a PNG in one batch on the card: every path goes to nvJPEG,
    which rejects the PNG (gray and empty without Pillow, retried with
    it), and each JPEG comes out of the loader and ``detect_files`` as in
    an all-JPEG batch."""
    from multigriddet_tpu_torch.data.annotations import pil_available
    png = tmp_path / 'not_a_jpeg.png'
    with open(fixture_path('png_named.jpg'), 'rb') as f:
        png.write_bytes(f.read())
    jpegs = [fixture_path(n) for n in ('photo_420_q90.jpg', 'odd_97x61.jpg',
                                       'photo_gray.jpg')]
    mixed = jpegs[:2] + [str(png)]
    retried = pil_available()
    loader = HostImageLoader([], (64, 64), max_boxes=1, num_workers=1,
                             link_format=link, device=cuda_device)
    try:
        want, _, _, _ = loader.load_batch([f'{p} 2,2,9,9,0' for p in jpegs],
                                          return_metas=True)
        got, _, _, ok = loader.load_batch([f'{p} 2,2,9,9,0' for p in mixed],
                                          return_metas=True)
    finally:
        loader.close()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert ok.tolist() == [True, True, retried]
    for g, w in zip(got, want):
        assert torch.equal(g[:2], w[:2])
        assert retried or bool((g[2] == 128).all())
    engine = tiny_engine(cuda_device, link)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = engine.detect_files(jpegs, batch_size=3)
        got = engine.detect_files(mixed, batch_size=3)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for gr, wr in zip(got[:2], want[:2]):
        for g, w in zip(gr, wr):
            np.testing.assert_array_equal(g, w)
    assert retried or len(got[2][0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize('name', ('photo_420_q90.jpg', 'photo_gray.jpg'))
def test_predict_image_on_the_card_needs_no_pillow(cuda_device, name):
    """On the card a JPEG is detected through ``detect_files`` and drawn on
    nvJPEG's full-size RGB where OpenCV or Pillow can draw (the drawing is
    None otherwise)."""
    from multigriddet_tpu_torch.inference.engine import _can_draw
    engine = tiny_engine(cuda_device)
    path = fixture_path(name)
    annotated, dets = engine.predict_image(path)
    assert len(dets[0]) == 5
    if _can_draw():
        assert annotated.shape == (480, 640, 3)
    else:
        assert annotated is None
    for got, want in zip(dets, engine.detect_files([path], batch_size=1)[0]):
        np.testing.assert_array_equal(got, want)
