"""The port's augmentation ops and chain against the JAX package's, on the
CPU, with the same draws.

Each JAX op runs from a key; the test replays the op's own
``jax.random.split`` / ``uniform`` / ``randint`` calls on that key to get
its draws (gates, factors, offsets, noise) and feeds them to the port's
``apply_<op>``.  Inputs: ``[B, H, W, 3]`` float32 images made from a seed
(a smooth picture: a random 1/8-size image upsampled, like a photo) and
``[B, N, 5]`` boxes with zero padding rows, B <= 4, canvases 64-96.

Tolerances:
* flips, rot90 and gridmask: exact (images and boxes);
* photometric ops: 1e-4 on the [0, 255] scale; the ``adjust_*`` cores
  also within 0.01 of the recorded TF reference
  (``tests/fixtures/reference/photometric.npz``), the JAX test's bound;
* resampling (resize-crop-pad, mosaic, copy-paste), filters (blur,
  sharpness, motion blur) and free rotation: 1e-3 on the [0, 255] scale
  (the matmuls and the bilinear sums round differently, ~1e-5);
* boxes: 1e-3 px, and the same slots zeroed (equal validity masks);
* the whole stage (``_device_stage``): images 1e-3 / 255 on its [0, 1]
  output, boxes 1e-3 px with equal masks, the targets' discrete fields
  exact and their offsets within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigriddet_tpu.data import augment as J
from multigriddet_tpu.data import pipeline as jpipe
from multigriddet_tpu_torch.data import augment as A
from multigriddet_tpu_torch.data import pipeline as P

PHOTO_ATOL, RESAMPLE_ATOL, BOX_ATOL, TARGET_ATOL = 1e-4, 1e-3, 1e-3, 1e-4
FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'reference')
ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
           np.array([[20, 20], [14, 28], [28, 14]], np.float32),
           np.array([[10, 10], [7, 14], [14, 7]], np.float32)]
NC = 3


def make_batch(seed, b=4, hw=(96, 96), n=6):
    """Smooth images in [0, 255] and boxes (some rows zero)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    low = rng.uniform(0, 255, (b, h // 8 + 1, w // 8 + 1, 3))
    img = np.repeat(np.repeat(low, 8, 1), 8, 2)[:, :h, :w]
    img = torch.nn.functional.avg_pool2d(
        torch.from_numpy(img).permute(0, 3, 1, 2), 5, 1, 2,
        count_include_pad=False).permute(0, 2, 3, 1).numpy()
    boxes = np.zeros((b, n, 5), np.float32)
    for i in range(b):
        for j in range(rng.randint(1, n + 1)):
            bw, bh = rng.uniform(6, w * 0.6), rng.uniform(6, h * 0.6)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, j] = [x1, y1, x1 + bw, y1 + bh, rng.randint(NC)]
    return img.astype(np.float32), boxes


# ---------------------------------------------------------------------------
# the JAX ops' draws, replayed from their keys
# ---------------------------------------------------------------------------

def _u(key, shape, lo=0.0, hi=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def jdraw_gate_value(key, b, prob, lo, hi, shape=None):
    """split -> (gate, value), the photometric / rotate / mixup pattern."""
    k1, k2 = jax.random.split(key)
    shape = shape or (b, 1, 1, 1)
    return {'apply': (_u(k1, shape) < prob).reshape(b),
            'value': _u(k2, shape, lo, hi).reshape(b)}


def jdraw_gate(key, b, prob, shape=None):
    return {'apply': (_u(key, shape or (b,)) < prob).reshape(b)}


def jdraw_motion_blur(key, b, prob):
    k1, k2 = jax.random.split(key)
    return {'apply': _u(k1, (b,)) < prob,
            'direction': np.asarray(jax.random.randint(k2, (b,), 0, 4))}


def jdraw_rotate90(key, b, prob):
    k1, k2 = jax.random.split(key)
    return {'apply': _u(k1, (b,)) < prob,
            'k': np.asarray(jax.random.randint(k2, (b,), 1, 4))}


def jdraw_resize(key, b, scale_range=(0.7, 1.3), aspect_range=(0.75, 1.333),
                 prob=1.0):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {'apply': _u(k1, (b,)) < prob,
            'scale': _u(k2, (b,), *scale_range),
            'aspect': _u(k3, (b,), *aspect_range), 'u': _u(k4, (b, 2))}


def jdraw_gridmask(key, b, prob, d_range=(40, 120)):
    k1, k2, k3 = jax.random.split(key, 3)
    return {'apply': _u(k1, (b,)) < prob,
            'd': np.asarray(jax.random.randint(k2, (b,), d_range[0],
                                               d_range[1] + 1)),
            'off': np.asarray(jax.random.randint(k3, (b, 2), 0,
                                                 d_range[1]))}


def jdraw_mosaic(key, b, prob, center_range=(0.3, 0.7)):
    k1, k2 = jax.random.split(key)
    return {'apply': _u(k1, (b,)) < prob,
            'center': _u(k2, (b, 2), *center_range)}


def jdraw_copypaste(key, b, n, prob, max_paste):
    k1, k2, k3, _ = jax.random.split(key, 4)
    return {'apply': _u(k1, (b,)) < prob, 'noise': _u(k2, (b, n)),
            'u': _u(k3, (b, max_paste, 2))}


def jdraw_chain(key, b, n, cfg):
    """The draws of ``multigriddet_tpu.data.pipeline._device_stage``'s
    chain, in the port's ``draw_chain`` layout."""
    keys = jax.random.split(key, 12)
    d = {'resize': jdraw_resize(keys[0], b, tuple(cfg.get(
            'scale_range', (0.7, 1.3)))),
         'hflip': jdraw_gate(keys[1], b, cfg.get('hflip_prob', 0.5)),
         'brightness': jdraw_gate_value(keys[2], b, 0.5, -0.2, 0.2),
         'contrast': jdraw_gate_value(keys[3], b, 0.5, 0.8, 1.2),
         'saturation': jdraw_gate_value(keys[4], b, 0.5, 0.8, 1.2),
         'hue': jdraw_gate_value(keys[5], b, 0.5, -0.1, 0.1),
         'grayscale': jdraw_gate(keys[6], b, cfg.get('grayscale_prob', 0.1),
                                 (b, 1, 1, 1)),
         'rotate90': jdraw_rotate90(keys[7], b, cfg.get('rotate_prob',
                                                        0.05))}
    if cfg.get('blur_prob', 0.0) > 0:
        d['blur'] = jdraw_gate(keys[11], b, cfg['blur_prob'], (b, 1, 1, 1))
    if cfg.get('sharpness_prob', 0.0) > 0:
        d['sharpness'] = jdraw_gate_value(jax.random.fold_in(key, 101), b,
                                          cfg['sharpness_prob'], 0.0, 0.8)
    if cfg.get('motion_blur_prob', 0.0) > 0:
        d['motion_blur'] = jdraw_motion_blur(jax.random.fold_in(key, 102), b,
                                             cfg['motion_blur_prob'])
    if cfg.get('rotate_any_prob', 0.0) > 0:
        m = cfg.get('rotate_max_deg', 15.0)
        d['rotate_any'] = jdraw_gate_value(jax.random.fold_in(key, 103), b,
                                           cfg['rotate_any_prob'], -m, m,
                                           (b,))
    if cfg.get('enhance_type') == 'gridmask':
        d['gridmask'] = jdraw_gridmask(keys[8], b,
                                       cfg.get('gridmask_prob', 0.1))
    if cfg.get('mosaic_prob', 0.0) > 0:
        d['mosaic'] = jdraw_mosaic(keys[9], b, cfg['mosaic_prob'])
    if cfg.get('mixup_prob', 0.0) > 0:
        d['mixup'] = jdraw_gate_value(keys[10], b, cfg['mixup_prob'], 0.2,
                                      0.8)
    if cfg.get('copypaste_prob', 0.0) > 0:
        cp = int(cfg.get('copypaste_max', 4))
        cap = n * jpipe.calculate_expansion_factor(
            cfg.get('mosaic_prob', 0.0), cfg.get('mixup_prob', 0.0))
        d['copypaste'] = jdraw_copypaste(jax.random.fold_in(key, 104), b,
                                         cap + cp, cfg['copypaste_prob'], cp)
    return d


def _t(draws):
    if isinstance(draws, dict):
        return {k: _t(v) for k, v in draws.items()}
    return torch.from_numpy(np.array(draws))


def assert_boxes_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    gv = ((got[..., 2] - got[..., 0]) > 0) & ((got[..., 3] - got[..., 1]) > 0)
    wv = ((want[..., 2] - want[..., 0]) > 0) & (
        (want[..., 3] - want[..., 1]) > 0)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)


def run_both(jop, draws, apply, seed, hw=(96, 96), jkw=None, akw=None,
             boxes_fn=None):
    """(port images, port boxes, JAX images, JAX boxes) for one op."""
    img, boxes = make_batch(seed, hw=hw)
    if boxes_fn is not None:
        boxes = boxes_fn(boxes)
    key = jax.random.PRNGKey(seed)
    ji, jb = jop(key, jnp.asarray(img), jnp.asarray(boxes), **(jkw or {}))
    ti, tb = apply(torch.from_numpy(img), torch.from_numpy(boxes),
                   _t(draws(key, img.shape[0], boxes.shape[1])),
                   **(akw or {}))
    return ti.numpy(), tb.numpy(), np.asarray(ji), np.asarray(jb)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

def test_adjust_cores_match_the_tf_reference():
    """The ``adjust_*`` cores against the recorded tf.image outputs, at the
    JAX test's atol 0.01 (tests/test_reference_parity.py)."""
    fix = np.load(os.path.join(FIX, 'photometric.npz'))
    img = torch.from_numpy(fix['image'])
    cases = ([(f'brightness_{d}', A.adjust_brightness(img, d))
              for d in (-0.2, 0.15)]
             + [(f'contrast_{c}', A.adjust_contrast(img, c))
                for c in (0.8, 1.3)]
             + [(f'saturation_{s}', A.adjust_saturation(img, s))
                for s in (0.7, 1.4)]
             + [(f'hue_{h}', A.adjust_hue(img, h)) for h in (-0.1, 0.08)]
             + [('grayscale', A.to_grayscale(img))])
    for name, mine in cases:
        np.testing.assert_allclose(mine.numpy(), fix[name], atol=0.01,
                                   err_msg=name)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('op', ['brightness', 'contrast', 'saturation',
                                'hue', 'grayscale'])
def test_photometric_ops_match_jax(op, seed):
    """1e-4 on the [0, 255] scale; boxes untouched."""
    table = {
        'brightness': (J.random_brightness, A.apply_brightness,
                       lambda k, b, n: jdraw_gate_value(k, b, 0.5, -0.2,
                                                        0.2)),
        'contrast': (J.random_contrast, A.apply_contrast,
                     lambda k, b, n: jdraw_gate_value(k, b, 0.5, 0.8, 1.2)),
        'saturation': (J.random_saturation, A.apply_saturation,
                       lambda k, b, n: jdraw_gate_value(k, b, 0.5, 0.8,
                                                        1.2)),
        'hue': (J.random_hue, A.apply_hue,
                lambda k, b, n: jdraw_gate_value(k, b, 0.5, -0.1, 0.1)),
        'grayscale': (J.random_grayscale, A.apply_grayscale,
                      lambda k, b, n: jdraw_gate(k, b, 0.5, (b, 1, 1, 1)))}
    jop, apply, draws = table[op]
    jkw = {'prob': 0.5} if op == 'grayscale' else None
    ti, tb, ji, jb = run_both(jop, draws, apply, seed, jkw=jkw)
    np.testing.assert_allclose(ti, ji, rtol=0, atol=PHOTO_ATOL)
    np.testing.assert_array_equal(tb, jb)


def test_hsv_round_trip_matches_jax():
    img, _ = make_batch(5)
    rgb = img / 255.0
    jh = J._rgb_to_hsv(jnp.asarray(rgb))
    th = A._rgb_to_hsv(torch.from_numpy(rgb))
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(
        A._hsv_to_rgb(*th).numpy(), np.asarray(J._hsv_to_rgb(*jh)), rtol=0,
        atol=1e-6)


# ---------------------------------------------------------------------------
# flips, rotations, filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('op', ['hflip', 'vflip', 'rotate90'])
def test_flips_and_rot90_are_exact(op, seed):
    table = {
        'hflip': (J.random_hflip, A.apply_hflip,
                  lambda k, b, n: jdraw_gate(k, b, 0.5)),
        'vflip': (J.random_vflip, A.apply_vflip,
                  lambda k, b, n: jdraw_gate(k, b, 0.5)),
        'rotate90': (J.random_rotate90, A.apply_rotate90,
                     lambda k, b, n: jdraw_rotate90(k, b, 0.9))}
    jop, apply, draws = table[op]
    ti, tb, ji, jb = run_both(jop, draws, apply, seed,
                              jkw={'prob': 0.9 if op == 'rotate90' else 0.5})
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('op', ['blur', 'sharpness', 'motion_blur',
                                'rotate_any'])
def test_filters_and_free_rotation_match_jax(op, seed):
    """1e-3 on the [0, 255] scale, boxes 1e-3 px with equal masks."""
    table = {
        'blur': (J.random_blur, A.apply_blur,
                 lambda k, b, n: jdraw_gate(k, b, 0.6, (b, 1, 1, 1))),
        'sharpness': (J.random_sharpness, A.apply_sharpness,
                      lambda k, b, n: jdraw_gate_value(k, b, 0.6, 0.0, 0.8)),
        'motion_blur': (J.random_motion_blur, A.apply_motion_blur,
                        lambda k, b, n: jdraw_motion_blur(k, b, 0.8)),
        'rotate_any': (J.random_rotate_any, A.apply_rotate_any,
                       lambda k, b, n: jdraw_gate_value(k, b, 0.8, -30.0,
                                                        30.0, (b,)))}
    jop, apply, draws = table[op]
    jkw = {'prob': {'blur': 0.6, 'sharpness': 0.6}.get(op, 0.8)}
    if op == 'rotate_any':
        jkw['max_deg'] = 30.0
    ti, tb, ji, jb = run_both(jop, draws, apply, seed, jkw=jkw)
    np.testing.assert_allclose(ti, ji, rtol=0, atol=RESAMPLE_ATOL)
    assert_boxes_close(tb, jb)


# ---------------------------------------------------------------------------
# resampling, gridmask, batch mixing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('scale', [(0.3, 0.6), (0.7, 1.3), (1.2, 1.8)])
def test_scale_and_translate_matches_jax(scale):
    """Down (antialiased), around 1 and up, at fractional offsets, on two
    canvases of unequal sides."""
    rng = np.random.RandomState(1)
    img, _ = make_batch(1, hw=(64, 96))
    s = rng.uniform(*scale, (4, 2)).astype(np.float32)
    t = rng.uniform(-20, 30, (4, 2)).astype(np.float32)
    want = np.stack([np.asarray(jax.image.scale_and_translate(
        jnp.asarray(img[i]), (64, 96, 3), (0, 1), jnp.asarray(s[i]),
        jnp.asarray(t[i]), method='linear')) for i in range(4)])
    got = A.scale_and_translate(torch.from_numpy(img), torch.from_numpy(s),
                                torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_ATOL)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_resize_crop_pad_matches_jax(seed):
    ti, tb, ji, jb = run_both(
        J.random_resize_crop_pad, lambda k, b, n: jdraw_resize(
            k, b, (0.5, 1.5), prob=0.8), A.apply_resize_crop_pad, seed,
        jkw={'scale_range': (0.5, 1.5), 'prob': 0.8})
    np.testing.assert_allclose(ti, ji, rtol=0, atol=RESAMPLE_ATOL)
    assert_boxes_close(tb, jb)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_gridmask_is_exact(seed):
    """d_range (8, 30) on the 96 canvas so the grid and the visibility
    rule both act; exact."""
    ti, tb, ji, jb = run_both(
        J.random_gridmask, lambda k, b, n: jdraw_gridmask(k, b, 0.8,
                                                          (8, 30)),
        A.apply_gridmask, seed, jkw={'prob': 0.8, 'd_range': (8, 30)})
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)


def test_integral_image_matches_jax():
    m = (np.random.RandomState(0).rand(2, 9, 7) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        A._integral_image(torch.from_numpy(m)).numpy(),
        np.stack([np.asarray(J._integral_image(jnp.asarray(x))) for x in m]))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_mosaic_matches_jax(seed):
    """Boxes at x4 capacity (mosaic's own expansion); every quadrant goes
    through the antialiased resampler (scale < 1)."""
    ti, tb, ji, jb = run_both(
        J.random_mosaic, lambda k, b, n: jdraw_mosaic(k, b, 0.8),
        A.apply_mosaic, seed, jkw={'prob': 0.8},
        boxes_fn=lambda bx: np.asarray(J.expand_box_capacity(bx, 4)))
    np.testing.assert_allclose(ti, ji, rtol=0, atol=RESAMPLE_ATOL)
    assert_boxes_close(tb, jb)


@pytest.mark.parametrize('seed', [0, 1])
def test_mixup_matches_jax(seed):
    ti, tb, ji, jb = run_both(
        J.random_mixup, lambda k, b, n: jdraw_gate_value(k, b, 0.8, 0.2,
                                                         0.8),
        A.apply_mixup, seed, jkw={'prob': 0.8},
        boxes_fn=lambda bx: np.asarray(J.expand_box_capacity(bx, 2)))
    np.testing.assert_allclose(ti, ji, rtol=0, atol=PHOTO_ATOL)
    np.testing.assert_array_equal(tb, jb)


def test_pack_valid_front_is_stable():
    _, boxes = make_batch(3)
    boxes = np.asarray(J.expand_box_capacity(boxes, 4))
    boxes = boxes[:, np.random.RandomState(0).permutation(boxes.shape[1])]
    np.testing.assert_array_equal(
        A._pack_valid_front(torch.from_numpy(boxes)).numpy(),
        np.asarray(J._pack_valid_front(jnp.asarray(boxes))))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_copypaste_matches_jax(seed):
    """Capacity +4 slots for the pastes; the donor choice is a top-k with
    ties (all invalid rows draw equal priority bonuses)."""
    ti, tb, ji, jb = run_both(
        J.random_copypaste, lambda k, b, n: jdraw_copypaste(k, b, n, 0.8, 4),
        A.apply_copypaste, seed, jkw={'prob': 0.8, 'max_paste': 4},
        akw={'max_paste': 4},
        boxes_fn=lambda bx: np.pad(bx, ((0, 0), (0, 4), (0, 0))))
    np.testing.assert_allclose(ti, ji, rtol=0, atol=RESAMPLE_ATOL)
    assert_boxes_close(tb, jb)


def test_random_ops_draw_on_the_cpu_and_apply_anywhere():
    """``random_<op>`` = draw from the generator + apply: equal to applying
    the same generator's draws by hand."""
    img, boxes = make_batch(4)
    ti, tb = torch.from_numpy(img), torch.from_numpy(boxes)
    for rop, draw, apply in [
            (A.random_hue, A.draw_hue, A.apply_hue),
            (A.random_rotate90, A.draw_rotate90, A.apply_rotate90),
            (A.random_resize_crop_pad, A.draw_resize_crop_pad,
             A.apply_resize_crop_pad)]:
        got = rop(torch.Generator().manual_seed(3), ti, tb)
        want = apply(ti, tb, draw(torch.Generator().manual_seed(3), 4))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = A.random_copypaste(torch.Generator().manual_seed(3), ti, tb,
                             prob=1.0, max_paste=2)
    want = A.apply_copypaste(ti, tb, A.draw_copypaste(
        torch.Generator().manual_seed(3), 4, boxes.shape[1], 1.0, 2),
        max_paste=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the whole stage
# ---------------------------------------------------------------------------

TRAIN_CONFIG_AUG = {'enabled': True, 'enhance_type': 'mosaic',
                    'mosaic_prob': 0.3, 'mixup_prob': 0.1}
EVERY_OP = {'enabled': True, 'enhance_type': 'gridmask', 'mosaic_prob': 0.5,
            'mixup_prob': 0.5, 'gridmask_prob': 0.5, 'copypaste_prob': 0.6,
            'copypaste_max': 3, 'blur_prob': 0.3, 'sharpness_prob': 0.3,
            'motion_blur_prob': 0.3, 'rotate_any_prob': 0.5,
            'rotate_prob': 0.3, 'grayscale_prob': 0.2}


def _freeze(cfg):
    return jpipe._freeze(cfg)


@pytest.mark.parametrize('name,cfg', [('train_config', TRAIN_CONFIG_AUG),
                                      ('every_op', EVERY_OP)])
def test_device_stage_matches_jax(name, cfg):
    """``configs/train_config.yaml``'s block, and one with every optional
    op on: the JAX stage from a key against the port's stage fed that
    key's draws.  Images, boxes and the 9-cell targets."""
    img, boxes = make_batch(11, hw=(64, 64))
    key = jax.random.PRNGKey(7)
    ji, jy, jb = jpipe._device_stage(
        jnp.asarray(img.round().clip(0, 255).astype(np.uint8)),
        jnp.asarray(boxes), key, _freeze(cfg),
        tuple(tuple(map(tuple, a.tolist())) for a in ANCHORS), NC, (64, 64),
        True)
    draws = _t(jdraw_chain(key, 4, boxes.shape[1], cfg))
    ti, ty, tb = P._device_stage(
        torch.from_numpy(img.round().clip(0, 255).astype(np.uint8)), boxes,
        None, cfg, ANCHORS, NC, (64, 64), True, draws=draws)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                               atol=RESAMPLE_ATOL / 255.0)
    assert tb.shape == jb.shape
    assert_boxes_close(tb.numpy(), jb)
    for a, b in zip(ty, jy):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(a[..., 4:], b[..., 4:])
        np.testing.assert_allclose(a[..., :4], b[..., :4], rtol=0,
                                   atol=TARGET_ATOL)


def _valid_np(boxes):
    return ((boxes[..., 2] - boxes[..., 0]) > 0) & (
        (boxes[..., 3] - boxes[..., 1]) > 0)


@pytest.mark.parametrize('cfg,factor,extra', [
    ({'mosaic_prob': 0.5, 'mixup_prob': 0.5}, 8, 0),
    ({'mosaic_prob': 0.5}, 4, 0),
    ({'mixup_prob': 0.5}, 2, 0),
    ({'mixup_prob': 0.5, 'copypaste_prob': 0.5, 'copypaste_max': 3}, 2, 3),
    ({}, 1, 0)])
def test_chain_invariants(cfg, factor, extra):
    """Capacity x8/x4/x2/x1 plus the copy-paste slots; every box inside
    the canvas and at least MIN_BOX_PX a side; the stage is a function of
    the generator's seed."""
    img, boxes = make_batch(2, hw=(64, 64))
    cfg = dict(cfg, enabled=True, rotate_any_prob=0.3)
    for seed in range(3):
        out = [P._device_stage(torch.from_numpy(img.astype(np.uint8)),
                               boxes, torch.Generator().manual_seed(seed),
                               cfg, ANCHORS, NC, (64, 64), True)
               for _ in range(2)]
        (i1, _, b1), (i2, _, b2) = out
        assert torch.equal(i1, i2) and torch.equal(b1, b2)
        b1 = b1.numpy()
        assert b1.shape == (4, 6 * factor + extra, 5)
        v = _valid_np(b1)
        assert v.any()
        live = b1[v]
        assert (live[:, :4] >= 0).all() and (live[:, [0, 2]] <= 64).all()
        assert (live[:, [1, 3]] <= 64).all()
        assert (live[:, 2] - live[:, 0] >= A.MIN_BOX_PX).all()
        assert (live[:, 3] - live[:, 1] >= A.MIN_BOX_PX).all()


def test_mixup_loses_no_valid_box():
    """After mosaic has scattered the boxes over its quadrant sections,
    mixup (x8 capacity) keeps every valid box of both images."""
    _, boxes = make_batch(6, n=6)
    boxes = np.asarray(J.expand_box_capacity(boxes, 8))
    spread = boxes.copy()
    # boxes in every quarter of the capacity, as mosaic leaves them
    for q in range(4):
        spread[:, q * 12:q * 12 + 6] = boxes[:, :6]
    img = np.zeros((4, 8, 8, 3), np.float32)
    draws = {'apply': torch.ones(4, dtype=torch.bool),
             'value': torch.full((4,), 0.5)}
    _, out = A.apply_mixup(torch.from_numpy(img), torch.from_numpy(spread),
                           draws)
    out = out.numpy()
    nv = _valid_np(spread).sum(1)
    assert (_valid_np(out).sum(1) == nv + np.roll(nv, -1)).all()


def test_turning_one_op_on_leaves_the_other_draws():
    """Each op draws from a generator of its own slot: enabling blur,
    gridmask or copy-paste leaves every other op's draws equal."""
    base = {'enabled': True, 'mosaic_prob': 0.3, 'mixup_prob': 0.1}
    ref = P.draw_chain(torch.Generator().manual_seed(5), 4, 6, base)
    for extra in ({'blur_prob': 0.2}, {'enhance_type': 'gridmask'},
                  {'copypaste_prob': 0.2}, {'rotate_any_prob': 0.1},
                  {'sharpness_prob': 0.1, 'motion_blur_prob': 0.1}):
        got = P.draw_chain(torch.Generator().manual_seed(5), 4, 6,
                           dict(base, **extra))
        assert set(ref) < set(got)
        for op, draws in ref.items():
            for k, v in draws.items():
                assert torch.equal(got[op][k], v), (extra, op, k)
