"""The port's Weighted Boxes Fusion and decoder facade against JAX.

``postprocess/wbf.py`` is the port's own copy of host numpy code: its
outputs equal the JAX function's exactly (tolerance zero) in both modes,
and its 'reference' mode matches the recorded reference fixtures
(``tests/fixtures/reference/wbf.npz``) at the tolerance of
``tests/test_reference_parity.py`` (boxes 1e-4, scores 1e-6).
``MultiGridDecoder`` runs decode and NMS in PyTorch on the CPU: on the
same logits its classes and counts equal JAX's, boxes agree to 1e-3
image pixels and scores to 1e-5 (float32 decode rounds differently in
the two frameworks, ~1e-6 relative).
"""

import json
import os

import numpy as np
import pytest

from multigriddet_tpu.postprocess import MultiGridDecoder as JaxDecoder
from multigriddet_tpu.postprocess import wbf as jax_wbf
from multigriddet_tpu_torch.postprocess import MultiGridDecoder, wbf

FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'reference')
SCENARIOS = ['clustered', 'maxconf', 'chain', 'ties', 'skipthr',
             'ensemble', 'allskip']


@pytest.fixture(scope='module')
def wbf_fix():
    return np.load(os.path.join(FIX, 'wbf.npz'))


@pytest.fixture(scope='module')
def wbf_cfg():
    with open(os.path.join(FIX, 'wbf_configs.json')) as f:
        return json.load(f)


def _fixture_args(wbf_fix, wbf_cfg, name, mode):
    kw = wbf_cfg[name]
    models = (wbf_fix[f'{name}_in_models']
              if f'{name}_in_models' in wbf_fix else None)
    args = (wbf_fix[f'{name}_in_boxes'], wbf_fix[f'{name}_in_scores'],
            wbf_fix[f'{name}_in_classes'])
    return args, dict(iou_thr=kw['iou_thr'],
                      score_thr=kw.get('skip_box_thr', 0.0),
                      conf_type=kw.get('conf_type', 'avg'), mode=mode,
                      models=models, model_weights=kw.get('weights'))


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('name', SCENARIOS)
def test_reference_mode_matches_fixtures_and_jax(wbf_fix, wbf_cfg, name):
    args, kw = _fixture_args(wbf_fix, wbf_cfg, name, 'reference')
    fb, fs, fc = wbf.weighted_boxes_fusion(*args, **kw)
    np.testing.assert_allclose(fb, wbf_fix[f'{name}_boxes'], atol=1e-4)
    np.testing.assert_array_equal(fc, wbf_fix[f'{name}_classes'])
    np.testing.assert_allclose(fs, wbf_fix[f'{name}_scores'], atol=1e-6)
    _equal((fb, fs, fc), jax_wbf.weighted_boxes_fusion(*args, **kw))


@pytest.mark.parametrize('name', SCENARIOS)
def test_paper_mode_equals_jax_on_fixtures(wbf_fix, wbf_cfg, name):
    args, kw = _fixture_args(wbf_fix, wbf_cfg, name, 'paper')
    _equal(wbf.weighted_boxes_fusion(*args, **kw),
           jax_wbf.weighted_boxes_fusion(*args, **kw))


def _random_pool(seed, n=60):
    rng = np.random.RandomState(seed)
    centers = rng.rand(6, 2) * 300
    pick = rng.randint(0, 6, n)
    xy = centers[pick] + rng.randn(n, 2) * 6
    wh = rng.rand(n, 2) * 30 + 40
    boxes = np.concatenate([xy, wh], 1).astype(np.float32)
    scores = rng.rand(n).round(2).astype(np.float32)      # ties
    classes = rng.randint(0, 3, n).astype(np.int32)
    return boxes, classes, scores


@pytest.mark.parametrize('mode', ['paper', 'reference'])
@pytest.mark.parametrize('conf_type', ['avg', 'max', 'box_and_model_avg'])
def test_random_pools_equal_jax(mode, conf_type):
    boxes, classes, scores = _random_pool(1)
    kw = dict(iou_thr=0.5, score_thr=0.1, conf_type=conf_type, mode=mode)
    _equal(wbf.weighted_boxes_fusion(boxes, scores, classes, **kw),
           jax_wbf.weighted_boxes_fusion(boxes, scores, classes, **kw))
    with pytest.raises(ValueError):
        wbf.weighted_boxes_fusion(boxes, scores, classes, mode='other')


@pytest.mark.parametrize('mode', ['paper', 'reference'])
@pytest.mark.parametrize('max_out', [None, 5, 1000])
def test_fuse_and_cap_equals_jax(mode, max_out):
    boxes, classes, scores = _random_pool(2)
    got = wbf.fuse_and_cap(boxes, classes, scores, 0.45, mode, max_out)
    want = jax_wbf.fuse_and_cap(boxes, classes, scores, 0.45, mode,
                                max_out)
    _equal(got, want)
    if max_out == 5:
        assert len(got[0]) == 5
    empty = np.zeros((0, 4), np.float32)
    out = wbf.fuse_and_cap(empty, np.zeros(0, np.int32),
                           np.zeros(0, np.float32), 0.45, mode, max_out)
    assert all(len(a) == 0 for a in out)


@pytest.mark.parametrize('use_wbf', [False, True])
def test_decoder_facade_matches_jax(use_wbf):
    """The decoder of tests/test_inference.py:66-84, on the same logits
    through both frameworks."""
    rng = np.random.RandomState(2)
    anchors = [np.array([[40, 40], [30, 50]], np.float32),
               np.array([[20, 20], [15, 25]], np.float32),
               np.array([[10, 10], [8, 12]], np.float32)]
    preds = [rng.randn(1, g, g, 5 + 2 + 2).astype(np.float32) * 2
             for g in (2, 4, 8)]
    kw = dict(confidence=0.1, use_wbf=use_wbf, max_boxes=20)
    got = MultiGridDecoder(anchors, 2, (64, 64), device='cpu',
                           **kw).postprocess(preds, (48, 80))
    want = JaxDecoder(anchors, 2, (64, 64), **kw).postprocess(preds,
                                                              (48, 80))
    gb, gc, gs = got
    wb, wc, ws = (np.asarray(a) for a in want)
    assert len(gb) > 3 and len(gb) == len(wb)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    # xyxy, clipped to the original image
    assert (gb[:, 0] >= 0).all() and (gb[:, 2] <= 80).all()
    assert (gb[:, 1] >= 0).all() and (gb[:, 3] <= 48).all()
