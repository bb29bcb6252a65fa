"""The port's mAP metrics against the JAX package's, on the CPU.

``multigriddet_tpu_torch.evaluation.metrics`` is the port's own copy of
host numpy code, so the tolerance is zero: on the same prediction and
ground-truth dicts every number of ``calculate_map`` and
``calculate_map_reference`` equals the JAX function's bit for bit (with
the per-class thread pool on and off, COCO and VOC interpolation), the
native matcher equals the numpy matcher, and ``format_results`` gives the
same text.  The reference mode is also held against the recorded
reference fixtures (``tests/fixtures/reference/map.npz``) at the
tolerance of ``tests/test_metrics_parity.py`` (1e-9).
"""

import json
import os

import numpy as np
import pytest

from multigriddet_tpu.evaluation import metrics as jax_metrics
from multigriddet_tpu_torch.data import native
from multigriddet_tpu_torch.evaluation import metrics

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), 'fixtures',
                           'reference')
THRESHOLDS = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95]


def random_dicts(seed, n_images=12, num_classes=5):
    """Predictions near the ground truth plus false positives, with score
    ties, an image without predictions, one without ground truth and a
    prediction-only class."""
    rng = np.random.RandomState(seed)
    preds, gts = {}, {}
    for img in range(n_images):
        m = rng.randint(0, 6) if img != 3 else 0
        xy = rng.rand(m, 2) * 200
        wh = rng.rand(m, 2) * 120 + 4
        gb = np.concatenate([xy, wh], 1).astype(np.float32)
        gc = rng.randint(0, num_classes - 1, m).astype(np.int32)
        gts[img] = {'boxes': gb, 'classes': gc}
        if img == 5:
            continue
        k = rng.randint(0, 5)
        pb = np.concatenate([gb + rng.randn(m, 4).astype(np.float32) * 6,
                             np.concatenate([rng.rand(k, 2) * 200,
                                             rng.rand(k, 2) * 80 + 4], 1)])
        pc = np.concatenate([gc, rng.randint(0, num_classes, k)])
        sc = rng.rand(m + k).round(1)          # ties
        preds[img] = {'boxes': pb.astype(np.float32),
                      'classes': pc.astype(np.int32),
                      'scores': sc.astype(np.float32)}
    return preds, gts


def assert_same(got, want, path=''):
    """Equal structure and values (NaN equal to NaN), no tolerance."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{path}[{i}]')
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('interp', ['coco', 'voc'])
@pytest.mark.parametrize('parallel', [False, True])
def test_calculate_map_equals_jax(seed, interp, parallel):
    preds, gts = random_dicts(seed)
    kw = dict(interpolation_method=interp, use_parallel=parallel,
              class_names=list('abcde'))
    got = metrics.calculate_map(preds, gts, 5, **kw)
    want = jax_metrics.calculate_map(preds, gts, 5, **kw)
    assert want['mAP'] > 0
    assert_same(got, want)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('interp', ['coco', 'voc'])
@pytest.mark.parametrize('cache_ious', [True, False])
def test_calculate_map_reference_equals_jax(seed, interp, cache_ious):
    preds, gts = random_dicts(seed)
    kw = dict(interpolation_method=interp, cache_ious=cache_ious)
    got = metrics.calculate_map_reference(preds, gts, 5, **kw)
    want = jax_metrics.calculate_map_reference(preds, gts, 5, **kw)
    assert_same(got, want)


def test_optimize_classes_off_and_empty_inputs():
    preds, gts = random_dicts(2)
    for kw in ({'optimize_classes': False},
               {'compute_size_breakdown': False},
               {'iou_thresholds': (0.5, 0.7)}):
        assert_same(metrics.calculate_map(preds, gts, 5, **kw),
                    jax_metrics.calculate_map(preds, gts, 5, **kw))
    assert_same(metrics.calculate_map({}, {}, 3),
                jax_metrics.calculate_map({}, {}, 3))
    assert_same(metrics.calculate_map_reference({}, {}, 3),
                jax_metrics.calculate_map_reference({}, {}, 3))


@pytest.fixture(scope='module')
def recorded():
    npz = np.load(os.path.join(FIXTURE_DIR, 'map.npz'))
    with open(os.path.join(FIXTURE_DIR, 'map_values.json')) as f:
        values = json.load(f)
    return npz, values


def _to_dict_format(npz, name):
    """The recorded scenario in the dict-of-image format (top-left xywh),
    keeping the recorder's insertion order per image."""
    predictions, ground_truths = {}, {}
    p_img, g_img = npz[f'{name}_pred_img'], npz[f'{name}_gt_img']

    def xywh(b):
        out = b.copy()
        out[:, 2] -= out[:, 0]
        out[:, 3] -= out[:, 1]
        return out

    for img in np.unique(np.concatenate([p_img, g_img])):
        pm, gm = p_img == img, g_img == img
        predictions[int(img)] = {
            'boxes': xywh(npz[f'{name}_pred_box'][pm]).astype(np.float64),
            'classes': npz[f'{name}_pred_cls'][pm].astype(np.int64),
            'scores': npz[f'{name}_pred_score'][pm].astype(np.float64)}
        ground_truths[int(img)] = {
            'boxes': xywh(npz[f'{name}_gt_box'][gm]).astype(np.float64),
            'classes': npz[f'{name}_gt_cls'][gm].astype(np.int64)}
    return predictions, ground_truths


def _assert_close(res, ref, path=''):
    for k, v in ref.items():
        assert k in res, f'missing key {path}{k}'
        if isinstance(v, dict):
            _assert_close(res[k], v, path=f'{path}{k}/')
        else:
            np.testing.assert_allclose(res[k], v, atol=1e-9, rtol=1e-9,
                                       err_msg=f'mismatch at {path}{k}')


@pytest.mark.parametrize('scenario', ['crowded', 'absent', 'sizes'])
@pytest.mark.parametrize('run', ['coco', 'voc', 'coco_nocache'])
def test_reference_mode_matches_recorded_fixtures(recorded, scenario, run):
    npz, values = recorded
    predictions, ground_truths = _to_dict_format(npz, scenario)
    kw = dict(interpolation_method='voc') if run == 'voc' else {}
    if run == 'coco_nocache':
        kw['cache_ious'] = False
    res = metrics.calculate_map_reference(predictions, ground_truths, 5,
                                          THRESHOLDS, **kw)
    _assert_close(res, values[f'{scenario}/{run}'])


@pytest.mark.parametrize('scenario', ['crowded', 'absent', 'sizes'])
def test_native_mode_on_recorded_scenarios(recorded, scenario):
    """Native mode on the recorded scenarios: equal to the JAX function,
    and at or above the reference's trapz AP (the rectangle below the
    first recall point that trapz drops; test_metrics_parity.py)."""
    npz, values = recorded
    predictions, ground_truths = _to_dict_format(npz, scenario)
    got = metrics.calculate_map(predictions, ground_truths, 5, THRESHOLDS)
    assert_same(got, jax_metrics.calculate_map(predictions, ground_truths,
                                               5, THRESHOLDS))
    if scenario != 'absent':      # 'absent' has a prediction-only class
        assert got['mAP50'] >= values[f'{scenario}/coco']['mAP50'] - 1e-9


@pytest.mark.parametrize('seed', range(4))
def test_native_matcher_equals_numpy(seed):
    rng = np.random.RandomState(seed)
    n, m = rng.randint(1, 40), rng.randint(1, 12)
    scores = rng.rand(n).round(1).astype(np.float32)       # ties
    ious = rng.rand(n, m).astype(np.float32)
    ious[ious < 0.4] = 0.0
    ious[:, 0] = ious[:, 1] if m > 1 else ious[:, 0]        # equal columns
    thr = np.asarray(THRESHOLDS, np.float64)
    assert native.matcher_available()
    got = native.match_all_thresholds(scores, ious, thr)
    want = metrics._match_all_thresholds_np(scores, ious, thr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_metrics._match_all_thresholds_np(scores, ious, thr))


def test_calculate_map_same_through_numpy_matcher(monkeypatch):
    preds, gts = random_dicts(3)
    with_native = metrics.calculate_map(preds, gts, 5)
    monkeypatch.setattr(native, 'matcher_available', lambda: False)
    assert_same(metrics.calculate_map(preds, gts, 5), with_native)


@pytest.mark.parametrize('mode', ['native', 'reference'])
def test_format_results_same_text(mode):
    preds, gts = random_dicts(4)
    fn = 'calculate_map' if mode == 'native' else 'calculate_map_reference'
    got = getattr(metrics, fn)(preds, gts, 5, class_names=list('abcde'))
    want = getattr(jax_metrics, fn)(preds, gts, 5, class_names=list('abcde'))
    for top_k in (2, 20):
        assert (metrics.format_results(got, top_k)
                == jax_metrics.format_results(want, top_k))


def test_helpers_equal_jax():
    rng = np.random.RandomState(5)
    a = (rng.rand(7, 4) * 50).astype(np.float32)
    b = (rng.rand(5, 4) * 50).astype(np.float32)
    np.testing.assert_array_equal(metrics.iou_matrix(a, b),
                                  jax_metrics.iou_matrix(a, b))
    s = rng.rand(7).astype(np.float32)
    np.testing.assert_array_equal(metrics.match_detections(a, s, b, 0.1),
                                  jax_metrics.match_detections(a, s, b, 0.1))
    r = np.sort(rng.rand(9))
    p = rng.rand(9)
    for method in ('coco', 'voc'):
        assert (metrics.average_precision(r, p, method)
                == jax_metrics.average_precision(r, p, method))
    preds, gts = random_dicts(6)
    assert_same(metrics._filter_area(preds, gts, 1024.0, 9216.0),
                jax_metrics._filter_area(preds, gts, 1024.0, 9216.0))
