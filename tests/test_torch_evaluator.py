"""The port's evaluator, eval CLI and report plots against the JAX
package's, on the CPU (and, marked ``cuda``, on the card).

Setup: ``multigriddet_tiny`` at 64x64 with two classes, 11 PIL-written
JPEG images plus one corrupt file, and one msgpack weights bundle written
by the JAX checkpoint code and read by both evaluators.  The ground truth
is taken from a first evaluation's detections, so the mAPs are large
enough to compare.  With ``link_format: rgb`` at float32, for the ``xla``
and ``pallas_fused`` backends and both metric modes:

* per image, the classes and the number of detections are equal;
* boxes agree to 2e-3 image pixels and scores to 1e-5 (the forward and
  decode round differently in the two frameworks, ~1e-6 relative, and
  the letterbox inverse scales canvas pixels by up to 1.5);
* every mAP number agrees to 1e-6 (IoUs move by ~1e-5 with the boxes);
* ``evaluation_results.json`` has the same keys.

The card's test (``python -m pytest --noconftest -m cuda
tests/test_torch_evaluator.py``) needs no JAX and no Pillow.
"""

import json
import os

import numpy as np
import pytest
import torch

from multigriddet_tpu_torch.evaluation import (MultiGridEvaluator,
                                               generate_evaluation_report)
from multigriddet_tpu_torch.models import (create_model,
                                           random_flax_variables)
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

HW = (64, 64)
N_IMAGES = 11


def write_model_files(root):
    anchors = os.path.join(root, 'anchors.txt')
    with open(anchors, 'w') as f:
        f.write('40,40 30,50 50,30\n20,20 15,25 25,15\n10,10 8,12 12,8\n')
    classes = os.path.join(root, 'classes.txt')
    with open(classes, 'w') as f:
        f.write('a\nb\n')
    return anchors, classes


def eval_config(root, annotation, weights, backend='xla', mode='native',
                **ev):
    anchors, classes = write_model_files(root)
    evaluation = {
        'batch_size': 4, 'confidence_threshold': 0.05,
        'nms_threshold': 0.45, 'nms_method': 'diou', 'use_iol': True,
        'max_detections': 500, 'link_format': 'rgb',
        'nms_backend': backend, 'metrics_mode': mode,
        'pipeline_depth': 1, 'num_workers': 2, 'save_detections': True,
        'results_dir': os.path.join(root, f'results_{backend}_{mode}')}
    evaluation.update(ev)
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': 2,
            'input_shape': [*HW, 3], 'anchors_path': anchors,
            'classes_path': classes}},
        'environment': {'mixed_precision': False},
        'weights_path': weights,
        'data': {'annotation': annotation, 'classes_path': classes},
        'evaluation': evaluation,
    }


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """Images, the JAX-written weights bundle, and an annotation file
    whose ground truth comes from a first evaluation's detections."""
    from PIL import Image
    save_params = pytest.importorskip(
        'multigriddet_tpu.training.checkpoint').save_params
    root = str(tmp_path_factory.mktemp('eval'))
    rng = np.random.RandomState(0)
    paths = []
    for i in range(N_IMAGES):
        h, w = [(48, 80), (64, 64), (70, 40)][i % 3]
        low = rng.randint(0, 256, (h // 4, w // 4, 3)).astype(np.uint8)
        p = os.path.join(root, f'img_{i}.jpg')
        Image.fromarray(low).resize((w, h), Image.BICUBIC).save(p,
                                                                quality=95)
        paths.append(p)
    corrupt = os.path.join(root, 'corrupt.jpg')
    with open(corrupt, 'wb') as f:
        f.write(b'not a jpeg')
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=3)
    weights = os.path.join(root, 'weights.msgpack')
    save_params(weights, {'params': params, 'batch_stats': stats})

    bare = os.path.join(root, 'bare.txt')
    with open(bare, 'w') as f:
        f.write('\n'.join(paths) + '\n')
    first = MultiGridEvaluator(
        eval_config(root, bare, weights, save_results=False), device='cpu')
    first.evaluate()
    lines = []
    for i, p in enumerate(paths):
        pred = first.predictions[i]
        top = np.argsort(-pred['scores'], kind='stable')[:3]
        toks = [f'{x:.1f},{y:.1f},{x + w:.1f},{y + h:.1f},{c}'
                for (x, y, w, h), c in zip(pred['boxes'][top],
                                           pred['classes'][top])]
        toks.append(f'2,3,30,40,{i % 2}')            # one missed box each
        lines.append(' '.join([p] + toks))
    lines.append(f'{corrupt} 5,5,30,30,1')            # a failed image
    annotation = os.path.join(root, 'ann.txt')
    with open(annotation, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return root, annotation, weights


def _jax_evaluator(config):
    jax_eval = pytest.importorskip('multigriddet_tpu.evaluation')
    return jax_eval.MultiGridEvaluator(config)


@pytest.mark.parametrize('backend', ['xla', 'pallas_fused'])
@pytest.mark.parametrize('mode', ['native', 'reference'])
def test_evaluator_matches_jax(dataset, backend, mode):
    root, annotation, weights = dataset
    ours = MultiGridEvaluator(
        eval_config(root, annotation, weights, backend, mode), device='cpu')
    assert ours.link_format == 'rgb' and ours.device.type == 'cpu'
    got = ours.evaluate()
    jcfg = eval_config(root, annotation, weights, backend, mode)
    jcfg['evaluation']['results_dir'] += '_jax'
    theirs = _jax_evaluator(jcfg)
    want = theirs.evaluate()

    assert got['num_images'] == want['num_images'] == N_IMAGES + 1
    assert set(ours.predictions) == set(theirs.predictions)
    total = 0
    for img, p in ours.predictions.items():
        q = theirs.predictions[img]
        assert len(p['boxes']) == len(q['boxes']), img
        total += len(p['boxes'])
        np.testing.assert_array_equal(p['classes'], q['classes'])
        np.testing.assert_allclose(p['boxes'], q['boxes'], rtol=0,
                                   atol=2e-3)
        np.testing.assert_allclose(p['scores'], q['scores'], rtol=0,
                                   atol=1e-5)
        g, h = ours.ground_truths[img], theirs.ground_truths[img]
        np.testing.assert_array_equal(g['boxes'], h['boxes'])
        np.testing.assert_array_equal(g['classes'], h['classes'])
    assert total > 3 * N_IMAGES
    # the corrupt image: its ground truth counts, it gets no predictions
    assert len(ours.predictions[N_IMAGES]['boxes']) == 0
    assert len(ours.ground_truths[N_IMAGES]['boxes']) == 1

    for key in ('mAP', 'mAP50', 'mAP75', 'mAP_small', 'mAP_medium',
                'mAP_large'):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    assert got['mAP50'] > 0.1
    for name, info in want['per_class_ap'].items():
        assert abs(got['per_class_ap'][name]['ap'] - info['ap']) <= 1e-6
        assert got['per_class_ap'][name]['count'] == info['count']
    np.testing.assert_array_equal(got['gt_counts'], want['gt_counts'])

    files = {}
    for ev, tag in ((ours, 'ours'), (theirs, 'jax')):
        with open(os.path.join(ev.results_dir,
                               'evaluation_results.json')) as f:
            files[tag] = json.load(f)
        with open(os.path.join(ev.results_dir, 'detections.json')) as f:
            assert len(json.load(f)) == total
    assert set(files['ours']) == set(files['jax'])


def test_evaluator_wbf_and_annotated_images(dataset):
    root, annotation, weights = dataset
    cfg = eval_config(root, annotation, weights, use_wbf=True,
                      max_detections=7)
    cfg['visualizations'] = {'save_annotated_images': {
        'enabled': True, 'max_images': 2,
        'save_dir': os.path.join(root, 'annotated')}}
    ours = MultiGridEvaluator(cfg, device='cpu')
    got = ours.evaluate()
    theirs = _jax_evaluator(cfg)
    want = theirs.evaluate()
    for img, p in ours.predictions.items():
        q = theirs.predictions[img]
        assert len(p['boxes']) == len(q['boxes']) <= 7
        np.testing.assert_array_equal(p['classes'], q['classes'])
        np.testing.assert_allclose(p['boxes'], q['boxes'], rtol=0,
                                   atol=2e-3)
    assert abs(got['mAP'] - want['mAP']) <= 1e-6
    assert sorted(os.listdir(os.path.join(root, 'annotated'))) == [
        'eval_000000.jpg', 'eval_000001.jpg']


def test_eval_cli_on_cpu(dataset, capsys):
    import yaml

    from multigriddet_tpu_torch.eval import main
    root, annotation, weights = dataset
    cfg = eval_config(root, annotation, weights, results_dir=os.path.join(
        root, 'cli'))
    path = os.path.join(root, 'eval.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    assert main(['--config', path, '--device', 'cpu', '--max-images', '5',
                 '--batch-size', '2', '--conf', '0.1']) == 0
    out = capsys.readouterr().out
    assert 'mAP@0.5:0.95' in out and 'img/s' in out
    with open(os.path.join(root, 'cli', 'evaluation_results.json')) as f:
        assert json.load(f)['num_images'] == 5


def test_generate_evaluation_report(dataset, tmp_path):
    pytest.importorskip('matplotlib')
    root, annotation, weights = dataset
    ev = MultiGridEvaluator(eval_config(root, annotation, weights,
                                        save_results=False), device='cpu')
    results = ev.evaluate()
    jax_viz = pytest.importorskip('multigriddet_tpu.evaluation.'
                                  'visualizations')
    produced = {}
    for tag, fn in (('ours', generate_evaluation_report),
                    ('jax', jax_viz.generate_evaluation_report)):
        cfg = {'output': {'save_dir': str(tmp_path / tag), 'dpi': 40},
               'pr_curves': {'top_k': 2}}
        produced[tag] = fn(results, ev.predictions, ev.ground_truths,
                           ev.class_names, cfg)
    assert set(produced['ours']) == set(produced['jax']) == {
        'pr_curves', 'per_class_ap', 'confusion_matrix', 'iou_distribution',
        'confidence_analysis'}
    for path in produced['ours'].values():
        assert os.path.exists(path)
    assert (sorted(os.listdir(tmp_path / 'ours' / 'pr_curves'))
            == sorted(os.listdir(tmp_path / 'jax' / 'pr_curves')))


# ---------------------------------------------------------------------------
# in-memory batches, on the CPU and on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('device', [
    'cpu', pytest.param('cuda', marks=pytest.mark.cuda)])
def test_evaluate_batches_against_plain_popmax(tmp_path, device):
    """In-memory batches through ``_evaluate_batches`` with
    ``pallas_fused``, the ground truth made by the plain pop-max on the
    same candidate pools: the predictions equal it exactly, mAP over the
    boxes at least 0.1 px a side is 1 (the letterbox inverse clips boxes
    wholly in the gray bands to zero area, and those match nothing), and
    on the card the kernel ran once per batch."""
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc (the kernels build at '
                    'first use); run with -m cuda on the card')
    from multigriddet_tpu_torch.evaluation.metrics import calculate_map
    from multigriddet_tpu_torch.models import load_flax_variables
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.ops.geometry import canvas_boxes_to_image
    from multigriddet_tpu_torch.training.steps import candidate_pool
    dev = torch.device(device)
    cfg = eval_config(str(tmp_path), None, None, 'pallas_fused',
                      save_results=False)
    ev = MultiGridEvaluator(cfg, device=dev)
    load_flax_variables(ev.model, *random_flax_variables(ev.model, seed=3))
    rng = np.random.RandomState(1)
    items, plain = [], {}
    for k in range(3):
        batch = np.full((4, *HW, 3), 128, np.uint8)     # 80x48 letterboxed
        batch[:, 8:56] = rng.randint(0, 256, (4, 48, 64, 3))
        with torch.inference_mode():
            pool = candidate_pool(
                ev.model, torch.from_numpy(batch).to(dev).float() / 255.0,
                ev.spec['anchors'], HW)
            b, c, s, v = (t.cpu().numpy() for t in cuda_nms.popmax_nms_plain(
                *pool, 0.05, 0.45, 500, 'diou', True))
        metas = []
        for i in range(len(batch)):
            xywh = canvas_boxes_to_image(b[i][v[i]], (48, 80), HW)
            plain[4 * k + i] = (xywh, c[i][v[i]], s[i][v[i]])
            gt = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:],
                                 c[i][v[i]][:, None]], 1).astype(np.float32)
            metas.append((4 * k + i, gt, 48, 80, None, False))
        items.append(((batch,), metas))
    cuda_nms.popmax_nms.launches = 0
    ev._evaluate_batches(items)
    assert cuda_nms.popmax_nms.launches == (3 if device == 'cuda' else 0)
    for img, (b, c, s) in plain.items():
        p = ev.predictions[img]
        np.testing.assert_array_equal(p['boxes'], b)
        np.testing.assert_array_equal(p['classes'], c)
        np.testing.assert_array_equal(p['scores'], s)
    keeps = {img: (p['boxes'][:, 2] >= 0.1) & (p['boxes'][:, 3] >= 0.1)
             for img, p in ev.predictions.items()}
    assert sum(k.sum() for k in keeps.values()) > 20

    def sized(d):
        return {img: {key: val[keeps[img]] for key, val in p.items()}
                for img, p in d.items()}

    res = calculate_map(sized(ev.predictions), sized(ev.ground_truths), 2)
    assert abs(res['mAP'] - 1.0) <= 1e-6, res['mAP']
