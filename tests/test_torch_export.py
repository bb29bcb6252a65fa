"""Serving export of the port: ``torch.export`` artifacts against the JAX
package's ``jax.export`` artifacts and against the port's live step.

``multigriddet_tiny`` at 64x64, 3 classes, the JAX test's knobs
(``confidence=0.05, max_boxes=10, pre_nms_top_k=64``), the same flax
weights in both frameworks (the JAX init, through the weight bridge),
programs for batches 2 and 4:

* the port's ``ServingModel`` against the JAX ``ServingModel``: classes,
  valid masks and order equal, boxes and scores within 2e-5 (the JAX
  test's own tolerance);
* the port's artifact against the port's live step: bit-equal on the CPU;
* the JAX test's other cases on the port: padding (b1 runs the b2
  program), chunking (b7 runs as 4 + 3), an unbatched image, the
  ``letterbox`` and ``pallas`` errors, ``use_wbf`` outputs; the soft-NMS
  sweep exported as a loop; the CLI with ``--check``.

JAX is imported inside the fixtures, so that the card's test
(``python -m pytest --noconftest -m cuda tests/test_torch_export.py``, on
a host without JAX) collects this file.
"""

import json
import os

import numpy as np
import pytest
import torch

from multigriddet_tpu_torch.inference.export import (ServingModel,
                                                     export_serving)
from multigriddet_tpu_torch.models import (create_model, load_flax_variables,
                                           random_flax_variables)
from multigriddet_tpu_torch.training.steps import (fetch_detections,
                                                   make_infer_step)

HW = (64, 64)
NC = 3
KW = dict(confidence=0.05, max_boxes=10, pre_nms_top_k=64)
ANCHORS = [np.array([[40, 40], [20, 20], [10, 10]], np.float32) / f
           for f in (1, 2, 4)]


def _live(model, images, **kw):
    step = make_infer_step(model, ANCHORS, HW, **dict(KW, **kw))
    dev = next(model.parameters()).device
    return fetch_detections(step(torch.from_numpy(images).to(dev)))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope='module')
def weights():
    """The JAX init of ``multigriddet_tiny`` (the JAX test's weights)."""
    import jax
    import jax.numpy as jnp
    from multigriddet_tpu.models import create_model as jax_create_model
    jmodel = jax_create_model('multigriddet_tiny', num_classes=NC)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = create_model('multigriddet_tiny', num_classes=NC)
    load_flax_variables(model, variables['params'],
                        variables['batch_stats'])
    return jmodel, variables, model


@pytest.fixture(scope='module')
def artifact(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp('serving')
    meta = export_serving(weights[2], ANCHORS, HW, str(out),
                          batch_sizes=[2, 4], class_names=['a', 'b', 'c'],
                          device='cpu', **KW)
    return out, meta


@pytest.fixture(scope='module')
def serving(artifact):
    return ServingModel(str(artifact[0]), device='cpu')


def test_metadata(artifact):
    out, meta = artifact
    on_disk = json.loads((out / 'metadata.json').read_text())
    assert on_disk == meta
    assert meta['format'] == 'multigriddet_tpu_torch.serving/1'
    assert meta['input_hw'] == list(HW)
    assert meta['input_dtype'] == 'uint8'
    assert meta['platforms'] == ['cpu']
    assert set(meta['programs']) == {'2', '4'}
    assert meta['class_names'] == ['a', 'b', 'c']
    assert meta['outputs'] == ['boxes_xywh_canvas', 'classes', 'scores',
                               'valid']
    assert meta['params'] == KW
    for name in meta['programs'].values():
        assert (out / name).stat().st_size > 0


def test_serving_model_matches_the_jax_artifact(weights, serving,
                                                tmp_path):
    from multigriddet_tpu.inference.export import \
        ServingModel as JaxServingModel
    from multigriddet_tpu.inference.export import \
        export_serving as jax_export_serving
    jmodel, variables, _ = weights
    jax_export_serving(jmodel, variables, ANCHORS, HW, str(tmp_path),
                       batch_sizes=[2, 4], class_names=['a', 'b', 'c'],
                       platforms=('cpu',), **KW)
    jserving = JaxServingModel(str(tmp_path))
    assert serving.batch_sizes == jserving.batch_sizes == [2, 4]
    rng = np.random.RandomState(0)
    for n in (2, 4):
        imgs = rng.randint(0, 255, (n, *HW, 3)).astype(np.uint8)
        got, want = serving(imgs), [np.asarray(o) for o in jserving(imgs)]
        (gb, gc, gs, gv), (wb, wc, ws, wv) = got, want
        assert gv.any()
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gc[gv], wc[wv])
        np.testing.assert_allclose(gb[gv], wb[wv], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(gs[gv], ws[wv], rtol=2e-5, atol=2e-5)


def test_roundtrip_bit_equal_to_the_live_step(weights, serving):
    rng = np.random.RandomState(1)
    for n in (2, 4):
        imgs = rng.randint(0, 255, (n, *HW, 3)).astype(np.uint8)
        _assert_equal(serving(imgs), _live(weights[2], imgs))


def test_padding_and_chunking(weights, serving):
    model = weights[2]
    rng = np.random.RandomState(2)

    # batch 1 pads to the b2 program: its row equals the live step's on
    # the same image padded by hand
    img = rng.randint(0, 255, (1, *HW, 3)).astype(np.uint8)
    got = serving(img)
    want = _live(model, np.concatenate([img, np.zeros_like(img)]))
    assert all(g.shape[0] == 1 for g in got)
    _assert_equal(got, [w[:1] for w in want])

    # batch 7 > the largest program (4): chunks of 4 + 3 (padded to 4)
    imgs = rng.randint(0, 255, (7, *HW, 3)).astype(np.uint8)
    got = serving(imgs)
    assert all(g.shape[0] == 7 for g in got)
    tail = np.concatenate([imgs[4:], np.zeros_like(imgs[:1])])
    want = [np.concatenate([a, b[:3]]) for a, b in
            zip(_live(model, imgs[:4]), _live(model, tail))]
    _assert_equal(got, want)

    # one unbatched image is promoted to batch 1
    _assert_equal(serving(imgs[0]), [g[:1] for g in serving(imgs[:1])])


def test_rejects_bad_input_and_pallas(weights, serving, tmp_path):
    with pytest.raises(ValueError, match='letterbox'):
        serving(np.zeros((1, 32, 32, 3), np.uint8))
    for backend in ('pallas', 'pallas_fused'):
        with pytest.raises(ValueError, match='pallas'):
            export_serving(weights[2], ANCHORS, HW, str(tmp_path),
                           device='cpu', nms_backend=backend, **KW)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize('kw', [dict(use_wbf=True),
                                dict(nms_method='soft')],
                         ids=['wbf', 'soft'])
def test_wbf_and_soft_nms_programs(weights, tmp_path, kw):
    """``use_wbf`` exports the candidate pool (JAX ``export.py:88-91``);
    the soft-NMS sweep exports as one loop, not K unrolled steps."""
    model = weights[2]
    meta = export_serving(model, ANCHORS, HW, str(tmp_path),
                          batch_sizes=[2], device='cpu', **dict(KW, **kw))
    if kw.get('use_wbf'):
        assert meta['outputs'] == ['candidate_boxes_xywh_canvas',
                                   'candidate_classes', 'candidate_scores',
                                   'candidate_valid']
    else:
        ep = torch.export.load(str(tmp_path / 'program_b2.pt2'))
        loops = [n for n in ep.graph.nodes if n.op == 'call_function'
                 and 'while_loop' in str(n.target)]
        assert len(loops) == 1, 'the soft sweep must export as one loop'
    imgs = np.random.RandomState(3).randint(0, 255, (2, *HW, 3)).astype(
        np.uint8)
    got = ServingModel(str(tmp_path), device='cpu')(imgs)
    want = _live(model, imgs, **kw)
    assert got[3].any()
    _assert_equal(got, want)


def test_export_cli_with_check(tmp_path, capsys):
    from multigriddet_tpu_torch.export import main
    (tmp_path / 'anchors.txt').write_text(
        '40,40 20,20 10,10\n20,20 10,10 5,5\n10,10 5,5 2,2\n')
    (tmp_path / 'classes.txt').write_text('a\nb\nc\n')
    cfg = tmp_path / 'infer.yaml'
    cfg.write_text(
        'model:\n  type: preset\n  preset:\n'
        '    architecture: multigriddet_tiny\n    num_classes: 3\n'
        '    input_shape: [64, 64, 3]\n'
        f'    anchors_path: {tmp_path / "anchors.txt"}\n'
        f'    classes_path: {tmp_path / "classes.txt"}\n'
        'input:\n  type: image\n  input_shape: [64, 64, 3]\n'
        'detection:\n  confidence_threshold: 0.05\n  max_boxes: 10\n'
        '  pre_nms_top_k: 64\n')
    out = tmp_path / 'serving'
    assert main(['--config', str(cfg), '--output', str(out),
                 '--batch-sizes', '2', '--check', '--device', 'cpu']) == 0
    assert 'check OK' in capsys.readouterr().out
    assert json.loads((out / 'metadata.json').read_text())['class_names'] \
        == ['a', 'b', 'c']


@pytest.mark.cuda
def test_export_and_reload_on_the_card(tmp_path):
    """On the card: an artifact traced there, and one traced on the CPU,
    serve on the card with the live step's results (classes and valid
    equal, boxes and scores within 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; run with -m cuda on the card')
    model = create_model('multigriddet_tiny', num_classes=NC)
    load_flax_variables(model, *random_flax_variables(model, seed=0))
    imgs = np.random.RandomState(4).randint(0, 255, (2, *HW, 3)).astype(
        np.uint8)
    export_serving(model, ANCHORS, HW, str(tmp_path / 'cpu'),
                   batch_sizes=[2], device='cpu', **KW)
    model.cuda()
    export_serving(model, ANCHORS, HW, str(tmp_path / 'cuda'),
                   batch_sizes=[2], **KW)
    want = _live(model, imgs)
    for traced in ('cpu', 'cuda'):
        got = ServingModel(str(tmp_path / traced))(imgs)
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=2e-5, atol=2e-5)
