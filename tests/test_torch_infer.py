"""The port's fused infer step and serving engine, on the CPU.

``make_infer_step`` is held against the JAX ``make_infer_step`` on the tiny
model at float32 with the same seeded weights and images, for the rgb and
yuv420 links and all three NMS backends (the Pallas kernels run in
interpret mode, the port's kernels through their plain versions).  Valid
masks and classes must be equal; boxes agree to 1e-3 canvas pixels and
scores to 1e-5 (forward and decode round differently in the two
frameworks, ~1e-6 relative).
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multigriddet_tpu.models import create_model as jax_create_model
from multigriddet_tpu.ops.yuv import rgb_to_yuv420_np
from multigriddet_tpu.training.steps import \
    make_infer_step as jax_make_infer_step
from multigriddet_tpu_torch.inference import MultiGridInference
from multigriddet_tpu_torch.models import (create_model, load_flax_variables,
                                           random_flax_variables)
from multigriddet_tpu_torch.training.steps import (fetch_detections,
                                                   make_infer_step,
                                                   unpack_detections)

ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
           np.array([[20, 20], [15, 25], [25, 15]], np.float32),
           np.array([[10, 10], [8, 12], [12, 8]], np.float32)]
HW = (64, 64)


@pytest.fixture(scope='module')
def tiny():
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=7)
    load_flax_variables(model, params, stats)
    jmodel = jax_create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                              num_classes=2)
    images = np.random.RandomState(8).randint(0, 256, (2, *HW, 3)).astype(
        np.uint8)
    return model, jmodel, {'params': params, 'batch_stats': stats}, images


@pytest.mark.parametrize('backend', ['xla', 'pallas', 'pallas_fused'])
@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_infer_step_matches_jax(tiny, backend, link):
    model, jmodel, variables, images = tiny
    kw = dict(confidence=0.02, nms_threshold=0.45, max_boxes=20,
              pre_nms_top_k=64, nms_backend=backend, link_format=link)
    jstep = jax_make_infer_step(jmodel, ANCHORS, HW, **kw)
    step = make_infer_step(model, ANCHORS, HW, **kw)
    if link == 'rgb':
        want = jstep(variables, jnp.asarray(images))
        got = step(torch.from_numpy(images))
    else:
        planes = rgb_to_yuv420_np(images)
        want = jstep(variables, *(jnp.asarray(p) for p in planes))
        got = step(*(torch.from_numpy(p) for p in planes))
    gb, gc, gs, gv = fetch_detections(got)
    wb, wc, ws, wv = (np.asarray(a) for a in want)
    assert gv.sum() >= 4
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gc[gv], wc[wv])
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-3)
    np.testing.assert_allclose(gs[gv], ws[wv], rtol=0, atol=1e-5)


def test_infer_step_packed_and_candidates(tiny):
    model, _, _, images = tiny
    x = torch.from_numpy(images)
    plain = make_infer_step(model, ANCHORS, HW, confidence=0.02,
                            max_boxes=20)(x)
    packed = make_infer_step(model, ANCHORS, HW, confidence=0.02,
                             max_boxes=20, pack_outputs=True)(x)
    assert packed.shape == (2, 7, 20)
    for a, b in zip(unpack_detections(packed), fetch_detections(plain)):
        np.testing.assert_array_equal(a, b)
    cands = make_infer_step(model, ANCHORS, HW, confidence=0.02,
                            pre_nms_top_k=32, use_wbf=True)(x)
    b, c, s, v = fetch_detections(cands)
    assert b.shape == (2, 32, 4) and v.sum() > 0
    assert np.all(np.diff(s, axis=1) <= 0)      # score-sorted


@pytest.fixture
def config(tmp_path):
    anchors = tmp_path / 'anchors.txt'
    anchors.write_text('40,40 30,50 50,30\n20,20 15,25 25,15\n'
                       '10,10 8,12 12,8\n')
    classes = tmp_path / 'classes.txt'
    classes.write_text('a\nb\n')
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': 2,
            'input_shape': [64, 64, 3], 'anchors_path': str(anchors),
            'classes_path': str(classes)}},
        'environment': {'mixed_precision': False},
        'input': {'type': 'image', 'input_shape': [64, 64, 3]},
        'detection': {'confidence_threshold': 0.02, 'nms_threshold': 0.45,
                      'max_boxes': 10, 'nms_backend': 'pallas_fused'},
        'output': {'save_result': False},
    }


def test_engine_on_cpu_from_config(config, tmp_path):
    engine = MultiGridInference(config, device='cpu')
    assert engine.compute_dtype == torch.float32
    rng = np.random.RandomState(0)
    imgs = [Image.fromarray(rng.randint(0, 255, (48, 80, 3)).astype('uint8')),
            Image.fromarray(rng.randint(0, 255, (70, 30, 3)).astype('uint8'))]
    boxes, classes, scores = engine.detect(imgs[0])
    assert boxes.shape[1] == 4 and len(boxes) == len(classes) == len(scores)
    assert len(boxes) > 0
    # boxes are clipped to the ORIGINAL image
    assert (boxes[:, 0] >= 0).all() and (boxes[:, 0] + boxes[:, 2]
                                         <= 80 + 1e-3).all()
    batched = engine.detect_batch(imgs, batch_size=4, pipeline_depth=1)
    assert len(batched) == 2
    np.testing.assert_allclose(batched[0][0], boxes, atol=1e-4)
    np.testing.assert_array_equal(batched[0][1], classes)

    d = tmp_path / 'imgs'
    d.mkdir()
    for i, img in enumerate(imgs):
        img.save(d / f'{i}.png')
    (d / 'broken.jpg').write_bytes(b'not an image')
    results = engine.predict_directory(str(d), str(tmp_path / 'out'))
    assert len(results) == 3 and results[2][0] is None
    assert (tmp_path / 'out' / '0.png').exists()

    annotated, _ = engine.predict_image(str(d / '0.png'),
                                        str(tmp_path / 'one'))
    assert annotated.shape == (48, 80, 3)


def test_engine_bf16_default_and_unported_modes(config, monkeypatch):
    """bfloat16 by default; the modes the first slice left out (host WBF,
    the yuv420 file link, video and camera) now run."""
    cfg = dict(config, environment={})
    engine = MultiGridInference(cfg, device='cpu')
    assert engine.compute_dtype == torch.bfloat16
    outs = engine.infer_batch(np.zeros((1, 64, 64, 3), np.uint8))
    assert outs[2].dtype == torch.float32 and outs[0].shape == (1, 10, 4)
    wbf = MultiGridInference(
        dict(config, detection=dict(config['detection'], use_wbf=True,
                                    link_format='yuv420')), device='cpu')
    assert wbf.use_wbf and wbf._infer_yuv is not None
    img = Image.fromarray(np.random.RandomState(2).randint(
        0, 255, (48, 80, 3)).astype('uint8'))
    boxes, classes, scores = wbf.detect(img)
    assert 0 < len(boxes) <= 10 and len(classes) == len(scores)
    seen = []
    monkeypatch.setattr(engine, 'predict_video',
                        lambda source, out_path=None, **kw: seen.append(
                            (source, kw['batch_size'])) or 0)
    engine.config = dict(config, input={'type': 'video', 'source': 'x.mp4'})
    assert engine.run() == 0 and seen == [('x.mp4', 8)]


def test_entry_point_needs_a_gpu_unless_cpu_is_asked(config, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MultiGridInference(config)


def test_cli_runs_on_cpu(config, tmp_path):
    import yaml
    from multigriddet_tpu_torch.infer import main
    img = tmp_path / 'in.png'
    Image.fromarray(np.random.RandomState(1).randint(
        0, 255, (40, 50, 3)).astype('uint8')).save(img)
    cfg_path = tmp_path / 'infer.yaml'
    cfg_path.write_text(yaml.safe_dump(config))
    out = tmp_path / 'out'
    assert main(['--config', str(cfg_path), '--input', str(img),
                 '--output', str(out), '--device', 'cpu']) == 0
    assert (out / 'in.png').exists()


def test_port_imports_no_jax():
    """A fresh interpreter that imports every module of the port has
    neither JAX nor the JAX package loaded, nor msgpack (the card's host
    has none); the training subpackages are among the modules."""
    code = textwrap.dedent('''
        import importlib, pkgutil, sys
        import multigriddet_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + '.')]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                            'orbax', 'msgpack',
                                            'multigriddet_tpu'))
        assert len(names) >= 20, names
        for sub in ('losses', 'losses.multigrid_loss', 'ops.encoding',
                    'training', 'training.trainer', 'training.checkpoint',
                    'data.pipeline', 'train'):
            assert pkg.__name__ + '.' + sub in names, sub
        assert not bad, bad
        print(len(names))
    ''')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
