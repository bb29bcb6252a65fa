"""The port's file, video and WBF serving paths against the JAX engine's.

Both engines load one msgpack weights bundle (``multigriddet_tiny`` at
64x64, float32) and serve the same PIL- or OpenCV-written files:
``detect_files`` through the native JPEG loader, through the PIL fallback,
on a mixed PNG/JPEG list with a corrupt file, over the yuv420 link and
with host WBF, and ``predict_video`` on a 3-frame clip.  Per image the
number of detections and the classes are equal; boxes agree to 2e-3
image pixels and scores to 1e-5 (forward and decode round differently in
the two frameworks, ~1e-6 relative, and the letterbox inverse scales
canvas pixels by up to 1.5).
"""

import os

import numpy as np
import pytest
from PIL import Image

from multigriddet_tpu_torch.data import native
from multigriddet_tpu_torch.inference import MultiGridInference
from multigriddet_tpu_torch.models import create_model, random_flax_variables
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

BOX_ATOL, SCORE_ATOL = 2e-3, 1e-5


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    from multigriddet_tpu.training.checkpoint import save_params
    root = tmp_path_factory.mktemp('engine')
    anchors = root / 'anchors.txt'
    anchors.write_text('40,40 30,50 50,30\n20,20 15,25 25,15\n'
                       '10,10 8,12 12,8\n')
    classes = root / 'classes.txt'
    classes.write_text('a\nb\n')
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=11)
    weights = root / 'w.msgpack'
    save_params(str(weights), {'params': params, 'batch_stats': stats})
    config = {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': 2,
            'input_shape': [64, 64, 3], 'anchors_path': str(anchors),
            'classes_path': str(classes)}},
        'environment': {'mixed_precision': False},
        'weights_path': str(weights),
        'input': {'type': 'image', 'input_shape': [64, 64, 3]},
        'detection': {'confidence_threshold': 0.05, 'nms_threshold': 0.45,
                      'max_boxes': 12, 'nms_backend': 'pallas_fused'},
        'output': {'save_result': False},
    }
    rng = np.random.RandomState(5)
    jpgs, pngs = [], []
    for i, (h, w) in enumerate([(48, 80), (64, 64), (70, 40), (40, 64),
                                (50, 50)]):
        low = rng.randint(0, 256, (h // 4, w // 4, 3)).astype(np.uint8)
        img = Image.fromarray(low).resize((w, h), Image.BICUBIC)
        p = root / f'f{i}.jpg'
        img.save(p, quality=95)
        jpgs.append(str(p))
        q = root / f'f{i}.png'
        img.save(q)
        pngs.append(str(q))
    bad = root / 'broken.jpg'
    bad.write_bytes(b'not a jpeg')
    disguised = root / 'disguised.jpg'
    Image.open(pngs[0]).save(disguised, format='PNG')
    return root, config, jpgs, pngs, str(bad), str(disguised)


def _engines(config, **det):
    from multigriddet_tpu.inference import MultiGridInference as JaxEngine
    cfg = dict(config, detection=dict(config['detection'], **det))
    return MultiGridInference(cfg, device='cpu'), JaxEngine(cfg)


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for (gb, gc, gs), (wb, wc, ws) in zip(got, want):
        wb, wc, ws = (np.asarray(a) for a in (wb, wc, ws))
        assert len(gb) == len(wb)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize('case', ['native', 'pil_fallback', 'mixed',
                                  'yuv420', 'wbf'])
def test_detect_files_matches_jax(setup, monkeypatch, case):
    root, config, jpgs, pngs, bad, disguised = setup
    det = {}
    if case == 'yuv420':
        det = {'link_format': 'yuv420'}
    elif case == 'wbf':
        det = {'use_wbf': True, 'pre_nms_top_k': 64, 'nms_threshold': 0.3}
    ours, theirs = _engines(config, **det)
    paths = jpgs + [bad, disguised]
    if case == 'mixed':
        paths = [jpgs[0], pngs[1], bad, pngs[2], jpgs[3]]
    if case == 'pil_fallback':
        import multigriddet_tpu.data.native as jax_native
        monkeypatch.setattr(native, 'native_available', lambda: False)
        monkeypatch.setattr(jax_native, 'native_available', lambda: False)
    got = ours.detect_files(paths, batch_size=3, num_workers=2,
                            pipeline_depth=1)
    want = theirs.detect_files(paths, batch_size=3, num_workers=2,
                               pipeline_depth=1)
    _assert_results_equal(got, want)
    assert sum(len(r[0]) for r in got) > len(paths)
    assert len(got[paths.index(bad)][0]) == 0       # unreadable: empty
    if disguised in paths:                          # PNG under .jpg: PIL
        assert len(got[paths.index(disguised)][0]) > 0
    if case == 'wbf':
        assert all(len(r[0]) <= 12 for r in got)


def test_detect_files_native_equals_pil_path(setup):
    """On PNG files (the PIL path) detect_files agrees with detect() per
    image: padding the last short chunk changes nothing."""
    root, config, jpgs, pngs, bad, disguised = setup
    ours, _ = _engines(config)
    files = ours.detect_files(pngs, batch_size=2)
    for path, (b, c, s) in zip(pngs, files):
        db, dc, ds = ours.detect(Image.open(path))
        np.testing.assert_allclose(b, db, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(c, dc)


def test_predict_directory_uses_detect_files(setup, tmp_path, monkeypatch):
    root, config, jpgs, pngs, bad, disguised = setup
    ours, _ = _engines(config)
    d = tmp_path / 'dir'
    d.mkdir()
    for p in jpgs[:2] + [bad]:
        os.symlink(p, d / os.path.basename(p))
    calls = []
    orig = ours.detect_files
    monkeypatch.setattr(ours, 'detect_files',
                        lambda paths, **kw: calls.append(paths)
                        or orig(paths, **kw))
    results = ours.predict_directory(str(d), str(tmp_path / 'out'))
    assert len(calls) == 1 and len(calls[0]) == 3
    assert len(results) == 3 and results[0][0] is None    # broken.jpg
    assert (tmp_path / 'out' / 'f0.jpg').exists()


def _write_clip(path, frames=3):
    cv2 = pytest.importorskip('cv2')
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'mp4v'), 5,
                        (64, 48))
    rng = np.random.RandomState(4)
    for _ in range(frames):
        low = rng.randint(0, 255, (12, 16, 3)).astype('uint8')
        w.write(cv2.resize(low, (64, 48), interpolation=cv2.INTER_CUBIC))
    w.release()


def test_predict_video_matches_jax(setup, tmp_path):
    root, config, *_ = setup
    src = tmp_path / 'in.mp4'
    _write_clip(src)
    ours, theirs = _engines(config)
    fused = {}
    for tag, eng in (('ours', ours), ('jax', theirs)):
        seen = fused[tag] = []
        orig = eng._host_fuse

        def spy(b, c, s, orig=orig, seen=seen):
            seen.append((np.array(b), np.array(c), np.array(s)))
            return orig(b, c, s)

        eng._host_fuse = spy
        out = tmp_path / f'{tag}.mp4'
        assert eng.predict_video(str(src), str(out), batch_size=2,
                                 pipeline_depth=1) == 3
        assert out.exists() and out.stat().st_size > 0
    assert len(fused['ours']) == len(fused['jax']) == 3
    _assert_results_equal([(b, c, s) for b, c, s in fused['ours']],
                          fused['jax'])


def test_run_dispatches_video_and_camera(setup, tmp_path, monkeypatch):
    root, config, *_ = setup
    src = tmp_path / 'clip.mp4'
    _write_clip(src)
    cfg = dict(config, input={'type': 'video', 'source': str(src)},
               video={'batch_size': 2, 'pipeline_depth': 0},
               output={'save_result': True,
                       'output_dir': str(tmp_path / 'out')})
    engine = MultiGridInference(cfg, device='cpu')
    assert engine.run() == 3
    assert (tmp_path / 'out' / 'annotated_clip.mp4').exists()
    seen = {}
    monkeypatch.setattr(engine, 'predict_camera',
                        lambda device, show=True: seen.update(
                            device=device, show=show) or 0)
    engine.config = dict(cfg, input={'type': 'camera', 'source': '1'},
                         output={'show_result': False})
    engine.run()
    assert seen == {'device': 1, 'show': False}
    with pytest.raises(IOError):
        engine.predict_video(str(tmp_path / 'missing.mp4'))
