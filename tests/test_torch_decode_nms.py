"""The port's decode, geometry, NMS and yuv420 transport against the JAX
package and the recorded reference fixtures, on the CPU.

Tolerances: decode boxes and scores agree with JAX to 1e-6 relative (the
two frameworks' tanh/sigmoid/exp/logsumexp round differently in the last
bits); class ids, keep sets, detection order and the gathered boxes and
scores of the standard/diou/cluster NMS are exact; soft-NMS decayed
scores agree to 1e-6 relative (exp rounding).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigriddet_tpu.ops import decode as jdecode
from multigriddet_tpu.ops import geometry as jgeometry
from multigriddet_tpu.ops.nms import batched_nms as jax_batched_nms
from multigriddet_tpu.ops.yuv import yuv420_to_rgb as jax_yuv420_to_rgb
from multigriddet_tpu_torch.ops import (batched_nms, canvas_boxes_to_image,
                                        decode_for_nms, decode_predictions,
                                        rgb_to_yuv420_np, yuv420_to_rgb)

FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'reference')
COCO_ANCHORS = [np.array([[112, 74], [149, 190], [370, 328]], np.float32),
                np.array([[28, 17], [56, 112], [57, 35]], np.float32),
                np.array([[9, 10], [13, 28], [28, 55]], np.float32)]
INPUT_HW = (608, 608)
SMALL_GRIDS = [(5, 5), (10, 10), (20, 20)]


def _preds(seed, nc=80, b=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, gh, gw, 5 + 3 + nc).astype(np.float32) * 2
            for gh, gw in SMALL_GRIDS]


@pytest.mark.parametrize('use_softmax,rescore', [(True, True), (False, True),
                                                 (True, False)])
def test_decode_for_nms_matches_jax(use_softmax, rescore):
    preds = _preds(0)
    jb, js, jc = jax.jit(lambda ps: jdecode.decode_for_nms(
        ps, COCO_ANCHORS, INPUT_HW, rescore, use_softmax))(preds)
    tb, ts, tc = decode_for_nms([torch.from_numpy(p) for p in preds],
                                COCO_ANCHORS, INPUT_HW, rescore, use_softmax)
    assert tc.dtype == torch.int32 and tb.shape == (2, 525, 4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('use_softmax', [True, False])
def test_decode_predictions_matches_jax(use_softmax):
    preds = _preds(1, nc=8)
    want = jax.jit(lambda ps: jdecode.decode_predictions(
        ps, COCO_ANCHORS, INPUT_HW, use_softmax=use_softmax))(preds)
    got = decode_predictions([torch.from_numpy(p) for p in preds],
                             COCO_ANCHORS, INPUT_HW, use_softmax=use_softmax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_decode_for_nms_matches_reference_fixture():
    """decoder.npz holds the reference decoder's output on loss.npz's
    predictions (8 classes, 416 canvas); recorded in float32 by TF, so
    held to 1e-4 as the JAX package's own parity test is."""
    with open(os.path.join(FIX, 'manifest.json')) as f:
        manifest = json.load(f)
    anchors = [np.asarray(a, np.float32) for a in manifest['anchors']]
    hw = tuple(manifest['input_hw'])
    data = np.load(os.path.join(FIX, 'loss.npz'))
    ref = np.load(os.path.join(FIX, 'decoder.npz'))['decoded_softmax1']
    preds = [torch.from_numpy(data[f'pred_l{l}']) for l in range(3)]
    boxes, scores, classes = decode_for_nms(preds, anchors, hw)
    np.testing.assert_allclose(boxes.numpy(), ref[..., 0:4], atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), ref[..., 4], atol=1e-4)
    np.testing.assert_array_equal(classes.numpy(),
                                  np.argmax(ref[..., 5:], axis=-1))


def _pool(seed, b=2, n=300, nc=20):
    rng = np.random.RandomState(seed)
    boxes = rng.rand(b, n, 4).astype(np.float32) * 300
    boxes[..., 2:] = rng.rand(b, n, 2).astype(np.float32) * 90 + 5
    scores = rng.rand(b, n).astype(np.float32)
    scores[:, 50:60] = scores[:, 40:50]        # exact-tie armies
    classes = rng.randint(0, nc, (b, n)).astype(np.int32)
    return boxes, scores, classes


def _assert_same_detections(got, want, score_rtol=0.0):
    gb, gc, gs, gv = (t.numpy() for t in got)
    wb, wc, ws, wv = (np.asarray(a) for a in want)
    assert gb.shape == wb.shape and gv.shape == wv.shape
    np.testing.assert_array_equal(gv, wv)
    v = wv
    np.testing.assert_array_equal(gc[v], wc[v])
    np.testing.assert_array_equal(gb[v], wb[v])
    np.testing.assert_allclose(gs[v], ws[v], rtol=score_rtol, atol=0)
    # invalid slots carry the -1e9 sentinel score
    np.testing.assert_array_equal(gs[~v], ws[~v])


@pytest.mark.parametrize('method,use_iol,class_aware,top_k,max_boxes', [
    ('standard', False, False, 512, 50),
    ('standard', True, False, 512, 50),
    ('diou', True, False, 512, 50),
    ('diou', False, False, 128, 40),
    ('diou', True, True, 512, 60),
    ('standard', False, True, 64, 30),
    ('cluster', True, False, 512, 50),
    ('soft', False, False, 96, 50),
    ('diou', True, False, 16, 20),          # fewer candidates than outputs
])
def test_batched_nms_xla_path_matches_jax(method, use_iol, class_aware,
                                          top_k, max_boxes):
    boxes, scores, classes = _pool(3)
    kw = dict(confidence=0.05, nms_threshold=0.45, max_boxes=max_boxes,
              pre_nms_top_k=top_k, nms_method=method, use_iol=use_iol,
              class_aware=class_aware)
    want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), **kw)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), **kw)
    _assert_same_detections(got, want,
                            score_rtol=1e-6 if method == 'soft' else 0.0)


@pytest.mark.parametrize('name,method', [
    ('std_iol', 'standard'), ('std_iou', 'standard'),
    ('diou', 'diou'), ('diou_iol', 'diou'), ('soft', 'soft')])
def test_batched_nms_matches_reference_fixture(name, method):
    """nms.npz: the reference's nms_boxes (which ignores use_iol and
    confidence, hence use_iol=False, confidence=0); the reference's order
    is its own, so detections are compared sorted by score."""
    fix = np.load(os.path.join(FIX, 'nms.npz'))
    b, c, s, v = batched_nms(
        torch.from_numpy(fix['in_boxes'])[None],
        torch.from_numpy(fix['in_scores'])[None],
        torch.from_numpy(fix['in_classes'])[None],
        confidence=0.0, nms_threshold=0.5, max_boxes=100,
        nms_method=method, use_iol=False)
    keep = v[0].numpy()
    mb, mc, ms = b[0].numpy()[keep], c[0].numpy()[keep], s[0].numpy()[keep]
    rb, rc, rs = (fix[f'{name}_boxes'], fix[f'{name}_classes'],
                  fix[f'{name}_scores'])
    assert len(mb) == len(rb)
    mo, ro = np.argsort(-ms, kind='stable'), np.argsort(-rs, kind='stable')
    np.testing.assert_allclose(mb[mo], rb[ro], atol=1e-3)
    np.testing.assert_array_equal(mc[mo], rc[ro])
    np.testing.assert_allclose(ms[mo], rs[ro], atol=1e-4)


def test_yuv420_to_rgb_matches_jax_edges_included():
    """Bilinear chroma upsampling agrees with jax.image.resize everywhere,
    the first and last rows and columns included (1e-4 absolute on a 0-255
    scale: the two resizers form the same weights in a different order)."""
    rng = np.random.RandomState(4)
    y = rng.randint(0, 256, (2, 12, 16)).astype(np.uint8)
    cb = rng.randint(0, 256, (2, 6, 8)).astype(np.uint8)
    cr = rng.randint(0, 256, (2, 6, 8)).astype(np.uint8)
    want = np.asarray(jax_yuv420_to_rgb(jnp.asarray(y), jnp.asarray(cb),
                                        jnp.asarray(cr)))
    got = yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(cb),
                        torch.from_numpy(cr)).numpy()
    assert got.shape == (2, 12, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=0, atol=1e-4)


def test_rgb_to_yuv420_np_matches_jax():
    from multigriddet_tpu.ops.yuv import rgb_to_yuv420_np as jax_pack
    rgb = np.random.RandomState(5).randint(0, 256, (2, 8, 10, 3)).astype(
        np.uint8)
    for a, b in zip(rgb_to_yuv420_np(rgb), jax_pack(rgb)):
        np.testing.assert_array_equal(a, b)


def test_canvas_boxes_to_image_matches_jax():
    boxes = np.array([[-20.0, 40.0, 120.0, 120.0],
                      [540.0, 500.0, 120.0, 120.0],
                      [280.0, 280.0, 50.0, 40.0]], np.float32)
    for clip in (True, False):
        want = jgeometry.canvas_boxes_to_image(boxes, (480, 640), (608, 608),
                                               clip=clip)
        got = canvas_boxes_to_image(boxes, (480, 640), (608, 608), clip=clip)
        np.testing.assert_array_equal(got, np.asarray(want))
