"""The port's 9-cell target encoder against the JAX encoder.

The same numpy boxes go through JAX ``encode_targets``, its numpy oracle
``encode_targets_np`` and the port's ``encode_targets`` on the CPU, and are
compared with the recorded TF reference (``encoder.npz``, keys ``np_l*``).

Tolerances: the discrete fields (which cells hold a box, objectness, the
anchor and class one-hots) are exact; the offsets and log-ratios
(channels 0-3) agree within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from multigriddet_tpu.ops import encoding as jenc
from multigriddet_tpu_torch.ops import decode, encoding, geometry

FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'reference')
OFFSET_ATOL = 1e-6
TINY_ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
                np.array([[20, 20], [14, 28], [28, 14]], np.float32),
                np.array([[10, 10], [7, 14], [14, 7]], np.float32)]


def assert_grids_equal(got, want, num_anchors=(3, 3, 3)):
    assert len(got) == len(want)
    for l, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        # discrete fields exact: objectness, anchor and class one-hots
        np.testing.assert_array_equal(g[..., 4:], w[..., 4:],
                                      err_msg=f'layer {l} discrete fields')
        np.testing.assert_allclose(g[..., :4], w[..., :4], rtol=0,
                                   atol=OFFSET_ATOL,
                                   err_msg=f'layer {l} offsets')


def random_boxes(seed, batch, n, hw, num_classes, fill=0.7, max_wh=None):
    """Boxes ``[B, n, 5]`` on an ``hw`` canvas, some rows padding, some
    degenerate (zero width), in annotation order."""
    rng = np.random.RandomState(seed)
    h, w = hw
    max_wh = max_wh or (0.6 * w, 0.6 * h)
    boxes = np.zeros((batch, n, 5), np.float32)
    for b in range(batch):
        k = rng.randint(1, n + 1) if fill < 1 else n
        for t in range(k):
            bw = rng.uniform(2, max_wh[0])
            bh = rng.uniform(2, max_wh[1])
            x1 = rng.uniform(-0.1 * w, w - 2)
            y1 = rng.uniform(-0.1 * h, h - 2)
            boxes[b, t] = [x1, y1, min(x1 + bw, w), min(y1 + bh, h),
                           rng.randint(num_classes)]
        if k > 2 and rng.rand() < 0.5:
            boxes[b, 1, 2] = boxes[b, 1, 0]      # degenerate row mid-list
    return boxes


def _both(boxes, anchors, nc, hw, **kw):
    want = jenc.encode_targets(boxes, anchors, nc, hw, **kw)
    got = encoding.encode_targets(boxes, anchors, nc, hw, **kw)
    return got, want


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_random_batches_match_jax_and_numpy_oracle(seed, coco_anchors):
    hw = (416, 416)
    boxes = random_boxes(seed, 4, 24, hw, 80)
    got, want = _both(boxes, coco_anchors, 80, hw)
    assert_grids_equal(got, want)
    assert_grids_equal(got, jenc.encode_targets_np(boxes, coco_anchors, 80,
                                                   hw))


def test_tiny_canvas_crowded(coco_anchors):
    """64x64 canvas, every row a box: the occupancy rule decides often."""
    hw = (64, 64)
    boxes = random_boxes(7, 3, 30, hw, 2, fill=1.0, max_wh=(40, 40))
    got, want = _both(boxes, TINY_ANCHORS, 2, hw)
    assert_grids_equal(got, want)
    assert_grids_equal(got, jenc.encode_targets_np(boxes, TINY_ANCHORS, 2,
                                                   hw))


def test_adjacent_boxes_occupancy_rule(coco_anchors):
    """Two boxes one cell apart on the same layer and anchor: the second
    overwrites cells of the first only while it holds fewer than 3."""
    hw = (608, 608)
    boxes = np.zeros((2, 4, 5), np.float32)
    for b, dx in enumerate((32.0, 64.0)):
        boxes[b, 0] = [280, 280, 380, 360, 1]
        boxes[b, 1] = [280 + dx, 280, 380 + dx, 360, 2]
        boxes[b, 2] = [280 + dx, 280 + dx, 380 + dx, 360 + dx, 3]
    got, want = _both(boxes, coco_anchors, 80, hw)
    assert_grids_equal(got, want)
    obj = got[0][..., 4].numpy()
    cls = got[0][..., 5 + 3:].numpy().argmax(-1)
    # box 1 took cells of box 0 (the overlap of their 3x3 neighbourhoods)
    assert obj.sum() > 0 and len(np.unique(cls[obj > 0.5])) >= 2


def test_corner_and_edge_boxes(coco_anchors):
    hw = (416, 416)
    boxes = np.array([[[0, 0, 20, 14, 0], [396, 0, 416, 30, 1],
                       [0, 380, 60, 416, 2], [390, 395, 416, 416, 3],
                       [200, 0, 260, 8, 4], [0, 0, 416, 416, 5]]],
                     np.float32)
    got, want = _both(boxes, coco_anchors, 80, hw)
    assert_grids_equal(got, want)
    assert_grids_equal(got, jenc.encode_targets_np(boxes, coco_anchors, 80,
                                                   hw))


def test_iol_ties_take_the_first_anchor():
    """Boxes whose rounded IoL ties between anchors (one anchor repeated
    across layers, and boxes exactly between two anchors)."""
    anchors = [np.array([[30, 30], [60, 60]], np.float32),
               np.array([[30, 30], [15, 15]], np.float32),
               np.array([[60, 60], [8, 8]], np.float32)]
    hw = (256, 256)
    boxes = np.array([[[10, 10, 40, 40, 0], [100, 100, 160, 160, 1],
                       [50, 120, 95, 165, 0], [200, 30, 215, 45, 1],
                       [0, 0, 0, 0, 0]]], np.float32)
    got, want = _both(boxes, anchors, 2, hw)
    assert_grids_equal(got, want, (2, 2, 2))
    wh = torch.from_numpy(boxes[0, :4, 2:4] - boxes[0, :4, 0:2])
    all_np, layer_np, k_np = encoding.flatten_anchors(anchors)
    layer, k, _ = encoding.match_anchors(
        wh, torch.from_numpy(all_np), torch.from_numpy(layer_np).long(),
        torch.from_numpy(k_np).long())
    jl, jk, _ = jenc.match_anchors(wh.numpy(), all_np, layer_np, k_np)
    np.testing.assert_array_equal(layer.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    assert int(layer[0]) == 0 and int(k[0]) == 0   # first of the tie


@pytest.mark.parametrize('thresh', [0.8, 0.5])
def test_multi_anchor_assign(thresh, coco_anchors):
    hw = (416, 416)
    boxes = random_boxes(11, 3, 16, hw, 80)
    got, want = _both(boxes, coco_anchors, 80, hw, multi_anchor_assign=True,
                      multi_anchor_thresh=thresh)
    assert_grids_equal(got, want)
    single = encoding.encode_targets(boxes, coco_anchors, 80, hw)
    assert (sum(int((g[..., 4] > 0.5).sum()) for g in got)
            >= sum(int((g[..., 4] > 0.5).sum()) for g in single))


def test_non_square_canvas(coco_anchors):
    """Grid axes the correct way round on a 320x512 canvas."""
    hw = (320, 512)
    boxes = random_boxes(5, 2, 12, hw, 80)
    got, want = _both(boxes, coco_anchors, 80, hw)
    assert [tuple(g.shape[1:3]) for g in got] == [(10, 16), (20, 32),
                                                 (40, 64)]
    assert_grids_equal(got, want)
    assert_grids_equal(got, jenc.encode_targets_np(boxes, coco_anchors, 80,
                                                   hw))


def test_matches_recorded_reference_encoder():
    with open(os.path.join(FIX, 'manifest.json')) as f:
        manifest = json.load(f)
    anchors = [np.asarray(a, np.float32) for a in manifest['anchors']]
    fix = np.load(os.path.join(FIX, 'encoder.npz'))
    got = encoding.encode_targets(
        fix['boxes'], anchors, manifest['num_classes'],
        tuple(manifest['input_hw']),
        grid_shapes=[tuple(g) for g in manifest['grids']])
    assert_grids_equal(got, [fix[f'np_l{l}'] for l in range(3)])


def test_padding_only_and_empty_batches(coco_anchors):
    hw = (416, 416)
    boxes = np.zeros((2, 5, 5), np.float32)
    got, want = _both(boxes, coco_anchors, 80, hw)
    assert_grids_equal(got, want)
    assert all(float(g.abs().sum()) == 0.0 for g in got)


def test_boxes_given_as_a_tensor_and_numpy_agree(coco_anchors):
    hw = (416, 416)
    boxes = random_boxes(3, 2, 10, hw, 80)
    a = encoding.encode_targets(boxes, coco_anchors, 80, hw)
    b = encoding.encode_targets(torch.from_numpy(boxes), coco_anchors, 80,
                                hw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize('max_boxes', [4, 64])
def test_extract_center_gt_boxes_round_trip(max_boxes, coco_anchors):
    """The centre cells give back the boxes, in the JAX order, within
    1 px of the encoded ones (centres are floored to whole pixels)."""
    hw = (416, 416)
    boxes = random_boxes(9, 2, 12, hw, 80)
    y = encoding.encode_targets(boxes, coco_anchors, 80, hw)
    jy = jenc.encode_targets(boxes, coco_anchors, 80, hw)
    for l in range(3):
        got_b, got_m = encoding.extract_center_gt_boxes(
            y[l], coco_anchors[l], hw, max_boxes)
        want_b, want_m = jenc.extract_center_gt_boxes(
            jy[l], coco_anchors[l], hw, max_boxes)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                                   rtol=1e-6, atol=1e-4)
    # every box with a centre cell comes back (max_boxes permitting)
    if max_boxes == 64:
        rec = []
        for l in range(3):
            b, m = encoding.extract_center_gt_boxes(y[l], coco_anchors[l],
                                                    hw, max_boxes)
            rec.append(b[0][m[0]].numpy())
        rec = np.concatenate(rec)
        cxcy = np.floor((boxes[0, :, 0:2] + boxes[0, :, 2:4]) / 2)
        wh = boxes[0, :, 2:4] - boxes[0, :, 0:2]
        live = (wh[:, 0] * wh[:, 1]) > 0
        for (cx, cy), (w, h) in zip(cxcy[live], wh[live]):
            d = np.abs(rec[:, 0] - cx) + np.abs(rec[:, 1] - cy)
            j = int(np.argmin(d))
            if d[j] < 1.0:
                np.testing.assert_allclose(rec[j, 2:], [w, h], rtol=1e-4)


def test_geometry_and_inverse_activation_match_jax():
    """The anchor metrics and cxcywh helpers of item 7, and the Newton
    inverse of the xy activation."""
    from multigriddet_tpu.ops import decode as jdec
    from multigriddet_tpu.ops import geometry as jgeo
    rng = np.random.RandomState(0)
    wh = rng.uniform(1, 300, (2, 7, 2)).astype(np.float32)
    anc = rng.uniform(5, 300, (9, 2)).astype(np.float32)
    t_wh, t_anc = torch.from_numpy(wh), torch.from_numpy(anc)
    for name in ('iol_wh', 'iou_wh'):
        np.testing.assert_allclose(
            getattr(geometry, name)(t_wh, t_anc).numpy(),
            np.asarray(getattr(jgeo, name)(wh, anc)), rtol=1e-6, atol=1e-7)
    b1 = rng.uniform(1, 100, (2, 5, 4)).astype(np.float32)
    b2 = rng.uniform(1, 100, (2, 6, 4)).astype(np.float32)
    for name in ('cxcywh_to_xyxy', 'xyxy_to_cxcywh'):
        np.testing.assert_allclose(
            getattr(geometry, name)(torch.from_numpy(b1)).numpy(),
            np.asarray(getattr(jgeo, name)(b1)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        geometry.pairwise_iou_cxcywh(torch.from_numpy(b1),
                                     torch.from_numpy(b2)).numpy(),
        np.asarray(jgeo.pairwise_iou_cxcywh(b1, b2)), rtol=1e-5, atol=1e-6)
    y = rng.uniform(-0.99, 1.99, (50,)).astype(np.float32)
    got = decode.invert_xy_activation(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jdec.invert_xy_activation(y)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(decode.xy_activation(got).numpy(), y,
                               atol=1e-5)
