"""The port's MultiGridLoss against the JAX loss and the recorded reference.

* The 15 recorded configurations (``loss.npz`` / ``loss_values.json``, run
  as ``tests/test_reference_parity.py`` runs them, ``reference_compat``):
  total within 1e-5 relative of the recorded TF value; the
  configurations that crash in the TF reference are finite and within
  1e-5 relative of JAX.
* Every ``LossConfig`` branch (several per case) against JAX ``multigrid_loss`` on the same
  float32 inputs: the total and every metric within 1e-5 relative (of
  max(1, |value|)); ``num_positives`` exact.
* Gradients with respect to ``y_pred`` against ``jax.grad``: each layer's
  gradient within 1e-5 of that tensor's largest |gradient| (the two
  frameworks sum in different orders).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigriddet_tpu.losses import LossConfig as JLossConfig
from multigriddet_tpu.losses import multigrid_loss as jax_loss
from multigriddet_tpu.ops.encoding import encode_targets as jax_encode
from multigriddet_tpu_torch.losses import LossConfig, multigrid_loss

FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'reference')
with open(os.path.join(FIX, 'manifest.json')) as f:
    MANIFEST = json.load(f)
REF_ANCHORS = [np.asarray(a, np.float32) for a in MANIFEST['anchors']]
RTOL = 1e-5
GRAD_RTOL = 1e-5

ANCHORS = [np.array([[60, 48], [90, 100], [120, 110]], np.float32),
           np.array([[24, 18], [30, 50], [44, 30]], np.float32),
           np.array([[8, 9], [12, 20], [20, 14]], np.float32)]
HW = (128, 96)
NC = 5


def _reference_kwargs(kw):
    m = dict(reference_compat=True)
    for k in LossConfig.__dataclass_fields__:
        if k in kw:
            m[k] = kw[k]
    if 'loss_normalization' in kw:
        m['loss_normalization'] = tuple(kw['loss_normalization'])
    for ref_key, ours in (('use_giou_loss', 'giou'), ('use_diou_loss', 'diou'),
                          ('use_ciou_loss', 'ciou')):
        if kw.get(ref_key):
            m['iou_loss_type'] = ours
    return m


@pytest.fixture(scope='module')
def recorded():
    data = np.load(os.path.join(FIX, 'loss.npz'))
    with open(os.path.join(FIX, 'loss_values.json')) as f:
        values = json.load(f)
    return data, values


@pytest.mark.parametrize('name', sorted(MANIFEST['loss_configs']))
def test_recorded_reference_configurations(name, recorded):
    data, values = recorded
    y_pred = [data[f'pred_l{l}'] for l in range(3)]
    y_true = [data[f'true_l{l}'] for l in range(3)]
    kw = dict(MANIFEST['loss_configs'][name])
    cw = kw.pop('class_weights', None)
    m = _reference_kwargs(kw)
    hw = tuple(MANIFEST['input_hw'])
    nc = MANIFEST['num_classes']
    total, _ = multigrid_loss([torch.from_numpy(p) for p in y_pred],
                              [torch.from_numpy(t) for t in y_true],
                              REF_ANCHORS, nc, hw, LossConfig(**m),
                              None if cw is None else torch.tensor(cw))
    mine = float(total)
    ref = values[name]
    if not isinstance(ref, dict):
        assert abs(mine - ref) / max(abs(ref), 1e-9) < RTOL, (mine, ref)
        return
    # the configuration crashes in the TF reference: held to JAX instead
    want, _ = jax.jit(lambda p, t: jax_loss(
        p, t, REF_ANCHORS, nc, hw, JLossConfig(**m),
        None if cw is None else jnp.asarray(cw, jnp.float32)))(
            y_pred, y_true)
    assert np.isfinite(mine)
    assert abs(mine - float(want)) / max(abs(float(want)), 1.0) < RTOL


def _inputs(seed, batch=2):
    """Encoded targets of random boxes and predictions near them (so the
    ignore mask, the assigned IoU and the consensus groups are live)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, 12, 5), np.float32)
    for b in range(batch):
        for t in range(rng.randint(4, 12)):
            w, h = rng.uniform(6, 80), rng.uniform(6, 90)
            x, y = rng.uniform(0, HW[1] - w), rng.uniform(0, HW[0] - h)
            boxes[b, t] = [x, y, x + w, y + h, rng.randint(NC)]
    y_true = [np.asarray(t) for t in jax_encode(boxes, ANCHORS, NC, HW)]
    y_pred = []
    for t in y_true:
        p = rng.normal(0, 1.0, t.shape).astype(np.float32)
        # positive cells: wh near the target, so IoUs cross the thresholds
        p[..., 2:4] = np.where(t[..., 4:5] > 0.5,
                               t[..., 2:4] + rng.normal(0, 0.2, t[..., 2:4]
                                                        .shape), p[..., 2:4])
        y_pred.append(p.astype(np.float32))
    return y_pred, y_true


CONFIGS = {
    'opt1_norm_grid_batch': dict(loss_option=1,
                                 loss_normalization=('grid', 'batch')),
    'opt2_scales': dict(coord_scale=5.0, object_scale=2.0,
                        no_object_scale=0.5, class_scale=2.0),
    'opt3_giou': dict(loss_option=3, iou_loss_type='giou'),
    'opt3_diou_norm_positives': dict(loss_option=3, iou_loss_type='diou',
                                     loss_normalization=('positives',)),
    'opt3_ciou': dict(loss_option=3, iou_loss_type='ciou'),
    'focal_max_gt_2': dict(use_focal_loss=True, max_gt_boxes=2,
                           ignore_thresh=0.2),
    'softmax_weights': dict(use_softmax_loss=True),
    'smoothing_weights_anchor_scale': dict(label_smoothing=0.1,
                                           anchor_scale=1.7),
    'iou_aware_trainable_nms': dict(use_iou_aware_objectness=True,
                                    iou_objectness_ratio=0.7,
                                    trainable_nms_weight=0.8,
                                    ignore_thresh=0.3),
    'consensus_no_sg': dict(use_consensus_loss=True,
                            consensus_stop_gradient=False),
    'reference_compat_consensus': dict(reference_compat=True,
                                       anchor_scale=1.7,
                                       use_consensus_loss=True),
    # the loss block of configs/train_config.yaml (consensus with
    # stop-gradient)
    'train_config_yaml': dict(coord_scale=5.0, no_object_scale=0.5,
                              label_smoothing=0.01, use_consensus_loss=True),
}
CLASS_WEIGHTS = np.linspace(0.5, 2.0, NC).astype(np.float32)


def _jax_total_and_metrics(cfg, cw, y_pred, y_true):
    def f(p):
        return jax_loss(p, y_true, ANCHORS, NC, HW, JLossConfig(**cfg), cw,
                        strides=(32, 16, 8))
    (total, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        [jnp.asarray(p) for p in y_pred])
    return float(total), {k: float(v) for k, v in metrics.items()}, grads


def _torch_total_and_metrics(cfg, cw, y_pred, y_true):
    preds = [torch.tensor(p, requires_grad=True) for p in y_pred]
    total, metrics = multigrid_loss(
        preds, [torch.from_numpy(t) for t in y_true], ANCHORS, NC, HW,
        LossConfig(**cfg), None if cw is None else torch.from_numpy(cw),
        strides=(32, 16, 8))
    total.backward()
    return (float(total), {k: float(v) for k, v in metrics.items()},
            [p.grad.numpy() for p in preds])


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_branch_matches_jax_with_gradients(name):
    cfg = CONFIGS[name]
    cw = CLASS_WEIGHTS if 'weights' in name else None
    y_pred, y_true = _inputs(sorted(CONFIGS).index(name))
    jt, jm, jg = _jax_total_and_metrics(cfg, None if cw is None
                                        else jnp.asarray(cw), y_pred, y_true)
    tt, tm, tg = _torch_total_and_metrics(cfg, cw, y_pred, y_true)
    assert set(tm) == set(jm)
    assert abs(tt - jt) <= RTOL * max(1.0, abs(jt)), (tt, jt)
    for k in jm:
        if k == 'num_positives':
            assert tm[k] == jm[k]
        else:
            assert abs(tm[k] - jm[k]) <= RTOL * max(1.0, abs(jm[k])), \
                (k, tm[k], jm[k])
    assert jm['num_positives'] > 0
    for l, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=f'{name}: layer {l} gradient')


def test_ignore_mask_is_live_and_carries_no_gradient():
    """The inputs reach the ignore mask (some no-object cells above the
    threshold), and the mask's IoU tensors keep no autograd graph."""
    from multigriddet_tpu_torch.losses.multigrid_loss import _ignore_mask
    y_pred, y_true = _inputs(3)
    pred = torch.tensor(y_pred[1], requires_grad=True)
    obj = (torch.from_numpy(y_true[1][..., 4:5]) > 0.5).float()
    ignore, assigned, max_iou = _ignore_mask(
        LossConfig(ignore_thresh=0.3), pred[..., 0:2], pred[..., 2:4],
        torch.from_numpy(y_true[1]), torch.from_numpy(ANCHORS[1]), obj,
        (16.0, 16.0))
    assert not (ignore.requires_grad or assigned.requires_grad
                or max_iou.requires_grad)
    assert float(ignore.sum()) > 0 and float(assigned.sum()) > 0
