"""Frozen copies of the training settings the reference needs: the loss
settings read from a ``training`` block, the balanced class weights from
the annotation counts, and the warmup + cosine learning-rate schedule of
the update count (``multigriddet_tpu_torch/config/builder.py`` and
``utils/anchors.py``; nothing of the program is imported)."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from .chain import calculate_expansion_factor
from .loss import LossConfig


def loss_config(training: dict) -> LossConfig:
    loss = training.get('loss', {}) or {}
    aug = training.get('augmentation', {}) or {}
    max_gt = loss.get('max_gt_boxes')
    if max_gt is None:
        factor = calculate_expansion_factor(
            float(aug.get('mosaic_prob', 0.0) or 0.0),
            float(aug.get('mixup_prob', 0.0) or 0.0))
        max_gt = int(aug.get('max_boxes_per_image', 100)) * factor
        if float(aug.get('copypaste_prob', 0.0) or 0.0) > 0:
            max_gt += int(aug.get('copypaste_max', 4))
    norm = training.get('loss_normalization', ['batch'])
    if isinstance(norm, str):
        norm = [norm]
    iou_type = 'giou'
    for key, kind in (('use_giou_loss', 'giou'), ('use_diou_loss', 'diou'),
                      ('use_ciou_loss', 'ciou')):
        if loss.get(key):
            iou_type = kind
    return LossConfig(
        loss_option=int(training.get('loss_option', 2)),
        ignore_thresh=float(loss.get('ignore_thresh', 0.5)),
        coord_scale=float(loss.get('coord_scale', 1.0)),
        object_scale=float(loss.get('object_scale', 1.0)),
        no_object_scale=float(loss.get('no_object_scale', 1.0)),
        class_scale=float(loss.get('class_scale', 1.0)),
        anchor_scale=float(loss.get('anchor_scale', 1.0)),
        label_smoothing=float(training.get('label_smoothing', 0.0)),
        use_focal_loss=bool(loss.get('use_focal_loss', False)),
        use_softmax_loss=bool(loss.get('use_softmax_loss', False)),
        iou_loss_type=iou_type,
        use_iou_aware_objectness=bool(
            loss.get('use_iou_aware_objectness', False)),
        iou_objectness_power=float(loss.get('iou_objectness_power', 1.5)),
        iou_objectness_ratio=float(loss.get('iou_objectness_ratio', 1.0)),
        trainable_nms_weight=float(loss.get('trainable_nms_weight', 0.0)),
        trainable_nms_power=float(loss.get('trainable_nms_power', 2.0)),
        use_consensus_loss=bool(loss.get('use_consensus_loss', False)),
        consensus_kernel_size=int(loss.get('consensus_kernel_size', 3)),
        consensus_iou_power=float(loss.get('consensus_iou_power', 1.5)),
        consensus_min_iou=float(loss.get('consensus_min_iou', 1e-3)),
        consensus_coord_scale=float(loss.get('consensus_coord_scale', 0.5)),
        consensus_obj_scale=float(loss.get('consensus_obj_scale', 0.5)),
        consensus_class_scale=float(loss.get('consensus_class_scale', 0.3)),
        consensus_stop_gradient=bool(
            loss.get('consensus_stop_gradient', True)),
        consensus_center_tolerance=float(
            loss.get('consensus_center_tolerance', 1e-4)),
        loss_normalization=tuple(norm),
        max_gt_boxes=int(max_gt),
    )


def class_weights(lines: Sequence[str], num_classes: int,
                  clip_range=(0.1, 10.0)) -> np.ndarray:
    """``balanced``: total / (C * count), normalised to mean 1, clipped."""
    counts = np.zeros(num_classes, np.int64)
    for line in lines:
        for box in line.strip().split()[1:]:
            fields = box.split(',')
            if len(fields) == 5:
                cls = int(float(fields[4]))
                if 0 <= cls < num_classes:
                    counts[cls] += 1
    counts = counts.astype(np.float64)
    w = counts.sum() / (len(counts) * np.maximum(counts, 1.0))
    w = w / max(w.mean(), 1e-12)
    return np.clip(w, *clip_range).astype(np.float32)


def lr_schedule(training: dict, sched: dict, updates_per_epoch: int
                ) -> Callable[[int], float]:
    """Warmup from ``base * warmup_lr_factor`` to ``base`` over
    ``warmup_epochs``, then a cosine to ``min_lr`` at the last epoch."""
    base = float(training['learning_rate'])
    warmup = max(int(sched.get('warmup_epochs', 0)) * updates_per_epoch, 0)
    decay = max(int(training['epochs']) * updates_per_epoch - warmup, 1)
    init = base * float(sched.get('warmup_lr_factor', 0.01))
    end = float(sched.get('min_lr', 1e-7))
    warmup_steps = max(warmup, 1)
    decay_steps = decay + warmup_steps
    alpha = end / base
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init - base) * frac + base
        c = min(count - warmup_steps, cos_steps)
        return base * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c
                                                         / cos_steps))
                       + alpha)
    return schedule
