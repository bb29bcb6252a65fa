"""Frozen copy of ``multigriddet_tpu_torch/losses/iou.py`` for the plain
reference (imports rewritten; nothing of the program is imported).

IoU-family localization losses (IoU / GIoU / DIoU / CIoU) on tensors.

Counterpart of ``multigriddet_tpu/losses/iou.py``: elementwise over
aligned cxcywh box grids, the same expressions and eps.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-7


def _corners(xy, wh):
    half = wh / 2.0
    return xy - half, xy + half


def iou_cxcywh(true_xy, true_wh, pred_xy, pred_wh):
    """Elementwise IoU of aligned cxcywh boxes, and the corners/union the
    GIoU/DIoU terms reuse."""
    t_min, t_max = _corners(true_xy, true_wh)
    p_min, p_max = _corners(pred_xy, pred_wh)
    i_min = torch.maximum(t_min, p_min)
    i_max = torch.minimum(t_max, p_max)
    i_wh = torch.clamp_min(i_max - i_min, 0.0)
    inter = i_wh[..., 0] * i_wh[..., 1]
    t_area = true_wh[..., 0] * true_wh[..., 1]
    p_area = pred_wh[..., 0] * pred_wh[..., 1]
    union = t_area + p_area - inter
    return inter / (union + EPS), (t_min, t_max, p_min, p_max, union)


def giou(true_xy, true_wh, pred_xy, pred_wh):
    iou, (t_min, t_max, p_min, p_max, union) = iou_cxcywh(
        true_xy, true_wh, pred_xy, pred_wh)
    e_min = torch.minimum(t_min, p_min)
    e_max = torch.maximum(t_max, p_max)
    e_wh = torch.clamp_min(e_max - e_min, 0.0)
    enclose = e_wh[..., 0] * e_wh[..., 1]
    return iou - (enclose - union) / (enclose + EPS)


def diou(true_xy, true_wh, pred_xy, pred_wh, use_ciou: bool = False):
    iou, (t_min, t_max, p_min, p_max, _) = iou_cxcywh(
        true_xy, true_wh, pred_xy, pred_wh)
    center_dist = torch.sum((true_xy - pred_xy) ** 2, dim=-1)
    e_min = torch.minimum(t_min, p_min)
    e_max = torch.maximum(t_max, p_max)
    diag = torch.sum((e_max - e_min) ** 2, dim=-1)
    d = iou - center_dist / (diag + EPS)
    if use_ciou:
        v = (4.0 / (math.pi ** 2)) * torch.square(
            torch.atan2(true_wh[..., 0], true_wh[..., 1] + EPS)
            - torch.atan2(pred_wh[..., 0], pred_wh[..., 1] + EPS))
        alpha = v / (1.0 - iou + v + EPS)
        d = d - alpha * v
    return d


def iou_family_loss(kind: str, true_xy, true_wh, pred_xy, pred_wh,
                    object_mask) -> torch.Tensor:
    """Masked sum of ``1 - metric``; ``object_mask`` is ``[..., 1]``."""
    if kind == 'giou':
        metric = giou(true_xy, true_wh, pred_xy, pred_wh)
    elif kind == 'diou':
        metric = diou(true_xy, true_wh, pred_xy, pred_wh)
    elif kind == 'ciou':
        metric = diou(true_xy, true_wh, pred_xy, pred_wh, use_ciou=True)
    else:
        raise ValueError(f'unknown IoU loss kind {kind!r}')
    return torch.sum((1.0 - metric) * object_mask[..., 0])
