"""Box geometry on tensors (anchor matching, overlaps) and on host arrays
(letterbox).

Counterpart of ``multigriddet_tpu/ops/geometry.py``.  The anchor metrics
and pairwise overlaps keep the JAX expressions and their float32
evaluation order, so anchor picks and keep decisions at the threshold edge
agree.  The letterbox inverse runs on at most ``max_boxes`` boxes per image
after NMS, on the host in numpy, as the JAX engine runs it.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8


# ---------------------------------------------------------------------------
# (w, h) anchor metrics: boxes and anchors share an implied centre
# ---------------------------------------------------------------------------

def iol_wh(boxes_wh: torch.Tensor, anchors_wh: torch.Tensor) -> torch.Tensor:
    """Intersection over the larger area of ``[..., N, 2]`` boxes and
    ``[M, 2]`` anchors: ``[..., N, M]`` (the encoder's matching metric)."""
    b = boxes_wh[..., :, None, :]
    inter = torch.minimum(b, anchors_wh)
    inter_area = inter[..., 0] * inter[..., 1]
    box_area = boxes_wh[..., :, None, 0] * boxes_wh[..., :, None, 1]
    anchor_area = anchors_wh[:, 0] * anchors_wh[:, 1]
    return inter_area / (torch.maximum(box_area, anchor_area) + EPS)


def iou_wh(boxes_wh: torch.Tensor, anchors_wh: torch.Tensor) -> torch.Tensor:
    """IoU of ``[..., N, 2]`` boxes and ``[M, 2]`` anchors, centres shared."""
    b = boxes_wh[..., :, None, :]
    inter = torch.minimum(b, anchors_wh)
    inter_area = inter[..., 0] * inter[..., 1]
    box_area = boxes_wh[..., :, None, 0] * boxes_wh[..., :, None, 1]
    anchor_area = anchors_wh[:, 0] * anchors_wh[:, 1]
    return inter_area / (box_area + anchor_area - inter_area + EPS)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    xy, wh = boxes[..., 0:2], boxes[..., 2:4]
    half = wh / 2.0
    return torch.cat([xy - half, xy + half], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    mins, maxs = boxes[..., 0:2], boxes[..., 2:4]
    return torch.cat([(mins + maxs) / 2.0, maxs - mins], dim=-1)


def pairwise_iou_cxcywh(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of ``[..., N, 4]`` and ``[..., M, 4]`` cxcywh boxes:
    ``[..., N, M]``."""
    b1 = cxcywh_to_xyxy(boxes1)[..., :, None, :]
    b2 = cxcywh_to_xyxy(boxes2)[..., None, :, :]
    inter_min = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    inter_max = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    inter_wh = torch.clamp_min(inter_max - inter_min, 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    area2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    return inter / (area1 + area2 - inter + EPS)


def pairwise_iou_xywh_topleft(boxes1: torch.Tensor, boxes2: torch.Tensor,
                              use_iol: bool = False) -> torch.Tensor:
    """Pairwise IoU (or IoL: intersection over the larger area) of top-left
    ``(x, y, w, h)`` boxes: ``[..., N, 4] x [..., M, 4] -> [..., N, M]``."""
    x1, y1 = boxes1[..., :, None, 0], boxes1[..., :, None, 1]
    w1, h1 = boxes1[..., :, None, 2], boxes1[..., :, None, 3]
    x2, y2 = boxes2[..., None, :, 0], boxes2[..., None, :, 1]
    w2, h2 = boxes2[..., None, :, 2], boxes2[..., None, :, 3]
    inter_w = torch.clamp_min(
        torch.minimum(x1 + w1, x2 + w2) - torch.maximum(x1, x2), 0.0)
    inter_h = torch.clamp_min(
        torch.minimum(y1 + h1, y2 + h2) - torch.maximum(y1, y2), 0.0)
    inter = inter_w * inter_h
    a1, a2 = w1 * h1, w2 * h2
    if use_iol:
        return inter / (torch.maximum(a1, a2) + EPS)
    return inter / (a1 + a2 - inter + EPS)


def pairwise_diou_xywh_topleft(boxes1: torch.Tensor, boxes2: torch.Tensor,
                               use_iol: bool = False) -> torch.Tensor:
    """DIoU = IoU (or IoL) - centre_distance^2 / enclosing_diagonal^2."""
    iou = pairwise_iou_xywh_topleft(boxes1, boxes2, use_iol=use_iol)
    c1x = boxes1[..., :, None, 0] + boxes1[..., :, None, 2] / 2.0
    c1y = boxes1[..., :, None, 1] + boxes1[..., :, None, 3] / 2.0
    c2x = boxes2[..., None, :, 0] + boxes2[..., None, :, 2] / 2.0
    c2y = boxes2[..., None, :, 1] + boxes2[..., None, :, 3] / 2.0
    dx, dy = c1x - c2x, c1y - c2y
    center_dist = dx * dx + dy * dy
    enc_xmin = torch.minimum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    enc_ymin = torch.minimum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    enc_xmax = torch.maximum(boxes1[..., :, None, 0] + boxes1[..., :, None, 2],
                             boxes2[..., None, :, 0] + boxes2[..., None, :, 2])
    enc_ymax = torch.maximum(boxes1[..., :, None, 1] + boxes1[..., :, None, 3],
                             boxes2[..., None, :, 1] + boxes2[..., None, :, 3])
    ex, ey = enc_xmax - enc_xmin, enc_ymax - enc_ymin
    diag = ex * ex + ey * ey
    return iou - center_dist / (diag + EPS)


# ---------------------------------------------------------------------------
# Letterbox coordinate transforms (host numpy, per image after NMS)
# ---------------------------------------------------------------------------

def undo_letterbox_boxes(boxes_cxcywh_norm, image_hw, model_hw):
    """Normalized canvas ``(cx, cy, w, h)`` -> top-left ``(x, y, w, h)``
    in original image pixels (inverse of the letterbox transform)."""
    boxes = np.asarray(boxes_cxcywh_norm, np.float32)
    box_xy, box_wh = boxes[..., 0:2], boxes[..., 2:4]
    image_hw = np.asarray(image_hw, np.float32)
    model_hw = np.asarray(model_hw, np.float32)
    new_shape = np.round(image_hw * np.min(model_hw / image_hw))
    offset_hw = (model_hw - new_shape) / 2.0 / model_hw
    scale_hw = model_hw / new_shape
    offset, scale = offset_hw[::-1], scale_hw[::-1]   # (x, y)
    box_xy = (box_xy - offset) * scale
    box_wh = box_wh * scale
    box_xy = box_xy - box_wh / 2.0
    image_wh = image_hw[::-1]
    return np.concatenate([box_xy * image_wh, box_wh * image_wh], axis=-1)


def clip_boxes_xywh(boxes_xywh, image_hw):
    """Clip top-left boxes to the image; both corners clip, w/h shrink."""
    boxes = np.asarray(boxes_xywh, np.float32)
    image_hw = np.asarray(image_hw, np.float32)
    x1 = np.clip(boxes[..., 0], 0.0, image_hw[1])
    y1 = np.clip(boxes[..., 1], 0.0, image_hw[0])
    x2 = np.clip(boxes[..., 0] + boxes[..., 2], 0.0, image_hw[1])
    y2 = np.clip(boxes[..., 1] + boxes[..., 3], 0.0, image_hw[0])
    return np.stack([x1, y1, x2 - x1, y2 - y1], axis=-1)


def canvas_boxes_to_image(boxes_xywh, image_hw, model_hw,
                          clip: bool = True):
    """Top-left boxes in letterbox-canvas pixels -> original image pixels."""
    boxes = np.asarray(boxes_xywh, np.float32)
    model_wh = np.asarray(model_hw, np.float32)[::-1]
    cxcy = (boxes[..., 0:2] + boxes[..., 2:4] / 2.0) / model_wh
    wh = boxes[..., 2:4] / model_wh
    out = undo_letterbox_boxes(np.concatenate([cxcy, wh], axis=-1),
                               image_hw, model_hw)
    if clip:
        out = clip_boxes_xywh(out, image_hw)
    return out
