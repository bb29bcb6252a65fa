"""Frozen copy of ``multigriddet_tpu_torch/losses/multigrid_loss.py`` for the plain
reference (imports rewritten; nothing of the program is imported).

MultiGridDet composite loss on tensors.

Counterpart of ``multigriddet_tpu/losses/multigrid_loss.py``: the same
terms, options and metrics dict, the same float32 expressions.

  total = coord_scale * L_loc + object_scale * L_obj
        + anchor_scale * L_anchor + class_scale * L_class
        [+ consensus_{coord,obj,class}_scale * consensus terms]

* Option 1: masked MSE on (activated xy, log wh); option 2 adds the BCE
  anchor-prediction loss; option 3 is GIoU/DIoU/CIoU on decoded boxes.
* Objectness: BCE over all cells, object/no-object scales, the ignore
  mask, optional IoU-aware soft targets and the trainable-NMS term.
* Class: BCE (label smoothing, class weights) or sigmoid/softmax focal.
* Consensus: IoL^p-weighted variance over the 3x3 cells that decode to
  the same box centre.

The ignore mask, the assigned-anchor IoU and the max IoU carry no
gradient in JAX (``stop_gradient``); here they are computed under
``torch.no_grad()``, so autograd keeps none of the ``[B, cells, G]`` IoU
tensors for the backward.  The IoU against the GT boxes is taken one
anchor at a time, which bounds its peak memory to ``[B, cells, G]``.

Under data parallel (``parallel.distributed``) the normalizers are the
global batch's: the ``batch`` and ``grid`` factors count the global batch,
the ``positives`` factor and the consensus normalizer sum over the ranks.
Each rank's loss is then its share of the global loss, and the ranks'
gradients and metrics are summed (``num_positives`` stays the rank's own
count until the step sums the metrics).

Under a spatial partition (``parallel/spatial.py``) the predictions are
this rank's band of rows of each map while ``y_true`` is whole, as JAX
places it ``P('batch')``: the per-cell terms read the band's rows of
``y_true``, the ignore mask compares the band's boxes with the GT boxes
of the whole image, the consensus patches gather their halo rows from the
neighbouring bands (with gradients through the fetched predictions), the
``batch`` and ``grid`` factors count the global batch at the global grid,
and the positives and consensus normalizers sum each cell once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .encoding import extract_center_gt_boxes
from .util import all_sum, spatial, to_device, world_size, xy_activation
from .focal import (binary_cross_entropy_with_logits, sigmoid_focal_loss,
                    softmax_focal_loss)
from .iou import iou_family_loss

METRIC_KEYS = ('location', 'objectness', 'anchor', 'classification',
               'consensus_coord', 'consensus_obj', 'consensus_class')


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss configuration; defaults as in the JAX package."""

    loss_option: int = 2
    ignore_thresh: float = 0.5
    coord_scale: float = 1.0
    object_scale: float = 1.0
    no_object_scale: float = 1.0
    class_scale: float = 1.0
    anchor_scale: float = 1.0
    label_smoothing: float = 0.0
    use_focal_loss: bool = False
    use_softmax_loss: bool = False
    iou_loss_type: str = 'giou'          # option-3 metric: giou|diou|ciou
    use_iou_aware_objectness: bool = False
    iou_objectness_power: float = 1.5
    iou_objectness_ratio: float = 1.0
    trainable_nms_weight: float = 0.0
    trainable_nms_power: float = 2.0
    use_consensus_loss: bool = False
    consensus_kernel_size: int = 3
    consensus_iou_power: float = 1.5
    consensus_min_iou: float = 1e-3
    consensus_coord_scale: float = 0.5
    consensus_obj_scale: float = 0.5
    consensus_class_scale: float = 0.3
    consensus_stop_gradient: bool = True
    consensus_center_tolerance: float = 1e-4
    loss_normalization: Tuple[str, ...] = ('batch',)
    max_gt_boxes: int = 64               # GT capacity of the ignore mask
    reference_compat: bool = False       # the TF reference's quirks: the
                                         # transposed-grid ignore mask and
                                         # a squared anchor_scale
    eps: float = 1e-7


def _norm_factor(cfg: LossConfig, batch: int, gh: int, gw: int,
                 object_mask: torch.Tensor) -> torch.Tensor:
    factor = torch.ones((), device=object_mask.device)
    for kind in cfg.loss_normalization:
        if kind == 'batch':
            factor = factor * batch
        elif kind == 'grid':
            factor = factor * (batch * gh * gw)
        elif kind == 'positives':
            factor = factor * torch.clamp_min(all_sum(torch.sum(object_mask)),
                                              1.0)
    return torch.clamp_min(factor, 1.0)


def _patches(x: torch.Tensor, k: int, halo: bool = False) -> torch.Tensor:
    """SAME-padded k x k neighbourhoods: [B,H,W,C] -> [B,H,W,k*k,C].  With
    ``halo``, ``x`` already holds its ``k // 2`` rows above and below
    (a band's neighbours) and only the columns are padded."""
    r = k // 2
    if halo:
        h, w = x.shape[1] - 2 * r, x.shape[2]
        xp = F.pad(x, (0, 0, r, r))
    else:
        _, h, w, _ = x.shape
        xp = F.pad(x, (0, 0, r, r, r, r))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :]
                        for dy in range(k) for dx in range(k)], dim=3)


def _pairwise_iou_cxcywh(a: torch.Tensor, b: torch.Tensor,
                         b_mask: torch.Tensor) -> torch.Tensor:
    """IoU between [B,N,4] and [B,G,4] cxcywh boxes -> [B,N,G] (masked)."""
    a_min = a[..., 0:2] - a[..., 2:4] / 2.0
    a_max = a[..., 0:2] + a[..., 2:4] / 2.0
    b_min = b[..., 0:2] - b[..., 2:4] / 2.0
    b_max = b[..., 0:2] + b[..., 2:4] / 2.0
    i_min = torch.maximum(a_min[:, :, None, :], b_min[:, None, :, :])
    i_max = torch.minimum(a_max[:, :, None, :], b_max[:, None, :, :])
    i_wh = torch.clamp_min(i_max - i_min, 0.0)
    inter = i_wh[..., 0] * i_wh[..., 1]
    a_area = (a[..., 2] * a[..., 3])[:, :, None]
    b_area = (b[..., 2] * b[..., 3])[:, None, :]
    iou = inter / (a_area + b_area - inter + 1e-7)
    return torch.where(b_mask[:, None, :], iou, torch.zeros_like(iou))


def _mask_from_iou(cfg, iou_all, y_true, object_mask, na):
    max_iou = torch.amax(iou_all, dim=-1, keepdim=True)
    ignore = ((max_iou > cfg.ignore_thresh)
              & (object_mask < 0.5)).float()
    assigned = torch.sum(iou_all * y_true[..., 5:5 + na], dim=-1,
                         keepdim=True)
    return ignore, assigned * object_mask, max_iou


@torch.no_grad()
def _ignore_mask(cfg: LossConfig, pred_xy, pred_wh, y_true, anchors,
                 object_mask, stride_hw, y_full=None, row0=0):
    """(ignore [B,gh,gw,1], assigned-anchor IoU [B,gh,gw,1], max IoU
    [B,gh,gw,1]) against the GT boxes recovered from the centre cells.
    Under a spatial partition ``pred_xy`` .. ``object_mask`` are a band
    starting at global row ``row0`` and ``y_full`` is the whole map."""
    b, gh, gw, _ = pred_xy.shape
    y_full = y_true if y_full is None else y_full
    na = anchors.shape[0]
    sh, sw = stride_hw
    gt_boxes, gt_mask = extract_center_gt_boxes(
        y_full, anchors, (sh * y_full.shape[1], sw * gw), cfg.max_gt_boxes)
    dev = pred_xy.device
    cols = torch.arange(gw, dtype=torch.float32, device=dev)
    rows = torch.arange(row0, row0 + gh, dtype=torch.float32,
                        device=dev)[:, None]
    pxy = xy_activation(pred_xy)
    px = (pxy[..., 0] + cols) * sw
    py = (pxy[..., 1] + rows) * sh
    centres = torch.stack([px, py], dim=-1)
    ewh = torch.exp(pred_wh)
    per_anchor = []
    for a in range(na):
        pred_boxes = torch.cat([centres, ewh * anchors[a]],
                               dim=-1).reshape(b, -1, 4)
        iou = _pairwise_iou_cxcywh(pred_boxes, gt_boxes, gt_mask)
        per_anchor.append(torch.amax(iou, dim=-1))
    iou_all = torch.stack(per_anchor, dim=-1).reshape(b, gh, gw, na)
    return _mask_from_iou(cfg, iou_all, y_true, object_mask, na)


@torch.no_grad()
def _reference_compat_ignore_mask(cfg: LossConfig, pred_xy, pred_wh, y_true,
                                  anchors, object_mask, stride_hw,
                                  y_full=None, row0=0):
    """The TF reference's ignore mask with its three quirks (JAX
    ``multigrid_loss.py:175-225``): the transposed grid (row index added
    to x), one "GT" per positive cell, and wh inflated by the stride.
    ``y_full`` and ``row0`` as in :func:`_ignore_mask`."""
    b, gh, gw, _ = pred_xy.shape
    y_full = y_true if y_full is None else y_full
    na = anchors.shape[0]
    sh, sw = stride_hw
    dev = pred_xy.device
    scale = to_device(np.asarray([sw, sh], np.float32), dev)

    def coords(lo, hi):
        rows = torch.arange(lo, hi, dtype=torch.float32, device=dev)[:, None]
        cols = torch.arange(gw, dtype=torch.float32, device=dev)
        return torch.stack(torch.broadcast_tensors(rows, cols), dim=-1)

    fcoords = coords(0, y_full.shape[1])
    gxy = (y_full[..., 0:2] + fcoords) * scale
    sel = torch.argmax(y_full[..., 5:5 + na], dim=-1)
    gwh = torch.exp(y_full[..., 2:4]) * anchors[sel] * scale
    gt_boxes = torch.cat([gxy, gwh], dim=-1).reshape(b, -1, 4)
    gt_mask = (y_full[..., 4] > 0.5).reshape(b, -1)
    tcoords = coords(row0, row0 + gh)
    pxy = (xy_activation(pred_xy) + tcoords) * scale
    per_anchor = []
    for a in range(na):
        pwh = torch.exp(pred_wh) * anchors[a] * scale
        pred_boxes = torch.cat([pxy, pwh], dim=-1).reshape(b, -1, 4)
        iou = _pairwise_iou_cxcywh(pred_boxes, gt_boxes, gt_mask)
        per_anchor.append(torch.amax(iou, dim=-1))
    iou_all = torch.stack(per_anchor, dim=-1).reshape(b, gh, gw, na)
    return _mask_from_iou(cfg, iou_all, y_true, object_mask, na)


def _grid(cfg: LossConfig, lo: int, hi: int, gw: int, dev) -> torch.Tensor:
    """The cell coordinates of rows ``[lo, hi)``: ``[1, rows, gw, 2]``."""
    rows = torch.arange(lo, hi, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(gw, dtype=torch.float32, device=dev)
    rows, cols = torch.broadcast_tensors(rows, cols)
    if cfg.reference_compat:
        # the reference's transposed grid: only diagonal neighbours of a
        # box share a decoded centre, so its groups differ
        return torch.stack([rows, cols], dim=-1)[None]
    return torch.stack([cols, rows], dim=-1)[None]


def _consensus_losses(cfg: LossConfig, pred_xy, pred_wh, pred_obj,
                      pred_class, true_xy, object_mask, assigned_iou,
                      y_full=None, row0=0):
    """Variance consensus over same-centre 3x3 groups.  Under a spatial
    partition the inputs are a band from global row ``row0`` of maps whose
    whole targets are ``y_full``; the patches' halo rows come from the
    whole targets and, for the predictions, from the neighbouring bands
    (one exchange, gradients flowing back through the fetched rows)."""
    k = cfg.consensus_kernel_size
    _, gh, gw, _ = pred_xy.shape
    num_classes = pred_class.shape[-1]
    dev = pred_xy.device
    halo = y_full is not None

    center_x = (true_xy[..., 0] >= 0.0) & (true_xy[..., 0] < 1.0)
    center_y = (true_xy[..., 1] >= 0.0) & (true_xy[..., 1] < 1.0)
    center_mask = (center_x & center_y).float()[..., None] * object_mask

    true_centers = true_xy + _grid(cfg, row0, row0 + gh, gw, dev)
    values = {'box': torch.cat([pred_xy, pred_wh], dim=-1),
              'obj': torch.sigmoid(pred_obj),
              'cls': torch.sigmoid(pred_class)}

    if halo:
        r, rows = k // 2, y_full.shape[1]
        f_omask = (y_full[..., 4:5] > 0.5).to(y_full.dtype)
        f_centers = y_full[..., 0:2] + _grid(cfg, 0, rows, gw, dev)
        # the targets' halo: SAME zeros outside the map, as the whole
        # map's patches pad them
        ext = F.pad(torch.cat([f_omask, f_centers], -1),
                    (0, 0, 0, 0, r, r))[:, row0:row0 + gh + 2 * r]
        mask_p = _patches(ext[..., 0:1], k, True)
        center_p = _patches(ext[..., 1:3], k, True)
        pext = spatial.halo_rows(torch.cat(
            [values['box'], values['obj'], values['cls'], assigned_iou], -1),
            rows, r)
        iou_p = _patches(pext[..., -1:], k, True)
        values = {'box': pext[..., 0:4], 'obj': pext[..., 4:5],
                  'cls': pext[..., 5:5 + num_classes]}
    else:
        mask_p = _patches(object_mask, k)
        iou_p = _patches(assigned_iou, k)
        center_p = _patches(true_centers, k)

    same_center = (torch.amax(torch.abs(center_p - true_centers[:, :, :, None]),
                              dim=-1, keepdim=True)
                   < cfg.consensus_center_tolerance).float()
    group = mask_p * same_center * center_mask[:, :, :, None]

    valid_w = torch.where(group > 0.0,
                          torch.clamp_min(iou_p, cfg.consensus_min_iou),
                          torch.zeros_like(iou_p))
    raw_w = torch.pow(valid_w, cfg.consensus_iou_power) * group
    w = raw_w / (torch.sum(raw_w, dim=3, keepdim=True) + cfg.eps)
    w_s = w[..., 0]

    normalizer = torch.clamp_min(all_sum(torch.sum(center_mask)), 1.0)

    def variance(x):
        xp = _patches(x, k, halo)
        consensus = torch.sum(w * xp, dim=3)
        if cfg.consensus_stop_gradient:
            consensus = consensus.detach()
        return torch.square(xp - consensus[:, :, :, None])

    box_d2 = torch.sum(variance(values['box']), dim=-1)
    coord_var = torch.sum(w_s * box_d2) / normalizer

    obj_d2 = variance(values['obj'])[..., 0]
    obj_var = torch.sum(w_s * obj_d2) / normalizer

    cls_d2 = variance(values['cls'])
    cls_var = torch.sum(w_s[..., None] * cls_d2) / (normalizer * num_classes)
    return coord_var, obj_var, cls_var


def multigrid_loss(y_pred: Sequence[torch.Tensor],
                   y_true: Sequence[torch.Tensor],
                   anchors: Sequence,
                   num_classes: int,
                   input_hw: Tuple[int, int],
                   cfg: LossConfig = LossConfig(),
                   class_weights: Optional[torch.Tensor] = None,
                   strides: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MultiGridDet loss over all scales.

    ``y_pred``: per-scale raw logits ``[B, gh, gw, 5 + A_l + C]``;
    ``y_true``: the encoder's targets, same layout; ``anchors``: per-layer
    ``[A_l, 2]`` (numpy or tensors; pass tensors on the device to spare the
    copies); ``strides``: per-layer strides (default: ``input_hw`` over the
    grid).  Returns (scalar total, metrics dict of scalars).
    """
    # the global batch under data parallel (``parallel.distributed``):
    # a space group's ranks hold the same images
    part = spatial.current()
    batch = y_pred[0].shape[0] * world_size() // (
        part.space.size if part is not None else 1)
    dev = y_pred[0].device
    if class_weights is None:
        class_weights = torch.ones((num_classes,), device=dev)
    cw = to_device(class_weights, dev, torch.float32).reshape(
        1, 1, 1, num_classes)

    zero = torch.zeros((), device=dev)
    totals = {k: zero for k in METRIC_KEYS}
    num_pos_total = zero

    for l, (pred, true) in enumerate(zip(y_pred, y_true)):
        # float32, or float64 for a float64 model (the reference of the
        # port's gradient checks)
        pred = pred if pred.dtype == torch.float64 else pred.float()
        true = true.to(pred.dtype)
        anc = anchors[l]
        if not isinstance(anc, torch.Tensor):
            anc = to_device(np.asarray(anc, np.float32), dev)
        na = anc.shape[0]
        _, gh, gw, _ = true.shape           # the whole map's grid
        band = {}
        if part is not None:
            # this rank's band of rows; y_true stays whole for the GT
            # boxes and the consensus halo
            row0, row1 = part.band(gh)
            if pred.shape[1] != row1 - row0:
                raise ValueError(f'scale {l}: a band of {pred.shape[1]} '
                                 f'rows; rank {part.space.index} holds rows '
                                 f'[{row0}, {row1}) of {gh}')
            band = dict(y_full=true, row0=row0)
            true = true[:, row0:row1]
        if strides is not None:
            stride_hw = (float(strides[l]), float(strides[l]))
        else:
            stride_hw = (input_hw[0] / gh, input_hw[1] / gw)

        pred_xy, pred_wh = pred[..., 0:2], pred[..., 2:4]
        pred_obj = pred[..., 4:5]
        pred_anchor = pred[..., 5:5 + na]
        pred_class = pred[..., 5 + na:]
        true_xy, true_wh = true[..., 0:2], true[..., 2:4]
        true_obj = true[..., 4:5]
        true_anchor = true[..., 5:5 + na]
        true_class = true[..., 5 + na:]

        object_mask = (true_obj > 0.5).float()
        num_pos_total = num_pos_total + torch.sum(object_mask)
        norm = _norm_factor(cfg, batch, gh, gw, object_mask)

        mask_fn = (_reference_compat_ignore_mask if cfg.reference_compat
                   else _ignore_mask)
        ignore, assigned_iou, max_iou = mask_fn(
            cfg, pred_xy.detach(), pred_wh.detach(), true, anc, object_mask,
            stride_hw, **band)

        # -------- localization --------
        if cfg.loss_option in (1, 2):
            pxy = xy_activation(pred_xy)
            xy_l = torch.sum(torch.square(true_xy - pxy), -1, keepdim=True)
            wh_l = torch.sum(torch.square(true_wh - pred_wh), -1,
                             keepdim=True)
            loc = torch.sum((xy_l + wh_l) * object_mask) / norm
        else:
            sel = torch.argmax(true_anchor, dim=-1)
            stride_wh = to_device(
                np.asarray([stride_hw[1], stride_hw[0]], np.float32), dev)
            anc_wh = anc[sel] / stride_wh
            p_box_xy = xy_activation(pred_xy)
            p_box_wh = torch.exp(pred_wh) * anc_wh
            t_box_wh = torch.exp(true_wh) * anc_wh
            loc = iou_family_loss(
                cfg.iou_loss_type, true_xy, t_box_wh, p_box_xy, p_box_wh,
                object_mask) / norm
        totals['location'] = totals['location'] + loc

        # -------- objectness --------
        obj_target = true_obj
        if cfg.use_iou_aware_objectness:
            pos_iou = torch.clamp(assigned_iou, 0.0, 1.0)
            iou_t = torch.pow(pos_iou + cfg.eps, cfg.iou_objectness_power)
            blended = (cfg.iou_objectness_ratio * iou_t
                       + (1.0 - cfg.iou_objectness_ratio) * true_obj)
            obj_target = object_mask * blended + (1 - object_mask) * obj_target
        obj_bce = binary_cross_entropy_with_logits(obj_target, pred_obj)
        weight = (object_mask * cfg.object_scale
                  + (1.0 - object_mask) * (1.0 - ignore)
                  * cfg.no_object_scale)
        if cfg.trainable_nms_weight > 0.0:
            supp = torch.pow(torch.clamp(max_iou, 0.0, 1.0) + cfg.eps,
                             cfg.trainable_nms_power)
            weight = weight + ((1.0 - object_mask) * ignore
                               * cfg.trainable_nms_weight * supp)
        totals['objectness'] = (totals['objectness']
                                + torch.sum(obj_bce * weight) / norm)

        # -------- anchor prediction --------
        a_bce = binary_cross_entropy_with_logits(true_anchor, pred_anchor)
        totals['anchor'] = totals['anchor'] + torch.sum(
            a_bce * object_mask * (1.0 - ignore)) / norm

        # -------- classification --------
        if cfg.use_softmax_loss:
            c_l = softmax_focal_loss(true_class, pred_class)
        elif cfg.use_focal_loss:
            c_l = sigmoid_focal_loss(true_class, pred_class)
        else:
            smooth = true_class
            if cfg.label_smoothing > 0:
                smooth = (true_class * (1.0 - cfg.label_smoothing)
                          + cfg.label_smoothing / num_classes)
            c_l = binary_cross_entropy_with_logits(smooth, pred_class)
        totals['classification'] = (totals['classification']
                                    + torch.sum(c_l * cw * object_mask)
                                    / norm)

        # -------- consensus --------
        if cfg.use_consensus_loss:
            cc, co, ccls = _consensus_losses(
                cfg, pred_xy, pred_wh, pred_obj, pred_class, true_xy,
                object_mask, assigned_iou, **band)
            totals['consensus_coord'] = totals['consensus_coord'] + cc
            totals['consensus_obj'] = totals['consensus_obj'] + co
            totals['consensus_class'] = totals['consensus_class'] + ccls

    anchor_scale = (cfg.anchor_scale ** 2 if cfg.reference_compat
                    else cfg.anchor_scale)
    total = (cfg.coord_scale * totals['location']
             + cfg.object_scale * totals['objectness']
             + anchor_scale * totals['anchor']
             + cfg.class_scale * totals['classification'])
    if cfg.use_consensus_loss:
        total = total + (cfg.consensus_coord_scale * totals['consensus_coord']
                         + cfg.consensus_obj_scale * totals['consensus_obj']
                         + cfg.consensus_class_scale
                         * totals['consensus_class'])

    metrics = dict(totals)
    metrics['total'] = total
    metrics['num_positives'] = num_pos_total
    return total, metrics
