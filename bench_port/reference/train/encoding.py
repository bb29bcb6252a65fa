"""Frozen copy of ``multigriddet_tpu_torch/ops/encoding.py`` for the plain
reference (imports rewritten; nothing of the program is imported).

3x3 multi-grid target encoding on tensors.

Counterpart of ``multigriddet_tpu/ops/encoding.py``.  For each valid box,
in annotation order:

  pick (layer, anchor) = argmax IoL over all anchors (rounded to 3 dp,
  first index on ties); take the cell (i = col, j = row) of the box centre
  ``floor((x1 + x2) / 2)`` and the offsets tx, ty; tw, th =
  log(max(wh / anchor_wh, 1e-3)); then for the 9 candidates (ki, kj) in
  ki-major order: skip a cell out of bounds; skip a cell already taken
  while the box holds 3 or more cells; else overwrite the cell with
  ``[tx - ki, ty - kj, tw, th, 1, onehot(anchor), onehot(class)]``.

The rule is serial over boxes.  The port precomputes everything that does
not depend on the grid's state for all boxes of the batch at once, then
loops over the box index up to the batch's largest valid count; each
iteration reads the occupancy of every image's candidate cells and writes
them with one scatter.  Within a box the write rule has a closed form:
candidate c writes iff it is in bounds and either fewer than 3 in-bound
candidates precede it (the count still below 3 means it writes whatever
the occupancy) or its cell is free.

The valid count is taken where the boxes are: boxes handed over on the CPU
(the generator's numpy batches) cost the device no sync; boxes already on
the card cost one host sync per batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .util import iol_wh, to_device

# candidate (ki, kj) order: ki-major, kj-minor
_KI = np.repeat(np.arange(-1, 2), 3)          # [-1,-1,-1, 0,0,0, 1,1,1]
_KJ = np.tile(np.arange(-1, 2), 3)            # [-1, 0, 1,-1,0,1,-1, 0, 1]
MAX_CELLS_PER_BOX = 3


def flatten_anchors(anchors: Sequence[np.ndarray]):
    """(all_anchors [TA, 2] f32, layer_of [TA] i32, k_of [TA] i32)."""
    all_anchors = np.concatenate([np.asarray(a, np.float32) for a in anchors],
                                 0)
    layer_of = np.concatenate(
        [np.full(len(a), l, np.int32) for l, a in enumerate(anchors)])
    k_of = np.concatenate(
        [np.arange(len(a), dtype=np.int32) for a in anchors])
    return all_anchors, layer_of, k_of


def _rounded_iol(boxes_wh: torch.Tensor, all_anchors: torch.Tensor):
    return torch.round(iol_wh(boxes_wh, all_anchors) * 1000.0) / 1000.0


def match_anchors(boxes_wh: torch.Tensor, all_anchors: torch.Tensor,
                  layer_of: torch.Tensor, k_of: torch.Tensor):
    """Best (layer, anchor) per ``[..., N, 2]`` box by rounded IoL:
    (layer ``[..., N]``, k ``[..., N]``, anchor_wh ``[..., N, 2]``)."""
    gidx = torch.argmax(_rounded_iol(boxes_wh, all_anchors), dim=-1)
    return layer_of[gidx], k_of[gidx], all_anchors[gidx]


def default_grid_shapes(input_hw: Tuple[int, int], num_layers: int):
    strides = (32, 16, 8, 4, 2)
    return tuple((input_hw[0] // strides[l], input_hw[1] // strides[l])
                 for l in range(num_layers))


def encode_targets(boxes, anchors: Sequence[np.ndarray], num_classes: int,
                   input_hw: Tuple[int, int],
                   grid_shapes: Optional[Sequence[Tuple[int, int]]] = None,
                   multi_anchor_assign: bool = False,
                   multi_anchor_thresh: float = 0.8,
                   device=None) -> Tuple[torch.Tensor, ...]:
    """Encode a padded batch of boxes into the per-layer target grids.

    Args:
      boxes: ``[B, N, 5]`` ``(x1, y1, x2, y2, class)`` in canvas pixels,
        numpy or a tensor; rows with ``w * h <= 0`` are padding.
      anchors: per-layer ``[A_l, 2]`` anchors (pixels), coarse layer first.
      device: where the grids are built; default: where ``boxes`` lie.

    Returns:
      tuple of ``[B, gh_l, gw_l, 5 + A_l + C]`` float32 grids.
    """
    boxes = torch.as_tensor(np.asarray(boxes, np.float32)
                            if not isinstance(boxes, torch.Tensor)
                            else boxes, dtype=torch.float32)
    dev = torch.device(device) if device is not None else boxes.device
    anchors = [np.asarray(a, np.float32) for a in anchors]
    num_layers = len(anchors)
    if grid_shapes is None:
        grid_shapes = default_grid_shapes(input_hw, num_layers)
    grid_shapes = [tuple(int(v) for v in g) for g in grid_shapes]
    in_h, in_w = input_hw
    bsz = boxes.shape[0]
    a_per = [len(a) for a in anchors]
    feat = [5 + a + num_classes for a in a_per]
    f_max = max(feat)
    cells = [gh * gw for gh, gw in grid_shapes]
    offsets = np.concatenate([[0], np.cumsum(cells)]).astype(np.int64)
    total = int(offsets[-1])

    # stable-partition the valid boxes to the front; the loop runs to the
    # batch's largest valid count, counted where the boxes lie
    wh0 = boxes[..., 2:4] - boxes[..., 0:2]
    valid0 = (wh0[..., 0] * wh0[..., 1]) > 0.0
    max_valid = int(valid0.sum(1).max()) if bsz else 0
    perm = torch.sort((~valid0).to(torch.uint8), dim=1, stable=True)[1]
    boxes = torch.gather(boxes, 1, perm[..., None].expand(-1, -1, 5))
    boxes = to_device(boxes[:, :max_valid], dev)

    grid = torch.zeros(bsz, total + 1, f_max, device=dev)   # + a sink row
    if max_valid:
        idx, always, if_free, vals = _candidates(
            boxes, anchors, num_classes, (in_h, in_w), grid_shapes,
            offsets, f_max, multi_anchor_assign, multi_anchor_thresh)
        rows = torch.arange(bsz, device=dev)[:, None]
        sink = torch.full_like(idx[:, 0], total)
        for t in range(max_valid):
            idx_t = idx[:, t]
            taken = grid[rows, idx_t, 4] > 0.5
            write = always[:, t] | (if_free[:, t] & ~taken)
            grid[rows, torch.where(write, idx_t, sink)] = vals[:, t]
    out: List[torch.Tensor] = []
    for l, (gh, gw) in enumerate(grid_shapes):
        g = grid[:, offsets[l]:offsets[l + 1], :feat[l]]
        out.append(g.reshape(bsz, gh, gw, feat[l]))
    return tuple(out)


def _candidates(boxes, anchors, num_classes, input_hw, grid_shapes, offsets,
                f_max, multi_anchor_assign, multi_anchor_thresh):
    """Everything of the 9-cell write that does not depend on the grid:
    per (image, box, layer x candidate) the flat cell index, whether it
    writes regardless of occupancy, whether it writes only a free cell, and
    the row it writes.  Shapes ``[B, M, L * 9]`` and ``[B, M, L * 9, F]``."""
    dev = boxes.device
    in_h, in_w = input_hw
    all_np, layer_np, k_np = flatten_anchors(anchors)
    all_anchors = to_device(all_np, dev)
    layer_of = to_device(layer_np, dev, torch.long)
    k_of = to_device(k_np, dev, torch.long)
    ki = to_device(_KI, dev, torch.long)
    kj = to_device(_KJ, dev, torch.long)
    class_ids = torch.arange(num_classes, device=dev)

    xy = torch.floor((boxes[..., 0:2] + boxes[..., 2:4]) / 2.0)
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    cls = boxes[..., 4].long()
    valid = (wh[..., 0] * wh[..., 1]) > 0.0
    iols = _rounded_iol(wh, all_anchors)                    # [B, M, TA]
    sel_layer = layer_of[torch.argmax(iols, dim=-1)]
    best_global = torch.amax(iols, dim=-1)

    idx, always, if_free, vals = [], [], [], []
    for l, (gh, gw) in enumerate(grid_shapes):
        a_l = len(anchors[l])
        masked = torch.where((layer_of == l), iols,
                             torch.full_like(iols, -1.0))
        gidx = torch.argmax(masked, dim=-1)
        box_k = k_of[gidx]
        box_twh = torch.log(torch.clamp_min(wh / all_anchors[gidx], 1e-3))
        cx = xy[..., 0] * (gw / in_w)
        cy = xy[..., 1] * (gh / in_h)
        i = torch.floor(cx).long()
        j = torch.floor(cy).long()
        tx, ty = cx - i, cy - j
        ci = i[..., None] + ki                               # [B, M, 9]
        cj = j[..., None] + kj
        inb = (ci >= 0) & (ci < gw) & (cj >= 0) & (cj < gh)
        on_layer = valid & (sel_layer == l)
        if multi_anchor_assign:
            layer_iol = torch.amax(masked, dim=-1)
            qualifies = ((layer_iol / torch.clamp_min(best_global, 1e-8))
                         >= multi_anchor_thresh) & (layer_iol > 0.5)
            on_layer = valid & ((sel_layer == l) | qualifies)
        # the count still below 3: fewer than 3 in-bound candidates precede
        before = torch.cumsum(inb.long(), -1) - inb.long()
        low = before < MAX_CELLS_PER_BOX
        live = inb & on_layer[..., None]
        always.append(live & low)
        if_free.append(live & ~low)
        flat = (int(offsets[l]) + cj.clamp(0, gh - 1) * gw
                + ci.clamp(0, gw - 1))
        idx.append(flat)
        row = torch.zeros(*ci.shape, f_max, device=dev)
        row[..., 0] = tx[..., None] - ki
        row[..., 1] = ty[..., None] - kj
        row[..., 2:4] = box_twh[..., None, :]
        row[..., 4] = 1.0
        row[..., 5:5 + a_l] = F.one_hot(box_k, a_l).float()[..., None, :]
        row[..., 5 + a_l:5 + a_l + num_classes] = (
            cls[..., None] == class_ids).float()[..., None, :]
        vals.append(row)
    return (torch.cat(idx, -1), torch.cat(always, -1), torch.cat(if_free, -1),
            torch.cat(vals, -2))


def extract_center_gt_boxes(y_true_layer: torch.Tensor,
                            anchors_layer, input_hw: Tuple[int, int],
                            max_boxes: int):
    """Recover up to ``max_boxes`` boxes from a target grid: each box owns
    one centre cell, whose offsets lie in [0, 1).  Cells are taken in flat
    order (``jax.lax.top_k`` of the 0/1 centre mask: lower index first).

    Returns (boxes ``[B, max_boxes, 4]`` cxcywh in canvas pixels, mask
    ``[B, max_boxes]``).
    """
    in_h, in_w = input_hw
    b, gh, gw, _ = y_true_layer.shape
    dev = y_true_layer.device
    if not isinstance(anchors_layer, torch.Tensor):
        anchors_layer = to_device(np.asarray(anchors_layer, np.float32), dev)
    txy = y_true_layer[..., 0:2]
    obj = y_true_layer[..., 4]
    is_center = ((txy[..., 0] >= 0.0) & (txy[..., 0] < 1.0)
                 & (txy[..., 1] >= 0.0) & (txy[..., 1] < 1.0) & (obj > 0.5))
    cols = torch.arange(gw, dtype=torch.float32, device=dev)
    rows = torch.arange(gh, dtype=torch.float32, device=dev)[:, None]
    cx = (txy[..., 0] + cols) * (in_w / gw)
    cy = (txy[..., 1] + rows) * (in_h / gh)
    n_anchors = anchors_layer.shape[0]
    anchor_idx = torch.argmax(y_true_layer[..., 5:5 + n_anchors], dim=-1)
    wh = torch.exp(y_true_layer[..., 2:4]) * anchors_layer[anchor_idx]
    score = is_center.float().reshape(b, -1)
    k = min(max_boxes, score.shape[1])
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    flat = torch.cat([cx[..., None], cy[..., None], wh],
                     dim=-1).reshape(b, -1, 4)
    boxes = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 4))
    if k < max_boxes:
        boxes = F.pad(boxes, (0, 0, 0, max_boxes - k))
        top = F.pad(top, (0, max_boxes - k))
    return boxes, top > 0.5
