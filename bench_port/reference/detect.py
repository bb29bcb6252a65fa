"""Plain PyTorch reference of MultiGridDet's decode and greedy NMS.

Decode (MultiGridDet, as the repository's configurations state it): for
a scale's logits ``t`` of a cell at column ``cx``, row ``cy`` of a
``gw x gh`` grid, ``x = (tanh(0.15 t_x) + sigmoid(0.15 t_x) + cx) / gw``
(and ``y`` alike), the anchor is the argmax of the anchor logits and
``w = anchor_w * exp(t_w) / W`` (``h`` alike), the class is the argmax of
the class logits, and the score is ``sigmoid(obj) * max softmax(anchor
logits) * max softmax(class logits)``.  Boxes are returned as top-left
``(x, y, w, h)`` canvas pixels, one candidate per cell.

NMS is the class-agnostic greedy pop-max: drop candidates below the
confidence, then ``max_boxes`` times take the highest score left (the
lowest index among equal scores), keep it, and remove every candidate
whose overlap with it is at least the threshold.  The overlap is DIoU
over IoL (intersection over the larger area, less the squared centre
distance over the squared diagonal of the enclosing box).  The number of
(kept box, live candidate) pairs the steps compare is counted: it is the
work of the pop-max kernel (``counts/popmax_nms.json``).

Imports nothing but torch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

EPS = 1e-8
NEG = -1e9


def xy_act(t):
    return torch.tanh(0.15 * t) + torch.sigmoid(0.15 * t)


def decode_level(logits: torch.Tensor, anchors: torch.Tensor,
                 canvas_hw: Tuple[int, int], num_anchors: int):
    """One scale's ``[B, gh, gw, A + C + 5]`` logits -> per-cell
    candidates: boxes ``[B, gh*gw, A, 4]`` (top-left canvas pixels under
    each anchor), scores ``[B, gh*gw]``, class ``[B, gh*gw]``, anchor
    ``[B, gh*gw]`` (the argmax), and the logit margins of every class and
    anchor below the best (``[B, gh*gw, C]``, ``[B, gh*gw, A]``)."""
    b, gh, gw, _ = logits.shape
    dev = logits.device
    H, W = canvas_hw
    rows, cols = torch.meshgrid(torch.arange(gh, device=dev,
                                             dtype=torch.float32),
                                torch.arange(gw, device=dev,
                                             dtype=torch.float32),
                                indexing='ij')
    cx = (xy_act(logits[..., 0]) + cols) / gw * W
    cy = (xy_act(logits[..., 1]) + rows) / gh * H
    wh = anchors[None, None, None] * torch.exp(logits[..., None, 2:4])
    box_cx, box_cy = cx[..., None], cy[..., None]
    boxes = torch.stack([box_cx - wh[..., 0] / 2, box_cy - wh[..., 1] / 2,
                         wh[..., 0], wh[..., 1]], dim=-1)   # [B,gh,gw,A,4]
    a_log = logits[..., 5:5 + num_anchors]
    c_log = logits[..., 5 + num_anchors:]
    score = (torch.sigmoid(logits[..., 4])
             * torch.softmax(a_log, -1).amax(-1)
             * torch.softmax(c_log, -1).amax(-1))
    n = gh * gw
    return (boxes.reshape(b, n, num_anchors, 4), score.reshape(b, n),
            c_log.argmax(-1).reshape(b, n), a_log.argmax(-1).reshape(b, n),
            (c_log.amax(-1, keepdim=True) - c_log).reshape(b, n, -1),
            (a_log.amax(-1, keepdim=True) - a_log).reshape(b, n, -1))


def decode(maps: Sequence[torch.Tensor], anchors: Sequence,
           canvas_hw: Tuple[int, int]):
    """All scales, coarse first, concatenated along the cells.  Returns
    ``dict(boxes_all [B, N, A, 4], boxes [B, N, 4] (the argmax anchor's),
    scores, classes, anchors, class_margin, anchor_margin)``."""
    parts = []
    for m, a in zip(maps, anchors):
        a = torch.as_tensor(a, dtype=torch.float32, device=m.device)
        parts.append(decode_level(m.float(), a, canvas_hw, a.shape[0]))
    out = [torch.cat([p[i] for p in parts], dim=1) for i in range(6)]
    boxes_all = out[0]
    idx = out[3][..., None, None].expand(-1, -1, 1, 4)
    return {'boxes_all': boxes_all,
            'boxes': boxes_all.gather(2, idx)[:, :, 0],
            'scores': out[1], 'classes': out[2], 'anchors': out[3],
            'class_margin': out[4], 'anchor_margin': out[5]}


def overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DIoU over IoL of top-left boxes ``[..., N, 4] x [..., M, 4]`` ->
    ``[..., N, M]``."""
    x1, y1, w1, h1 = (a[..., :, None, i] for i in range(4))
    x2, y2, w2, h2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp_min(torch.minimum(x1 + w1, x2 + w2)
                         - torch.maximum(x1, x2), 0.0)
    ih = torch.clamp_min(torch.minimum(y1 + h1, y2 + h2)
                         - torch.maximum(y1, y2), 0.0)
    iol = iw * ih / (torch.maximum(w1 * h1, w2 * h2) + EPS)
    dx = (x1 + w1 / 2) - (x2 + w2 / 2)
    dy = (y1 + h1 / 2) - (y2 + h2 / 2)
    ex = torch.maximum(x1 + w1, x2 + w2) - torch.minimum(x1, x2)
    ey = torch.maximum(y1 + h1, y2 + h2) - torch.minimum(y1, y2)
    return iol - (dx * dx + dy * dy) / (ex * ex + ey * ey + EPS)


def popmax_nms(boxes: torch.Tensor, scores: torch.Tensor,
               classes: torch.Tensor, confidence: float, threshold: float,
               max_boxes: int):
    """Greedy NMS, batched.  Returns ``(boxes [B, M, 4], classes [B, M],
    scores [B, M], valid [B, M], pairs)`` with ``pairs`` the number of
    (kept box, live candidate) comparisons the steps made."""
    b, n = scores.shape
    dev = scores.device
    s = torch.where(scores >= confidence, scores, torch.full((), NEG,
                                                             device=dev))
    col = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    out_b = torch.zeros(b, max_boxes, 4, device=dev)
    out_c = torch.zeros(b, max_boxes, dtype=torch.long, device=dev)
    out_s = torch.full((b, max_boxes), NEG, device=dev)
    out_v = torch.zeros(b, max_boxes, dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.long, device=dev)
    for i in range(max_boxes):
        alive = s > NEG / 2
        cur = s.amax(1)
        live = cur > NEG / 2
        pairs += (alive & live[:, None]).sum()
        idx = torch.where(s == cur[:, None], col, n).amin(1).clamp_max(n - 1)
        bi = boxes[rows, idx]
        ov = overlap(bi[:, None], boxes)[:, 0]
        sup = ((ov >= threshold) | (col == idx[:, None])) & live[:, None]
        s = torch.where(sup, torch.full((), NEG, device=dev), s)
        out_b[:, i] = bi
        out_c[:, i] = classes[rows, idx]
        out_s[:, i] = torch.where(live, cur, out_s[:, i])
        out_v[:, i] = live
    return out_b, out_c, out_s, out_v, int(pairs)
