"""The correctness numbers of a serve cell: served detections against the
plain reference's float32 forward and decode of the same canvases.

Each served detection (box, class, score; top-left canvas pixels) is
matched to the reference candidate nearest to it: over every cell and
every anchor of the three scales, the least largest coordinate gap.  Per
image, over its served detections:

* ``box_err``: the median of one less the IoU of the served box and the
  matched reference box (a box scaled by 1.1 reads 0.17, one moved by a
  tenth of its width 0.18);
* ``score_err``: the median gap between the served score and the
  reference's at the matched cell;
* ``logit_gap``: the 90th percentile of the margin by which the served
  class's logit, or the matched anchor's, lies below the reference's best
  at its cell (0 where both are the reference's argmax);
* ``greedy_gap``: the served list replayed as greedy NMS on the
  reference's scores and boxes: before each served detection, the highest
  reference score among the candidates that no earlier served detection
  suppresses (overlap under the threshold less a margin for rounding in
  the boxes), less the served detection's reference score; after the last
  one, while the image holds fewer than ``max_boxes``, the highest such
  score less the confidence (a candidate left out).  The median over
  these steps: an image whose list is missing, reordered or cut short
  reads the scores it passed over.

Each of these is the mean over the images compared: the random network's
bfloat16 rounding moves a few detections of thousands far, and the
medians and means keep the numbers steady from seed to seed (``PERF.md``).

* ``kept_overlap``: the largest overlap of two served detections' own
  boxes, less the threshold.  Greedy NMS keeps no box that overlaps an
  earlier kept one by the threshold or more, and the served boxes are the
  ones it compared, so this holds exactly up to the overlap's float32
  rounding (a kept box that an earlier one should have removed reads
  above it).

The limits are in ``checks/<cell>.json``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port.reference.detect import decode, overlap

# rounding in the served model's boxes moves overlaps by about this much:
# a candidate this close under the threshold counts as suppressed
OVERLAP_MARGIN = 0.05
NUMBERS = ('box_err', 'score_err', 'logit_gap', 'greedy_gap',
           'kept_overlap')
PER_IMAGE = ('box_err', 'score_err', 'logit_gap', 'greedy_gap')


def compare(ref: Dict[str, torch.Tensor], served, confidence: float,
            threshold: float, max_boxes: int) -> Dict[str, float]:
    """``ref``: :func:`decode` of the reference maps of a batch;
    ``served``: the batch's ``(boxes [B, M, 4], classes [B, M], scores
    [B, M], valid [B, M])`` as the program returned them (numpy or
    tensors)."""
    dev = ref['scores'].device
    sb, sc, ss, sv = (torch.as_tensor(a).to(dev) for a in served)
    sb, ss = sb.float(), ss.float()
    per_image = {k: [] for k in PER_IMAGE}
    kept = -threshold
    b, n, na, _ = ref['boxes_all'].shape
    for i in range(b):
        k = int(sv[i].sum())
        if not bool(sv[i, :k].all()):
            raise ValueError('served valid slots are not a prefix')
        boxes_i = sb[i, :k]
        flat = ref['boxes_all'][i].reshape(n * na, 4)
        scores = ref['scores'][i]
        if k:
            gap = (boxes_i[:, None, :] - flat[None]).abs().amax(-1)
            j = gap.argmin(1)
            cell, anchor = j // na, j % na
            per_image['box_err'].append(float(
                (1 - iou(boxes_i, flat[j])).median()))
            per_image['score_err'].append(float(
                (ss[i, :k] - scores[cell]).abs().median()))
            cls = sc[i, :k].long().clamp(0, ref['class_margin'].shape[-1] - 1)
            bad_class = sc[i, :k].long() != cls
            cm = ref['class_margin'][i, cell, cls]
            cm = torch.where(bad_class, torch.full_like(cm, float('inf')), cm)
            am = ref['anchor_margin'][i, cell, anchor]
            per_image['logit_gap'].append(float(torch.quantile(
                torch.maximum(cm, am), 0.9)))
            picks = flat[j]
        else:
            cell = torch.zeros(0, dtype=torch.long, device=dev)
            picks = torch.zeros(0, 4, device=dev)
        per_image['greedy_gap'].append(_greedy_gap(
            ref['boxes'][i], scores, cell, picks, confidence, threshold,
            max_boxes))
        if k > 1:
            earlier = torch.tril(torch.ones(k, k, dtype=torch.bool,
                                            device=dev), -1)
            ov = overlap(boxes_i, boxes_i)
            kept = max(kept, float(ov[earlier].max()))
    out = {k: sum(v) / len(v) if v else 0.0 for k, v in per_image.items()}
    out['kept_overlap'] = kept - threshold
    return out


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of top-left boxes ``[k, 4]`` with ``[k, 4]``, pair by pair."""
    iw = torch.clamp_min(torch.minimum(a[:, 0] + a[:, 2], b[:, 0] + b[:, 2])
                         - torch.maximum(a[:, 0], b[:, 0]), 0.0)
    ih = torch.clamp_min(torch.minimum(a[:, 1] + a[:, 3], b[:, 1] + b[:, 3])
                         - torch.maximum(a[:, 1], b[:, 1]), 0.0)
    inter = iw * ih
    union = a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter
    return inter / torch.clamp_min(union, 1e-9)


def _greedy_gap(boxes, scores, cell, picks, confidence, threshold,
                max_boxes) -> float:
    """See the module docstring.  ``boxes``/``scores``: one image's
    reference candidates ``[N, 4]``, ``[N]``; ``cell``: the served
    detections' matched cells ``[k]``; ``picks``: their reference boxes."""
    k, n = cell.shape[0], scores.shape[0]
    dev = scores.device
    ok = scores >= confidence
    # suppressed[t, c]: an earlier served box (index < t) removes c
    if k:
        hit = overlap(picks, boxes) >= threshold - OVERLAP_MARGIN   # [k, N]
        hit[torch.arange(k, device=dev), cell] = True
        before = torch.cumsum(hit.int(), 0) > 0
        suppressed = torch.cat([torch.zeros(1, n, dtype=torch.bool,
                                            device=dev), before], 0)
    else:
        suppressed = torch.zeros(1, n, dtype=torch.bool, device=dev)
    avail = ok[None] & ~suppressed                                 # [k+1, N]
    best = torch.where(avail, scores[None], torch.full((), -1.0,
                                                       device=dev)).amax(1)
    gaps = [best[:k] - scores[cell]] if k else []
    if k < max_boxes:
        gaps.append((best[k] - confidence).reshape(1))
    if not gaps:
        return 0.0
    return max(0.0, float(torch.cat(gaps).median()))


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Over several batches of one size: the mean of the per-image
    numbers and the largest ``kept_overlap``."""
    if not readings:
        return {k: 0.0 for k in NUMBERS}
    out = {k: sum(r[k] for r in readings) / len(readings) for k in PER_IMAGE}
    out['kept_overlap'] = max(r['kept_overlap'] for r in readings)
    return out
