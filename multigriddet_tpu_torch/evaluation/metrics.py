"""Custom COCO-style mAP (no pycocotools), vectorized NumPy.

The port's own copy of ``multigriddet_tpu/evaluation/metrics.py`` (host
numpy code, so the numbers are the JAX package's to the last bit), with
the native matcher bound through the port's ``data/native.py``.  It
re-implements the reference's evaluation metrics (the reference's
``evaluation/metrics.py:28-865``): vectorized IoU
matrices, greedy confidence-ordered matching, PR curves with COCO all-point
or VOC 11-point interpolation, per-class AP over an IoU-threshold grid,
small/medium/large breakdowns at the 32^2 / 96^2 COCO area splits, and a
formatted results printer.

Boxes everywhere are top-left ``(x, y, w, h)`` in original-image pixels.
Predictions: dict image_id -> {'boxes': [N,4], 'classes': [N],
'scores': [N]}.  Ground truth: dict image_id -> {'boxes': [M,4],
'classes': [M]}.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..data import native

COCO_IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))
AREA_RANGES = {
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, float('inf')),
}


def iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of top-left xywh boxes: [N, M]
    (reference metrics.py:28-70)."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)), np.float32)
    x11, y11 = boxes1[:, 0:1], boxes1[:, 1:2]
    x12, y12 = x11 + boxes1[:, 2:3], y11 + boxes1[:, 3:4]
    x21, y21 = boxes2[None, :, 0], boxes2[None, :, 1]
    x22, y22 = x21 + boxes2[None, :, 2], y21 + boxes2[None, :, 3]
    iw = np.maximum(0.0, np.minimum(x12, x22) - np.maximum(x11, x21))
    ih = np.maximum(0.0, np.minimum(y12, y22) - np.maximum(y11, y21))
    inter = iw * ih
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    return (inter / np.maximum(a1 + a2 - inter, 1e-9)).astype(np.float32)


def match_detections(pred_boxes, pred_scores, gt_boxes,
                     iou_threshold: float) -> np.ndarray:
    """Greedy confidence-ordered matching (reference metrics.py:73-218).

    Returns a bool TP flag per prediction (sorted by the caller's order).
    """
    n, m = len(pred_boxes), len(gt_boxes)
    tp = np.zeros(n, bool)
    if n == 0 or m == 0:
        return tp
    ious = iou_matrix(pred_boxes, gt_boxes)
    taken = np.zeros(m, bool)
    order = np.argsort(-pred_scores, kind='stable')
    for i in order:
        j = int(np.argmax(np.where(taken, -1.0, ious[i])))
        if ious[i, j] >= iou_threshold and not taken[j]:
            tp[i] = True
            taken[j] = True
    return tp


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      method: str = 'coco') -> float:
    """COCO all-point or VOC 11-point AP (reference metrics.py:221-304)."""
    if method == 'voc':
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = recalls >= t
            ap += (precisions[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _class_pr(predictions: Dict, ground_truths: Dict, class_id: int,
              iou_threshold: float, area_range=None):
    """Per-class TP flags + PR curve over all images (single-threshold
    reference implementation; ``calculate_map`` uses the indexed
    all-thresholds-at-once path below, pinned to this one in
    tests/test_metrics.py)."""
    all_scores, all_tp = [], []
    n_gt = 0
    for img_id, gt in ground_truths.items():
        gmask = gt['classes'] == class_id
        g_boxes = gt['boxes'][gmask]
        if area_range is not None:
            areas = g_boxes[:, 2] * g_boxes[:, 3]
            in_range = (areas >= area_range[0]) & (areas < area_range[1])
        else:
            in_range = np.ones(len(g_boxes), bool)
        n_gt += int(in_range.sum())
        pred = predictions.get(img_id)
        if pred is None or len(pred['boxes']) == 0:
            continue
        pmask = pred['classes'] == class_id
        p_boxes, p_scores = pred['boxes'][pmask], pred['scores'][pmask]
        if area_range is not None:
            p_areas = p_boxes[:, 2] * p_boxes[:, 3]
            p_in = (p_areas >= area_range[0]) & (p_areas < area_range[1])
            p_boxes, p_scores = p_boxes[p_in], p_scores[p_in]
        tp = match_detections(p_boxes, p_scores, g_boxes[in_range],
                              iou_threshold)
        all_scores.append(p_scores)
        all_tp.append(tp)
    if not all_scores:
        return None, n_gt
    scores = np.concatenate(all_scores)
    tp = np.concatenate(all_tp)
    order = np.argsort(-scores, kind='stable')
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recalls = cum_tp / max(n_gt, 1)
    precisions = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    return (recalls, precisions, scores[order], tp), n_gt


class _ClassImageEntry:
    """One (class, image) cell of the eval index: per-class pred scores,
    pred/gt areas, and the pairwise IoU matrix — computed ONCE and reused
    across every IoU threshold and area range (the naive path recomputes
    all of it per (class, threshold, area) task: at COCO scale that is
    80 classes x 10 thresholds x 4 ranges of full-dataset scans)."""

    __slots__ = ('scores', 'p_areas', 'g_areas', 'ious', 'has_pred')

    def __init__(self, scores, p_areas, g_areas, ious, has_pred):
        self.scores = scores
        self.p_areas = p_areas
        self.g_areas = g_areas
        self.ious = ious
        self.has_pred = has_pred


def _build_eval_index(predictions: Dict, ground_truths: Dict):
    """ONE pass over the images -> {class: [entries]}.

    Only images present in ``ground_truths`` participate, and only
    classes appearing in an image (gt or pred side) get an entry there —
    exactly the work :func:`_class_pr` does per task, hoisted out of the
    (threshold x area) grid."""
    index: Dict[int, list] = {}
    for img_id, gt in ground_truths.items():
        g_classes = np.asarray(gt['classes'])
        g_boxes = np.asarray(gt['boxes']).reshape(-1, 4)
        pred = predictions.get(img_id)
        has_pred = pred is not None and len(pred['boxes']) > 0
        classes_here = set(np.unique(g_classes).tolist())
        if has_pred:
            p_classes = np.asarray(pred['classes'])
            p_boxes = np.asarray(pred['boxes']).reshape(-1, 4)
            p_scores = np.asarray(pred['scores'])
            classes_here.update(np.unique(p_classes).tolist())
        for c in classes_here:
            gb = g_boxes[g_classes == c]
            if has_pred:
                pmask = p_classes == c
                pb, ps = p_boxes[pmask], p_scores[pmask]
            else:
                pb = np.zeros((0, 4), np.float32)
                ps = np.zeros((0,), np.float32)
            index.setdefault(int(c), []).append(_ClassImageEntry(
                ps, pb[:, 2] * pb[:, 3], gb[:, 2] * gb[:, 3],
                iou_matrix(pb, gb), has_pred))
    return index


def _match_all_thresholds_np(scores: np.ndarray, ious: np.ndarray,
                             thresholds: np.ndarray) -> np.ndarray:
    """Greedy confidence-ordered matching for EVERY threshold in one
    pass: [T, N] TP flags, threshold t's row identical to
    ``match_detections(..., thresholds[t])`` (same stable score order,
    same first-max-wins argmax tie-break; the taken-gt mask is tracked
    per threshold)."""
    n, m = ious.shape
    t = len(thresholds)
    tp = np.zeros((t, n), bool)
    if n == 0 or m == 0:
        return tp
    order = np.argsort(-scores, kind='stable')
    taken = np.zeros((t, m), bool)
    rows = np.arange(t)
    for i in order:
        masked = np.where(taken, -1.0, ious[i][None, :])     # [T, M]
        j = np.argmax(masked, axis=1)
        ok = masked[rows, j] >= thresholds
        tp[ok, i] = True
        taken[ok, j[ok]] = True
    return tp


def _match_all_thresholds(scores: np.ndarray, ious: np.ndarray,
                          thresholds: np.ndarray) -> np.ndarray:
    """Native matching (``native/matcher.cpp``, the semantics of
    :func:`_match_all_thresholds_np`, held equal in
    tests/test_torch_metrics.py) with the NumPy fallback."""
    n, m = ious.shape
    if n == 0 or m == 0 or not native.matcher_available():
        return _match_all_thresholds_np(scores, ious, thresholds)
    return native.match_all_thresholds(scores, ious, thresholds)


def _class_curves_indexed(entries, thresholds: np.ndarray,
                          area_range=None):
    """PR data for one class at ALL thresholds from the prebuilt index.

    Returns ``((recalls [T,N], precisions [T,N]), n_gt)`` or
    ``(None, n_gt)`` when no gt-image carries predictions — the same
    per-threshold contract as :func:`_class_pr`."""
    n_gt = 0
    scores_parts, tp_parts = [], []
    for e in entries:
        if area_range is None:
            ps, ious = e.scores, e.ious
            n_gt += ious.shape[1]
        else:
            gk = ((e.g_areas >= area_range[0])
                  & (e.g_areas < area_range[1]))
            pk = ((e.p_areas >= area_range[0])
                  & (e.p_areas < area_range[1]))
            n_gt += int(gk.sum())
            ps = e.scores[pk]
            ious = e.ious[pk][:, gk]
        if not e.has_pred:
            continue
        scores_parts.append(ps)
        tp_parts.append(_match_all_thresholds(ps, ious, thresholds))
    if not scores_parts:
        return None, n_gt
    scores = np.concatenate(scores_parts)
    tp = np.concatenate(tp_parts, axis=1)
    order = np.argsort(-scores, kind='stable')
    tp = tp[:, order]
    cum_tp = np.cumsum(tp, axis=1)
    cum_fp = np.cumsum(~tp, axis=1)
    recalls = cum_tp / max(n_gt, 1)
    precisions = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    return (recalls, precisions), n_gt


def calculate_map(predictions: Dict, ground_truths: Dict,
                  num_classes: int,
                  iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS,
                  interpolation_method: str = 'coco',
                  optimize_classes: bool = True,
                  class_names: Optional[Sequence[str]] = None,
                  compute_size_breakdown: bool = True,
                  use_parallel: bool = False) -> Dict:
    """Full mAP computation (reference calculate_map, metrics.py:529-814).

    The heavy lifting runs on a prebuilt index (one pass over the
    images; per-(class, image) IoU matrices computed once) and matches
    all IoU thresholds in a single greedy pass per class, so cost is
    O(images + matches) instead of O(classes x thresholds x ranges x
    images).  ``use_parallel`` fans the per-CLASS tasks over a thread
    pool (NumPy releases the GIL in the heavy kernels) — the counterpart
    of the reference's multiprocessing Pool (metrics.py:596-647) without
    the pickling cost.

    Returns a dict with mAP, mAP50, mAP75, per_class_ap, APS/APM/APL,
    per-class PR curves at IoU 0.5.
    """
    active = set()
    if optimize_classes:
        for gt in ground_truths.values():
            active.update(np.unique(gt['classes']).tolist())
        for p in predictions.values():
            active.update(np.unique(p['classes']).tolist())
    else:
        active = set(range(num_classes))

    ap_grid = np.zeros((num_classes, len(iou_thresholds)), np.float64)
    gt_counts = np.zeros(num_classes, np.int64)
    pr_curves = {}

    index = _build_eval_index(predictions, ground_truths)
    thr_arr = np.asarray(iou_thresholds, np.float64)
    area_items = (list(AREA_RANGES.items()) if compute_size_breakdown
                  else [])

    def class_task(c):
        entries = index.get(c, [])
        pr, n_gt = _class_curves_indexed(entries, thr_arr)
        aps = np.zeros(len(thr_arr), np.float64)
        curve = None
        if pr is not None and n_gt > 0:
            recalls, precisions = pr
            for ti, thr in enumerate(thr_arr):
                aps[ti] = average_precision(recalls[ti], precisions[ti],
                                            interpolation_method)
                if abs(thr - 0.5) < 1e-6:
                    curve = (recalls[ti], precisions[ti])
        # size breakdown: n_gt and pred availability are threshold-
        # independent, so a range contributes either its mean AP over
        # every threshold or nothing
        size_aps = {}
        for size_name, rng in area_items:
            spr, sn_gt = _class_curves_indexed(entries, thr_arr, rng)
            if spr is not None and sn_gt > 0:
                sr, sp = spr
                size_aps[size_name] = float(np.mean([
                    average_precision(sr[ti], sp[ti],
                                      interpolation_method)
                    for ti in range(len(thr_arr))]))
        return c, n_gt, aps, curve, size_aps

    classes = [c for c in sorted(active) if c < num_classes]
    if use_parallel and len(classes) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=8) as pool:
            results_iter = list(pool.map(class_task, classes))
    else:
        results_iter = [class_task(c) for c in classes]
    size_ap_lists: Dict[str, list] = {name: [] for name, _ in area_items}
    for c, n_gt, aps, curve, size_aps in results_iter:
        gt_counts[c] = n_gt
        ap_grid[c] = aps
        if curve is not None:
            pr_curves[c] = curve
        for size_name, ap in size_aps.items():
            size_ap_lists[size_name].append(ap)

    valid = gt_counts > 0
    results: Dict = {
        'per_class_ap': {},
        'gt_counts': gt_counts,
        'pr_curves': pr_curves,
        'iou_thresholds': list(iou_thresholds),
    }
    names = class_names or [str(i) for i in range(num_classes)]
    for c in range(num_classes):
        if valid[c]:
            results['per_class_ap'][names[c]] = {
                'ap': float(ap_grid[c].mean()),
                'ap50': float(ap_grid[c, 0]),
                'count': int(gt_counts[c]),
            }
    if valid.any():
        results['mAP'] = float(ap_grid[valid].mean())
        results['mAP50'] = float(ap_grid[valid, 0].mean())
        i75 = (np.abs(np.asarray(iou_thresholds) - 0.75) < 1e-6).nonzero()[0]
        results['mAP75'] = (float(ap_grid[valid, i75[0]].mean())
                            if len(i75) else float('nan'))
    else:
        results['mAP'] = results['mAP50'] = results['mAP75'] = 0.0

    if compute_size_breakdown:
        for size_name in AREA_RANGES:
            aps = size_ap_lists.get(size_name, [])
            results[f'mAP_{size_name}'] = (float(np.mean(aps)) if aps
                                           else 0.0)
    return results


def format_results(results: Dict, top_k: int = 20) -> str:
    """Formatted results table (reference metrics.py:817-865)."""
    lines = ['=' * 64,
             f"mAP@0.5:0.95 = {results.get('mAP', 0):.4f}   "
             f"mAP@0.5 = {results.get('mAP50', 0):.4f}   "
             f"mAP@0.75 = {results.get('mAP75', 0):.4f}"]
    for size in ('small', 'medium', 'large'):
        key = f'mAP_{size}'
        if key in results:
            lines.append(f'  AP-{size[0].upper()} = {results[key]:.4f}')
    lines.append('-' * 64)
    per_class = sorted(results.get('per_class_ap', {}).items(),
                       key=lambda kv: -kv[1]['ap'])
    lines.append(f'{"class":<28}{"AP":>8}{"AP50":>8}{"#gt":>8}')
    for name, info in per_class[:top_k]:
        lines.append(f'{name:<28}{info["ap"]:>8.4f}{info["ap50"]:>8.4f}'
                     f'{info["count"]:>8d}')
    if len(per_class) > top_k:
        lines.append(f'... {len(per_class) - top_k} more classes')
    lines.append('=' * 64)
    return '\n'.join(lines)


# ---------------------------------------------------------------------------
# Reference-exact mAP (behavioral twin of reference calculate_map)
# ---------------------------------------------------------------------------
# The native calculate_map above implements the STANDARD COCO-style AP
# (all-point step interpolation, GT-bearing classes only).  The reference's
# calculate_map (its evaluation/metrics.py:529-814)
# differs in ways that change the numbers, so accuracy comparisons against
# reference-produced results need this faithful twin:
#
#   1. "coco" AP is np.trapz over recall-sorted interpolated precision with
#      NO (recall=0, precision) anchor (metrics.py:285-302) — it drops the
#      rectangle below the first recall point, so AP is systematically lower
#      than standard all-point AP (up to the full first-point precision).
#   2. Classes with predictions but zero GT contribute AP=0.0 to the mean;
#      classes with GT and no predictions contribute 0.0; a class with
#      neither would score 1.0 but is never active (metrics.py:330, 427-446).
#   3. The UNCACHED matching path computes IoU via BoxUtils.box_iou, which
#      interprets the xyxy boxes it is given as CENTER-format (cx, cy, w, h)
#      (utils/boxes.py:27-37) — a misread that changes the IoU values.  The
#      top-level run uses the cached (correct-xyxy) path while predictions
#      <= 10k, but the APS/APM/APL recursion ALWAYS passes cache_ious=False
#      (metrics.py:752-800), so the reference's size-breakdown numbers are
#      computed with misread IoUs.  Replicated faithfully behind
#      ``cache_ious``.
#   4. Precision/recall use +1e-8 denominators; matching sorts by
#      np.argsort(score)[::-1] (ties in reverse index order).
#
# Inputs use THIS module's dict format (top-left xywh); boxes are converted
# to xyxy internally, matching what the reference evaluator feeds its
# metrics (evaluator.py:115).


def _xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    out = np.asarray(boxes, np.float64).reshape(-1, 4).copy()
    out[:, 2] += out[:, 0]
    out[:, 3] += out[:, 1]
    return out


def _iou_xyxy_pair(a: np.ndarray, b: np.ndarray) -> float:
    """Correct xyxy IoU with the reference's where=union>0 guard."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return float(inter / union) if union > 0 else 0.0


def _iou_center_misread_pair(a: np.ndarray, b: np.ndarray) -> float:
    """Reference BoxUtils.box_iou on xyxy input: treats (x1,y1,x2,y2) as
    (cx,cy,w,h) (reference utils/boxes.py:27-56)."""
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    if ix2 <= ix1 or iy2 <= iy1:
        return 0.0
    inter = (ix2 - ix1) * (iy2 - iy1)
    union = a[2] * a[3] + b[2] * b[3] - inter
    return float(inter / union) if union > 0 else 0.0


def _iou_rows_xyxy(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_iou_xyxy_pair` of one box vs [G,4] gts.

    Same float64 IEEE operations in the same order as the scalar pair
    function, so the values are bit-identical."""
    ix1 = np.maximum(box[0], gts[:, 0])
    iy1 = np.maximum(box[1], gts[:, 1])
    ix2 = np.minimum(box[2], gts[:, 2])
    iy2 = np.minimum(box[3], gts[:, 3])
    inter = np.maximum(0.0, ix2 - ix1) * np.maximum(0.0, iy2 - iy1)
    union = ((box[2] - box[0]) * (box[3] - box[1])
             + (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]) - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _iou_rows_center_misread(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_iou_center_misread_pair` of one box vs [G,4]."""
    ax1, ay1 = box[0] - box[2] / 2, box[1] - box[3] / 2
    ax2, ay2 = box[0] + box[2] / 2, box[1] + box[3] / 2
    gx1, gy1 = gts[:, 0] - gts[:, 2] / 2, gts[:, 1] - gts[:, 3] / 2
    gx2, gy2 = gts[:, 0] + gts[:, 2] / 2, gts[:, 1] + gts[:, 3] / 2
    ix1, iy1 = np.maximum(ax1, gx1), np.maximum(ay1, gy1)
    ix2, iy2 = np.minimum(ax2, gx2), np.minimum(ay2, gy2)
    empty = (ix2 <= ix1) | (iy2 <= iy1)
    inter = (ix2 - ix1) * (iy2 - iy1)
    union = box[2] * box[3] + gts[:, 2] * gts[:, 3] - inter
    ok = ~empty & (union > 0)
    return np.where(ok, inter / np.where(ok, union, 1.0), 0.0)


class _ClassMatchCache:
    """Per-class matching geometry computed ONCE and reused across the IoU
    threshold grid.  The reference recomputes every pairwise IoU per
    threshold (and the naive twin did too — O(P*G) scalar Python per
    threshold); the candidate IoU rows don't depend on the threshold, so
    caching them changes the complexity, not the results."""

    def __init__(self, preds, gts):
        self.preds = preds
        self.n = len(preds)
        scores = np.array([p[2] for p in preds])
        self.order = np.argsort(scores)[::-1]
        self.sorted_scores = scores[self.order]
        # gts grouped by image; local order == global index order, which is
        # what the reference's candidate scan iterates in
        self.gt_count: Dict = {}
        gt_rows: Dict = {}
        for img_id, box in gts:
            gt_rows.setdefault(img_id, []).append(box)
        self.gt_boxes = {img: np.asarray(rows, np.float64)
                         for img, rows in gt_rows.items()}
        self.gt_count = {img: len(rows) for img, rows in gt_rows.items()}
        self._rows: Dict = {}

    def row(self, pi: int, cached: bool) -> np.ndarray:
        key = (pi, cached)
        r = self._rows.get(key)
        if r is None:
            img_id, box, _ = self.preds[pi]
            g = self.gt_boxes[img_id]
            r = (_iou_rows_xyxy(box, g) if cached
                 else _iou_rows_center_misread(box, g))
            self._rows[key] = r
        return r

    def fresh_taken(self) -> Dict:
        return {img: np.zeros(n, bool) for img, n in self.gt_count.items()}


def _ref_match_cached(cache: '_ClassMatchCache', iou_threshold: float,
                      cached: bool):
    """Greedy global-confidence matching for one class, exactly like the
    reference match_predictions_to_gt[_cached] (metrics.py:73-218):

    - cached path: strict-> accumulation from 0.0 over untaken same-image
      gts in index order (first max wins; an all-zero row never matches),
      correct xyxy IoU;
    - uncached path: argmax (first max wins, zero rows CAN match at
      threshold 0), center-misread IoU.

    Returns (tp, fp, sorted scores)."""
    tp = np.zeros(cache.n, bool)
    fp = np.zeros(cache.n, bool)
    taken = cache.fresh_taken()
    for i, pi in enumerate(cache.order):
        img_id = cache.preds[pi][0]
        t = taken.get(img_id)
        if t is None or t.all():
            fp[i] = True
            continue
        row = cache.row(pi, cached)
        if cached:
            masked = np.where(t, -1.0, row)
            k = int(np.argmax(masked))
            if masked[k] > 0.0 and masked[k] >= iou_threshold:
                tp[i] = True
                t[k] = True
            else:
                fp[i] = True
        else:
            masked = np.where(t, -np.inf, row)
            k = int(np.argmax(masked))
            if masked[k] >= iou_threshold:
                tp[i] = True
                t[k] = True
            else:
                fp[i] = True
    return tp, fp, cache.sorted_scores


def _ref_match_class(preds, gts, iou_threshold: float, cached: bool):
    """One-shot wrapper over :func:`_ref_match_cached` (kept for direct
    single-threshold use; ``preds``: list of (image_id, xyxy box, score),
    ``gts``: list of (image_id, xyxy box))."""
    return _ref_match_cached(_ClassMatchCache(preds, gts), iou_threshold,
                             cached)


def _ref_average_precision(precisions: np.ndarray, recalls: np.ndarray,
                           method: str) -> float:
    """Reference compute_average_precision (metrics.py:252-304)."""
    if len(precisions) == 0 or len(recalls) == 0:
        return 0.0
    if method == 'voc':
        vals = []
        for t in np.arange(0, 1.1, 0.1):
            m = recalls >= t
            vals.append(float(precisions[m].max()) if m.any() else 0.0)
        return float(np.mean(vals))
    si = np.argsort(recalls)
    rs, ps = recalls[si], precisions[si]
    interp = np.maximum.accumulate(ps[::-1])[::-1]   # suffix max
    if len(rs) > 1:
        # trapezoid == renamed trapz (numpy 2); keep the old name working
        trapezoid = getattr(np, 'trapezoid', None) or np.trapz
        return float(trapezoid(interp, rs))
    return float(interp[0] * rs[0])


def _ref_class_ap(preds, gts, iou_threshold: float, method: str,
                  cached: bool, cache: Optional[_ClassMatchCache] = None
                  ) -> float:
    """Reference calculate_ap_for_class[_cached] (metrics.py:307-390).

    Pass ``cache`` (built once per class) when evaluating several
    thresholds — the pairwise IoUs are threshold-independent."""
    if not preds:
        return 0.0 if gts else 1.0
    if not gts:
        return 0.0
    if cache is None:
        cache = _ClassMatchCache(preds, gts)
    tp, fp, _ = _ref_match_cached(cache, iou_threshold, cached)
    ct, cf = np.cumsum(tp), np.cumsum(fp)
    precisions = ct / (ct + cf + 1e-8)
    recalls = ct / (len(gts) + 1e-8)
    return _ref_average_precision(precisions, recalls, method)


def _flatten_by_class(predictions: Dict, ground_truths: Dict):
    """Dict-of-image format -> per-class flat lists in the reference
    evaluator's accumulation order (image insertion order, detection
    order within an image — evaluator.py:283-299, 101-127)."""
    preds_by_class: Dict[int, list] = {}
    gts_by_class: Dict[int, list] = {}
    for img_id, p in predictions.items():
        boxes = _xywh_to_xyxy(p['boxes'])
        for box, c, s in zip(boxes, p['classes'], p['scores']):
            preds_by_class.setdefault(int(c), []).append(
                (img_id, box, float(s)))
    for img_id, g in ground_truths.items():
        boxes = _xywh_to_xyxy(g['boxes'])
        for box, c in zip(boxes, g['classes']):
            gts_by_class.setdefault(int(c), []).append((img_id, box))
    return preds_by_class, gts_by_class


def calculate_map_reference(predictions: Dict, ground_truths: Dict,
                            num_classes: int,
                            iou_thresholds: Sequence[float]
                            = COCO_IOU_THRESHOLDS,
                            interpolation_method: str = 'coco',
                            optimize_classes: bool = True,
                            class_names: Optional[Sequence[str]] = None,
                            cache_ious: bool = True,
                            compute_size_breakdown: bool = True) -> Dict:
    """Reference-exact mAP (reference calculate_map, metrics.py:529-814).

    Same inputs as ``calculate_map``; returns the reference's result schema
    (mAP/mAP50/mAP75, per_class with AP{t:.2f} keys, per_iou, APS/APM/APL
    + *50 variants) plus native-schema aliases (per_class_ap,
    mAP_small/medium/large) so ``format_results`` and the plot helpers
    render either mode (PR curves are native-mode only).  Pinned to
    recorded reference fixtures in tests/test_metrics_parity.py.
    """
    iou_thresholds = list(iou_thresholds)
    names = list(class_names) if class_names else [
        f'class_{i}' for i in range(num_classes)]
    preds_by_class, gts_by_class = _flatten_by_class(predictions,
                                                     ground_truths)
    if optimize_classes:
        active = sorted(set(preds_by_class) | set(gts_by_class))
    else:
        active = list(range(num_classes))

    results: Dict = {
        'per_class': {}, 'per_iou': {},
        'num_predictions': sum(len(v) for v in preds_by_class.values()),
        'num_ground_truths': sum(len(v) for v in gts_by_class.values()),
    }
    iou_aps = {t: [] for t in iou_thresholds}
    results['per_class_ap'] = {}  # native-schema alias for format/plots
    for c in active:
        preds = preds_by_class.get(c, [])
        gts = gts_by_class.get(c, [])
        cache = _ClassMatchCache(preds, gts) if preds and gts else None
        per_thr = {}
        for t in iou_thresholds:
            ap = _ref_class_ap(preds, gts, t, interpolation_method,
                               cached=cache_ious, cache=cache)
            per_thr[f'AP{t:.2f}'] = ap
            iou_aps[t].append(ap)
        per_thr['AP'] = float(np.mean(list(per_thr.values())))
        name = names[c] if c < len(names) else f'class_{c}'
        results['per_class'][name] = per_thr
        results['per_class_ap'][name] = {
            'ap': per_thr['AP'],
            'ap50': per_thr.get('AP0.50', 0.0),
            'count': len(gts),
        }
    for t in iou_thresholds:
        if iou_aps[t]:
            results['per_iou'][f'mAP{t:.2f}'] = float(np.mean(iou_aps[t]))
    results['mAP50'] = (results['per_iou'].get('mAP0.50', 0.0)
                        if 0.5 in iou_thresholds else 0.0)
    results['mAP75'] = (results['per_iou'].get('mAP0.75', 0.0)
                        if 0.75 in iou_thresholds else 0.0)
    results['mAP'] = (float(np.mean([
        results['per_iou'].get(f'mAP{t:.2f}', 0.0)
        for t in iou_thresholds])) if iou_thresholds else 0.0)

    if compute_size_breakdown:
        # reference size recursion: xyxy-area filters, then a nested
        # calculate_map with cache_ious=False (the misread-IoU path) and
        # no further recursion (metrics.py:736-800)
        for key, lo, hi in (('APS', None, 1024.0),
                            ('APM', 1024.0, 9216.0),
                            ('APL', 9216.0, None)):
            fp, fg = _filter_area(predictions, ground_truths, lo, hi)
            if sum(len(g['boxes']) for g in fg.values()):
                sub = calculate_map_reference(
                    fp, fg, num_classes, iou_thresholds,
                    interpolation_method, optimize_classes, class_names,
                    cache_ious=False, compute_size_breakdown=False)
                results[key] = sub['mAP']
                results[key + '50'] = sub.get('mAP50', 0.0)
            else:
                results[key] = results[key + '50'] = 0.0
    else:
        for key in ('APS', 'APM', 'APL'):
            results[key] = results[key + '50'] = 0.0
    # native-schema aliases so format_results / the plot helpers render
    # reference-mode results too
    for key, size in (('APS', 'small'), ('APM', 'medium'), ('APL', 'large')):
        results[f'mAP_{size}'] = results[key]
    return results


def _filter_area(predictions: Dict, ground_truths: Dict,
                 min_area: Optional[float], max_area: Optional[float]):
    """Reference filter_by_area on xyxy areas (metrics.py:425-460),
    applied image-wise to the dict format (xywh area == xyxy area)."""
    def keep_mask(boxes):
        areas = np.asarray(boxes, np.float64).reshape(-1, 4)[:, 2] \
            * np.asarray(boxes, np.float64).reshape(-1, 4)[:, 3]
        m = np.ones(len(areas), bool)
        if min_area is not None:
            m &= areas >= min_area
        if max_area is not None:
            m &= areas < max_area
        return m

    fp = {}
    for img_id, p in predictions.items():
        m = keep_mask(p['boxes'])
        fp[img_id] = {'boxes': p['boxes'][m], 'classes': p['classes'][m],
                      'scores': p['scores'][m]}
    fg = {}
    for img_id, g in ground_truths.items():
        m = keep_mask(g['boxes'])
        fg[img_id] = {'boxes': g['boxes'][m], 'classes': g['classes'][m]}
    return fp, fg
