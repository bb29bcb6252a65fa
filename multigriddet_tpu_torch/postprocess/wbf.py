"""Weighted Boxes Fusion (host NumPy).

The port's own copy of ``multigriddet_tpu/postprocess/wbf.py``, a
behavioral port of the reference's ``postprocess/wbf.py:11-290``:
per-class clustering of boxes at ``iou_thr`` with confidence-weighted
coordinate averaging — an alternative to NMS for ensembles.  Box format:
top-left ``(x, y, w, h)``.

Two clustering modes:

* ``mode='paper'`` (default): the arXiv:1910.13302 formulation — a box
  joins the first cluster whose **running weighted-average** box overlaps
  it at ``iou_thr``, and the representative is updated after every join.
* ``mode='reference'``: an exact behavioral twin of the reference class
  (wbf.py:129-218) — clusters are formed against the **seed** box only
  (the highest-scored unassigned box), membership is decided in one pass
  over the score-descending order (``np.argsort(scores)[::-1]``, the
  reference's exact tie order), the fused box is the
  score×model-weight-weighted average of the final cluster, and outputs
  are emitted class-ascending in cluster-creation order with **no** final
  global sort (the reference's raw ``fuse_boxes`` contract).  Pinned to
  recorded fixtures in tests/test_torch_wbf.py.

The two modes differ on chains of partial overlaps (A↔B and B↔C overlap
but A↔C does not): 'reference' seeds a cluster at A and leaves C out even
when the running average would have absorbed it.  See docs/PARITY.md.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..evaluation.metrics import iou_matrix


def _fused_confidence(scores: np.ndarray, weights: np.ndarray,
                      conf_type: str) -> float:
    """Reference wbf.py:252-275 confidence fusion."""
    if conf_type == 'max':
        return float(np.max(scores))
    if conf_type in ('box_and_model_avg', 'absent_model_aware_avg'):
        # the reference implements both as mean(score * model_weight)
        # (wbf.py:269-273, its own comment calls it "simplified")
        return float(np.mean(scores * weights))
    return float(np.mean(scores))


def _reference_fuse(boxes: np.ndarray, scores: np.ndarray,
                    classes: np.ndarray, iou_thr: float, score_thr: float,
                    conf_type: str, models: np.ndarray,
                    model_weights: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact twin of WeightedBoxesFusion.fuse_boxes (wbf.py:38-218)."""
    keep = scores >= score_thr
    boxes, scores = boxes[keep], scores[keep]
    classes, models = classes[keep], models[keep]
    out_boxes, out_scores, out_classes = [], [], []
    for c in np.unique(classes):
        sel = classes == c
        b, s, m = boxes[sel], scores[sel], models[sel]
        # the reference's exact sort call — ties land in whatever order
        # np.argsort's default quicksort leaves after the reversal
        order = np.argsort(s)[::-1]
        b, s, m = b[order], s[order], m[order]
        used = np.zeros(len(b), bool)
        for i in range(len(b)):
            if used[i]:
                continue
            # cluster membership is decided against the SEED box i only
            member = [i]
            for j in range(i + 1, len(b)):
                if used[j]:
                    continue
                if iou_matrix(b[i:i + 1], b[j:j + 1])[0, 0] >= iou_thr:
                    member.append(j)
                    used[j] = True
            idx = np.asarray(member)
            w = s[idx] * model_weights[m[idx]]
            w = w / w.sum()
            out_boxes.append(np.average(b[idx], axis=0, weights=w))
            out_scores.append(_fused_confidence(
                s[idx], model_weights[m[idx]], conf_type))
            out_classes.append(int(c))
    if not out_boxes:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int32))
    return (np.stack(out_boxes).astype(np.float32),
            np.asarray(out_scores, np.float32),
            np.asarray(out_classes, np.int32))


def weighted_boxes_fusion(boxes: np.ndarray, scores: np.ndarray,
                          classes: np.ndarray, iou_thr: float = 0.55,
                          score_thr: float = 0.0,
                          conf_type: str = 'avg',
                          mode: str = 'paper',
                          models: Optional[np.ndarray] = None,
                          model_weights: Optional[Sequence[float]] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse overlapping same-class boxes.

    Args:
      boxes: ``[N, 4]`` top-left xywh.
      scores: ``[N]``.
      classes: ``[N]`` int.
      conf_type: 'avg' (mean of cluster scores), 'max', or
        'box_and_model_avg' / 'absent_model_aware_avg' (mean of
        score × model weight, the reference's simplified forms).
      mode: 'paper' (running-average clustering, score-sorted output) or
        'reference' (exact reference twin — see module docstring).
      models: optional ``[N]`` int model index per box (ensemble fusion);
        defaults to a single model 0.
      model_weights: optional per-model weight table; defaults to 1.0.

    Returns (fused_boxes, fused_scores, fused_classes); 'paper' mode sorts
    by descending score, 'reference' mode keeps the reference's raw
    class-ascending cluster order.
    """
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32).reshape(-1)
    classes = np.asarray(classes).reshape(-1)
    if models is None:
        models = np.zeros(len(boxes), np.int32)
    else:
        models = np.asarray(models, np.int32).reshape(-1)
    n_models = int(models.max()) + 1 if len(models) else 1
    if model_weights is None:
        model_weights = np.ones(n_models, np.float32)
    else:
        model_weights = np.asarray(model_weights, np.float32)

    if mode == 'reference':
        fb, fs, fc = _reference_fuse(boxes, scores, classes, iou_thr,
                                     score_thr, conf_type, models,
                                     model_weights)
        return fb, fs, fc
    if mode != 'paper':
        raise ValueError(f"wbf mode must be 'paper' or 'reference', "
                         f"got {mode!r}")

    keep = scores >= score_thr
    boxes, scores, classes = boxes[keep], scores[keep], classes[keep]
    models = models[keep]
    out_boxes, out_scores, out_classes = [], [], []
    for c in np.unique(classes):
        sel = classes == c
        b, s, m = boxes[sel], scores[sel], models[sel]
        order = np.argsort(-s, kind='stable')
        b, s, m = b[order], s[order], m[order]
        w_all = s * model_weights[m]
        clusters: list[list[int]] = []
        reps: list[np.ndarray] = []
        for i in range(len(b)):
            placed = False
            for ci, rep in enumerate(reps):
                if iou_matrix(b[i:i + 1], rep[None])[0, 0] >= iou_thr:
                    clusters[ci].append(i)
                    idx = clusters[ci]
                    w = w_all[idx]
                    reps[ci] = (b[idx] * w[:, None]).sum(0) / w.sum()
                    placed = True
                    break
            if not placed:
                clusters.append([i])
                reps.append(b[i].copy())
        for ci, idx in enumerate(clusters):
            w = w_all[idx]
            fused = (b[idx] * w[:, None]).sum(0) / w.sum()
            score = _fused_confidence(s[idx], model_weights[m[idx]],
                                      conf_type)
            out_boxes.append(fused)
            out_scores.append(score)
            out_classes.append(int(c))
    if not out_boxes:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int32))
    out_boxes = np.stack(out_boxes).astype(np.float32)
    out_scores = np.asarray(out_scores, np.float32)
    out_classes = np.asarray(out_classes, np.int32)
    order = np.argsort(-out_scores, kind='stable')
    return out_boxes[order], out_scores[order], out_classes[order]


def fuse_and_cap(boxes: np.ndarray, classes: np.ndarray, scores: np.ndarray,
                 iou_thr: float, mode: str = 'paper',
                 max_out: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """WBF + the reference's over-capacity filter, for the product paths.

    One shared implementation of the fuse-then-cap block the inference
    engine, evaluator, and decoder facade all need: run
    :func:`weighted_boxes_fusion` on one image's candidate pool, then —
    exactly like the reference's ``_filter_boxes``
    (multigrid_decode.py:322-345) — keep the top ``max_out`` by score
    ('reference' mode output is class-ordered, so an unsorted slice would
    be wrong).

    Takes and returns ``(boxes, classes, scores)`` (the detection-tuple
    order the serving paths use).  Empty inputs pass through unchanged.
    """
    if not len(boxes):
        return boxes, classes, scores
    boxes, scores, classes = weighted_boxes_fusion(
        boxes, scores, classes, iou_thr=iou_thr, mode=mode)
    if max_out is not None and len(boxes) > max_out:
        top = np.argsort(scores)[::-1][:max_out]
        boxes, classes, scores = boxes[top], classes[top], scores[top]
    return boxes, classes, scores
