"""Evaluation report plots (matplotlib).

Counterpart of ``multigriddet_tpu/evaluation/visualizations.py`` (after
the reference's ``evaluation/visualizations.py:30-591``): PR curves
(per-class / averaged / top-k), confusion matrix heatmap, per-class AP
bars, IoU histogram, confidence sweep (P/R/F1 vs threshold), and a
``generate_evaluation_report`` orchestrator driven by the same config
block.  matplotlib is imported, with the Agg backend, when a plot is
drawn, so the module imports on a host without it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from .metrics import iou_matrix


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _save(fig, out_dir: str, name: str, fmt: str = 'png', dpi: int = 150):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f'{name}.{fmt}')
    fig.savefig(path, dpi=dpi, bbox_inches='tight')
    _pyplot().close(fig)
    return path


def plot_pr_curves(results: Dict, class_names: Sequence[str],
                   out_dir: str, top_k: int = 10, fmt='png', dpi=150,
                   show_per_class: bool = True,
                   show_averaged: bool = True):
    """PR-curve plots (reference visualizations.py:30-155).

    ``show_averaged`` renders the combined top-k overlay figure;
    ``show_per_class`` additionally writes one figure per ranked class
    under ``pr_curves/`` (the reference's per-class output layout).
    Returns the overlay path (or the pr_curves dir when only per-class
    figures were produced).
    """
    curves = results.get('pr_curves', {})
    if not curves or not (show_per_class or show_averaged):
        return None
    per_class = results.get('per_class_ap', {})
    ranked = sorted(
        ((per_class.get(class_names[c], {}).get('ap50', 0.0), c)
         for c in curves), reverse=True)[:top_k]
    produced = None
    if show_per_class:
        pr_dir = os.path.join(out_dir, 'pr_curves')
        for ap50, c in ranked:
            recalls, precisions = curves[c]
            fig, ax = _pyplot().subplots(figsize=(6, 4.5))
            ax.plot(recalls, precisions, 'b-', lw=2,
                    label=f'PR curve (AP50={ap50:.3f})')
            ax.fill_between(recalls, precisions, alpha=0.2)
            ax.set_xlabel('Recall')
            ax.set_ylabel('Precision')
            ax.set_title(f'Precision-Recall: {class_names[c]}')
            ax.set_xlim(0, 1)
            ax.set_ylim(0, 1.02)
            ax.legend(loc='best')
            ax.grid(alpha=0.3)
            name = f"pr_curve_{str(class_names[c]).replace(' ', '_')}"
            _save(fig, pr_dir, name, fmt, dpi)
        produced = pr_dir
    if show_averaged:
        fig, ax = _pyplot().subplots(figsize=(7, 5))
        for ap50, c in ranked:
            recalls, precisions = curves[c]
            ax.plot(recalls, precisions, lw=1.2,
                    label=f'{class_names[c]} ({ap50:.3f})')
        ax.set_xlabel('Recall')
        ax.set_ylabel('Precision')
        ax.set_title(f'PR curves @IoU 0.5 (top {len(ranked)} classes)')
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1.02)
        ax.legend(fontsize=7, loc='lower left')
        ax.grid(alpha=0.3)
        produced = _save(fig, out_dir, 'pr_curves', fmt, dpi)
    return produced


def plot_per_class_ap(results: Dict, out_dir: str, top_k: int = 30,
                      fmt='png', dpi=150):
    per_class = results.get('per_class_ap', {})
    if not per_class:
        return None
    items = sorted(per_class.items(), key=lambda kv: -kv[1]['ap'])[:top_k]
    names = [k for k, _ in items]
    aps = [v['ap'] for _, v in items]
    fig, ax = _pyplot().subplots(figsize=(8, max(3, 0.25 * len(names))))
    ax.barh(names[::-1], aps[::-1])
    ax.set_xlabel('AP@0.5:0.95')
    ax.set_title('Per-class AP')
    ax.grid(alpha=0.3, axis='x')
    return _save(fig, out_dir, 'per_class_ap', fmt, dpi)


def plot_confusion_matrix(predictions: Dict, ground_truths: Dict,
                          class_names: Sequence[str], out_dir: str,
                          iou_threshold: float = 0.5, top_k: int = 20,
                          normalize: bool = True, conf_threshold=0.25,
                          fmt='png', dpi=150):
    n = len(class_names)
    cm = np.zeros((n + 1, n + 1), np.int64)  # +1 = background/missed
    for img_id, gt in ground_truths.items():
        pred = predictions.get(img_id)
        p_boxes = pred['boxes'] if pred is not None else np.zeros((0, 4))
        p_cls = pred['classes'] if pred is not None else np.zeros((0,), int)
        p_scs = pred['scores'] if pred is not None else np.zeros((0,))
        keep = p_scs >= conf_threshold
        p_boxes, p_cls = p_boxes[keep], p_cls[keep]
        ious = iou_matrix(p_boxes, gt['boxes'])
        taken_gt = np.zeros(len(gt['boxes']), bool)
        taken_pred = np.zeros(len(p_boxes), bool)
        if ious.size:
            for i in np.argsort(-p_scs[keep], kind='stable'):
                j = int(np.argmax(np.where(taken_gt, -1.0, ious[i])))
                if ious[i, j] >= iou_threshold and not taken_gt[j]:
                    cm[int(gt['classes'][j]), int(p_cls[i])] += 1
                    taken_gt[j] = True
                    taken_pred[i] = True
        for j in np.where(~taken_gt)[0]:
            cm[int(gt['classes'][j]), n] += 1          # missed
        for i in np.where(~taken_pred)[0]:
            cm[n, int(p_cls[i])] += 1                   # false positive
    freq = cm[:n, :].sum(1)
    order = np.argsort(-freq)[:top_k]
    idx = np.concatenate([order, [n]])
    sub = cm[np.ix_(idx, idx)].astype(np.float64)
    if normalize:
        sub = sub / np.maximum(sub.sum(axis=1, keepdims=True), 1)
    labels = [class_names[i] for i in order] + ['background']
    fig, ax = _pyplot().subplots(figsize=(8, 7))
    im = ax.imshow(sub, cmap='Blues')
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticks(range(len(labels)))
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel('Predicted')
    ax.set_ylabel('True')
    ax.set_title('Confusion matrix')
    fig.colorbar(im, shrink=0.8)
    return _save(fig, out_dir, 'confusion_matrix', fmt, dpi)


def plot_iou_distribution(predictions: Dict, ground_truths: Dict,
                          out_dir: str, fmt='png', dpi=150):
    best_ious = []
    for img_id, gt in ground_truths.items():
        pred = predictions.get(img_id)
        if pred is None or not len(pred['boxes']) or not len(gt['boxes']):
            continue
        ious = iou_matrix(pred['boxes'], gt['boxes'])
        best_ious.extend(ious.max(axis=1).tolist())
    if not best_ious:
        return None
    fig, ax = _pyplot().subplots(figsize=(6, 4))
    ax.hist(best_ious, bins=40, range=(0, 1))
    ax.axvline(0.5, color='r', ls='--', lw=1)
    ax.set_xlabel('Best IoU per detection')
    ax.set_ylabel('Count')
    ax.set_title('Localization quality (IoU distribution)')
    return _save(fig, out_dir, 'iou_distribution', fmt, dpi)


def plot_confidence_analysis(predictions: Dict, ground_truths: Dict,
                             out_dir: str, iou_threshold: float = 0.5,
                             fmt='png', dpi=150):
    from .metrics import match_detections
    all_scores, all_tp, n_gt = [], [], 0
    for img_id, gt in ground_truths.items():
        n_gt += len(gt['boxes'])
        pred = predictions.get(img_id)
        if pred is None or not len(pred['boxes']):
            continue
        tp = match_detections(pred['boxes'], pred['scores'], gt['boxes'],
                              iou_threshold)
        all_scores.append(pred['scores'])
        all_tp.append(tp)
    if not all_scores:
        return None
    scores = np.concatenate(all_scores)
    tp = np.concatenate(all_tp)
    thresholds = np.linspace(0.05, 0.95, 19)
    precisions, recalls, f1s = [], [], []
    for t in thresholds:
        sel = scores >= t
        tp_t = tp[sel].sum()
        p = tp_t / max(sel.sum(), 1)
        r = tp_t / max(n_gt, 1)
        precisions.append(p)
        recalls.append(r)
        f1s.append(2 * p * r / max(p + r, 1e-9))
    fig, ax = _pyplot().subplots(figsize=(6, 4))
    ax.plot(thresholds, precisions, label='precision')
    ax.plot(thresholds, recalls, label='recall')
    ax.plot(thresholds, f1s, label='F1')
    best = thresholds[int(np.argmax(f1s))]
    ax.axvline(best, color='gray', ls=':',
               label=f'best F1 @ {best:.2f}')
    ax.set_xlabel('Confidence threshold')
    ax.legend()
    ax.grid(alpha=0.3)
    ax.set_title('Precision / Recall / F1 vs confidence')
    return _save(fig, out_dir, 'confidence_analysis', fmt, dpi)


def generate_evaluation_report(results: Dict, predictions: Dict,
                               ground_truths: Dict,
                               class_names: Sequence[str],
                               viz_config: Optional[Dict] = None):
    """Produce the enabled plot set (reference visualizations.py:520-591)."""
    cfg = viz_config or {}
    out = (cfg.get('output', {}) or {})
    out_dir = out.get('save_dir', 'results/evaluation/plots')
    fmt = out.get('format', 'png')
    dpi = int(out.get('dpi', 150))
    plots = cfg.get('plots', {}) or {}
    produced = {}
    if plots.get('precision_recall_curves', True):
        pr_cfg = cfg.get('pr_curves', {}) or {}
        produced['pr_curves'] = plot_pr_curves(
            results, class_names, out_dir,
            top_k=int(pr_cfg.get('top_k', 10)), fmt=fmt, dpi=dpi,
            show_per_class=bool(pr_cfg.get('show_per_class', True)),
            show_averaged=bool(pr_cfg.get('show_averaged', True)))
    if plots.get('per_class_map_bar', True):
        produced['per_class_ap'] = plot_per_class_ap(
            results, out_dir, fmt=fmt, dpi=dpi)
    if plots.get('confusion_matrix', True):
        cm_cfg = cfg.get('confusion_matrix', {}) or {}
        produced['confusion_matrix'] = plot_confusion_matrix(
            predictions, ground_truths, class_names, out_dir,
            top_k=int(cm_cfg.get('top_k', 20)),
            normalize=bool(cm_cfg.get('normalize', True)), fmt=fmt, dpi=dpi)
    if plots.get('iou_distribution', True):
        produced['iou_distribution'] = plot_iou_distribution(
            predictions, ground_truths, out_dir, fmt=fmt, dpi=dpi)
    if plots.get('confidence_analysis', True):
        produced['confidence_analysis'] = plot_confidence_analysis(
            predictions, ground_truths, out_dir, fmt=fmt, dpi=dpi)
    return {k: v for k, v in produced.items() if v}
