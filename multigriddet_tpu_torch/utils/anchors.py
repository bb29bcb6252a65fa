"""Anchor and class-name files, and class weights.

Counterpart of ``multigriddet_tpu/utils/anchors.py``: one line per scale of
``w,h`` pairs, coarse scale first; one class name per line; automatic
class weights from annotation counts.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

# Default COCO anchor set (configs/yolov3_coco_anchor.txt).
DEFAULT_COCO_ANCHORS: List[np.ndarray] = [
    np.array([[112, 74], [149, 190], [370, 328]], np.float32),
    np.array([[28, 17], [56, 112], [57, 35]], np.float32),
    np.array([[9, 10], [13, 28], [28, 55]], np.float32),
]


def load_anchors(path: Optional[str] = None) -> List[np.ndarray]:
    """Parse an anchor file; a missing path gives the COCO anchors."""
    if path is None or not os.path.exists(path):
        return [a.copy() for a in DEFAULT_COCO_ANCHORS]
    anchors = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals = np.array([float(v) for v in line.replace(',', ' ').split()],
                            np.float32)
            anchors.append(vals.reshape(-1, 2))
    return anchors


def load_classes(path: str) -> List[str]:
    """Load class names, one per line."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def compute_class_weights(class_counts: Sequence[int],
                          method: str = 'balanced',
                          clip_range=(0.1, 10.0)) -> np.ndarray:
    """Class weights from per-class counts: ``balanced`` total / (C *
    count), ``inverse`` 1 / count or ``sqrt_inverse`` 1 / sqrt(count),
    normalized to mean 1, then clipped to ``clip_range``."""
    counts = np.asarray(class_counts, np.float64)
    safe = np.maximum(counts, 1.0)
    if method == 'balanced':
        w = counts.sum() / (len(counts) * safe)
    elif method == 'inverse':
        w = 1.0 / safe
    elif method == 'sqrt_inverse':
        w = 1.0 / np.sqrt(safe)
    else:
        raise ValueError(f'unknown class-weight method {method!r}')
    w = w / max(w.mean(), 1e-12)
    return np.clip(w, *clip_range).astype(np.float32)


def class_counts_from_annotations(annotation_lines: Sequence[str],
                                  num_classes: int) -> np.ndarray:
    """Count per-class boxes in ``path x1,y1,x2,y2,cls ...`` lines."""
    counts = np.zeros(num_classes, np.int64)
    for line in annotation_lines:
        for box in line.strip().split()[1:]:
            fields = box.split(',')
            if len(fields) == 5:
                cls = int(float(fields[4]))
                if 0 <= cls < num_classes:
                    counts[cls] += 1
    return counts
