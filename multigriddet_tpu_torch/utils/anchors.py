"""Anchor and class-name files.

Counterpart of ``load_anchors``/``load_classes`` in
``multigriddet_tpu/utils/anchors.py``: one line per scale of ``w,h``
pairs, coarse scale first; one class name per line.
"""

from __future__ import annotations

import os
from typing import List, Optional

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
