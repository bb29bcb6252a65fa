"""Detection drawing: class colours and box/label rendering.

Counterpart of ``multigriddet_tpu/utils/visualization.py``: HSV-spread
class colours shuffled with a fixed seed, and top-left ``(x, y, w, h)``
boxes drawn with labels, by OpenCV where it is installed and by Pillow
otherwise (both imported when drawing).
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

import numpy as np


def get_colors(num_classes: int, seed: int = 10101) -> List[tuple]:
    """HSV-spread RGB colours, shuffled with a fixed seed."""
    hsv = [(i / num_classes, 1.0, 1.0) for i in range(num_classes)]
    colors = [tuple(int(255 * c) for c in colorsys.hsv_to_rgb(*h))
              for h in hsv]
    np.random.RandomState(seed).shuffle(colors)
    return colors


def draw_boxes(image: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
               scores: np.ndarray, class_names: Sequence[str],
               colors: Optional[List[tuple]] = None,
               show_scores: bool = True) -> np.ndarray:
    """Draw boxes with class/score labels; returns a new uint8 RGB image."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    img = np.ascontiguousarray(image).copy()
    if colors is None:
        colors = get_colors(max(len(class_names), 1))
    h, w = img.shape[:2]
    for box, cls, score in zip(boxes, classes, scores):
        x, y, bw, bh = box[:4]
        x1, y1 = int(max(x, 0)), int(max(y, 0))
        x2, y2 = int(min(x + bw, w - 1)), int(min(y + bh, h - 1))
        if x2 <= x1 or y2 <= y1:
            continue
        color = colors[int(cls) % len(colors)]
        name = (class_names[int(cls)] if int(cls) < len(class_names)
                else str(int(cls)))
        label = f'{name} {score:.2f}' if show_scores else name
        if cv2 is not None:
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX,
                                          0.5, 1)
            cv2.rectangle(img, (x1, max(y1 - th - 6, 0)),
                          (x1 + tw + 2, y1), color, -1)
            cv2.putText(img, label, (x1 + 1, max(y1 - 4, th)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1,
                        cv2.LINE_AA)
        else:
            from PIL import Image, ImageDraw
            pil = Image.fromarray(img)
            d = ImageDraw.Draw(pil)
            d.rectangle([x1, y1, x2, y2], outline=color, width=2)
            d.text((x1 + 2, max(y1 - 12, 0)), label, fill=color)
            img = np.asarray(pil).copy()
    return img
