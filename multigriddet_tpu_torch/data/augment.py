"""The device input stage's box-capacity and normalize steps.

Counterpart of the last two functions of ``multigriddet_tpu/data/augment.py``
(``expand_box_capacity`` and ``normalize_images``).  The random ops of that
module (photometric, geometric, mosaic, mixup, copy-paste) are not ported
yet: the generator refuses enabled training augmentation (ROADMAP Queue 1
item 10).

Conventions as in the JAX module: images ``[B, H, W, 3]`` float32 in
[0, 255]; boxes ``[B, N, 5]`` ``(x1, y1, x2, y2, class)`` canvas pixels,
zero rows are padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def expand_box_capacity(boxes, factor: int):
    """Pad the box axis to ``factor`` times its capacity (numpy or tensor)."""
    if factor <= 1:
        return boxes
    n = boxes.shape[1]
    if isinstance(boxes, torch.Tensor):
        return F.pad(boxes, (0, 0, 0, n * (factor - 1)))
    return np.pad(boxes, ((0, 0), (0, n * (factor - 1)), (0, 0)))


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [0, 1] at the end of the chain."""
    return images / 255.0
