"""Host-side image letterboxing.

Counterpart of ``letterbox_image`` in
``multigriddet_tpu/data/annotations.py:43-58``: the same Pillow BICUBIC
resize onto a gray (128) canvas.  Pillow is imported when called.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def letterbox_image(image, target_hw: Tuple[int, int]
                    ) -> Tuple[np.ndarray, float, int, int]:
    """Aspect-preserving resize of a PIL image onto a gray canvas.

    Returns (uint8 array [H, W, 3], scale, pad_x, pad_y).
    """
    from PIL import Image

    th, tw = target_hw
    iw, ih = image.size
    scale = min(tw / iw, th / ih)
    nw, nh = int(round(iw * scale)), int(round(ih * scale))
    pad_x, pad_y = (tw - nw) // 2, (th - nh) // 2
    resized = image.resize((nw, nh), Image.BICUBIC)
    canvas = Image.new('RGB', (tw, th), (128, 128, 128))
    canvas.paste(resized, (pad_x, pad_y))
    return np.asarray(canvas, np.uint8), scale, pad_x, pad_y
