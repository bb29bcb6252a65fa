"""MultiGridDecoder: the reference-API postprocess facade.

Counterpart of ``multigriddet_tpu/postprocess/decoder.py``:
``postprocess(predictions, image_shape) -> (boxes, classes, scores)`` for
one image's raw per-scale head outputs.  Decode, the confidence filter
and NMS run on the decoder's device (``cuda`` unless ``device='cpu'`` is
passed) through the port's ``decode_predictions`` and ``batched_nms``;
with ``use_wbf`` the confidence-filtered pool is fused on the host
instead.  Output boxes are ``(x1, y1, x2, y2)`` in original-image pixels,
clipped.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.decode import decode_predictions
from ..ops.geometry import canvas_boxes_to_image
from ..ops.nms import batched_nms
from .wbf import fuse_and_cap


class MultiGridDecoder:

    def __init__(self, anchors: Sequence[np.ndarray], num_classes: int,
                 input_hw: Tuple[int, int] = (608, 608),
                 confidence: float = 0.1, nms_threshold: float = 0.45,
                 nms_method: str = 'diou', use_iol: bool = True,
                 use_wbf: bool = False, max_boxes: int = 100,
                 wbf_mode: str = 'paper', device=None):
        self.anchors = [np.asarray(a, np.float32) for a in anchors]
        self.num_classes = num_classes
        self.input_hw = tuple(input_hw)
        self.confidence = confidence
        self.nms_threshold = nms_threshold
        self.nms_method = nms_method
        self.use_iol = use_iol
        self.use_wbf = use_wbf
        self.wbf_mode = wbf_mode
        self.max_boxes = max_boxes
        self.device = resolve_device(device)

    @torch.inference_mode()
    def _decode_nms(self, preds):
        hw = self.input_hw
        dec = decode_predictions(preds, self.anchors, hw)
        scale = torch.tensor([hw[1], hw[0], hw[1], hw[0]],
                             dtype=torch.float32, device=dec.device)
        xy, wh = dec[..., 0:2], dec[..., 2:4]
        tl = torch.cat([xy - wh / 2.0, wh], dim=-1) * scale
        scores = dec[..., 4]
        classes = torch.argmax(dec[..., 5:], dim=-1).to(torch.int32)
        if self.use_wbf:
            # WBF fuses on the host; return the confidence-filtered pool
            return tl, classes, scores, scores >= self.confidence
        return batched_nms(
            tl, scores, classes, self.confidence, self.nms_threshold,
            max_boxes=self.max_boxes, nms_method=self.nms_method,
            use_iol=self.use_iol)

    def postprocess(self, predictions: Sequence[np.ndarray],
                    image_shape: Optional[Tuple[int, int]] = None):
        """Decode one image's raw per-scale outputs to final detections.

        Args:
          predictions: per-scale ``[1, gh, gw, 5 + A + C]`` arrays.
          image_shape: original (height, width); defaults to the canvas.

        Returns (boxes ``[N, 4]`` xyxy pixels, classes ``[N]``,
        scores ``[N]``).
        """
        preds = [torch.as_tensor(np.asarray(p, np.float32)).to(self.device)
                 for p in predictions]
        tl, classes, scores, valid = (t[0].cpu().numpy()
                                      for t in self._decode_nms(preds))
        tl, classes, scores = tl[valid], classes[valid], scores[valid]
        if self.use_wbf:
            tl, classes, scores = fuse_and_cap(
                tl, classes, scores, iou_thr=self.nms_threshold,
                mode=self.wbf_mode, max_out=self.max_boxes)
        ih, iw = image_shape or self.input_hw
        if len(tl):
            xywh = canvas_boxes_to_image(tl, (ih, iw), self.input_hw)
            boxes = np.stack([xywh[:, 0], xywh[:, 1],
                              xywh[:, 0] + xywh[:, 2],
                              xywh[:, 1] + xywh[:, 3]], axis=-1)
        else:
            boxes = np.zeros((0, 4), np.float32)
        return boxes, classes, scores
