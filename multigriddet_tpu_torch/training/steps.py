"""The fused inference step: pixels -> forward -> decode -> NMS.

Counterpart of the inference half of ``multigriddet_tpu/training/steps.py``
(``make_infer_step``, ``unpack_detections``, ``fetch_detections``).  The
step is a plain closure over the model; PyTorch runs it eagerly on the
device that holds the model and the images.  The forward runs in the
model's compute dtype; decode and NMS run in float32.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..ops.decode import decode_for_nms
from ..ops.nms import NEG_INF, batched_nms, gather_rows, top_k
from ..ops.yuv import yuv420_to_rgb


def candidate_pool(model, images: torch.Tensor, anchors: Sequence,
                   input_hw: Tuple[int, int]):
    """Forward + compact decode of float images ``[B, H, W, 3]`` in [0, 1].

    Returns the NMS pool ``(boxes [B, N, 4] top-left canvas pixels,
    scores [B, N], classes [B, N] int32)``, one candidate per grid cell.
    """
    outs = model(images)
    boxes, scores, classes = decode_for_nms(outs, anchors, input_hw)
    scale = torch.tensor([input_hw[1], input_hw[0], input_hw[1],
                          input_hw[0]], dtype=torch.float32,
                         device=boxes.device)
    xy, wh = boxes[..., 0:2], boxes[..., 2:4]
    tl = torch.cat([xy - wh / 2.0, wh], dim=-1) * scale
    return tl, scores, classes


def make_infer_step(model, anchors: Sequence[np.ndarray],
                    input_hw: Tuple[int, int],
                    confidence: float = 0.1,
                    nms_threshold: float = 0.45,
                    nms_method: str = 'diou',
                    use_iol: bool = True,
                    max_boxes: int = 100,
                    pre_nms_top_k: int = 1024,
                    class_aware: bool = False,
                    nms_backend: str = 'xla',
                    use_wbf: bool = False,
                    pack_outputs: bool = False,
                    link_format: str = 'rgb') -> Callable:
    """Fused forward + decode + NMS.

    ``link_format='rgb'`` gives ``step(images)`` for ``[B, H, W, 3]``
    uint8 (divided by 255 on the device) or float images;
    ``'yuv420'`` gives ``step(y, cb, cr)`` for planar 4:2:0 uint8.
    Returns ``(boxes [B, K, 4] top-left canvas pixels, classes [B, K]
    int32, scores [B, K], valid [B, K] bool)``, or with ``use_wbf`` the
    ``pre_nms_top_k`` confidence-filtered candidates in score order, or
    with ``pack_outputs`` one ``[B, 7, K]`` float32 tensor
    ``[x, y, w, h, class, score, valid]``.
    """
    anchors = [np.asarray(a, np.float32) for a in anchors]
    if link_format not in ('rgb', 'yuv420'):
        raise ValueError(f'unknown link_format {link_format!r}')

    def _forward_chain(images):
        tl, scores, classes = candidate_pool(model, images, anchors,
                                             input_hw)
        if use_wbf:
            sc = torch.where(scores >= confidence, scores,
                             torch.tensor(NEG_INF, device=scores.device))
            top_sc, idx = top_k(sc, min(pre_nms_top_k, sc.shape[1]))
            res = (gather_rows(tl, idx), gather_rows(classes, idx), top_sc,
                   top_sc > -1e8)
        else:
            res = batched_nms(
                tl, scores, classes, confidence, nms_threshold,
                max_boxes=max_boxes, pre_nms_top_k=pre_nms_top_k,
                nms_method=nms_method, use_iol=use_iol,
                class_aware=class_aware, backend=nms_backend)
        if pack_outputs:
            b, c, s, v = res
            return torch.cat([b.transpose(-1, -2), c[:, None].float(),
                              s[:, None].float(), v[:, None].float()], dim=1)
        return res

    @torch.inference_mode()
    def step(images):
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        return _forward_chain(images)

    @torch.inference_mode()
    def step_yuv(y, cb, cr):
        return _forward_chain(yuv420_to_rgb(y, cb, cr) / 255.0)

    return step_yuv if link_format == 'yuv420' else step


def unpack_detections(packed):
    """Invert ``make_infer_step(pack_outputs=True)`` on the host: returns
    numpy (boxes [..., K, 4] f32, classes i32, scores f32, valid bool)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    return (np.moveaxis(packed[..., 0:4, :], -2, -1),
            packed[..., 4, :].astype(np.int32),
            packed[..., 5, :], packed[..., 6, :] > 0.5)


def fetch_detections(outs):
    """One host fetch of an infer-step result, tuple or packed."""
    if isinstance(outs, (tuple, list)):
        b, c, s, v = (t.cpu().numpy() for t in outs)
        return (b, c.astype(np.int32, copy=False), s, v.astype(bool))
    return unpack_detections(outs)
