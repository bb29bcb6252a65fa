"""Tensor ops of the port: decode, geometry, NMS and its CUDA kernels."""

from .cuda_nms import (greedy_nms, greedy_nms_plain, popmax_nms,
                       popmax_nms_plain)
from .decode import (decode_for_nms, decode_predictions, decode_scale,
                     decode_scale_for_nms, xy_activation)
from .geometry import (canvas_boxes_to_image, clip_boxes_xywh,
                       pairwise_diou_xywh_topleft, pairwise_iou_xywh_topleft,
                       undo_letterbox_boxes)
from .nms import batched_nms
from .yuv import rgb_to_yuv420_np, yuv420_to_rgb

__all__ = [
    'batched_nms', 'canvas_boxes_to_image', 'clip_boxes_xywh',
    'decode_for_nms', 'decode_predictions', 'decode_scale',
    'decode_scale_for_nms', 'greedy_nms', 'greedy_nms_plain',
    'pairwise_diou_xywh_topleft', 'pairwise_iou_xywh_topleft', 'popmax_nms',
    'popmax_nms_plain', 'rgb_to_yuv420_np', 'undo_letterbox_boxes',
    'xy_activation', 'yuv420_to_rgb',
]
