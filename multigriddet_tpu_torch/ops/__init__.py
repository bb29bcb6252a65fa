"""Tensor ops of the port: decode, geometry, NMS and its CUDA kernels."""

from .cuda_nms import (greedy_nms, greedy_nms_plain, popmax_nms,
                       popmax_nms_plain)
from .decode import (decode_for_nms, decode_predictions, decode_scale,
                     decode_scale_for_nms, invert_xy_activation,
                     xy_activation)
from .encoding import (encode_targets, extract_center_gt_boxes,
                       flatten_anchors, match_anchors)
from .geometry import (canvas_boxes_to_image, clip_boxes_xywh,
                       cxcywh_to_xyxy, iol_wh, iou_wh,
                       pairwise_diou_xywh_topleft, pairwise_iou_cxcywh,
                       pairwise_iou_xywh_topleft, undo_letterbox_boxes,
                       xyxy_to_cxcywh)
from .nms import batched_nms
from .yuv import rgb_to_yuv420_np, yuv420_to_rgb

__all__ = [
    'batched_nms', 'canvas_boxes_to_image', 'clip_boxes_xywh',
    'cxcywh_to_xyxy', 'decode_for_nms', 'decode_predictions',
    'decode_scale', 'decode_scale_for_nms', 'encode_targets',
    'extract_center_gt_boxes', 'flatten_anchors', 'greedy_nms',
    'greedy_nms_plain', 'invert_xy_activation', 'iol_wh', 'iou_wh',
    'match_anchors', 'pairwise_diou_xywh_topleft', 'pairwise_iou_cxcywh',
    'pairwise_iou_xywh_topleft', 'popmax_nms', 'popmax_nms_plain',
    'rgb_to_yuv420_np', 'undo_letterbox_boxes', 'xy_activation',
    'xyxy_to_cxcywh', 'yuv420_to_rgb',
]
