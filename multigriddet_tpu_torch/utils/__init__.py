"""Host utilities of the port."""

from .anchors import (DEFAULT_COCO_ANCHORS, class_counts_from_annotations,
                      compute_class_weights, load_anchors, load_classes)
from .profiling import PhaseTimer, trace
from .visualization import draw_boxes, get_colors

__all__ = ['DEFAULT_COCO_ANCHORS', 'PhaseTimer',
           'class_counts_from_annotations', 'compute_class_weights',
           'draw_boxes', 'get_colors', 'load_anchors', 'load_classes',
           'trace']
