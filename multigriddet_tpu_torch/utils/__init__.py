"""Host utilities of the port."""

from .anchors import DEFAULT_COCO_ANCHORS, load_anchors, load_classes
from .visualization import draw_boxes, get_colors

__all__ = ['DEFAULT_COCO_ANCHORS', 'draw_boxes', 'get_colors',
           'load_anchors', 'load_classes']
