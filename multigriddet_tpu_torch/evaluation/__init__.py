"""Evaluation layer of the port: evaluator, mAP metrics, report plots."""

from .evaluator import MultiGridEvaluator
from .metrics import (COCO_IOU_THRESHOLDS, average_precision, calculate_map,
                      format_results, iou_matrix, match_detections)
from .visualizations import generate_evaluation_report

__all__ = [
    'MultiGridEvaluator', 'COCO_IOU_THRESHOLDS', 'average_precision',
    'calculate_map', 'format_results', 'iou_matrix', 'match_detections',
    'generate_evaluation_report',
]
