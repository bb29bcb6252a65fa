"""Loss library of the port: MultiGridLoss, focal and IoU-family terms."""

from .focal import (binary_cross_entropy_with_logits, sigmoid_focal_loss,
                    softmax_focal_loss)
from .iou import diou, giou, iou_cxcywh, iou_family_loss
from .multigrid_loss import LossConfig, multigrid_loss

__all__ = [
    'LossConfig', 'binary_cross_entropy_with_logits', 'diou', 'giou',
    'iou_cxcywh', 'iou_family_loss', 'multigrid_loss', 'sigmoid_focal_loss',
    'softmax_focal_loss',
]
