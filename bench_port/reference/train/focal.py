"""Frozen copy of ``multigriddet_tpu_torch/losses/focal.py`` for the plain
reference (imports rewritten; nothing of the program is imported).

Binary cross-entropy and focal losses from logits.

Counterpart of ``multigriddet_tpu/losses/focal.py``: the same expressions,
elementwise, no reduction (alpha 0.25, gamma 2 by default).
"""

from __future__ import annotations

import torch


def binary_cross_entropy_with_logits(labels: torch.Tensor,
                                     logits: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x * z + log(1 + exp(-|x|))."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(labels: torch.Tensor, logits: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    p = torch.sigmoid(logits)
    bce = binary_cross_entropy_with_logits(labels, logits)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_t = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * bce


def softmax_focal_loss(labels: torch.Tensor, logits: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-class softmax focal loss (no reduction over the class axis)."""
    log_p = torch.log_softmax(logits, dim=-1)
    p = torch.exp(log_p)
    ce = -labels * log_p
    return alpha * torch.pow(1.0 - p, gamma) * ce
