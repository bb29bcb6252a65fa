"""MultiGridDet prediction decoding on tensors.

Counterpart of ``multigriddet_tpu/ops/decode.py``:

* ``xy = tanh(0.15 t) + sigmoid(0.15 t) + cell``, normalized by the grid;
* ``wh = anchors[argmax(anchor_logits)] * exp(twh) / input_wh``;
* rescored confidence ``sigmoid(obj) * max(anchor_p) * max(class_p)``.

Decode always runs in float32.  ``argmax`` ties resolve to the first
index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def xy_activation(t: torch.Tensor) -> torch.Tensor:
    """MultiGridDet coordinate activation: range (-1, 2), slope 1 at 0."""
    return torch.tanh(0.15 * t) + torch.sigmoid(0.15 * t)


def invert_xy_activation(y: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Newton inversion of ``xy_activation``, valid for y in (-1, 2)."""
    y = torch.clamp(y, -1.0 + 1e-4, 2.0 - 1e-4)
    x = torch.zeros_like(y)
    for _ in range(iters):
        s = torch.sigmoid(0.15 * x)
        th = torch.tanh(0.15 * x)
        fx = th + s - y
        dfx = 0.15 * (1.0 - th * th) + 0.15 * s * (1.0 - s)
        x = x - fx / torch.clamp_min(dfx, 1e-4)
    return x


def _cell_grid(gh: int, gw: int, device) -> torch.Tensor:
    rows, cols = torch.meshgrid(
        torch.arange(gh, dtype=torch.float32, device=device),
        torch.arange(gw, dtype=torch.float32, device=device), indexing='ij')
    return torch.stack([cols, rows], dim=-1)              # [gh, gw, 2]


def _anchors(anchors, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(anchors, np.float32), device=device)


def _boxes(prediction, anchors, anchor_scores, input_hw):
    """Box centres and sizes; the anchor is ``argmax(anchor_scores)``
    (logits on the NMS path, probabilities in ``decode_scale``, as in JAX).
    """
    _, gh, gw, _ = prediction.shape
    dev = prediction.device
    box_xy = xy_activation(prediction[..., 0:2]) + _cell_grid(gh, gw, dev)
    box_xy = box_xy / torch.tensor([gw, gh], dtype=torch.float32, device=dev)
    anchor_idx = torch.argmax(anchor_scores, dim=-1)
    in_wh = torch.tensor([input_hw[1], input_hw[0]], dtype=torch.float32,
                         device=dev)
    box_wh = anchors[anchor_idx] * torch.exp(prediction[..., 2:4]) / in_wh
    return box_xy, box_wh


def decode_scale(prediction: torch.Tensor, anchors, input_hw: Tuple[int, int],
                 rescore_confidence: bool = True,
                 use_softmax: bool = True) -> torch.Tensor:
    """One scale's ``[B, gh, gw, 5 + A + C]`` logits -> ``[B, gh*gw, 5 + C]``
    (normalized cxcywh, rescored confidence, class probabilities)."""
    b, gh, gw, _ = prediction.shape
    anchors = _anchors(anchors, prediction.device)
    num_anchors = anchors.shape[0]
    anchor_logits = prediction[..., 5:5 + num_anchors]
    class_logits = prediction[..., 5 + num_anchors:]
    if use_softmax:
        anchor_probs = torch.softmax(anchor_logits, dim=-1)
        class_probs = torch.softmax(class_logits, dim=-1)
    else:
        anchor_probs = torch.sigmoid(anchor_logits)
        class_probs = torch.sigmoid(class_logits)
    obj_probs = torch.sigmoid(prediction[..., 4:5])
    box_xy, box_wh = _boxes(prediction, anchors, anchor_probs, input_hw)
    if rescore_confidence:
        obj_probs = (obj_probs
                     * torch.amax(anchor_probs, dim=-1, keepdim=True)
                     * torch.amax(class_probs, dim=-1, keepdim=True))
    out = torch.cat([box_xy, box_wh, obj_probs, class_probs], dim=-1)
    return out.reshape(b, gh * gw, -1)


def decode_scale_for_nms(prediction: torch.Tensor, anchors,
                         input_hw: Tuple[int, int],
                         rescore_confidence: bool = True,
                         use_softmax: bool = True):
    """``decode_scale`` reduced to what NMS reads, without materializing
    the ``[B, N, C]`` class probabilities: ``max(softmax(x)) =
    exp(max(x) - logsumexp(x))`` and ``argmax(softmax(x)) = argmax(x)``.

    Returns ``(boxes [B, gh*gw, 4] normalized cxcywh, scores [B, gh*gw],
    classes [B, gh*gw] int32)``.
    """
    b, gh, gw, _ = prediction.shape
    anchors = _anchors(anchors, prediction.device)
    num_anchors = anchors.shape[0]
    anchor_logits = prediction[..., 5:5 + num_anchors]
    class_logits = prediction[..., 5 + num_anchors:]
    if use_softmax:
        anchor_max = torch.exp(torch.amax(anchor_logits, dim=-1)
                               - torch.logsumexp(anchor_logits, dim=-1))
        class_max = torch.exp(torch.amax(class_logits, dim=-1)
                              - torch.logsumexp(class_logits, dim=-1))
    else:
        anchor_max = torch.sigmoid(torch.amax(anchor_logits, dim=-1))
        class_max = torch.sigmoid(torch.amax(class_logits, dim=-1))
    classes = torch.argmax(class_logits, dim=-1).to(torch.int32)
    scores = torch.sigmoid(prediction[..., 4])
    if rescore_confidence:
        scores = scores * anchor_max * class_max
    box_xy, box_wh = _boxes(prediction, anchors, anchor_logits, input_hw)
    boxes = torch.cat([box_xy, box_wh], dim=-1)
    return (boxes.reshape(b, gh * gw, 4), scores.reshape(b, gh * gw),
            classes.reshape(b, gh * gw))


def decode_for_nms(predictions: Sequence[torch.Tensor], anchors,
                   input_hw: Tuple[int, int],
                   rescore_confidence: bool = True,
                   use_softmax: bool = True):
    """All scales, concatenated: the fused path's compact decode."""
    parts = [decode_scale_for_nms(p, a, input_hw, rescore_confidence,
                                  use_softmax)
             for p, a in zip(predictions, anchors)]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def decode_predictions(predictions: Sequence[torch.Tensor], anchors,
                       input_hw: Tuple[int, int],
                       rescore_confidence: bool = True,
                       use_softmax: bool = True) -> torch.Tensor:
    """Decode and concatenate all scales: ``[B, total_cells, 5 + C]``."""
    decoded: List[torch.Tensor] = [
        decode_scale(p, a, input_hw, rescore_confidence, use_softmax)
        for p, a in zip(predictions, anchors)]
    return torch.cat(decoded, dim=1)
