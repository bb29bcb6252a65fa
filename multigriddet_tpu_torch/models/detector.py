"""Detector assembly and preset factories (PyTorch).

Counterpart of ``multigriddet_tpu/models/detector.py:27-101,149-172``:
backbone -> (C3, C4, C5) -> MultiGrid head -> (y1, y2, y3).  The forward
takes NHWC images, as the flax model does, permutes them once to NCHW and
returns raw per-scale logits ``[B, gh, gw, A_l + C + 5]`` in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .darknet import Darknet53
from .head import MultiGridHead
from .layers import BN_MOMENTUM, ConvBN


class MultiGridDet(nn.Module):

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, images: torch.Tensor, train: Optional[bool] = None,
                backbone_train: Optional[bool] = None):
        """``images``: ``[B, H, W, 3]`` float, NHWC as in the JAX model.

        ``train`` selects BatchNorm's mode (default: the module's
        ``training`` flag); ``backbone_train`` overrides it for the
        backbone alone, as the freeze-level-1 stage runs the frozen
        backbone's BatchNorm in inference mode (JAX ``detector.py:40-52``).
        """
        bt = train if backbone_train is None else backbone_train
        taps = self.backbone(images.permute(0, 3, 1, 2), bt)
        return self.head(taps, train)


class TinyBackbone(nn.Module):
    """Minimal 5-stride backbone for smoke tests and CI."""

    out_channels: Tuple[int, int, int] = (32, 48, 64)

    def __init__(self, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        cin = 3
        for i, ch in enumerate((16, 24, *self.out_channels)):
            self.add_module(f'ConvBN_{i}', ConvBN(
                cin, ch, 3, strides=2, dtype=dtype, bn_momentum=bn_momentum))
            cin = ch

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        taps = []
        for i in range(5):
            x = getattr(self, f'ConvBN_{i}')(x, train)
            if i >= 2:
                taps.append(x)
        return tuple(taps)


def _head_channels(backbone) -> Tuple[int, int, int]:
    """Head working widths: half of each tap's width, coarse -> fine."""
    c3, c4, c5 = backbone.out_channels
    return c5 // 2, c4 // 2, c3 // 2


def _build(backbone_cls, num_anchors=(3, 3, 3), num_classes: int = 80,
           dtype: torch.dtype = torch.float32,
           bn_momentum: float = BN_MOMENTUM) -> MultiGridDet:
    backbone = backbone_cls(dtype=dtype, bn_momentum=bn_momentum)
    head = MultiGridHead(backbone.out_channels, tuple(num_anchors),
                         num_classes, _head_channels(backbone), dtype,
                         bn_momentum)
    return MultiGridDet(backbone, head)


def multigriddet_darknet(**kwargs) -> MultiGridDet:
    return _build(Darknet53, **kwargs)


def multigriddet_tiny(**kwargs) -> MultiGridDet:
    return _build(TinyBackbone, **kwargs)


_MODELS: Dict[str, Callable[..., MultiGridDet]] = {
    'multigriddet_darknet': multigriddet_darknet,
    'multigriddet_tiny': multigriddet_tiny,
}


def create_model(name: str, **kwargs) -> MultiGridDet:
    """Instantiate a ported preset by name (eval mode)."""
    if name not in _MODELS:
        raise NotImplementedError(
            f'preset {name!r} is not ported yet (ROADMAP Queue 1 item 12); '
            f'ported: {sorted(_MODELS)}')
    return _MODELS[name](**kwargs).eval()
