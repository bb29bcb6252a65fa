"""Composable FPN neck (the registry's ``neck`` slot), PyTorch, NCHW.

Counterpart of ``multigriddet_tpu/models/neck.py``: a top-down FPN that
``build_custom`` runs between the backbone and the head, pre-fusing the
taps.  The presets keep the head's implicit FPN and have no neck.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import BN_MOMENTUM, ConvBN, upsample2x
from .registry import register_neck


@register_neck('multigrid_fpn')
class MultiGridFPN(nn.Module):
    """Top-down FPN over (C3, C4, C5) taps of widths ``in_channels`` ->
    (N3, N4, C5): 1x1-reduce the coarse tap, upsample + concat into the
    next scale, refine with a 3x3/3x3 stack; the coarsest tap passes
    through untouched.  ``channels`` is (f1, f2, f3), coarse -> fine."""

    def __init__(self, in_channels: Tuple[int, int, int],
                 channels: Tuple[int, int, int] = (512, 256, 128),
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        c3, c4, c5 = in_channels
        self.channels = tuple(channels)
        f1c, f2c, f3c = self.channels
        kw = dict(dtype=dtype, bn_momentum=bn_momentum)
        self.ConvBN_0 = ConvBN(c5, f1c // 2, 1, **kw)
        self.ConvBN_1 = ConvBN(f1c // 2, f2c // 2, 1, **kw)
        self.ConvBN_2 = ConvBN(f2c // 2 + c4, f2c // 2, 3, **kw)
        self.ConvBN_3 = ConvBN(f2c // 2, f2c, 3, **kw)
        self.ConvBN_4 = ConvBN(f2c // 2 + c4, f3c // 2, 1, **kw)
        self.ConvBN_5 = ConvBN(f3c // 2 + c3, f3c // 2, 3, **kw)
        self.ConvBN_6 = ConvBN(f3c // 2, f3c, 3, **kw)

    @property
    def out_channels(self) -> Tuple[int, int, int]:
        """Output widths fine -> coarse: (f3, f2, -1), where -1 means the
        backbone's C5 passes through (``build_custom`` reads its width)."""
        return (self.channels[2], self.channels[1], -1)

    def forward(self, taps, train: Optional[bool] = None):
        c3, c4, c5 = taps
        x = self.ConvBN_0(c5, train)
        x = self.ConvBN_1(x, train)
        x = torch.cat([upsample2x(x), c4], dim=1)
        n4 = self.ConvBN_3(self.ConvBN_2(x, train), train)
        x = self.ConvBN_4(x, train)
        x = torch.cat([upsample2x(x), c3], dim=1)
        n3 = self.ConvBN_6(self.ConvBN_5(x, train), train)
        return n3, n4, c5
