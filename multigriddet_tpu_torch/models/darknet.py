"""Darknet53 backbone (PyTorch, NCHW).

Counterpart of ``multigriddet_tpu/models/darknet.py:25-81``: stem conv32 +
residual stages (64x1, 128x2, 256x8, 512x8, 1024x4) with taps after the
256- and 512-stage and at the output (strides 8, 16, 32).

The JAX package's ``s2d_stem`` is a space-to-depth execution rewrite for
the TPU's matrix unit with canonical parameter shapes; the same weights
give the same function through the plain 3x3 convs, which is all this
port runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import BN_MOMENTUM, ConvBN


class _ResStage(nn.Module):
    """Stride-2 downsample conv followed by ``num_blocks`` residual pairs."""

    def __init__(self, in_channels: int, filters: int, num_blocks: int,
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        kw = dict(dtype=dtype, bn_momentum=bn_momentum)
        self.num_blocks = num_blocks
        self.ConvBN_0 = ConvBN(in_channels, filters, 3, strides=2, **kw)
        for i in range(num_blocks):
            self.add_module(f'ConvBN_{2 * i + 1}',
                            ConvBN(filters, filters // 2, 1, **kw))
            self.add_module(f'ConvBN_{2 * i + 2}',
                            ConvBN(filters // 2, filters, 3, **kw))

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        x = self.ConvBN_0(x, train)
        for i in range(self.num_blocks):
            y = getattr(self, f'ConvBN_{2 * i + 1}')(x, train)
            x = x + getattr(self, f'ConvBN_{2 * i + 2}')(y, train)
        return x


class Darknet53(nn.Module):
    """Darknet53 body returning (C3, C4, C5) taps at strides (8, 16, 32)."""

    out_channels: Tuple[int, int, int] = (256, 512, 1024)

    def __init__(self, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, 3, dtype=dtype, bn_momentum=bn_momentum)
        widths = ((32, 64, 1), (64, 128, 2), (128, 256, 8), (256, 512, 8),
                  (512, 1024, 4))
        for i, (cin, cout, n) in enumerate(widths):
            self.add_module(f'_ResStage_{i}',
                            _ResStage(cin, cout, n, dtype, bn_momentum))

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        x = self.ConvBN_0(x, train)
        x = self._ResStage_0(x, train)
        x = self._ResStage_1(x, train)
        c3 = x = self._ResStage_2(x, train)
        c4 = x = self._ResStage_3(x, train)
        c5 = self._ResStage_4(x, train)
        return c3, c4, c5
