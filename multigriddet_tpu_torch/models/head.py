"""MultiGrid detection head with implicit top-down FPN (PyTorch, NCHW).

Counterpart of ``multigriddet_tpu/models/head.py:27-120``: per scale a
3-conv bottleneck, a 3x3 ConvBN and one predict conv with ``A + C + 5``
output channels; intermediate predict widths are 8x/4x/2x ``(A0 + C + 5)``,
all keyed off the first scale's anchor count as in the JAX head.  Scales
merge top-down through 1x1 reduce + 2x upsample + channel concat.

Outputs are NHWC ``[B, gh, gw, A + C + 5]`` float32, the layout decode
expects; the permute happens once, after each predict conv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import BN_MOMENTUM, ConvBN, PredictConv, upsample2x


class _Bottleneck(nn.Module):
    """ConvBN 1x1 -> 3x3 -> 1x1."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        kw = dict(dtype=dtype, bn_momentum=bn_momentum)
        self.ConvBN_0 = ConvBN(in_channels, filters, 1, **kw)
        self.ConvBN_1 = ConvBN(filters, filters * 2, 3, **kw)
        self.ConvBN_2 = ConvBN(filters * 2, filters, 1, **kw)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        x = self.ConvBN_0(x, train)
        return self.ConvBN_2(self.ConvBN_1(x, train), train)


class _ScaleHead(nn.Module):
    """Bottleneck + predict branch; returns (features, NHWC logits)."""

    def __init__(self, in_channels: int, filters: int, predict_filters: int,
                 out_filters: int, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self._Bottleneck_0 = _Bottleneck(in_channels, filters, dtype,
                                         bn_momentum)
        self.ConvBN_0 = ConvBN(filters, predict_filters, 3, dtype=dtype,
                               bn_momentum=bn_momentum)
        self.PredictConv_0 = PredictConv(predict_filters, out_filters,
                                         dtype=dtype)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        x = self._Bottleneck_0(x, train)
        y = self.PredictConv_0(self.ConvBN_0(x, train))
        return x, y.permute(0, 2, 3, 1).contiguous()


class MultiGridHead(nn.Module):
    """Three-scale MultiGrid head over (C3, C4, C5) taps."""

    def __init__(self, in_channels: Tuple[int, int, int],
                 num_anchors: Tuple[int, int, int] = (3, 3, 3),
                 num_classes: int = 80,
                 channels: Tuple[int, int, int] = (512, 256, 128),
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        c3, c4, c5 = in_channels
        a, c = tuple(num_anchors), num_classes
        f1c, f2c, f3c = channels
        base = a[0] + c + 5
        kw = dict(dtype=dtype, bn_momentum=bn_momentum)
        self._ScaleHead_0 = _ScaleHead(c5, f1c // 2, 8 * base, a[0] + c + 5,
                                       **kw)
        self.ConvBN_0 = ConvBN(f1c // 2, f2c // 2, 1, **kw)
        self._ScaleHead_1 = _ScaleHead(f2c // 2 + c4, f2c // 2, 4 * base,
                                       a[1] + c + 5, **kw)
        self.ConvBN_1 = ConvBN(f2c // 2, f3c // 2, 1, **kw)
        self._ScaleHead_2 = _ScaleHead(f3c // 2 + c3, f3c // 2, 2 * base,
                                       a[2] + c + 5, **kw)

    def forward(self, taps, train: Optional[bool] = None):
        c3, c4, c5 = taps
        x, y1 = self._ScaleHead_0(c5, train)
        x = torch.cat([upsample2x(self.ConvBN_0(x, train)), c4], dim=1)
        x, y2 = self._ScaleHead_1(x, train)
        x = torch.cat([upsample2x(self.ConvBN_1(x, train)), c3], dim=1)
        _, y3 = self._ScaleHead_2(x, train)
        return y1, y2, y3
