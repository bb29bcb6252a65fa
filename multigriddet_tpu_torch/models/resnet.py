"""ResNet-50/101 backbones (PyTorch, NCHW).

Counterpart of ``multigriddet_tpu/models/resnet.py``: bottleneck-v1.5
blocks (the stride on the 3x3), taps (C3, C4, C5) of widths (512, 1024,
2048) at strides (8, 16, 32).

Three departures from ``ConvBN`` follow the flax model:

* BatchNorm uses flax momentum 0.9 and eps 1e-5, with ReLU, whatever the
  config's ``bn_momentum`` says (JAX ``resnet.py:36-39,76-79``);
* every conv pads as flax ``padding='SAME'``: at stride 2 on an even size
  that is 0 top/left and 1 bottom/right, neither torch's symmetric
  ``padding=1`` nor ``ConvBN``'s top/left pad; the 7x7 stem pads (3, 3);
* the stem max-pool is ``SAME`` 3x3 at stride 2, padded with -inf.

Under a spatial partition (``parallel/spatial.py``) the SAME pads are
those of the whole map, read from the level's global rows: the bottom
pad reaches only the last band.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from .layers import linear, norm_act
from .registry import register_backbone

RN_MOMENTUM = 0.9
RN_EPSILON = 1e-5


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding='SAME'`` along one axis: ``ceil(size / stride)``
    outputs, the odd pixel of padding after (bottom/right)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor as flax ``padding='SAME'`` does, ahead of a
    VALID op of ``kernel`` and ``stride`` (under a spatial partition, with
    the rows this rank's output band needs)."""
    top, bottom = same_padding(spatial.rows_of(x), kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0 and spatial.current() is None:
        return x
    return spatial.pad(x, (left, right, top, bottom), kernel, stride,
                       value)


class _RNConvBN(nn.Module):
    """Conv (no bias, SAME) + BatchNorm(0.9, 1e-5) + optional ReLU."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 strides: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.strides, self.act, self.dtype = (kernel, strides,
                                                           act, dtype)
        self.Conv_0 = nn.Conv2d(in_channels, filters, kernel, strides,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(filters, eps=RN_EPSILON,
                                          momentum=1 - RN_MOMENTUM)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        x = pad_same(x, self.kernel, self.strides)
        y = F.conv2d(x.to(self.dtype), self.Conv_0.weight.to(self.dtype),
                     stride=self.strides)
        return norm_act(y, self.BatchNorm_0, train, RN_MOMENTUM,
                        F.relu if self.act else linear, self.dtype)


class _Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with a projection shortcut when the
    stride or width changes.  flax names the shortcut first: with one,
    ``_RNConvBN_0`` is the shortcut and the main path ``_RNConvBN_1..3``;
    without, the main path is ``_RNConvBN_0..2``."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shortcut = strides != 1 or in_channels != filters * 4
        convs = []
        if self.shortcut:
            convs.append(_RNConvBN(in_channels, filters * 4, 1, strides,
                                   act=False, dtype=dtype))
        convs += [_RNConvBN(in_channels, filters, 1, 1, dtype=dtype),
                  _RNConvBN(filters, filters, 3, strides, dtype=dtype),
                  _RNConvBN(filters, filters * 4, 1, 1, act=False,
                            dtype=dtype)]
        for i, conv in enumerate(convs):
            self.add_module(f'_RNConvBN_{i}', conv)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        first = int(self.shortcut)
        short = self._RNConvBN_0(x, train) if self.shortcut else x
        y = x
        for i in range(first, first + 3):
            y = getattr(self, f'_RNConvBN_{i}')(y, train)
        return F.relu(y + short)


class ResNet(nn.Module):
    """Bottleneck ResNet returning (C3, C4, C5) taps; ``_Bottleneck_k``
    counts across all four stages, as flax does."""

    out_channels: Tuple[int, int, int] = (512, 1024, 2048)
    stage_sizes: Sequence[int] = (3, 4, 6, 3)

    def __init__(self, dtype: torch.dtype = torch.float32,
                 stage_sizes: Optional[Sequence[int]] = None):
        super().__init__()
        self.dtype = dtype
        if stage_sizes is not None:
            self.stage_sizes = tuple(stage_sizes)
        self.Conv_0 = nn.Conv2d(3, 64, 7, 2, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(64, eps=RN_EPSILON,
                                          momentum=1 - RN_MOMENTUM)
        self.stage_ends = []
        k, cin = 0, 64
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = 64 * 2 ** stage
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f'_Bottleneck_{k}', _Bottleneck(
                    cin, filters, strides, dtype))
                k, cin = k + 1, filters * 4
            self.stage_ends.append(k)

    def stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The 7x7 stride-2 conv (pad 3) + BatchNorm + ReLU, then the SAME
        3x3 stride-2 max-pool."""
        x = spatial.pad(x, (3, 3, 3, 3), 7, 2)
        y = F.conv2d(x.to(self.dtype), self.Conv_0.weight.to(self.dtype),
                     stride=2)
        x = norm_act(y, self.BatchNorm_0, train, RN_MOMENTUM, F.relu,
                     self.dtype)
        return F.max_pool2d(pad_same(x, 3, 2, value=float('-inf')), 3, 2)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        train = self.training if train is None else train
        x = self.stem(x, train)
        taps = []
        for k in range(self.stage_ends[-1]):
            x = getattr(self, f'_Bottleneck_{k}')(x, train)
            if k + 1 in self.stage_ends[1:]:
                taps.append(x)
        c3, c4, c5 = taps
        return c3, c4, c5


@register_backbone('resnet50')
class ResNet50(ResNet):
    stage_sizes: Sequence[int] = (3, 4, 6, 3)


@register_backbone('resnet101')
class ResNet101(ResNet):
    stage_sizes: Sequence[int] = (3, 4, 23, 3)
