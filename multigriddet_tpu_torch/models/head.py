"""MultiGrid detection heads (PyTorch, NCHW).

Counterpart of ``multigriddet_tpu/models/head.py``:

* ``MultiGridHead`` (JAX ``:79-120``): per scale a 3-conv bottleneck, a
  3x3 conv and one predict conv with ``A + C + 5`` output channels;
  intermediate predict widths are 8x/4x/2x ``(A0 + C + 5)``, all keyed off
  the first scale's anchor count as in the JAX head.  Scales merge
  top-down through 1x1 reduce + 2x upsample + channel concat.  ``lite``
  swaps the 3x3 convs for depthwise-separable ones (``MultiGridLiteHead``)
  and ``use_spp`` inserts SPP + 1x1 into the first scale's bottleneck.
* ``PANetHead`` (``:145-200``): a top-down then a bottom-up path of
  ``_FiveConv`` merges with the compact predict convs; SPP by default.

Submodules carry the flax auto-names in construction order (``auto_name``),
so the lite bottleneck's 3x3 is ``SeparableConvBN_0`` and its last 1x1 is
``ConvBN_1`` (``ConvBN_2`` with SPP).  Outputs are NHWC
``[B, gh, gw, A + C + 5]`` float32, the layout decode expects; the
permute happens once, after each predict conv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import (BN_MOMENTUM, ConvBN, PredictConv, SeparableConvBN,
                     auto_name, spp, upsample2x)
from .registry import register_head


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class _Bottleneck(nn.Module):
    """ConvBN 1x1 -> [SPP -> 1x1] -> 3x3 (separable when ``lite``) -> 1x1."""

    def __init__(self, in_channels: int, filters: int, use_spp: bool = False,
                 lite: bool = False, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        kw = dict(dtype=dtype, bn_momentum=bn_momentum)
        conv3 = SeparableConvBN if lite else ConvBN
        self.order = [auto_name(self, ConvBN(in_channels, filters, 1, **kw))]
        self.use_spp = use_spp
        if use_spp:
            self.order.append(auto_name(
                self, ConvBN(4 * filters, filters, 1, **kw)))
        self.order += [auto_name(self, conv3(filters, filters * 2, 3, **kw)),
                       auto_name(self, ConvBN(filters * 2, filters, 1, **kw))]

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        x = getattr(self, self.order[0])(x, train)
        if self.use_spp:
            x = spp(x)
        for name in self.order[1:]:
            x = getattr(self, name)(x, train)
        return x


class _ScaleHead(nn.Module):
    """Bottleneck + predict branch; returns (features, NHWC logits)."""

    def __init__(self, in_channels: int, filters: int, predict_filters: int,
                 out_filters: int, use_spp: bool = False, lite: bool = False,
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self._Bottleneck_0 = _Bottleneck(in_channels, filters, use_spp, lite,
                                         dtype, bn_momentum)
        conv3 = SeparableConvBN if lite else ConvBN
        self.conv3 = auto_name(self, conv3(filters, predict_filters, 3,
                                           dtype=dtype,
                                           bn_momentum=bn_momentum))
        self.PredictConv_0 = PredictConv(predict_filters, out_filters,
                                         dtype=dtype)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        x = self._Bottleneck_0(x, train)
        y = self.PredictConv_0(getattr(self, self.conv3)(x, train))
        return x, _nhwc(y)


@register_head('multigrid')
class MultiGridHead(nn.Module):
    """Three-scale MultiGrid head over (C3, C4, C5) taps of widths
    ``in_channels``; ``channels`` are the working widths, coarse -> fine."""

    def __init__(self, in_channels: Tuple[int, int, int],
                 num_anchors: Tuple[int, int, int] = (3, 3, 3),
                 num_classes: int = 80,
                 channels: Tuple[int, int, int] = (512, 256, 128),
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM, use_spp: bool = False,
                 lite: bool = False):
        super().__init__()
        c3, c4, c5 = in_channels
        a, c = tuple(num_anchors), num_classes
        f1c, f2c, f3c = channels
        base = a[0] + c + 5
        kw = dict(lite=lite, dtype=dtype, bn_momentum=bn_momentum)
        ckw = dict(dtype=dtype, bn_momentum=bn_momentum)
        self._ScaleHead_0 = _ScaleHead(c5, f1c // 2, 8 * base, a[0] + c + 5,
                                       use_spp=use_spp, **kw)
        self.ConvBN_0 = ConvBN(f1c // 2, f2c // 2, 1, **ckw)
        self._ScaleHead_1 = _ScaleHead(f2c // 2 + c4, f2c // 2, 4 * base,
                                       a[1] + c + 5, **kw)
        self.ConvBN_1 = ConvBN(f2c // 2, f3c // 2, 1, **ckw)
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


@register_head('multigrid_lite')
class MultiGridLiteHead(MultiGridHead):
    """Depthwise-separable variant: ``lite`` defaults to True."""

    def __init__(self, *args, lite: bool = True, **kwargs):
        super().__init__(*args, lite=lite, **kwargs)


class _FiveConv(nn.Module):
    """1x1 / 3x3 (x2 wide) / 1x1 / 3x3 (x2 wide) / 1x1 (PANet merge)."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        cin = in_channels
        for i in range(5):
            k = 3 if i % 2 == 1 else 1
            f = filters * 2 if i % 2 == 1 else filters
            self.add_module(f'ConvBN_{i}', ConvBN(cin, f, k, dtype=dtype,
                                                  bn_momentum=bn_momentum))
            cin = f

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        for i in range(5):
            x = getattr(self, f'ConvBN_{i}')(x, train)
        return x


@register_head('panet')
class PANetHead(nn.Module):
    """PANet head: top-down then bottom-up paths with the compact
    ``A + C + 5`` predict convs.  The concatenations are ``[y4, x]``,
    ``[y3_in, x]``, ``[x, p4]`` and ``[x, p5]``; the bottom-up stride-2
    ConvBNs pad top/left.  ``lite`` is accepted and unused, as in JAX."""

    def __init__(self, in_channels: Tuple[int, int, int],
                 num_anchors: Tuple[int, int, int] = (3, 3, 3),
                 num_classes: int = 80,
                 channels: Tuple[int, int, int] = (512, 256, 128),
                 dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM, use_spp: bool = True,
                 lite: bool = False):
        super().__init__()
        c3, c4, c5 = in_channels
        a, c = tuple(num_anchors), num_classes
        f1c, f2c, f3c = channels
        kw = dict(dtype=dtype, bn_momentum=bn_momentum)
        # construction (call) order of the flax head
        self._Bottleneck_0 = _Bottleneck(c5, f1c, use_spp=use_spp, **kw)
        self.ConvBN_0 = ConvBN(f1c, f2c // 2, 1, **kw)
        self.ConvBN_1 = ConvBN(c4, f2c // 2, 1, **kw)
        self._FiveConv_0 = _FiveConv(2 * (f2c // 2), f2c // 2, **kw)
        self.ConvBN_2 = ConvBN(f2c // 2, f3c // 2, 1, **kw)
        self.ConvBN_3 = ConvBN(c3, f3c // 2, 1, **kw)
        self._FiveConv_1 = _FiveConv(2 * (f3c // 2), f3c // 2, **kw)
        self.ConvBN_4 = ConvBN(f3c // 2, f3c, 3, **kw)
        self.PredictConv_0 = PredictConv(f3c, a[2] + c + 5, dtype=dtype)
        self.ConvBN_5 = ConvBN(f3c // 2, f2c // 2, 3, strides=2, **kw)
        self._FiveConv_2 = _FiveConv(2 * (f2c // 2), f2c // 2, **kw)
        self.ConvBN_6 = ConvBN(f2c // 2, f2c, 3, **kw)
        self.PredictConv_1 = PredictConv(f2c, a[1] + c + 5, dtype=dtype)
        self.ConvBN_7 = ConvBN(f2c // 2, f1c // 2, 3, strides=2, **kw)
        self._FiveConv_3 = _FiveConv(f1c // 2 + f1c, f1c // 2, **kw)
        self.ConvBN_8 = ConvBN(f1c // 2, f1c, 3, **kw)
        self.PredictConv_2 = PredictConv(f1c, a[0] + c + 5, dtype=dtype)

    def forward(self, taps, train: Optional[bool] = None):
        c3, c4, c5 = taps
        # top-down
        p5 = self._Bottleneck_0(c5, train)
        x = upsample2x(self.ConvBN_0(p5, train))
        y4 = self.ConvBN_1(c4, train)
        p4 = self._FiveConv_0(torch.cat([y4, x], dim=1), train)
        x = upsample2x(self.ConvBN_2(p4, train))
        y3_in = self.ConvBN_3(c3, train)
        p3 = self._FiveConv_1(torch.cat([y3_in, x], dim=1), train)
        y3 = self.PredictConv_0(self.ConvBN_4(p3, train))
        # bottom-up
        x = self.ConvBN_5(p3, train)
        p4 = self._FiveConv_2(torch.cat([x, p4], dim=1), train)
        y2 = self.PredictConv_1(self.ConvBN_6(p4, train))
        x = self.ConvBN_7(p4, train)
        p5 = self._FiveConv_3(torch.cat([x, p5], dim=1), train)
        y1 = self.PredictConv_2(self.ConvBN_8(p5, train))
        return _nhwc(y1), _nhwc(y2), _nhwc(y3)
