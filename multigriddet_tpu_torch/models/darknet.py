"""Darknet53, CSPDarknet53 and MobileDarknet backbones (PyTorch, NCHW).

Counterpart of ``multigriddet_tpu/models/darknet.py``:

* ``Darknet53`` (JAX ``:25-81``): stem conv32 + residual stages (64x1,
  128x2, 256x8, 512x8, 1024x4) with taps after the 256- and 512-stage and
  at the output (strides 8, 16, 32);
* ``CSPDarknet53`` (``:84-114,156-180``): the same stage plan as
  cross-stage-partial stages, mish everywhere;
* ``MobileDarknet`` (``:117-153``): a 16-wide stem, five stride-2 stages
  of depthwise-separable residuals, taps (128, 256, 512).

The JAX package's ``s2d_stem`` is a space-to-depth execution rewrite for
the TPU's matrix unit with canonical parameter shapes; the same weights
give the same function through the plain 3x3 convs, which is all this
port runs (ROADMAP item 19).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import BN_MOMENTUM, ConvBN, SeparableConvBN, auto_name
from .registry import register_backbone


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


@register_backbone('darknet53')
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


class _CSPStage(nn.Module):
    """Cross-stage-partial stage (YOLOv4 layout), mish: a stride-2 conv,
    a 1x1 shortcut and a 1x1 main branch of ``hidden`` channels
    (``filters`` for the first stage, else half), ``num_blocks`` residual
    pairs on the main branch, a 1x1, then the concat ``[main, short]``
    and a 1x1 back to ``filters``."""

    def __init__(self, in_channels: int, filters: int, num_blocks: int,
                 first: bool = False, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        kw = dict(act='mish', dtype=dtype, bn_momentum=bn_momentum)
        hidden = filters if first else filters // 2
        self.num_blocks = num_blocks
        self.ConvBN_0 = ConvBN(in_channels, filters, 3, strides=2, **kw)
        self.ConvBN_1 = ConvBN(filters, hidden, 1, **kw)        # short
        self.ConvBN_2 = ConvBN(filters, hidden, 1, **kw)        # main
        for i in range(num_blocks):
            self.add_module(f'ConvBN_{2 * i + 3}',
                            ConvBN(hidden, filters // 2, 1, **kw))
            self.add_module(f'ConvBN_{2 * i + 4}',
                            ConvBN(filters // 2, hidden, 3, **kw))
        self.add_module(f'ConvBN_{2 * num_blocks + 3}',
                        ConvBN(hidden, hidden, 1, **kw))
        self.add_module(f'ConvBN_{2 * num_blocks + 4}',
                        ConvBN(2 * hidden, filters, 1, **kw))

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        n = self.num_blocks
        x = self.ConvBN_0(x, train)
        short = self.ConvBN_1(x, train)
        main = self.ConvBN_2(x, train)
        for i in range(n):
            y = getattr(self, f'ConvBN_{2 * i + 3}')(main, train)
            main = main + getattr(self, f'ConvBN_{2 * i + 4}')(y, train)
        main = getattr(self, f'ConvBN_{2 * n + 3}')(main, train)
        return getattr(self, f'ConvBN_{2 * n + 4}')(
            torch.cat([main, short], dim=1), train)


@register_backbone('csp_darknet53')
class CSPDarknet53(nn.Module):
    """CSPDarknet53 returning (C3, C4, C5) taps at strides (8, 16, 32)."""

    out_channels: Tuple[int, int, int] = (256, 512, 1024)

    def __init__(self, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, 3, dtype=dtype, bn_momentum=bn_momentum,
                               act='mish')
        widths = ((32, 64, 1), (64, 128, 2), (128, 256, 8), (256, 512, 8),
                  (512, 1024, 4))
        for i, (cin, cout, n) in enumerate(widths):
            self.add_module(f'_CSPStage_{i}', _CSPStage(
                cin, cout, n, first=i == 0, dtype=dtype,
                bn_momentum=bn_momentum))

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        x = self.ConvBN_0(x, train)
        x = self._CSPStage_0(x, train)
        x = self._CSPStage_1(x, train)
        c3 = x = self._CSPStage_2(x, train)
        c4 = x = self._CSPStage_3(x, train)
        c5 = self._CSPStage_4(x, train)
        return c3, c4, c5


@register_backbone('mobile_darknet')
class MobileDarknet(nn.Module):
    """Depthwise-separable Darknet-style backbone: stem ``ConvBN_0``, the
    stride-2 convs ``ConvBN_1..5`` and the residuals
    ``SeparableConvBN_0..7``, in the flax model's construction order."""

    out_channels: Tuple[int, int, int] = (128, 256, 512)
    STAGES = ((32, 1), (64, 1), (128, 2), (256, 2), (512, 2))

    def __init__(self, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        kw = dict(dtype=dtype, bn_momentum=bn_momentum)
        auto_name(self, ConvBN(3, 16, 3, **kw))
        self.stages = []
        cin = 16
        for filters, blocks in self.STAGES:
            down = auto_name(self, ConvBN(cin, filters, 3, strides=2, **kw))
            res = [auto_name(self, SeparableConvBN(filters, filters, 3, **kw))
                   for _ in range(blocks)]
            self.stages.append((down, res))
            cin = filters

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        x = self.ConvBN_0(x, train)
        taps = []
        for i, (down, res) in enumerate(self.stages):
            x = getattr(self, down)(x, train)
            for name in res:
                x = x + getattr(self, name)(x, train)
            if i >= 2:
                taps.append(x)
        return tuple(taps)
