"""Layer primitives of the model zoo (PyTorch, NCHW inside).

Counterpart of ``multigriddet_tpu/models/layers.py``: the no-bias conv +
BatchNorm + LeakyReLU(0.1) block with Darknet's top/left padding for
stride-2 convs, and the biased 1x1 predict conv that emits float32.

Submodules carry the flax auto-names (``Conv_0``, ``BatchNorm_0``) so the
``state_dict`` keys follow the flax parameter paths one to one
(``models/weights.py``).  Every conv runs in the block's ``dtype``
(bfloat16 for serving) with float32 parameters; BatchNorm runs in float32
as flax does, then casts back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPSILON = 1e-3
# flax momentum 0.99 (weight of the old running value) is torch 0.01
BN_MOMENTUM = 0.01


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


def _check_eval(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            'training-mode forward waits for the training slice (ROADMAP '
            'Queue 1 item 9); call model.eval()')


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm + LeakyReLU(0.1).

    Stride-2 convs pad top/left by one and run VALID; stride-1 convs pad
    SAME (``multigriddet_tpu/models/layers.py:137-141``).
    """

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, strides, dtype
        self.Conv_0 = nn.Conv2d(in_channels, filters, kernel, strides,
                                padding=0, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(filters, eps=BN_EPSILON,
                                          momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_eval(self)
        if self.strides == 2:
            x = F.pad(x, (1, 0, 1, 0))
        else:
            p = self.kernel // 2
            x = F.pad(x, (p, p, p, p))
        y = F.conv2d(x.to(self.dtype), self.Conv_0.weight.to(self.dtype),
                     stride=self.strides)
        bn = self.BatchNorm_0
        # flax order: (x - mean) * (rsqrt(var + eps) * scale) + bias, f32
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = ((y.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
             + bn.bias[:, None, None])
        return leaky_relu(y.to(self.dtype))


class PredictConv(nn.Module):
    """The linear 1x1 prediction conv, with bias; output is float32."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_channels, filters, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.Conv_0.weight, self.Conv_0.bias
        y = F.conv2d(x.to(self.dtype), w.to(self.dtype), b.to(self.dtype))
        return y.float()
