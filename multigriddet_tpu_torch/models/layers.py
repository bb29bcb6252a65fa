"""Layer primitives of the model zoo (PyTorch, NCHW inside).

Counterpart of ``multigriddet_tpu/models/layers.py``: the no-bias conv +
BatchNorm + LeakyReLU(0.1) block with Darknet's top/left padding for
stride-2 convs, and the biased 1x1 predict conv that emits float32.

Submodules carry the flax auto-names (``Conv_0``, ``BatchNorm_0``) so the
``state_dict`` keys follow the flax parameter paths one to one
(``models/weights.py``).  Every conv runs in the block's ``dtype``
(bfloat16 for serving) with float32 parameters; BatchNorm runs in float32
as flax does, then casts back.

BatchNorm follows ``flax.linen.BatchNorm`` in both modes.  In training it
normalizes with the batch's float32 mean and *fast* variance
``E[x^2] - E[x]^2`` (clipped at 0) over (batch, height, width), and
updates the running statistics as ``m * old + (1 - m) * batch`` with the
biased variance and the flax momentum ``m`` (``bn_momentum``, 0.99 by
default).  ``torch.nn.functional.batch_norm`` would store the unbiased
variance, so the module keeps ``nn.BatchNorm2d`` only as the holder of its
parameters and buffers.  A block's mode is its ``training`` flag unless the
caller passes ``train`` (the flax ``train`` argument).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99     # flax convention: the weight of the old value


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


def batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d, train: bool,
               momentum: float) -> torch.Tensor:
    """flax BatchNorm of an NCHW tensor, in float32 (float64 for a float64
    model, the reference of the port's gradient checks); see the module
    docstring.  In training the running statistics update in place."""
    yf = y if y.dtype == torch.float64 else y.float()
    if train:
        mean = yf.mean((0, 2, 3))
        mean2 = yf.square().mean((0, 2, 3))
        var = torch.clamp_min(mean2 - mean.square(), 0.0)
        with torch.no_grad():
            bn.running_mean.copy_(momentum * bn.running_mean
                                  + (1 - momentum) * mean)
            bn.running_var.copy_(momentum * bn.running_var
                                 + (1 - momentum) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    # flax order: (x - mean) * (rsqrt(var + eps) * scale) + bias
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((yf - mean[:, None, None]) * mul[:, None, None]
            + bn.bias[:, None, None])


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm + LeakyReLU(0.1).

    Stride-2 convs pad top/left by one and run VALID; stride-1 convs pad
    SAME (``multigriddet_tpu/models/layers.py:137-141``).
    """

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, strides, dtype
        self.bn_momentum = bn_momentum
        self.Conv_0 = nn.Conv2d(in_channels, filters, kernel, strides,
                                padding=0, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(filters, eps=BN_EPSILON,
                                          momentum=1 - bn_momentum)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        if self.strides == 2:
            x = F.pad(x, (1, 0, 1, 0))
        else:
            p = self.kernel // 2
            x = F.pad(x, (p, p, p, p))
        y = F.conv2d(x.to(self.dtype), self.Conv_0.weight.to(self.dtype),
                     stride=self.strides)
        y = batch_norm(y, self.BatchNorm_0, train, self.bn_momentum)
        return leaky_relu(y.to(self.dtype))


class PredictConv(nn.Module):
    """The linear 1x1 prediction conv, with bias; output is float32
    (float64 for a float64 model)."""

    def __init__(self, in_channels: int, filters: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_channels, filters, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.Conv_0.weight, self.Conv_0.bias
        y = F.conv2d(x.to(self.dtype), w.to(self.dtype), b.to(self.dtype))
        return y if y.dtype == torch.float64 else y.float()
