"""Layer primitives of the model zoo (PyTorch, NCHW inside).

Counterpart of ``multigriddet_tpu/models/layers.py``: the no-bias conv +
BatchNorm + activation block with Darknet's top/left padding for stride-2
convs (``act``: the JAX ``_ACTS`` table, leaky by default), its
depthwise-separable variant, the SPP pooling stage, and the biased 1x1
predict conv that emits float32.

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

Activation checkpointing (``environment.remat``, ``models/detector.py``)
needs two hooks from here.  :func:`no_stat_updates` stops ``batch_norm``
from moving the running statistics while a checkpointed forward is
recomputed in the backward, so the momentum is applied once, as the JAX
model's functional update does.  Under :func:`selective_remat` (the
selective mode, set around the backbone) :func:`norm_act`, the BatchNorm
+ activation after each conv, runs inside a ``torch.utils.checkpoint``:
the conv's output is kept and the BatchNorm and the activation are
recomputed in the backward (JAX ``layers.py:144-147`` and its
``save_only_these_names('conv_out')`` policy).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import spatial
from ..parallel.distributed import all_mean

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99     # flax convention: the weight of the old value

# thread-local: the autograd engine recomputes a checkpointed forward on
# its own thread for CUDA tensors, and the flags are set on that thread
_LOCAL = threading.local()


@contextlib.contextmanager
def _flag(name: str):
    before = getattr(_LOCAL, name, False)
    setattr(_LOCAL, name, True)
    try:
        yield
    finally:
        setattr(_LOCAL, name, before)


def no_stat_updates():
    """Train-mode ``batch_norm`` normalizes with the batch's statistics but
    leaves the running statistics as they are (the recompute of a
    checkpointed forward)."""
    return _flag('frozen_stats')


def selective_remat():
    """``norm_act`` checkpoints its BatchNorm + activation (see the module
    docstring)."""
    return _flag('selective')


def recompute_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: the forward runs as
    it is; its recompute in the backward moves no running statistic and
    runs under the spatial partition that was active in the forward
    (``parallel/spatial.py``), whichever thread runs it."""
    return contextlib.nullcontext(), _recompute(spatial.current())


@contextlib.contextmanager
def _recompute(part):
    with no_stat_updates(), spatial.active(part):
        yield


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))``.  JAX's softplus is ``logaddexp(x, 0)``;
    ``F.softplus`` returns ``x`` itself above 20, which differs from it by
    ``log1p(exp(-x)) < 2.1e-9``: at most ~2e-9 of the output there, far
    below the logit tolerance, and below float32's resolution of ``x``."""
    return x * torch.tanh(F.softplus(x))


def linear(x: torch.Tensor) -> torch.Tensor:
    return x


ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    'leaky': leaky_relu,
    'mish': mish,
    'relu': F.relu,
    'linear': linear,
}


def auto_name(parent: nn.Module, child: nn.Module) -> str:
    """Register ``child`` under its flax auto-name ``{kind}_{n}``, where
    ``kind`` is its class name and ``n`` counts the children of that kind
    that ``parent`` already holds (flax numbers submodules per class in
    construction order).  Returns the name."""
    kind = type(child).__name__
    n = sum(name.rsplit('_', 1)[0] == kind
            for name, _ in parent.named_children())
    name = f'{kind}_{n}'
    parent.add_module(name, child)
    return name


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (under a spatial
    partition, re-banded onto the finer level's band)."""
    if spatial.current() is not None:
        return spatial.upsample2x(x)
    return F.interpolate(x, scale_factor=2, mode='nearest')


def batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d, train: bool,
               momentum: float) -> torch.Tensor:
    """flax BatchNorm of an NCHW tensor, in float32 (float64 for a float64
    model, the reference of the port's gradient checks); see the module
    docstring.  In training the running statistics update in place.

    Under data parallel (``parallel.distributed``), the batch moments are
    averaged over the ranks with an autograd-aware all-reduce, so they
    are the global batch's (flax's ``axis_name`` pmean).  Under a spatial
    partition the ranks hold bands of uneven height, so the sums of ``y``
    and ``y^2`` are all-reduced and divided by the global count
    (``spatial.global_moments``)."""
    yf = y if y.dtype == torch.float64 else y.float()
    if train:
        if spatial.current() is not None:
            mean, mean2 = spatial.global_moments(yf)
        else:
            mean, mean2 = all_mean(yf.mean((0, 2, 3)),
                                   yf.square().mean((0, 2, 3)))
        var = torch.clamp_min(mean2 - mean.square(), 0.0)
        if not getattr(_LOCAL, 'frozen_stats', False):
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


def _norm_act(y: torch.Tensor, bn: nn.BatchNorm2d, train: bool,
              momentum: float, act: Callable, dtype: torch.dtype
              ) -> torch.Tensor:
    return act(batch_norm(y, bn, train, momentum).to(dtype))


def norm_act(y: torch.Tensor, bn: nn.BatchNorm2d, train: bool,
             momentum: float, act: Callable, dtype: torch.dtype
             ) -> torch.Tensor:
    """``act(batch_norm(y))`` in ``dtype``; under :func:`selective_remat`
    with gradients on, checkpointed, so only ``y`` is kept for the
    backward."""
    if getattr(_LOCAL, 'selective', False) and torch.is_grad_enabled():
        return checkpoint(_norm_act, y, bn, train, momentum, act, dtype,
                          use_reentrant=False,
                          context_fn=recompute_contexts)
    return _norm_act(y, bn, train, momentum, act, dtype)


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm + activation (``act``, one of
    :data:`ACTS`; LeakyReLU(0.1) by default).

    Stride-2 convs pad top/left by one and run VALID; stride-1 convs pad
    SAME (``multigriddet_tpu/models/layers.py:137-141``).
    """

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM, act: str = 'leaky'):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, strides, dtype
        self.bn_momentum = bn_momentum
        self.act = ACTS[act]
        self.Conv_0 = nn.Conv2d(in_channels, filters, kernel, strides,
                                padding=0, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(filters, eps=BN_EPSILON,
                                          momentum=1 - bn_momentum)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        if self.strides == 2:
            x = spatial.pad(x, (1, 0, 1, 0), self.kernel, 2)
        else:
            p = self.kernel // 2
            x = spatial.pad(x, (p, p, p, p), self.kernel, 1)
        y = F.conv2d(x.to(self.dtype), self.Conv_0.weight.to(self.dtype),
                     stride=self.strides)
        return norm_act(y, self.BatchNorm_0, train, self.bn_momentum,
                        self.act, self.dtype)


class SeparableConvBN(nn.Module):
    """Depthwise-separable ConvBN (JAX ``layers.py:202-237``): a depthwise
    ``kernel`` conv (``groups=in_channels``), BatchNorm, the activation, a
    pointwise 1x1 conv, BatchNorm, the activation.  Both BatchNorms use
    eps 1e-3; stride 2 pads top/left and runs VALID, as ``ConvBN``."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM, act: str = 'leaky'):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, strides, dtype
        self.bn_momentum = bn_momentum
        self.act = ACTS[act]
        self.Conv_0 = nn.Conv2d(in_channels, in_channels, kernel, strides,
                                groups=in_channels, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(in_channels, eps=BN_EPSILON)
        self.Conv_1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm2d(filters, eps=BN_EPSILON)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        if self.strides == 2:
            x = spatial.pad(x, (1, 0, 1, 0), self.kernel, 2)
        else:
            p = self.kernel // 2
            x = spatial.pad(x, (p, p, p, p), self.kernel, 1)
        w = self.Conv_0.weight.to(self.dtype)
        y = F.conv2d(x.to(self.dtype), w, stride=self.strides,
                     groups=w.shape[0])
        y = norm_act(y, self.BatchNorm_0, train, self.bn_momentum, self.act,
                     self.dtype)
        y = F.conv2d(y, self.Conv_1.weight.to(self.dtype))
        return norm_act(y, self.BatchNorm_1, train, self.bn_momentum,
                        self.act, self.dtype)


def spp(x: torch.Tensor, pool_sizes: Sequence[int] = (5, 9, 13)
        ) -> torch.Tensor:
    """Spatial pyramid pooling of an NCHW tensor: stride-1 max-pools with
    SAME padding (max-pooling pads with -inf), concatenated as
    ``pools[::-1] + [x]`` -- 13, 9, 5, then the identity (JAX
    ``layers.py:240-252``).  Under a spatial partition one exchange
    gathers the widest pool's halo rows (-inf outside the map) and each
    pool runs VALID along the rows on its share of them."""
    if spatial.current() is None:
        pools = [F.max_pool2d(x, k, stride=1, padding=k // 2)
                 for k in pool_sizes]
    else:
        r = max(pool_sizes) // 2
        xe = spatial.pad(x, (0, 0, r, r), 2 * r + 1, 1, float('-inf'))
        h = x.shape[2]
        pools = [F.max_pool2d(xe.narrow(2, r - k // 2, h + 2 * (k // 2)),
                              k, stride=1, padding=(0, k // 2))
                 for k in pool_sizes]
    return torch.cat(pools[::-1] + [x], dim=1)


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
