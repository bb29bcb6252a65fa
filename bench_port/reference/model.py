"""Plain PyTorch reference of the benchmarked detector.

``darknet``: Darknet-53 (YOLOv3, arXiv:1804.02767: a 3x3 stem and five
stride-2 stages of 1, 2, 8, 8, 4 residual pairs, 52 convolutions) and
MultiGridDet's three-scale head: per scale a 1x1 / 3x3 / 1x1 bottleneck,
a wide 3x3 (8, 4, 2 x (A + C + 5) filters) and a biased 1x1 predict
conv; the coarse features are reduced by a 1x1, upsampled and joined to
the next tap, as YOLOv3's FPN does.

Every convolution is bias-free and followed by BatchNorm (epsilon 1e-3,
flax's order ``(x - mean) * (rsqrt(var + eps) * scale) + bias``) and
leaky ReLU 0.1; stride-2 convolutions pad one row and column at the top
and left (Darknet's convention), stride-1 ones pad SAME.  The predict
convs emit ``A + C + 5`` channels per cell: x, y, w, h, objectness, A
anchor logits, C class logits.

The network is a list of units in the order they run.  Building it runs
the forward once on shapes alone, which records each unit's shape; the
weights are then filled by the caller (``harness/weights.py``).  In train
mode BatchNorm normalises with the batch's float32 moments (the biased
"fast" variance ``E[x^2] - E[x]^2``, clipped at 0) and keeps them on the
unit; :meth:`Net.update_running` then moves the running statistics
towards them, as the program's train step does once a step.  With
``checkpoint`` set, each unit keeps only its input for the backward and
recomputes the rest (the reference trains at the cell's batch on one
card).  ``quant`` (None by default) is applied to the input and the
weight of every convolution: the control of the correctness check passes
a float8 rounding there.

Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-3


def leaky(x):
    return F.leaky_relu(x, 0.1)


class _Shape:
    """What building the network passes between units: a shape alone (no
    tensor library is asked to trace it)."""

    class device:
        type = 'shape'

    def __init__(self, *shape):
        self.shape = tuple(shape)

    def __add__(self, other):
        return self


def _built(x) -> bool:
    return isinstance(x, _Shape)


class Unit:
    """One conv + BatchNorm + leaky ReLU, or one biased predict conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 predict: bool = False, residual: bool = False):
        self.cin, self.cout, self.k, self.stride = cin, cout, k, stride
        self.predict, self.residual = predict, residual
        self.weight: Optional[torch.Tensor] = None      # [cout, cin, k, k]
        self.bias: Optional[torch.Tensor] = None        # predict only
        self.gamma = self.beta = self.mean = self.var = None
        # train mode: the last batch's moments (mean, variance)
        self.moments = None

    def tensors(self) -> List[torch.Tensor]:
        """The unit's tensors in the port's ``state_dict`` order: conv
        weight, then BatchNorm scale, bias, running mean and variance (or
        the predict conv's bias)."""
        if self.predict:
            return [self.weight, self.bias]
        return [self.weight, self.gamma, self.beta, self.mean, self.var]

    def shapes(self):
        if self.predict:
            return [(self.cout, self.cin, 1, 1), (self.cout,)]
        return [(self.cout, self.cin, self.k, self.k)] + [(self.cout,)] * 4

    def trainables(self) -> List[torch.Tensor]:
        if self.predict:
            return [self.weight, self.bias]
        return [self.weight, self.gamma, self.beta]


class Net:
    """A list of units and the forward that runs them in order."""

    def __init__(self, arch: str, num_anchors: Sequence[int],
                 num_classes: int):
        if arch not in ARCHS:
            raise KeyError(f'unknown reference architecture {arch!r}')
        self.arch, self.num_classes = arch, num_classes
        self.num_anchors = tuple(num_anchors)
        self.units: List[Unit] = []
        self.quant: Optional[Callable] = None
        # train mode: keep only each convolution's input for the backward
        self.checkpoint = False
        self._building = True
        self._calibrating = False
        ARCHS[arch](self, _Shape(1, 3, 64, 64), False)
        self._building = False

    # --- the two primitives -------------------------------------------
    def _next(self, cin, cout, k, stride, predict=False,
              residual=False) -> Unit:
        if self._building:
            u = Unit(cin, cout, k, stride, predict, residual)
            self.units.append(u)
            return u
        u = self.units[self._pos]
        self._pos += 1
        if (u.cin, u.cout, u.k, u.stride) != (cin, cout, k, stride):
            raise RuntimeError('reference units out of order')
        return u

    def conv(self, x, cout: int, k: int, stride: int = 1, train=False,
             residual=False):
        """``residual``: the unit ends a residual branch (its output is
        added to the branch's input)."""
        u = self._next(x.shape[1], cout, k, stride, residual=residual)
        if self._building:
            return _Shape(x.shape[0], cout, math.ceil(x.shape[2] / stride),
                          math.ceil(x.shape[3] / stride))
        if self.checkpoint and train and torch.is_grad_enabled():
            return checkpoint(self._conv, u, x, stride, train,
                              use_reentrant=False)
        return self._conv(u, x, stride, train)

    def _conv(self, u: Unit, x, stride, train):
        k = u.k
        if stride == 2:
            x = F.pad(x, (1, 0, 1, 0))
        else:
            p = k // 2
            x = F.pad(x, (p, p, p, p))
        w = u.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        y = F.conv2d(x, w, stride=stride)
        if train or self._calibrating:
            mean = y.mean((0, 2, 3))
            var = torch.clamp_min(y.square().mean((0, 2, 3)) - mean.square(),
                                  0.0)
            if self._calibrating:
                u.mean = torch.zeros_like(mean)
                u.var = (var + mean.square()).detach()
                mean, var = u.mean, u.var
            else:
                # a checkpointed unit's recompute stores the same moments
                u.moments = (mean.detach(), var.detach())
        else:
            mean, var = u.mean, u.var
        mul = torch.rsqrt(var + BN_EPS) * u.gamma
        y = (y - mean[:, None, None]) * mul[:, None, None] \
            + u.beta[:, None, None]
        return leaky(y)

    def predict(self, x, cout: int):
        u = self._next(x.shape[1], cout, 1, 1, predict=True)
        if self._building:
            return _Shape(x.shape[0], x.shape[2], x.shape[3], cout)
        w = u.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        y = F.conv2d(x, w, u.bias)
        return y.permute(0, 2, 3, 1)

    # --- running it -----------------------------------------------------
    def forward(self, images: torch.Tensor, train: bool = False):
        """``images`` ``[B, H, W, 3]`` float in [0, 1] -> the three head
        maps ``[B, h, w, A + C + 5]``, coarse (stride 32) first."""
        self._pos = 0
        out = ARCHS[self.arch](self, images.permute(0, 3, 1, 2), train)
        if self._pos != len(self.units):
            raise RuntimeError('reference forward left units unused')
        return out

    __call__ = forward

    @torch.no_grad()
    def calibrate(self, images: torch.Tensor) -> None:
        """Set every BatchNorm's running statistics from its input over
        ``images``, layer after layer: the mean to 0 and the variance to
        the input's second moment, so each layer scales its channels to
        unit size without centring them (centring makes a deep random
        network amplify rounding: ``PERF.md``).  The harness then gives
        each layer a nonzero mean folded into its bias, which leaves
        this function as it is (``harness/weights.py``)."""
        self._calibrating = True
        try:
            self.forward(images)
        finally:
            self._calibrating = False

    def trainables(self) -> List[torch.Tensor]:
        return [t for u in self.units for t in u.trainables()]

    def running(self) -> List[torch.Tensor]:
        """Every BatchNorm's running mean and variance, in unit order."""
        return [t for u in self.units if not u.predict
                for t in (u.mean, u.var)]

    @torch.no_grad()
    def update_running(self, momentum: float) -> None:
        """``running = momentum * running + (1 - momentum) * batch``
        for every BatchNorm, from the last train-mode forward's
        moments."""
        for u in self.units:
            if u.predict:
                continue
            mean, var = u.moments
            u.mean = momentum * u.mean + (1 - momentum) * mean
            u.var = momentum * u.var + (1 - momentum) * var
            u.moments = None


def upsample2x(x):
    if _built(x):
        return _Shape(*x.shape[:2], 2 * x.shape[2], 2 * x.shape[3])
    return F.interpolate(x, scale_factor=2, mode='nearest')


def cat(xs):
    if _built(xs[0]):
        return _Shape(xs[0].shape[0], sum(x.shape[1] for x in xs),
                      *xs[0].shape[2:])
    return torch.cat(xs, dim=1)


STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


def darknet53(net: Net, x, train):
    x = net.conv(x, 32, 3, train=train)
    taps = []
    for filters, blocks in STAGES:
        x = net.conv(x, filters, 3, 2, train=train)
        for _ in range(blocks):
            y = net.conv(x, filters // 2, 1, train=train)
            x = x + net.conv(y, filters, 3, train=train, residual=True)
        taps.append(x)
    return taps[2:]


def multigrid(net: Net, x, train):
    c3, c4, c5 = darknet53(net, x, train)
    a, c = net.num_anchors, net.num_classes
    base = a[0] + c + 5
    outs = []
    feats = c5
    for level, (width, tap) in enumerate(((256, None), (128, c4),
                                          (64, c3))):
        if tap is not None:
            feats = cat([upsample2x(net.conv(feats, width, 1, train=train)),
                         tap])
        feats = net.conv(feats, width, 1, train=train)
        feats = net.conv(feats, 2 * width, 3, train=train)
        feats = net.conv(feats, width, 1, train=train)
        y = net.conv(feats, (8 >> level) * base, 3, train=train)
        outs.append(net.predict(y, a[level] + c + 5))
    return outs


ARCHS = {'darknet': multigrid}
BACKBONE_CONVS = {'darknet': 52}
