"""Detector assembly, presets and custom composition (PyTorch).

Counterpart of ``multigriddet_tpu/models/detector.py``: backbone ->
(C3, C4, C5) [-> neck] -> head -> (y1, y2, y3).  The forward takes NHWC
images, as the flax model does, permutes them once to NCHW and returns raw
per-scale logits ``[B, gh, gw, A_l + C + 5]`` in float32.

Activation checkpointing (``remat``, JAX ``detector.py:66-90``) covers the
backbone, through non-reentrant ``torch.utils.checkpoint``:

* ``True`` or ``'conv'`` (selective): each conv's output is kept and its
  BatchNorm and activation are recomputed in the backward, one conv at a
  time (``layers.norm_act``).  JAX names only ``ConvBN``'s outputs and so
  recomputes ResNet's and the separable convs too; the values are the
  same, the port keeps those conv outputs as well;
* ``'full'``: nothing inside the backbone is kept; its whole forward runs
  again in the backward.

Recomputes run under ``layers.no_stat_updates``, so train-mode BatchNorm
moves its running statistics once a step, in the first forward, and under
the spatial partition of the forward they repeat (``parallel/spatial.py``):
a recompute repeats its row exchanges and BatchNorm all-reduces, every
rank in the same order.  As in
JAX only the presets built by ``_build`` read ``remat``: the PANet preset
and ``build_custom`` ignore it.
"""

from __future__ import annotations

import inspect
from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .darknet import CSPDarknet53, Darknet53, MobileDarknet
from .head import MultiGridHead, PANetHead
from .layers import BN_MOMENTUM, ConvBN, recompute_contexts, selective_remat
from .registry import get_backbone, get_head, get_neck, register_model
from .resnet import ResNet50


def remat_mode(remat: Union[bool, str, None]) -> Optional[str]:
    """``environment.remat`` as the JAX builder reads it: falsy -> off,
    ``'full'`` -> ``'full'``, any other truthy value -> ``'conv'``."""
    if not remat:
        return None
    return 'full' if remat == 'full' else 'conv'


class MultiGridDet(nn.Module):
    """backbone -> taps [-> neck] -> head.  ``neck`` is the composable
    path's slot (``build_custom``); presets leave it ``None``.  ``remat``
    is ``None``, ``'conv'`` or ``'full'`` (see the module docstring)."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 remat: Union[bool, str, None] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.remat = remat_mode(remat)

    def forward(self, images: torch.Tensor, train: Optional[bool] = None,
                backbone_train: Optional[bool] = None):
        """``images``: ``[B, H, W, 3]`` float, NHWC as in the JAX model.

        ``train`` selects BatchNorm's mode (default: the module's
        ``training`` flag); ``backbone_train`` overrides it for the
        backbone alone, as the freeze-level-1 stage runs the frozen
        backbone's BatchNorm in inference mode (JAX ``detector.py:40-52``).
        """
        bt = train if backbone_train is None else backbone_train
        x = images.permute(0, 3, 1, 2)
        if self.remat == 'full' and torch.is_grad_enabled():
            taps = checkpoint(self.backbone, x, bt, use_reentrant=False,
                              context_fn=recompute_contexts)
        elif self.remat == 'conv':
            with selective_remat():
                taps = self.backbone(x, bt)
        else:
            taps = self.backbone(x, bt)
        if self.neck is not None:
            taps = self.neck(taps, train)
        return self.head(taps, train)


class TinyBackbone(nn.Module):
    """Minimal 5-stride backbone for smoke tests and CI."""

    out_channels: Tuple[int, int, int] = (32, 48, 64)

    def __init__(self, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        cin = 3
        for i, ch in enumerate((16, 24, *self.out_channels)):
            self.add_module(f'ConvBN_{i}', ConvBN(
                cin, ch, 3, strides=2, dtype=dtype, bn_momentum=bn_momentum))
            cin = ch

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        taps = []
        for i in range(5):
            x = getattr(self, f'ConvBN_{i}')(x, train)
            if i >= 2:
                taps.append(x)
        return tuple(taps)


def _head_channels(widths: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Head working widths: half of each tap's width, coarse -> fine (for
    Darknet's (256, 512, 1024): (512, 256, 128))."""
    c3, c4, c5 = widths
    return c5 // 2, c4 // 2, c3 // 2


def _build(backbone_cls, num_anchors=(3, 3, 3), num_classes: int = 80,
           use_spp: bool = False, lite: bool = False,
           dtype: torch.dtype = torch.float32,
           bn_momentum: float = BN_MOMENTUM, remat=False) -> MultiGridDet:
    """A preset: ``backbone_cls`` + ``MultiGridHead``.  ``bn_momentum``
    reaches only backbones that take it (ResNet keeps its 0.9)."""
    bkw = dict(dtype=dtype)
    if 'bn_momentum' in inspect.signature(backbone_cls).parameters:
        bkw['bn_momentum'] = bn_momentum
    backbone = backbone_cls(**bkw)
    head = MultiGridHead(backbone.out_channels, tuple(num_anchors),
                         num_classes, _head_channels(backbone.out_channels),
                         dtype, bn_momentum, use_spp=use_spp, lite=lite)
    return MultiGridDet(backbone, head, remat=remat)


@register_model('multigriddet_darknet')
def multigriddet_darknet(**kwargs) -> MultiGridDet:
    return _build(Darknet53, **kwargs)


@register_model('multigriddet_darknet_spp')
def multigriddet_darknet_spp(**kwargs) -> MultiGridDet:
    return _build(Darknet53, use_spp=True, **kwargs)


@register_model('multigriddet_darknet_lite')
def multigriddet_darknet_lite(**kwargs) -> MultiGridDet:
    return _build(Darknet53, lite=True, **kwargs)


@register_model('multigriddet_csp_darknet')
def multigriddet_csp_darknet(**kwargs) -> MultiGridDet:
    return _build(CSPDarknet53, **kwargs)


@register_model('multigriddet_darknet_panet')
def multigriddet_darknet_panet(num_anchors=(3, 3, 3), num_classes: int = 80,
                               dtype: torch.dtype = torch.float32,
                               bn_momentum: float = BN_MOMENTUM,
                               **kwargs) -> MultiGridDet:
    """CSPDarknet53 + PANet head.  Like the JAX factory it takes no
    ``remat``: the keyword is swallowed."""
    backbone = CSPDarknet53(dtype=dtype, bn_momentum=bn_momentum)
    head = PANetHead(backbone.out_channels, tuple(num_anchors), num_classes,
                     _head_channels(backbone.out_channels), dtype,
                     bn_momentum)
    return MultiGridDet(backbone, head)


@register_model('multigriddet_resnet')
def multigriddet_resnet(**kwargs) -> MultiGridDet:
    return _build(ResNet50, **kwargs)


@register_model('multigriddet_mobile')
def multigriddet_mobile(**kwargs) -> MultiGridDet:
    """Depthwise-separable backbone + lite head: the edge preset."""
    return _build(MobileDarknet, lite=True, **kwargs)


@register_model('multigriddet_tiny')
def multigriddet_tiny(**kwargs) -> MultiGridDet:
    return _build(TinyBackbone, **kwargs)


def build_custom(backbone_name: str, head_name: str = 'multigrid',
                 neck_name: Optional[str] = None, num_anchors=(3, 3, 3),
                 num_classes: int = 80, dtype: torch.dtype = torch.float32,
                 neck_kwargs=None, **head_kwargs) -> MultiGridDet:
    """Compose a detector from registered parts (``model.type: custom``),
    in eval mode.  An optional neck pre-fuses the taps; the head's widths
    then come from the neck's ``out_channels`` (its -1 slot is the
    backbone's C5 width) instead of the backbone's.  Backbone and neck get
    no ``bn_momentum`` (their default 0.99), and ``remat`` is not read, as
    in the JAX ``build_custom``."""
    backbone = get_backbone(backbone_name)(dtype=dtype)
    head_cls = get_head(head_name)
    widths = backbone.out_channels
    neck = None
    if neck_name and neck_name != 'none':
        neck = get_neck(neck_name)(widths, dtype=dtype,
                                   **(neck_kwargs or {}))
        fine, mid, coarse = neck.out_channels
        if coarse < 0:          # pass-through slot: the backbone's C5
            coarse = widths[2]
        widths = (fine, mid, coarse)
    head = head_cls(widths, num_anchors=tuple(num_anchors),
                    num_classes=num_classes,
                    channels=_head_channels(widths), dtype=dtype,
                    **head_kwargs)
    return MultiGridDet(backbone, head, neck=neck).eval()
