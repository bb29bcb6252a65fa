"""Train, eval and inference steps.

Counterpart of ``multigriddet_tpu/training/steps.py``.  Each step is a plain
closure; PyTorch runs it eagerly on the device that holds the model and the
batch.  The forward runs in the model's compute dtype; the loss, decode and
NMS run in float32.

* :func:`make_train_step`: ``step(state, images, y_true) -> (state,
  metrics)`` runs the train-mode forward, MultiGridLoss, the backward, the
  optimizer update and the EMA update, in place on ``state``.  Metrics stay
  on the device (the trainer fetches them once per epoch).
* :func:`make_fused_train_step`: the same from the generator's raw u8
  link-format batch (device stage, then the train step) in one call.
* :func:`make_eval_step`: inference-mode forward + loss metrics.
* :func:`make_infer_step`: the fused forward + decode + NMS of serving.

Under data parallel (``parallel.distributed``) the train and eval steps
return metrics summed over the ranks: the global loss terms.

Every step takes an optional ``mesh`` (``parallel/mesh.py``).  Under a 2-D
mesh that bands the rows (``sp > 1``) a step takes this rank's images at
the whole canvas (what every rank of its space group holds) and the whole
``y_true``, keeps its band of rows (JAX places images ``P('batch',
'space')`` and ``y_true`` ``P('batch')``), and runs the forward, the loss
and the backward under a ``parallel.spatial`` partition.  The infer step
then gathers the three head maps over the space group and decodes and
runs NMS on every rank (JAX ``make_infer_step(mesh=...)``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import to_device
from ..losses import LossConfig, multigrid_loss
from ..ops.decode import decode_for_nms
from ..ops.nms import NEG_INF, batched_nms, gather_rows, top_k
from ..ops.yuv import yuv420_to_rgb
from ..parallel import spatial
from ..parallel.distributed import all_sum_metrics
from ..parallel.mesh import spatial_space
from ..utils.profiling import span


class _OnDevice:
    """Anchors and class weights as tensors, copied once per device."""

    def __init__(self, anchors, class_weights):
        self.anchors = [np.asarray(a, np.float32) for a in anchors]
        self.class_weights = (None if class_weights is None else
                              np.asarray(class_weights, np.float32))
        self._cache: Dict = {}

    def __call__(self, device):
        if device not in self._cache:
            cw = self.class_weights
            self._cache[device] = (
                [to_device(a, device) for a in self.anchors],
                None if cw is None else to_device(cw, device))
        return self._cache[device]


def train_forward(model, images: torch.Tensor, freeze_level: int = 0):
    """The train-mode forward of a freeze level: 0 trains every BatchNorm;
    1 runs the frozen backbone's BatchNorm in inference mode (running
    statistics used and kept); 2 runs the whole model in inference mode
    (only the predict convs train)."""
    if freeze_level >= 2:
        return model(images, train=False)
    if freeze_level == 1:
        return model(images, train=True, backbone_train=False)
    return model(images, train=True)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model, decay: float):
    """``e = e * d + p * (1 - d)`` for every parameter, with ``d`` and
    ``1 - d`` taken in float32 as the JAX step takes them."""
    d = np.float32(decay)
    names = list(ema)
    params = dict(model.named_parameters())
    e = [ema[k] for k in names]
    p = [params[k].detach() for k in names]
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, torch._foreach_mul(p, float(np.float32(1) - d)))


def _build_train_core(anchors, num_classes, loss_cfg=LossConfig(),
                      class_weights=None, strides=(32, 16, 8),
                      freeze_level=0, ema_decay=None, mesh=None):
    """(state, images, y_true) -> (state, metrics), shared by
    :func:`make_train_step` and :func:`make_fused_train_step`."""
    consts = _OnDevice(anchors, class_weights)
    space = spatial_space(mesh)

    def step(state, images: torch.Tensor, y_true):
        model, opt = state.model, state.optimizer
        anc, cw = consts(images.device)
        with spatial.partitioned(space, images.shape[1]):
            with span('train.forward'):
                outs = train_forward(model, spatial.band_of(images, space),
                                     freeze_level)
            with span('train.loss'):
                total, metrics = multigrid_loss(
                    outs, list(y_true), anc, num_classes,
                    tuple(images.shape[1:3]), loss_cfg, cw, strides=strides)
            with span('train.backward'):
                opt.zero_grad()
                total.backward()
        with span('train.update'):
            opt.step()
            if ema_decay is not None and state.ema_params is not None:
                ema_update(state.ema_params, model, ema_decay)
            state.step += 1
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics['loss'] = total.detach()
            return state, all_sum_metrics(metrics)

    return step


def make_train_step(anchors: Sequence[np.ndarray], num_classes: int,
                    input_hw: Tuple[int, int],
                    loss_cfg: LossConfig = LossConfig(),
                    class_weights=None,
                    strides: Tuple[int, ...] = (32, 16, 8),
                    freeze_level: int = 0,
                    ema_decay: Optional[float] = None,
                    mesh=None) -> Callable:
    """``step(state, images [B, H, W, 3] f32 in [0, 1], y_true) -> (state,
    metrics)``: one update of ``state.model`` through ``state.optimizer``
    (whose parameters must follow the freeze level, see
    ``state.apply_freeze``), in place.  With ``ema_decay`` and
    ``state.ema_params``, the EMA moves after the update.  Under gradient
    accumulation the optimizer applies one update per k calls, while the
    BatchNorm statistics and the EMA move on every call, as under
    ``optax.MultiSteps``.  ``input_hw`` is the nominal canvas; the loss
    reads the canvas from the images (multi-scale).  ``mesh``: see the
    module docstring."""
    del input_hw
    return _build_train_core(anchors, num_classes, loss_cfg, class_weights,
                             strides, freeze_level, ema_decay, mesh)


def make_fused_train_step(anchors: Sequence[np.ndarray], num_classes: int,
                          loss_cfg: LossConfig = LossConfig(),
                          aug_cfg: Optional[dict] = None,
                          class_weights=None,
                          strides: Tuple[int, ...] = (32, 16, 8),
                          freeze_level: int = 0,
                          ema_decay: Optional[float] = None,
                          multi_anchor_assign: bool = False,
                          train_aug: bool = True, mesh=None):
    """The input stage and the train step in one call.

    Returns ``(host_step, bank_step)``: ``host_step(state, parts, boxes,
    generator)`` takes the generator's link-format pixels (a u8 rgb batch,
    a 1-tuple of one, or the yuv420 3-tuple) and ``[B, N, 5]`` boxes, runs
    the device stage (u8 -> f32, the augmentation chain of ``aug_cfg``
    drawn from ``generator`` when ``train_aug``, /255, 9-cell encoding),
    then the train step.  ``bank_step(state, banks, idx, boxes,
    generator)`` does the same from the rows ``idx`` of the device image
    bank (``banks``: the per-part bank tuple), gathered on the device.

    Under a 2-D ``mesh`` the ranks of a space group run the device stage
    alike (the same images and the same ``generator`` draws), and the
    train step keeps each rank's band of the stage's pixels and the whole
    ``y_true``.
    """
    from ..data.pipeline import _device_stage, _device_stage_bank
    anchors = [np.asarray(a, np.float32) for a in anchors]
    core = _build_train_core(anchors, num_classes, loss_cfg, class_weights,
                             strides, freeze_level, ema_decay, mesh)

    def host_step(state, parts, boxes, generator=None):
        if not isinstance(parts, (tuple, list)):
            parts = (parts,)
        hw = tuple(int(s) for s in parts[0].shape[1:3])
        with span('train.stage'):
            images, y_true, _ = _device_stage(
                parts, boxes, generator, aug_cfg, anchors, num_classes, hw,
                train_aug, multi_anchor_assign)
        return core(state, images, y_true)

    def bank_step(state, banks, idx, boxes, generator=None):
        if not isinstance(banks, (tuple, list)):
            banks = (banks,)
        hw = tuple(int(s) for s in banks[0].shape[1:3])
        with span('train.stage'):
            images, y_true, _ = _device_stage_bank(
                banks, idx, boxes, generator, aug_cfg, anchors, num_classes,
                hw, train_aug, multi_anchor_assign)
        return core(state, images, y_true)

    return host_step, bank_step


def make_eval_step(anchors: Sequence[np.ndarray], num_classes: int,
                   input_hw: Tuple[int, int],
                   loss_cfg: LossConfig = LossConfig(),
                   class_weights=None,
                   strides: Tuple[int, ...] = (32, 16, 8),
                   mesh=None) -> Callable:
    """``step(state, images, y_true) -> metrics``: the inference-mode
    forward (running BatchNorm statistics) and the loss metrics."""
    consts = _OnDevice(anchors, class_weights)
    space = spatial_space(mesh)

    @torch.no_grad()
    def step(state, images: torch.Tensor, y_true):
        anc, cw = consts(images.device)
        with spatial.partitioned(space, images.shape[1]):
            outs = state.model(spatial.band_of(images, space), train=False)
            total, metrics = multigrid_loss(
                outs, list(y_true), anc, num_classes, input_hw, loss_cfg,
                cw, strides=strides)
        metrics = dict(metrics)
        metrics['loss'] = total
        return all_sum_metrics(metrics)

    return step


def head_maps(model, images: torch.Tensor, space=None):
    """The model's three head maps of ``images``; with a ``space`` group
    (``parallel/spatial.py``), the forward runs on this rank's band and
    the whole maps are gathered on every rank of the group."""
    if space is None:
        return model(images)
    with spatial.partitioned(space, images.shape[1]):
        outs = model(spatial.band_of(images, space))
        return [spatial.gather_level(y, spatial.rows_of(y, 1))
                for y in outs]


def candidate_pool(model, images: torch.Tensor, anchors: Sequence,
                   input_hw: Tuple[int, int], space=None):
    """Forward + compact decode of float images ``[B, H, W, 3]`` in [0, 1]
    (``space``: :func:`head_maps`).

    Returns the NMS pool ``(boxes [B, N, 4] top-left canvas pixels,
    scores [B, N], classes [B, N] int32)``, one candidate per grid cell.
    """
    outs = head_maps(model, images, space)
    boxes, scores, classes = decode_for_nms(outs, anchors, input_hw)
    scale = torch.tensor([input_hw[1], input_hw[0], input_hw[1],
                          input_hw[0]], dtype=torch.float32,
                         device=boxes.device)
    xy, wh = boxes[..., 0:2], boxes[..., 2:4]
    tl = torch.cat([xy - wh / 2.0, wh], dim=-1) * scale
    return tl, scores, classes


def make_infer_fn(model, anchors: Sequence[np.ndarray],
                  input_hw: Tuple[int, int],
                  confidence: float = 0.1,
                  nms_threshold: float = 0.45,
                  nms_method: str = 'diou',
                  use_iol: bool = True,
                  max_boxes: int = 100,
                  pre_nms_top_k: int = 1024,
                  class_aware: bool = False,
                  nms_backend: str = 'xla',
                  use_wbf: bool = False,
                  pack_outputs: bool = False,
                  link_format: str = 'rgb', mesh=None) -> Callable:
    """The chain of :func:`make_infer_step` without its
    ``torch.inference_mode`` wrapper: what ``inference/export.py`` traces
    (under ``torch.no_grad``, the model in eval mode)."""
    anchors = [np.asarray(a, np.float32) for a in anchors]
    space = spatial_space(mesh)
    if link_format not in ('rgb', 'yuv420'):
        raise ValueError(f'unknown link_format {link_format!r}')

    def _forward_chain(images):
        tl, scores, classes = candidate_pool(model, images, anchors,
                                             input_hw, space)
        if use_wbf:
            sc = torch.where(scores >= confidence, scores,
                             torch.tensor(NEG_INF, device=scores.device))
            top_sc, idx = top_k(sc, min(pre_nms_top_k, sc.shape[1]))
            res = (gather_rows(tl, idx), gather_rows(classes, idx), top_sc,
                   top_sc > -1e8)
        else:
            res = batched_nms(
                tl, scores, classes, confidence, nms_threshold,
                max_boxes=max_boxes, pre_nms_top_k=pre_nms_top_k,
                nms_method=nms_method, use_iol=use_iol,
                class_aware=class_aware, backend=nms_backend)
        if pack_outputs:
            b, c, s, v = res
            return torch.cat([b.transpose(-1, -2), c[:, None].float(),
                              s[:, None].float(), v[:, None].float()], dim=1)
        return res

    def step(images):
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        return _forward_chain(images)

    def step_yuv(y, cb, cr):
        return _forward_chain(yuv420_to_rgb(y, cb, cr) / 255.0)

    return step_yuv if link_format == 'yuv420' else step


def make_infer_step(model, anchors: Sequence[np.ndarray],
                    input_hw: Tuple[int, int], **kwargs) -> Callable:
    """Fused forward + decode + NMS, under ``torch.inference_mode``.

    Keywords (:func:`make_infer_fn`): ``confidence`` 0.1,
    ``nms_threshold`` 0.45, ``nms_method`` ``'diou'``, ``use_iol`` True,
    ``max_boxes`` 100, ``pre_nms_top_k`` 1024, ``class_aware`` False,
    ``nms_backend`` ``'xla'``, ``use_wbf``, ``pack_outputs``,
    ``link_format``, ``mesh`` (a 2-D mesh: the forward on the bands, the
    head maps gathered, decode and NMS on every rank; the images are the
    rank's at the whole canvas).

    ``link_format='rgb'`` gives ``step(images)`` for ``[B, H, W, 3]``
    uint8 (divided by 255 on the device) or float images;
    ``'yuv420'`` gives ``step(y, cb, cr)`` for planar 4:2:0 uint8.
    Returns ``(boxes [B, K, 4] top-left canvas pixels, classes [B, K]
    int32, scores [B, K], valid [B, K] bool)``, or with ``use_wbf`` the
    ``pre_nms_top_k`` confidence-filtered candidates in score order, or
    with ``pack_outputs`` one ``[B, 7, K]`` float32 tensor
    ``[x, y, w, h, class, score, valid]``.
    """
    return torch.inference_mode()(
        make_infer_fn(model, anchors, input_hw, **kwargs))


def unpack_detections(packed):
    """Invert ``make_infer_step(pack_outputs=True)`` on the host: returns
    numpy (boxes [..., K, 4] f32, classes i32, scores f32, valid bool)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    return (np.moveaxis(packed[..., 0:4, :], -2, -1),
            packed[..., 4, :].astype(np.int32),
            packed[..., 5, :], packed[..., 6, :] > 0.5)


def fetch_detections(outs):
    """One host fetch of an infer-step result, tuple or packed."""
    with span('infer.fetch'):
        if isinstance(outs, (tuple, list)):
            b, c, s, v = (t.cpu().numpy() for t in outs)
            return (b, c.astype(np.int32, copy=False), s, v.astype(bool))
        return unpack_detections(outs)
