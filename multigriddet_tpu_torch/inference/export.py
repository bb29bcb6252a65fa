"""Serving export: the fused inference step as a self-contained artifact.

Counterpart of ``multigriddet_tpu/inference/export.py``.  Each batch size
gets one ``torch.export`` program of the whole fused step (u8 pixels /
255 -> forward -> decode -> NMS), its weights inside, saved with
``torch.export.save``; ``metadata.json`` holds the input spec, the class
names and the decode / NMS settings.  Serving needs torch and numpy only:
no model registry, config or weights file.

Layout of an exported directory::

    serving/
      program_b{N}.pt2   one program per batch size
      metadata.json      input spec, classes, decode/NMS params

The NMS is the portable ``xla`` backend (the cluster-NMS iteration, one
``while_loop`` in the program); ``nms_backend: pallas*`` is rejected, as
in JAX: the CUDA kernels are not part of an exported program.  Programs
traced on one device serve on another (``ServingModel`` moves them), but
an artifact is loaded by the torch version that wrote it:
``torch.export``'s format does not cross versions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..training.steps import make_infer_fn

_META = 'metadata.json'
FORMAT = 'multigriddet_tpu_torch.serving/1'


class _Serve(nn.Module):
    """The infer chain as a module, so that ``torch.export`` lifts the
    model's parameters and buffers into the program's state."""

    def __init__(self, model: nn.Module, anchors, input_hw, kwargs):
        super().__init__()
        self.model = model
        self.fn = make_infer_fn(model, anchors, input_hw, **kwargs)

    def forward(self, images_u8: torch.Tensor):
        return tuple(self.fn(images_u8))


def export_serving(model: nn.Module, anchors: Sequence[np.ndarray],
                   input_hw: Tuple[int, int], out_dir: str,
                   batch_sizes: Sequence[int] = (1,),
                   class_names: Optional[List[str]] = None,
                   device=None, **infer_kwargs) -> Dict[str, Any]:
    """Export the fused infer step for serving.

    Args:
      model: the detector, its weights folded into the programs; its
        parameters must lie on ``device`` (``cuda`` unless ``'cpu'`` is
        passed).  It is traced in eval mode and left as it was.
      anchors: per-scale anchor arrays.
      input_hw: model canvas (H, W).
      out_dir: artifact directory (created).
      batch_sizes: one program per batch size (static shapes; the loader
        picks the smallest program that fits and pads).
      class_names: stored in the metadata for the serving side.
      **infer_kwargs: ``make_infer_step`` knobs (confidence, nms_method,
        pre_nms_top_k, use_wbf, ...); ``nms_backend='pallas*'`` is
        rejected.

    Returns the metadata dict.
    """
    if str(infer_kwargs.get('nms_backend', 'xla')).startswith('pallas'):
        raise ValueError('serving export requires the portable xla NMS '
                         'backend (the pallas* backends launch CUDA kernels '
                         'that an exported program does not carry)')
    dev = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != dev.type:
        raise ValueError(f'the model lies on {on}; move it to {dev} to '
                         f'export there')
    os.makedirs(out_dir, exist_ok=True)
    serve = _Serve(model, anchors, input_hw, infer_kwargs)
    was_training = model.training
    model.eval()
    programs = {}
    try:
        for b in sorted(set(int(b) for b in batch_sizes)):
            images = torch.zeros((b, *input_hw, 3), dtype=torch.uint8,
                                 device=on)
            with torch.no_grad():
                ep = torch.export.export(serve, (images,))
            name = f'program_b{b}.pt2'
            torch.export.save(ep, os.path.join(out_dir, name))
            programs[str(b)] = name
    finally:
        model.train(was_training)
    meta = {
        'format': FORMAT,
        'input_hw': list(input_hw),
        'input_dtype': 'uint8',
        'layout': 'NHWC, full canvas; letterbox on host',
        'platforms': [dev.type],
        'programs': programs,
        'class_names': list(class_names or []),
        'outputs': (['candidate_boxes_xywh_canvas', 'candidate_classes',
                     'candidate_scores', 'candidate_valid']
                    if infer_kwargs.get('use_wbf') else
                    ['boxes_xywh_canvas', 'classes', 'scores', 'valid']),
        'params': {k: (list(v) if isinstance(v, (tuple, list)) else v)
                   for k, v in infer_kwargs.items()},
    }
    with open(os.path.join(out_dir, _META), 'w') as f:
        json.dump(meta, f, indent=1)
    return meta


class ServingModel:
    """Loads an exported artifact and serves batches on ``device``
    (``cuda`` unless ``'cpu'`` is passed).

    ``ServingModel(path)(images_u8)`` -> numpy ``(boxes, classes, scores,
    valid)`` for ``[B, H, W, 3]`` or one ``[H, W, 3]`` uint8 canvas.
    Batches smaller than a program are padded up to the smallest program
    that fits; larger ones are chunked by the largest program.
    """

    def __init__(self, path: str, device=None):
        from torch.export.passes import move_to_device_pass
        with open(os.path.join(path, _META)) as f:
            self.meta = json.load(f)
        if self.meta.get('format') != FORMAT:
            raise ValueError(f'{path}: not a {FORMAT} artifact '
                             f'({self.meta.get("format")!r})')
        self.device = resolve_device(device)
        self.input_hw = tuple(self.meta['input_hw'])
        self.class_names = self.meta['class_names']
        self._fns = {}
        traced_on = self.meta['platforms'][0]
        for b, name in sorted(self.meta['programs'].items(),
                              key=lambda kv: int(kv[0])):
            ep = torch.export.load(os.path.join(path, name))
            if traced_on != self.device.type:
                ep = move_to_device_pass(ep, str(self.device))
            self._fns[int(b)] = ep.module()
        if not self._fns:
            raise ValueError(f'no programs in {path}')
        self.batch_sizes = sorted(self._fns)

    def _run(self, images: np.ndarray):
        n = images.shape[0]
        fit = [b for b in self.batch_sizes if b >= n]
        if fit:  # pad up to the smallest program that fits
            b = fit[0]
            if n < b:
                pad = np.zeros((b - n, *images.shape[1:]), images.dtype)
                images = np.concatenate([images, pad], axis=0)
            x = torch.from_numpy(np.ascontiguousarray(images)).to(
                self.device)
            with torch.inference_mode():
                outs = self._fns[b](x)
            return tuple(o.cpu().numpy()[:n] for o in outs)
        # chunk by the largest program
        b = self.batch_sizes[-1]
        chunks = [self._run(images[i:i + b]) for i in range(0, n, b)]
        return tuple(np.concatenate(parts, axis=0)
                     for parts in zip(*chunks))

    def __call__(self, images) -> Tuple[np.ndarray, ...]:
        images = np.asarray(images, np.uint8)
        if images.ndim == 3:
            images = images[None]
        expect = (*self.input_hw, 3)
        if images.shape[1:] != expect:
            raise ValueError(
                f'expected [B, {expect[0]}, {expect[1]}, 3] uint8 canvas, '
                f'got {images.shape} (letterbox on host first)')
        return self._run(images)
