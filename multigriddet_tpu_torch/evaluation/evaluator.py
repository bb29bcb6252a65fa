"""MultiGridEvaluator: batched inference on the card + host mAP.

Counterpart of ``multigriddet_tpu/evaluation/evaluator.py``.  Decode and
NMS run inside the fused step on the device (``make_infer_step``), so the
host only decodes and letterboxes images, maps the at most
``max_detections`` boxes of an image back to its pixels, and computes
mAP.  A producer thread decodes batches (:meth:`_file_batches`) while the
consumer (:meth:`_evaluate_batches`) keeps ``pipeline_depth`` batches in
flight on the device.  Keeps the JAX evaluator's config keys, phase
timing (inference vs metrics seconds, images/s) and output files
(``evaluation_results.json``, ``detections.json``, annotated images).
Runs on ``cuda`` unless ``device='cpu'`` is passed.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import build_model_for_inference, resolve_compute_dtype
from ..data.annotations import (HostImageLoader, load_annotation_lines,
                                pad_batch, parse_annotation_line,
                                pil_available)
from ..device import resolve_device
from ..ops.geometry import canvas_boxes_to_image
from ..training.steps import fetch_detections, make_infer_step
from ..utils.visualization import draw_boxes, get_colors
from .metrics import (COCO_IOU_THRESHOLDS, calculate_map,
                      calculate_map_reference, format_results)


class MultiGridEvaluator:

    def __init__(self, config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        ev = config.get('evaluation', {}) or {}
        self.batch_size = int(ev.get('batch_size', 8))
        self.confidence = float(ev.get('confidence_threshold', 0.1))
        self.nms_threshold = float(ev.get('nms_threshold', 0.45))
        self.nms_method = ev.get('nms_method', 'diou')
        self.use_iol = bool(ev.get('use_iol', True))
        self.iou_thresholds = tuple(
            ev.get('iou_thresholds', COCO_IOU_THRESHOLDS))
        self.interp = ev.get('interpolation_method', 'coco')
        # 'native' = standard all-point COCO AP; 'reference' = the
        # reference's own computation (trapz AP, pred-only classes in the
        # mean; docs/PARITY.md #8-10)
        self.metrics_mode = ev.get('metrics_mode', 'native')
        self.max_images = ev.get('max_images')
        # per-image detection capacity (the reference decodes 500)
        self.max_detections = int(ev.get('max_detections', 500))
        self.use_wbf = bool(ev.get('use_wbf', False))
        self.wbf_mode = str(ev.get('wbf_mode', 'paper'))
        self.optimize_classes = bool(ev.get('optimize_classes', True))
        self.results_dir = ev.get('results_dir', 'results/evaluation')
        self.save_results = bool(ev.get('save_results', True))
        self.eval_cfg = ev
        self._load_model()
        self.results: Optional[Dict] = None
        self.timing: Dict[str, float] = {}

    def _load_model(self):
        # bfloat16 compute by default (environment.mixed_precision)
        self.compute_dtype = resolve_compute_dtype(self.config,
                                                   default_mixed=True)
        self.model, self.spec = build_model_for_inference(
            self.config, device=self.device)
        ev = self.eval_cfg
        shape = ev.get('input_shape') or self.spec['input_shape']
        self.input_hw: Tuple[int, int] = tuple(shape[:2])
        self.class_names = self.spec.get('class_names') or [
            str(i) for i in range(self.spec['num_classes'])]
        self._build_step()

    def _build_step(self):
        """The fused step for ``eval_cfg``'s NMS backend and pixel link."""
        ev = self.eval_cfg
        # pixel transport: 'auto' sends planar YCbCr 4:2:0 (half the
        # bytes, ops/yuv.py) on an even canvas; 'rgb' is byte-exact
        lf = str(ev.get('link_format', 'auto'))
        if lf == 'auto':
            even = self.input_hw[0] % 2 == 0 and self.input_hw[1] % 2 == 0
            lf = 'yuv420' if even else 'rgb'
        self.link_format = lf
        self._infer = make_infer_step(
            self.model, self.spec['anchors'], self.input_hw,
            confidence=self.confidence, nms_threshold=self.nms_threshold,
            nms_method=self.nms_method, use_iol=self.use_iol,
            max_boxes=self.max_detections,
            nms_backend=ev.get('nms_backend', 'xla'),
            pre_nms_top_k=int(ev.get('pre_nms_top_k', 1024)),
            use_wbf=self.use_wbf, link_format=self.link_format)

    def _load_annotations(self, path: str):
        lines = load_annotation_lines(path, shuffle=False)
        if self.max_images:
            lines = lines[:int(self.max_images)]
        return lines

    def _annotated_cfg(self) -> Dict:
        return ((self.config.get('visualizations', {}) or {})
                .get('save_annotated_images', {}) or {})

    # ------------------------------------------------------------------

    def evaluate(self, annotation_path: Optional[str] = None) -> Dict:
        data_cfg = self.config.get('data', {}) or {}
        path = annotation_path or data_cfg.get('annotation')
        lines = self._load_annotations(path)
        print(f'Evaluating {len(lines)} images @ {self.input_hw}')
        return self._evaluate_batches(
            _in_thread(self._file_batches(lines), maxsize=2))

    def _file_batches(self, lines: List[str]
                      ) -> Iterator[Tuple[Tuple[np.ndarray, ...], List]]:
        """Decode and letterbox ``lines`` in batches.

        Yields ``(parts, metas)``: ``parts`` the batch's pixels
        (``(images,)`` or ``(y, cb, cr)``, padded to ``batch_size``; numpy
        on the CPU, tensors decoded on the card), ``metas`` one
        ``(image_id, gt x1y1x2y2cls [M, 5], orig_h, orig_w, raw RGB or
        None, failed)`` per image.  The original size comes from the
        loader's metas.  An image that cannot be read is fed as the
        loader's gray canvas and marked failed: its ground truth counts as
        missed and it gets no predictions.  Only annotated images need
        Pillow (to read the original and to save the drawing)."""
        annotated_cfg = self._annotated_cfg()
        save_imgs = bool(annotated_cfg.get('enabled'))
        max_save = int(annotated_cfg.get('max_images', 10) or 0)
        if save_imgs and max_save > 0 and not pil_available():
            raise ImportError(
                'visualizations.save_annotated_images needs Pillow to read '
                'and save the annotated images, and this host has none; '
                'turn it off to evaluate without Pillow (JPEG files decode '
                'on the card without it, ROADMAP item 17)')
        loader = HostImageLoader(
            lines, self.input_hw, max_boxes=1,
            num_workers=int(self.eval_cfg.get('num_workers', 8)),
            link_format=self.link_format, device=self.device)
        try:
            for start in range(0, len(lines), self.batch_size):
                chunk = lines[start:start + self.batch_size]
                images, _, sizes, ok = loader.load_batch(chunk,
                                                         return_metas=True)
                parts = images if isinstance(images, tuple) else (images,)
                parts = tuple(pad_batch(p, self.batch_size) for p in parts)
                metas = []
                for bi, line in enumerate(chunk):
                    img_path, gt_boxes = parse_annotation_line(line)
                    raw = None
                    failed = not ok[bi]
                    if failed:
                        print(f'WARNING: cannot read {img_path}; counting '
                              f'its ground truth as missed')
                        ih, iw = self.input_hw
                    else:
                        iw, ih = int(sizes[bi, 3]), int(sizes[bi, 4])
                        if save_imgs and start + bi < max_save:
                            raw = _read_rgb(img_path)
                    metas.append((start + bi, gt_boxes, ih, iw, raw,
                                  failed))
                yield parts, metas
        finally:
            loader.close()

    def _evaluate_batches(self, items: Iterable) -> Dict:
        """Run the fused step over ``(parts, metas)`` batches (the form
        :meth:`_file_batches` yields), then the metrics phase.  Returns
        the results dict and keeps ``predictions`` and
        ``ground_truths``."""
        predictions: Dict[int, Dict] = {}
        ground_truths: Dict[int, Dict] = {}
        t_infer = 0.0
        n_images = 0
        t0_all = time.time()
        annotated_cfg = self._annotated_cfg()
        max_save = int(annotated_cfg.get('max_images', 10) or 0)
        colors = get_colors(len(self.class_names))
        n_saved = 0
        depth = max(int(self.eval_cfg.get('pipeline_depth', 4)), 0)
        pending: deque = deque()

        def drain_one():
            nonlocal t_infer, n_saved
            outs, metas = pending.popleft()
            t0 = time.time()
            bxs, cls, scs, valid = fetch_detections(outs)
            t_infer += time.time() - t0
            for bi, (img_id, gt_boxes, ih, iw, raw,
                     failed) in enumerate(metas):
                keep = valid[bi] if not failed else np.zeros_like(valid[bi])
                b, c, s = bxs[bi][keep], cls[bi][keep], scs[bi][keep]
                if self.use_wbf:
                    from ..postprocess.wbf import fuse_and_cap
                    b, c, s = fuse_and_cap(
                        b, c, s, iou_thr=self.nms_threshold,
                        mode=self.wbf_mode, max_out=self.max_detections)
                if len(b):
                    b = canvas_boxes_to_image(b, (ih, iw), self.input_hw)
                predictions[img_id] = {
                    'boxes': b.astype(np.float32),
                    'classes': c.astype(np.int32),
                    'scores': s.astype(np.float32)}
                # GT: x1y1x2y2cls -> top-left xywh
                g = gt_boxes
                gt_xywh = (np.stack(
                    [g[:, 0], g[:, 1], g[:, 2] - g[:, 0],
                     g[:, 3] - g[:, 1]], axis=-1)
                    if len(g) else np.zeros((0, 4), np.float32))
                ground_truths[img_id] = {
                    'boxes': gt_xywh.astype(np.float32),
                    'classes': (g[:, 4].astype(np.int32) if len(g)
                                else np.zeros((0,), np.int32))}
                if raw is not None and n_saved < max_save:
                    self._save_annotated(raw, b, c, s, gt_xywh,
                                         ground_truths[img_id]['classes'],
                                         img_id, colors, annotated_cfg)
                    n_saved += 1

        for parts, metas in items:
            n_images += len(metas)
            t0 = time.time()
            outs = self._infer(*(torch.as_tensor(p).to(self.device,
                                                       non_blocking=True)
                                 for p in parts))
            t_infer += time.time() - t0
            pending.append((outs, metas))
            if len(pending) > depth:
                drain_one()
        while pending:
            drain_one()

        self.timing['inference_s'] = t_infer
        self.timing['images_per_sec'] = (n_images / t_infer if t_infer > 0
                                         else 0.0)
        t0 = time.time()
        if self.metrics_mode == 'reference':
            results = calculate_map_reference(
                predictions, ground_truths, self.spec['num_classes'],
                self.iou_thresholds, self.interp, self.optimize_classes,
                self.class_names)
            results['gt_counts'] = np.array(
                [sum(int((g['classes'] == c).sum())
                     for g in ground_truths.values())
                 for c in range(self.spec['num_classes'])])
        else:
            results = calculate_map(
                predictions, ground_truths, self.spec['num_classes'],
                self.iou_thresholds, self.interp, self.optimize_classes,
                self.class_names,
                use_parallel=bool(self.eval_cfg.get('use_parallel', True)))
        self.timing['metrics_s'] = time.time() - t0
        self.timing['total_s'] = time.time() - t0_all
        results['timing'] = dict(self.timing)
        results['num_images'] = n_images
        self.results = results
        self.predictions = predictions
        self.ground_truths = ground_truths
        if self.save_results:
            self._save_results()
        return results

    def _save_annotated(self, raw, boxes, classes, scores, gt_boxes,
                        gt_classes, img_id, colors, cfg):
        from PIL import Image

        out_dir = cfg.get('save_dir',
                          os.path.join(self.results_dir, 'annotated_images'))
        os.makedirs(out_dir, exist_ok=True)
        img = raw
        if cfg.get('draw_predictions', True):
            img = draw_boxes(img, boxes, classes, scores, self.class_names,
                             colors)
        if cfg.get('draw_ground_truth', True) and len(gt_boxes):
            img = draw_boxes(img, gt_boxes, gt_classes,
                             np.ones(len(gt_boxes)), self.class_names,
                             [(255, 255, 255)] * len(self.class_names),
                             show_scores=False)
        ext = cfg.get('image_format', 'jpg')
        Image.fromarray(img).save(
            os.path.join(out_dir, f'eval_{img_id:06d}.{ext}'))

    def _save_results(self):
        os.makedirs(self.results_dir, exist_ok=True)
        out = {k: v for k, v in self.results.items()
               if k not in ('pr_curves', 'gt_counts')}
        out['gt_counts'] = self.results['gt_counts'].tolist()
        path = os.path.join(self.results_dir, 'evaluation_results.json')
        with open(path, 'w') as f:
            json.dump(out, f, indent=2)
        print(f'Saved results to {path}')
        if self.eval_cfg.get('save_detections'):
            # COCO results format: [{image_id, category_id, bbox, score}]
            dets = []
            for img_id, p in self.predictions.items():
                for box, cls, score in zip(p['boxes'], p['classes'],
                                           p['scores']):
                    dets.append({
                        'image_id': int(img_id),
                        'category_id': int(cls),
                        'bbox': [round(float(v), 2) for v in box],
                        'score': round(float(score), 5)})
            dpath = os.path.join(self.results_dir, 'detections.json')
            with open(dpath, 'w') as f:
                json.dump(dets, f)
            print(f'Saved {len(dets)} detections to {dpath}')

    def print_results(self):
        if self.results is None:
            print('No results yet — call evaluate() first.')
            return
        print(format_results(self.results))
        t = self.timing
        print(f"inference: {t.get('inference_s', 0):.1f}s "
              f"({t.get('images_per_sec', 0):.1f} img/s)  "
              f"metrics: {t.get('metrics_s', 0):.1f}s  "
              f"total: {t.get('total_s', 0):.1f}s")


def _in_thread(items: Iterator, maxsize: int) -> Iterator:
    """Run the generator ``items`` in a producer thread and yield what it
    yields, at most ``maxsize`` ahead.  An exception in the producer is
    raised here, so a failed decode never passes for the end of the
    data."""
    q: 'queue.Queue' = queue.Queue(maxsize=maxsize)
    done = object()

    def producer():
        try:
            for item in items:
                q.put(item)
            q.put(done)
        except BaseException as exc:   # handed to the consumer, re-raised
            q.put(exc)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _read_rgb(path: str) -> Optional[np.ndarray]:
    """The original RGB pixels of an image to annotate (Pillow), or None."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            return np.asarray(img.convert('RGB'))
    except (OSError, ValueError):
        return None
