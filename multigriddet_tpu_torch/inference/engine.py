"""MultiGridInference: image and directory inference on the card.

Counterpart of ``multigriddet_tpu/inference/engine.py``.  Forward, decode
and NMS run as one fused step on the device (``make_infer_step``); image
decoding, letterboxing, the letterbox inverse of the (at most
``max_boxes``) detections and drawing stay on the host.  Runs on
``cuda`` unless ``device='cpu'`` is passed.

Not ported yet (each raises ``NotImplementedError`` when a config asks
for it): video and camera input, the native-loader file path with the
yuv420 link format, and host WBF (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import glob
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import build_model_for_inference, resolve_compute_dtype
from ..data.annotations import letterbox_image
from ..device import resolve_device
from ..ops.geometry import canvas_boxes_to_image
from ..training.steps import fetch_detections, make_infer_step
from ..utils.visualization import draw_boxes, get_colors

_IMG_EXTS = ('.jpg', '.jpeg', '.png', '.bmp', '.webp')
_NOT_PORTED = 'not ported yet (ROADMAP Queue 1 item 5)'


class MultiGridInference:

    def __init__(self, config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        det = config.get('detection', {}) or {}
        self.confidence = float(det.get('confidence_threshold', 0.5))
        self.nms_threshold = float(det.get('nms_threshold', 0.45))
        self.nms_method = det.get('nms_method', 'diou')
        self.use_iol = bool(det.get('use_iol', True))
        self.max_boxes = int(det.get('max_boxes', 100))
        self.class_aware = bool(det.get('class_aware_nms', False))
        # xla | pallas (greedy kernel) | pallas_fused (pop-max kernel)
        self.nms_backend = det.get('nms_backend', 'xla')
        self.pre_nms_top_k = int(det.get('pre_nms_top_k', 1024))
        if det.get('use_wbf', False):
            raise NotImplementedError(f'detection.use_wbf: host WBF is '
                                      f'{_NOT_PORTED}')
        link_format = str(det.get('link_format', 'rgb'))
        if link_format != 'rgb':
            raise NotImplementedError(
                f'detection.link_format={link_format!r}: the native '
                f'yuv420 file path is {_NOT_PORTED}')
        self._load_model()

    def _load_model(self):
        self.compute_dtype = resolve_compute_dtype(self.config,
                                                   default_mixed=True)
        self.model, self.spec = build_model_for_inference(
            self.config, device=self.device)
        input_cfg = self.config.get('input', {}) or {}
        shape = input_cfg.get('input_shape') or self.spec['input_shape']
        self.input_hw: Tuple[int, int] = tuple(shape[:2])
        self.class_names = self.spec.get('class_names') or [
            str(i) for i in range(self.spec['num_classes'])]
        self.colors = get_colors(len(self.class_names))
        self._infer = make_infer_step(
            self.model, self.spec['anchors'], self.input_hw,
            confidence=self.confidence, nms_threshold=self.nms_threshold,
            nms_method=self.nms_method, use_iol=self.use_iol,
            max_boxes=self.max_boxes, class_aware=self.class_aware,
            nms_backend=self.nms_backend, pre_nms_top_k=self.pre_nms_top_k)

    # ------------------------------------------------------------------

    def infer_batch(self, batch):
        """Run the fused step on one ``[B, H, W, 3]`` uint8 batch (numpy or
        tensor).  Returns the device tuple ``(boxes, classes, scores,
        valid)`` without waiting for it; boxes are canvas pixels."""
        if isinstance(batch, np.ndarray) and not batch.flags.writeable:
            batch = batch.copy()   # letterboxed PIL arrays are read-only
        x = torch.as_tensor(batch).to(self.device, non_blocking=True)
        return self._infer(x)

    def detect(self, image):
        """Detect on one PIL image.

        Returns (boxes [N, 4] top-left xywh in original pixels,
        classes [N], scores [N]).
        """
        arr, _, _, _ = letterbox_image(image.convert('RGB'), self.input_hw)
        outs = self.infer_batch(arr[None])
        bxs, cls, scs, valid = (a[0] for a in fetch_detections(outs))
        bxs, cls, scs = bxs[valid], cls[valid], scs[valid]
        if len(bxs):
            bxs = canvas_boxes_to_image(bxs, (image.size[1], image.size[0]),
                                        self.input_hw)
        return bxs, cls, scs

    def detect_batch(self, images: List, batch_size: int = 16,
                     pipeline_depth: int = 4):
        """Batched detection, padded to ``batch_size`` per chunk.

        Device work is asynchronous: a chunk's results are fetched only
        after ``pipeline_depth`` further chunks were issued, so host
        letterboxing overlaps device compute.  Returns a list of
        (boxes, classes, scores) in each image's original pixels.
        """
        def preprocess(chunk):
            batch = np.zeros((batch_size, *self.input_hw, 3), np.uint8)
            sizes = []
            for i, img in enumerate(chunk):
                arr, _, _, _ = letterbox_image(img.convert('RGB'),
                                               self.input_hw)
                batch[i] = arr
                sizes.append((img.size[1], img.size[0]))
            return batch, sizes

        results: list = []
        pending: deque = deque()
        for start in range(0, len(images), batch_size):
            batch, sizes = preprocess(images[start:start + batch_size])
            pending.append((self.infer_batch(batch), sizes))
            if len(pending) > max(pipeline_depth, 0):
                self._postprocess_batch(*pending.popleft(), results)
        while pending:
            self._postprocess_batch(*pending.popleft(), results)
        return results

    def _postprocess_batch(self, outs, sizes, results):
        """Fetch one issued chunk and map it to original pixels.

        ``sizes`` rows are (orig_h, orig_w), or None for a slot whose input
        failed to load (an empty result)."""
        bxs, cls, scs, valid = fetch_detections(outs)
        empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
                 np.zeros((0,), np.float32))
        for i, size in enumerate(sizes):
            if size is None:
                results.append(empty)
                continue
            keep = valid[i]
            b, c, s = bxs[i][keep], cls[i][keep], scs[i][keep]
            if len(b):
                b = canvas_boxes_to_image(b, size, self.input_hw)
            results.append((b, c, s))

    def predict_image(self, path: str, output_dir: Optional[str] = None,
                      show: bool = False):
        from PIL import Image

        image = Image.open(path)
        t0 = time.time()
        boxes, classes, scores = self.detect(image)
        dt = time.time() - t0
        print(f'{os.path.basename(path)}: {len(boxes)} objects '
              f'in {dt*1000:.1f} ms')
        annotated = draw_boxes(np.asarray(image.convert('RGB')), boxes,
                               classes, scores, self.class_names,
                               self.colors)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            out_path = os.path.join(output_dir, os.path.basename(path))
            Image.fromarray(annotated).save(out_path)
            print(f'Saved to {out_path}')
        if show:
            try:
                Image.fromarray(annotated).show()
            except OSError as exc:  # headless host: warn, don't fail
                print(f'WARNING: could not display image: {exc}')
        return annotated, (boxes, classes, scores)

    def predict_directory(self, directory: str,
                          output_dir: Optional[str] = None,
                          batch_size: int = 16):
        """Annotate every image in a directory through :meth:`detect_batch`;
        unreadable files give empty detections with a warning."""
        from PIL import Image

        paths = sorted(
            p for p in glob.glob(os.path.join(directory, '*'))
            if p.lower().endswith(_IMG_EXTS))
        rgbs: List[Optional[np.ndarray]] = []
        for p in paths:
            try:
                with Image.open(p) as im:
                    rgbs.append(np.asarray(im.convert('RGB')))
            except OSError as exc:
                print(f'WARNING: could not read {p}: {exc}')
                rgbs.append(None)
        good = [i for i, a in enumerate(rgbs) if a is not None]
        t0 = time.time()
        found = self.detect_batch([Image.fromarray(rgbs[i]) for i in good],
                                  batch_size=batch_size)
        dt = time.time() - t0
        detections = [(np.zeros((0, 4), np.float32),
                       np.zeros((0,), np.int32),
                       np.zeros((0,), np.float32))] * len(paths)
        for i, r in zip(good, found):
            detections[i] = r
        results = []
        for p, rgb, (boxes, classes, scores) in zip(paths, rgbs, detections):
            print(f'{os.path.basename(p)}: {len(boxes)} objects')
            if rgb is None:
                results.append((None, (boxes, classes, scores)))
                continue
            annotated = draw_boxes(rgb, boxes, classes, scores,
                                   self.class_names, self.colors)
            if output_dir:
                os.makedirs(output_dir, exist_ok=True)
                Image.fromarray(annotated).save(
                    os.path.join(output_dir, os.path.basename(p)))
            results.append((annotated, (boxes, classes, scores)))
        if paths:
            print(f'{len(paths)} images in {dt:.2f}s '
                  f'({len(paths)/max(dt, 1e-9):.1f} img/s detection)')
        return results

    def run(self):
        """Dispatch on ``input.type``: image or directory."""
        input_cfg = self.config.get('input', {}) or {}
        output_cfg = self.config.get('output', {}) or {}
        out_dir = (output_cfg.get('output_dir', 'output')
                   if output_cfg.get('save_result', True) else None)
        kind = input_cfg.get('type', 'image')
        source = input_cfg.get('source')
        if kind == 'image':
            return self.predict_image(
                source, out_dir, show=output_cfg.get('show_result', False))
        if kind == 'directory':
            return self.predict_directory(source, out_dir)
        if kind in ('video', 'camera'):
            raise NotImplementedError(f'input.type={kind!r} is {_NOT_PORTED}')
        raise ValueError(f'unknown input type {kind!r}')
