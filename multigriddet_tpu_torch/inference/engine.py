"""MultiGridInference: image, directory, file-list, video and camera
inference on the card.

Counterpart of ``multigriddet_tpu/inference/engine.py``.  Forward, decode
and NMS run as one fused step on the device (``make_infer_step``); image
decoding, letterboxing, host WBF (``detection.use_wbf``), the letterbox
inverse of the (at most ``max_boxes``) detections and drawing stay on the
host, or, for JPEG files on the card, to nvJPEG and the card's letterbox
kernels (:meth:`MultiGridInference.detect_files`).
``detection.link_format: yuv420`` sends the file path's pixels as planar
YCbCr 4:2:0, half the bytes of RGB.  Runs on ``cuda`` unless
``device='cpu'`` is passed.  Pillow and OpenCV are imported where they
are used.
"""

from __future__ import annotations

import glob
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import build_model_for_inference, resolve_compute_dtype
from ..data.annotations import letterbox_image, pad_batch, pil_available
from ..device import resolve_device
from ..ops.geometry import canvas_boxes_to_image
from ..training.steps import fetch_detections, make_infer_step
from ..utils.profiling import span
from ..utils.visualization import draw_boxes, get_colors

_IMG_EXTS = ('.jpg', '.jpeg', '.png', '.bmp', '.webp')


def _need_pil(what: str):
    """Raise a clear error where a drawing needs Pillow and it is missing."""
    if not pil_available():
        raise ImportError(
            f'{what}, and this host has none; on the card JPEG files decode '
            f'without it (detect_files, or predict_image with --no-save '
            f'--no-show: ROADMAP item 17)')


def _can_draw() -> bool:
    """Whether :func:`draw_boxes` has OpenCV or Pillow to draw with."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return pil_available()
    return True


def _empty_result():
    return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
            np.zeros((0,), np.float32))


class MultiGridInference:

    def __init__(self, config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        self.on_card = self.device.type == 'cuda'
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
        # WBF replaces NMS: the step returns the confidence-filtered top
        # pre_nms_top_k candidates and the host fuses them
        self.use_wbf = bool(det.get('use_wbf', False))
        self.wbf_mode = str(det.get('wbf_mode', 'paper'))   # or 'reference'
        # 'yuv420': the file path sends planar 4:2:0 (half the bytes);
        # 'rgb' keeps serving byte-exact
        self.link_format = str(det.get('link_format', 'rgb'))
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
        kw = dict(confidence=self.confidence,
                  nms_threshold=self.nms_threshold,
                  nms_method=self.nms_method, use_iol=self.use_iol,
                  max_boxes=self.max_boxes, class_aware=self.class_aware,
                  nms_backend=self.nms_backend,
                  pre_nms_top_k=self.pre_nms_top_k, use_wbf=self.use_wbf)
        self._infer = make_infer_step(self.model, self.spec['anchors'],
                                      self.input_hw, **kw)
        self._infer_yuv = None
        if self.link_format == 'yuv420':
            self._infer_yuv = make_infer_step(
                self.model, self.spec['anchors'], self.input_hw,
                link_format='yuv420', **kw)

    def _host_fuse(self, boxes, classes, scores):
        """Apply WBF to one image's candidate pool (canvas pixels)."""
        if self.use_wbf:
            from ..postprocess.wbf import fuse_and_cap
            boxes, classes, scores = fuse_and_cap(
                boxes, classes, scores, iou_thr=self.nms_threshold,
                mode=self.wbf_mode, max_out=self.max_boxes)
        return boxes, classes, scores

    # ------------------------------------------------------------------

    def _to_device(self, array) -> torch.Tensor:
        if isinstance(array, np.ndarray) and not array.flags.writeable:
            array = array.copy()   # letterboxed PIL arrays are read-only
        return torch.as_tensor(array).to(self.device, non_blocking=True)

    def infer_batch(self, batch):
        """Run the fused step on one ``[B, H, W, 3]`` uint8 batch (numpy or
        tensor).  Returns the device tuple ``(boxes, classes, scores,
        valid)`` without waiting for it; boxes are canvas pixels."""
        with span('infer.upload'):
            x = self._to_device(batch)
        with span('infer.step'):
            return self._infer(x)

    def detect(self, image):
        """Detect on one PIL image.

        Returns (boxes [N, 4] top-left xywh in original pixels,
        classes [N], scores [N]).
        """
        arr, _, _, _ = letterbox_image(image.convert('RGB'), self.input_hw)
        outs = self.infer_batch(arr[None])
        bxs, cls, scs, valid = (a[0] for a in fetch_detections(outs))
        bxs, cls, scs = self._host_fuse(bxs[valid], cls[valid], scs[valid])
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
        for i, size in enumerate(sizes):
            if size is None:
                results.append(_empty_result())
                continue
            keep = valid[i]
            b, c, s = self._host_fuse(bxs[i][keep], cls[i][keep],
                                      scs[i][keep])
            if len(b):
                b = canvas_boxes_to_image(b, size, self.input_hw)
            results.append((b, c, s))

    def _detect_files_pil(self, paths: List[str], batch_size: int,
                          pipeline_depth: int):
        from PIL import Image

        imgs, good_idx = [], []
        for i, p in enumerate(paths):
            try:
                with Image.open(p) as im:
                    imgs.append(im.convert('RGB'))
                good_idx.append(i)
            except OSError:
                pass   # unreadable or corrupt file -> empty result slot
        results = [_empty_result()] * len(paths)
        for i, r in zip(good_idx, self.detect_batch(imgs, batch_size,
                                                    pipeline_depth)):
            results[i] = r
        return results

    def detect_files(self, paths: List[str], batch_size: int = 16,
                     num_workers: int = 8, pipeline_depth: int = 4):
        """File-based batched detection.

        On the card every file is decoded by nvJPEG on ``num_workers``
        threads (the calling one and a pool kept for the call) and
        letterboxed by the card's kernels
        (``data/jpeg_cuda.py``); on the CPU an all-JPEG list goes through
        the native loader (``data/native.py``) on ``num_workers`` native
        threads.  Either feeds the fused step, in planar 4:2:0 with
        ``link_format: yuv420``; a slot the decoder rejects (a PNG, a
        corrupt file) is retried with PIL where Pillow imports, and the
        last short chunk is padded to ``batch_size``.  On the CPU a list
        that is not all JPEG, or a host without the native loader, goes
        through :meth:`detect_batch` instead.  Pipelined like
        :meth:`detect_batch`.  Returns (boxes, classes, scores) per path in
        original pixels; unreadable files give empty results.
        """
        from ..data import jpeg_cuda, native

        all_jpeg = all(p.lower().endswith(('.jpg', '.jpeg')) for p in paths)
        on_card = self.on_card
        if not on_card and not (all_jpeg and native.native_available()):
            return self._detect_files_pil(paths, batch_size, pipeline_depth)
        if on_card:
            load_rgb = jpeg_cuda.load_letterbox_batch_cuda
            load_yuv = jpeg_cuda.load_letterbox_yuv_batch_cuda
            pool = ThreadPoolExecutor(max(1, num_workers),
                                      thread_name_prefix='nvjpeg')
            kw = {'device': self.device, 'pool': pool}
        else:
            load_rgb = native.load_letterbox_batch
            load_yuv = native.load_letterbox_yuv_batch
            pool = None
            kw = {'nthreads': num_workers}
        retry = pil_available()
        use_yuv = (self._infer_yuv is not None
                   and self.input_hw[0] % 2 == 0
                   and self.input_hw[1] % 2 == 0)
        results: list = []
        pending: deque = deque()
        try:
            for start in range(0, len(paths), batch_size):
                chunk = paths[start:start + batch_size]
                if use_yuv:
                    ys, cbs, crs, metas, ok = load_yuv(chunk, self.input_hw,
                                                       **kw)
                    parts = [ys, cbs, crs]
                else:
                    imgs, metas, ok = load_rgb(chunk, self.input_hw, **kw)
                    parts = [imgs]
                # one shape for every chunk
                parts = [pad_batch(p, batch_size) for p in parts]
                sizes = [(int(m[4]), int(m[3])) if good else None
                         for m, good in zip(metas, ok)]
                if retry:
                    for i in np.where(~ok)[0]:
                        self._retry_slot_pil(chunk[i], i, parts, sizes,
                                             use_yuv)
                if use_yuv:
                    outs = self._infer_yuv(*(self._to_device(p)
                                             for p in parts))
                else:
                    outs = self.infer_batch(parts[0])
                pending.append((outs, sizes))
                if len(pending) > max(pipeline_depth, 0):
                    self._postprocess_batch(*pending.popleft(), results)
            while pending:
                self._postprocess_batch(*pending.popleft(), results)
        finally:
            if pool is not None:
                pool.shutdown()
        return results

    def _retry_slot_pil(self, path, i, parts, sizes, use_yuv):
        """Decode slot ``i`` with PIL after the JPEG decoder rejected it
        (PNG/BMP/WebP content under a .jpg name); an unreadable file keeps
        its empty result."""
        from PIL import Image

        try:
            with Image.open(path) as im:
                rgb = im.convert('RGB')
                iw, ih = rgb.size
                arr, _, _, _ = letterbox_image(rgb, self.input_hw)
        except OSError:
            return
        if use_yuv:
            from ..ops.yuv import rgb_to_yuv420_np
            planes = rgb_to_yuv420_np(arr)
        else:
            planes = (arr,)
        for p, plane in zip(parts, planes):
            p[i] = (torch.from_numpy(np.array(plane)).to(p.device)
                    if isinstance(p, torch.Tensor) else plane)
        sizes[i] = (ih, iw)

    def predict_image(self, path: str, output_dir: Optional[str] = None,
                      show: bool = False):
        """Detect on one image file and draw the detections; save or show
        the drawing.  Returns ``(drawing, (boxes, classes, scores))``.

        On the card a JPEG goes through :meth:`detect_files` (nvJPEG and
        the card's letterbox) and is drawn on nvJPEG's full-size RGB
        (Pillow's where nvJPEG rejects the file and Pillow imports); the
        drawing is None where neither OpenCV nor Pillow imports.  Saving
        or showing needs Pillow, and so does reading any other file."""
        if output_dir or show:
            _need_pil('predict_image needs Pillow to save or show the '
                      'annotated image')
        if (self.device.type == 'cuda'
                and path.lower().endswith(('.jpg', '.jpeg'))):
            t0 = time.time()
            boxes, classes, scores = self.detect_files([path],
                                                       batch_size=1)[0]
            dt = time.time() - t0
            rgb = self._card_rgb(path)
        else:
            _need_pil(f'predict_image needs Pillow to read {path}')
            from PIL import Image

            image = Image.open(path)
            t0 = time.time()
            boxes, classes, scores = self.detect(image)
            dt = time.time() - t0
            rgb = np.asarray(image.convert('RGB'))
        print(f'{os.path.basename(path)}: {len(boxes)} objects '
              f'in {dt*1000:.1f} ms')
        annotated = (draw_boxes(rgb, boxes, classes, scores,
                                self.class_names, self.colors)
                     if rgb is not None and _can_draw() else None)
        if output_dir or show:
            if annotated is None:
                raise OSError(f'cannot read {path}')
            from PIL import Image
            drawing = Image.fromarray(annotated)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            out_path = os.path.join(output_dir, os.path.basename(path))
            drawing.save(out_path)
            print(f'Saved to {out_path}')
        if show:
            try:
                drawing.show()
            except OSError as exc:  # headless host: warn, don't fail
                print(f'WARNING: could not display image: {exc}')
        return annotated, (boxes, classes, scores)

    def _card_rgb(self, path: str) -> Optional[np.ndarray]:
        """A JPEG's full-size RGB to draw on: nvJPEG's, or Pillow's for a
        file nvJPEG rejects where Pillow imports; None if neither reads
        it."""
        from ..data.jpeg_cuda import decode_files

        (image,), _ = decode_files([path], self.device)
        if image is not None:    # [H, W, 3], or [H, W, 1] for a gray file
            return image.expand(-1, -1, 3).contiguous().cpu().numpy()
        if not pil_available():
            return None
        from PIL import Image
        try:
            with Image.open(path) as img:
                return np.asarray(img.convert('RGB'))
        except (OSError, ValueError):
            return None

    def predict_directory(self, directory: str,
                          output_dir: Optional[str] = None,
                          batch_size: int = 16):
        """Annotate every image in a directory; detection runs through the
        pipelined :meth:`detect_files`.  Unreadable files give empty
        detections with a warning."""
        _need_pil('predict_directory needs Pillow to read and draw the '
                  'annotated images')
        from PIL import Image

        paths = sorted(
            p for p in glob.glob(os.path.join(directory, '*'))
            if p.lower().endswith(_IMG_EXTS))
        t0 = time.time()
        detections = self.detect_files(paths, batch_size=batch_size)
        dt = time.time() - t0
        results = []
        for p, (boxes, classes, scores) in zip(paths, detections):
            print(f'{os.path.basename(p)}: {len(boxes)} objects')
            try:
                with Image.open(p) as im:
                    rgb = np.asarray(im.convert('RGB'))
            except OSError as exc:
                print(f'WARNING: could not read {p} for annotation: {exc}')
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

    def predict_video(self, source, output_path: Optional[str] = None,
                      show: bool = False, max_frames: Optional[int] = None,
                      pipeline_depth: int = 2, batch_size: int = 8,
                      resolution: Optional[Tuple[int, int]] = None):
        """Video (or camera index) loop through OpenCV.

        Frames go ``batch_size`` at a time through one fused step, and a
        chunk's results are fetched only after ``pipeline_depth`` further
        chunks were sent, so host decode and letterboxing overlap the
        device.  Output lags by up to ``(pipeline_depth + 1) * batch_size``
        frames; ``batch_size=1, pipeline_depth=0`` is a live loop (the
        default of :meth:`predict_camera`).  Returns the frame count.
        """
        import cv2

        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise IOError(f'cannot open video source {source!r}')
        if resolution:   # camera capture size (w, h); files ignore it
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, int(resolution[0]))
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, int(resolution[1]))
        writer = None
        if output_path:
            video_cfg = self.config.get('video', {}) or {}
            fps = video_cfg.get('fps') or cap.get(cv2.CAP_PROP_FPS) or 25
            fourcc = cv2.VideoWriter_fourcc(*video_cfg.get('fourcc', 'mp4v'))
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            writer = cv2.VideoWriter(output_path, fourcc, fps, (w, h))
        frames = 0
        stop = False
        batch_size = max(batch_size, 1)
        pending: deque = deque()
        batch = np.zeros((batch_size, *self.input_hw, 3), np.uint8)
        rgbs: list = []

        def dispatch():
            nonlocal batch
            pending.append((self.infer_batch(batch), list(rgbs)))
            rgbs.clear()
            # the sent chunk keeps its buffer: the next chunk gets a
            # fresh one instead of overwriting pixels still in flight
            batch = np.zeros((batch_size, *self.input_hw, 3), np.uint8)

        def flush_one():
            nonlocal stop
            outs, chunk_rgbs = pending.popleft()
            bxs, cls, scs, valid = fetch_detections(outs)
            for i, rgb in enumerate(chunk_rgbs):
                b, c, s = self._host_fuse(bxs[i][valid[i]],
                                          cls[i][valid[i]],
                                          scs[i][valid[i]])
                if len(b):
                    b = canvas_boxes_to_image(b, rgb.shape[:2],
                                              self.input_hw)
                annotated = draw_boxes(rgb, b, c, s, self.class_names,
                                       self.colors)
                bgr = cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR)
                if writer is not None:
                    writer.write(bgr)
                if show:  # pragma: no cover
                    cv2.imshow('MultiGridDet', bgr)
                    if cv2.waitKey(1) & 0xFF == ord('q'):
                        stop = True
                        return

        t0 = time.time()
        try:
            while not stop:
                ok, frame = cap.read()
                if not ok or (max_frames and frames >= max_frames):
                    break
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                # cv2 letterbox, the geometry of letterbox_image
                th, tw = self.input_hw
                ih, iw = rgb.shape[:2]
                s = min(tw / iw, th / ih)
                nw, nh = int(round(iw * s)), int(round(ih * s))
                px, py = (tw - nw) // 2, (th - nh) // 2
                slot = batch[len(rgbs)]
                slot[:] = 128
                slot[py:py + nh, px:px + nw] = cv2.resize(
                    rgb, (nw, nh), interpolation=cv2.INTER_CUBIC)
                rgbs.append(rgb)
                frames += 1
                if len(rgbs) == batch_size:
                    dispatch()
                    if len(pending) > max(pipeline_depth, 0):
                        flush_one()
            if rgbs and not stop:    # the last short chunk (padded slots
                dispatch()           # are computed but never emitted)
            while pending and not stop:
                flush_one()
        finally:
            cap.release()
            if writer is not None:
                writer.release()
        dt = time.time() - t0
        if frames:
            print(f'{frames} frames in {dt:.1f}s ({frames/dt:.1f} FPS)')
        return frames

    def predict_camera(self, device_id: int = 0, show: bool = True,
                       max_frames: Optional[int] = None):
        """Live camera loop: no batching or pipelining, least latency;
        ``camera.resolution`` sets the capture size."""
        cam = self.config.get('camera', {}) or {}
        return self.predict_video(device_id, None, show, max_frames,
                                  pipeline_depth=0, batch_size=1,
                                  resolution=cam.get('resolution'))

    def run(self):
        """Dispatch on ``input.type``: image, directory, video or camera."""
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
        if kind == 'video':
            out_path = None
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                out_path = os.path.join(
                    out_dir, 'annotated_' + os.path.basename(str(source)))
            video_cfg = self.config.get('video', {}) or {}
            return self.predict_video(
                source, out_path,
                show=bool(output_cfg.get('show_result', False)),
                pipeline_depth=int(video_cfg.get('pipeline_depth', 2)),
                batch_size=int(video_cfg.get('batch_size', 8)))
        if kind == 'camera':
            # a numeric input.source ("--input 1") is the device id;
            # camera.device_id is the config file's spelling
            cam = self.config.get('camera', {}) or {}
            device = (int(source) if source is not None
                      and str(source).isdigit()
                      else int(cam.get('device_id', 0)))
            return self.predict_camera(
                device, show=bool(output_cfg.get('show_result', True)))
        raise ValueError(f'unknown input type {kind!r}')
