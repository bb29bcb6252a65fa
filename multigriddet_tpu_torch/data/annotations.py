"""Annotation parsing and host-side image loading.

Counterpart of ``multigriddet_tpu/data/annotations.py``: one line per
image, ``image_path x1,y1,x2,y2,cls x1,y1,x2,y2,cls ...``; Pillow BICUBIC
letterboxing onto a gray (128) canvas; and ``HostImageLoader``, which
decodes and letterboxes batches: into numpy arrays on the CPU (native JPEG
loader where it is built, PIL otherwise), into tensors on the card
(nvJPEG and the card's letterbox kernels).  Pillow is imported when an
image is read through it, so the module imports without it.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device


def pil_available() -> bool:
    """Whether Pillow imports (the card's host may have none)."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def load_annotation_lines(path: str, shuffle: bool = True,
                          seed: Optional[int] = None) -> List[str]:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if shuffle:
        rng = np.random.RandomState(seed)
        rng.shuffle(lines)
    return lines


def parse_annotation_line(line: str) -> Tuple[str, np.ndarray]:
    """Split a line into (image_path, boxes [N, 5] float32)."""
    parts = line.split()
    path = parts[0]
    boxes = []
    for tok in parts[1:]:
        vals = tok.split(',')
        if len(vals) == 5:
            boxes.append([float(v) for v in vals])
    arr = (np.asarray(boxes, np.float32) if boxes
           else np.zeros((0, 5), np.float32))
    return path, arr


def letterbox_image(image, target_hw: Tuple[int, int]
                    ) -> Tuple[np.ndarray, float, int, int]:
    """Aspect-preserving resize of a PIL image onto a gray canvas.

    Returns (uint8 array [H, W, 3], scale, pad_x, pad_y).
    """
    from PIL import Image

    th, tw = target_hw
    iw, ih = image.size
    scale = min(tw / iw, th / ih)
    nw, nh = int(round(iw * scale)), int(round(ih * scale))
    pad_x, pad_y = (tw - nw) // 2, (th - nh) // 2
    resized = image.resize((nw, nh), Image.BICUBIC)
    canvas = Image.new('RGB', (tw, th), (128, 128, 128))
    canvas.paste(resized, (pad_x, pad_y))
    return np.asarray(canvas, np.uint8), scale, pad_x, pad_y


def _letterbox_boxes(boxes: np.ndarray, max_boxes: int, scale: float,
                     pad_x: float, pad_y: float) -> np.ndarray:
    """Image-pixel boxes -> canvas pixels, padded or cut to
    ``max_boxes`` rows."""
    out = np.zeros((max_boxes, 5), np.float32)
    n = min(len(boxes), max_boxes)
    if n:
        b = boxes[:n].copy()
        b[:, [0, 2]] = b[:, [0, 2]] * scale + pad_x
        b[:, [1, 3]] = b[:, [1, 3]] * scale + pad_y
        out[:n] = b
    return out


def pad_batch(part, n: int):
    """A batch (numpy or tensor) padded with zero slots to ``n`` rows."""
    if len(part) >= n:
        return part
    if isinstance(part, torch.Tensor):
        return torch.cat([part, part.new_zeros((n - len(part),
                                                *part.shape[1:]))])
    buf = np.zeros((n, *part.shape[1:]), part.dtype)
    buf[:len(part)] = part
    return buf


def load_and_letterbox(line: str, target_hw: Tuple[int, int],
                       max_boxes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one annotation line to (image [H, W, 3] u8,
    boxes [max_boxes, 5]) with the boxes in canvas pixels."""
    from PIL import Image

    path, boxes = parse_annotation_line(line)
    with Image.open(path) as img:
        img = img.convert('RGB')
        arr, scale, pad_x, pad_y = letterbox_image(img, target_hw)
    return arr, _letterbox_boxes(boxes, max_boxes, scale, pad_x, pad_y)


class HostImageLoader:
    """Image decode + letterbox producing batches.

    On the CPU (the default ``device``) JPEG batches go through the native
    loader (``data/native.py``) on ``num_workers`` native threads when it
    is built; everything else, and any slot the native path rejects, goes
    through PIL on a thread pool; the batches are numpy.  On a CUDA
    ``device`` every batch is decoded by nvJPEG on ``num_workers`` threads
    (the calling one and the loader's pool) and letterboxed by
    the card's kernels (``data/jpeg_cuda.py``) on the caller's current
    stream, and the batches are tensors on the device; a slot the decoder
    rejects (a PNG, a corrupt file) is retried through PIL where Pillow
    imports and stays gray otherwise.
    ``link_format='rgb'`` gives one ``[N, H, W, 3]`` u8 batch; ``'yuv420'``
    a tuple of planar ``(y [N, H, W], cb, cr [N, H/2, W/2])`` u8, half the
    bytes.  ``cache_images`` keeps decoded images in host memory;
    ``disk_cache_dir`` keeps them as ``.npy`` files keyed by
    sha1(line | file mtime | canvas | max_boxes), written atomically; on
    the card a miss is written from the device result with one
    device-to-host copy.
    """

    def __init__(self, lines: Sequence[str], target_hw: Tuple[int, int],
                 max_boxes: int = 100, num_workers: int = 8,
                 use_native: bool = True, cache_images: bool = False,
                 disk_cache_dir: Optional[str] = None,
                 link_format: str = 'rgb', device=None):
        self.lines = list(lines)
        self.target_hw = tuple(target_hw)
        self.max_boxes = max_boxes
        self.num_workers = num_workers
        if link_format not in ('rgb', 'yuv420'):
            raise ValueError(f'unknown link_format {link_format!r}')
        self.link_format = link_format
        self.device = (torch.device('cpu') if device is None
                       else resolve_device(device))
        self.on_card = self.device.type == 'cuda'
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        if use_native and not self.on_card:
            from .native import native_available
            self.use_native = native_available()
        else:
            self.use_native = False
        self.cache_images = cache_images
        self._cache = {} if cache_images else None
        self.disk_cache_dir = disk_cache_dir
        if disk_cache_dir:
            os.makedirs(disk_cache_dir, exist_ok=True)

    def _disk_key(self, line: str, hw: Tuple[int, int]) -> str:
        path = line.split()[0]
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            mtime = -1
        raw = f'{line}|{mtime}|{hw[0]}x{hw[1]}|{self.max_boxes}'
        if self.link_format != 'rgb':
            raw += f'|{self.link_format}'
        return hashlib.sha1(raw.encode()).hexdigest()

    @property
    def _part_suffixes(self) -> Tuple[str, ...]:
        if self.link_format == 'yuv420':
            return ('.y.npy', '.cb.npy', '.cr.npy')
        return ('.img.npy',)

    def _disk_read(self, key: str):
        base = os.path.join(self.disk_cache_dir, key)
        try:
            parts = tuple(np.asarray(np.load(base + sfx, mmap_mode='r'))
                          for sfx in self._part_suffixes)
            boxes = np.load(base + '.box.npy')
            return parts, boxes
        except (OSError, ValueError):
            return None

    def _disk_write(self, key: str, parts: Tuple[np.ndarray, ...],
                    boxes: np.ndarray):
        base = os.path.join(self.disk_cache_dir, key)
        try:
            pairs = list(zip(self._part_suffixes, parts))
            for suffix, arr in pairs + [('.box.npy', boxes)]:
                # np.save appends '.npy' unless the name ends with it
                tmp = base + f'.tmp{os.getpid()}{suffix}'
                np.save(tmp, arr)
                os.replace(tmp, base + suffix)   # atomic across processes
        except OSError:
            pass   # the cache is best-effort; the decode succeeded

    def _to_parts(self, canvas: np.ndarray) -> Tuple[np.ndarray, ...]:
        if self.link_format == 'yuv420':
            from ..ops.yuv import rgb_to_yuv420_np
            return rgb_to_yuv420_np(canvas)
        return (canvas,)

    def _load_batch_pil(self, batch_lines, hw):
        """Per line: (parts, boxes, metas (scale, pad_x, pad_y, w, h), ok);
        an unreadable file gives a gray canvas, no boxes and zero metas."""
        from PIL import Image

        def safe(line):
            path, boxes = parse_annotation_line(line)
            try:
                with Image.open(path) as img:
                    img = img.convert('RGB')
                    iw, ih = img.size
                    arr, scale, pad_x, pad_y = letterbox_image(img, hw)
            except (OSError, ValueError):
                return (self._to_parts(np.full((*hw, 3), 128, np.uint8)),
                        np.zeros((self.max_boxes, 5), np.float32),
                        np.zeros((5,), np.float32), False)
            bx = _letterbox_boxes(boxes, self.max_boxes, scale, pad_x, pad_y)
            return (self._to_parts(arr), bx,
                    np.asarray([scale, pad_x, pad_y, iw, ih], np.float32),
                    True)
        return list(self.pool.map(safe, batch_lines))

    def _alloc_parts(self, n: int, hw: Tuple[int, int]):
        # zeros (calloc), not np.empty: fresh pages faulted while a
        # device copy is in flight are slow (native/fastloader.cpp)
        if self.link_format == 'yuv420':
            return (np.zeros((n, *hw), np.uint8),
                    np.zeros((n, hw[0] // 2, hw[1] // 2), np.uint8),
                    np.zeros((n, hw[0] // 2, hw[1] // 2), np.uint8))
        return (np.zeros((n, *hw, 3), np.uint8),)

    def _unwrap(self, parts):
        """An rgb batch stays a bare array; a yuv420 batch a tuple."""
        return parts if self.link_format == 'yuv420' else parts[0]

    def _on_device(self, parts):
        """Host parts on the loader's device (the current stream)."""
        if not self.on_card:
            return parts
        return tuple(to_device(np.ascontiguousarray(p), self.device)
                     for p in parts)

    def load_batch(self, batch_lines: Sequence[str],
                   target_hw: Optional[Tuple[int, int]] = None,
                   return_metas: bool = False):
        """Returns (images, boxes [N, max_boxes, 5] in canvas pixels), and
        with ``return_metas`` also ``metas [N, 5]`` f32 ``(scale, pad_x,
        pad_y, full_w, full_h)`` and ``ok [N]`` bool (a loader with a cache
        keeps no metas, so it refuses ``return_metas``).  The images are
        numpy on the CPU and tensors on a CUDA device."""
        hw = tuple(target_hw or self.target_hw)
        if self._cache is None and not self.disk_cache_dir:
            parts, boxes, metas, ok = self._load_batch_uncached(batch_lines,
                                                                hw)
            if return_metas:
                return self._unwrap(parts), boxes, metas, ok
            return self._unwrap(parts), boxes
        if return_metas:
            raise ValueError('a loader with an image cache keeps no metas; '
                             'load without a cache for them')
        if self._cache is None:
            parts, boxes = self._load_batch_disk_or_decode(batch_lines, hw)
            return self._unwrap(self._on_device(parts)), boxes
        missing = [l for l in batch_lines if (l, hw) not in self._cache]
        if missing:
            parts, boxes = self._load_batch_disk_or_decode(missing, hw)
            for i, line in enumerate(missing):
                self._cache[(line, hw)] = (
                    tuple(pt[i] for pt in parts), boxes[i])
        out = self._alloc_parts(len(batch_lines), hw)
        boxes = np.zeros((len(batch_lines), self.max_boxes, 5), np.float32)
        for i, l in enumerate(batch_lines):
            img_parts, bx = self._cache[(l, hw)]
            for buf, pt in zip(out, img_parts):
                buf[i] = pt
            boxes[i] = bx
        return self._unwrap(self._on_device(out)), boxes

    def _load_batch_host(self, batch_lines: Sequence[str],
                         hw: Tuple[int, int]):
        """:meth:`_load_batch_uncached` as numpy (parts, boxes): a batch
        decoded on the card comes back in one copy per part."""
        parts, boxes, _, _ = self._load_batch_uncached(batch_lines, hw)
        if self.on_card:
            parts = tuple(p.cpu().numpy() for p in parts)
        return parts, boxes

    def _load_batch_disk_or_decode(self, batch_lines: Sequence[str],
                                   hw: Tuple[int, int]):
        """Returns (parts tuple of numpy batch arrays, boxes)."""
        if not self.disk_cache_dir:
            return self._load_batch_host(batch_lines, hw)
        keys = [self._disk_key(l, hw) for l in batch_lines]
        hits = list(self.pool.map(self._disk_read, keys))
        out = self._alloc_parts(len(batch_lines), hw)
        boxes = np.zeros((len(batch_lines), self.max_boxes, 5), np.float32)
        miss_idx = [i for i, h in enumerate(hits) if h is None]
        for i, h in enumerate(hits):
            if h is not None:
                for buf, pt in zip(out, h[0]):
                    buf[i] = pt
                boxes[i] = h[1]
        if miss_idx:
            m_parts, m_boxes = self._load_batch_host(
                [batch_lines[i] for i in miss_idx], hw)
            for j, i in enumerate(miss_idx):
                for buf, pt in zip(out, m_parts):
                    buf[i] = pt[j]
                boxes[i] = m_boxes[j]
            list(self.pool.map(
                lambda args: self._disk_write(*args),
                [(keys[i], tuple(pt[j] for pt in m_parts), m_boxes[j])
                 for j, i in enumerate(miss_idx)]))
        return out, boxes

    def _load_batch_uncached(self, batch_lines: Sequence[str],
                             hw: Tuple[int, int]):
        """Returns (parts tuple of batch arrays, boxes, metas, ok): numpy
        parts on the CPU, tensors on the card."""
        parsed = [parse_annotation_line(l) for l in batch_lines]
        paths = [p for p, _ in parsed]
        jpeg = all(p.lower().endswith(('.jpg', '.jpeg')) for p in paths)
        if paths and (self.on_card or (self.use_native and jpeg)):
            if self.on_card:
                from . import jpeg_cuda as loader
                kw = {'device': self.device, 'pool': self.pool}
                yuv, rgb = (loader.load_letterbox_yuv_batch_cuda,
                            loader.load_letterbox_batch_cuda)
            else:
                from . import native as loader
                kw = {'nthreads': self.num_workers}
                yuv, rgb = (loader.load_letterbox_yuv_batch,
                            loader.load_letterbox_batch)
            if self.link_format == 'yuv420':
                ys, cbs, crs, metas, ok = yuv(paths, hw, **kw)
                parts = (ys, cbs, crs)
            else:
                images, metas, ok = rgb(paths, hw, **kw)
                parts = (images,)
            boxes = np.zeros((len(paths), self.max_boxes, 5), np.float32)
            for i, (_, b) in enumerate(parsed):
                if ok[i]:
                    boxes[i] = _letterbox_boxes(b, self.max_boxes,
                                                metas[i, 0], metas[i, 1],
                                                metas[i, 2])
            # PIL retry for any slot the decoder rejected (a PNG, a
            # corrupt file), where Pillow imports
            bad = np.where(~ok)[0]
            if len(bad) and pil_available():
                results = self._load_batch_pil(
                    [batch_lines[i] for i in bad], hw)
                ok = ok.copy()
                for i, (img_parts, bx, meta, good) in zip(bad, results):
                    for buf, pt in zip(parts, img_parts):
                        buf[i] = (to_device(np.array(pt), self.device)
                                  if self.on_card else pt)
                    boxes[i], metas[i], ok[i] = bx, meta, good
            return parts, boxes, metas, ok
        results = self._load_batch_pil(batch_lines, hw)
        parts = self._alloc_parts(len(results), hw)
        n = len(results)
        boxes = np.zeros((n, self.max_boxes, 5), np.float32)
        metas = np.zeros((n, 5), np.float32)
        ok = np.zeros((n,), bool)
        for i, (img_parts, bx, meta, good) in enumerate(results):
            for buf, pt in zip(parts, img_parts):
                buf[i] = pt
            boxes[i], metas[i], ok[i] = bx, meta, good
        return self._on_device(parts), boxes, metas, ok

    def close(self):
        self.pool.shutdown(wait=False)
