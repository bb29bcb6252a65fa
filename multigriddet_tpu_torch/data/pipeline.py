"""The input pipeline: host decode, then the device stage.

Counterpart of ``multigriddet_tpu/data/pipeline.py``:

  host thread:  read file -> decode -> letterbox -> u8 batch (rgb or the
                yuv420 link format) -> host-to-device copy started
  device:       u8 -> f32 [0, 255] -> [0, 1] -> 9-cell target encoding

Batch order, epoch shuffles and multi-scale canvases come from the same
``np.random.RandomState(seed)`` draws as the JAX generator, so the port sees
the same batches, in the same order and at the same canvases.  In place of
the JAX generator's PRNG key, each batch carries an explicit
``torch.Generator``.

Not ported yet (ROADMAP Queue 1 item 10, the next slice): the random
augmentation ops of ``data/augment.py`` and the device-resident image bank
(``cache_images_device``).  Asking for either raises ``NotImplementedError``
when the generator is built; nothing is silently left out.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..ops.encoding import encode_targets
from ..ops.yuv import yuv420_to_rgb
from .annotations import HostImageLoader
from .augment import normalize_images

MULTISCALE_SHAPES = tuple((s, s) for s in range(320, 673, 32))

AUGMENT_NOT_PORTED = (
    'training augmentation (training.augmentation.enabled) is not ported '
    'yet (ROADMAP Queue 1 item 10); set training.augmentation.enabled: '
    'false')
BANK_NOT_PORTED = (
    'the device image bank (data_loader.cache_images_device) is not ported '
    'yet (ROADMAP Queue 1 item 10)')


def calculate_expansion_factor(mosaic_prob: float, mixup_prob: float) -> int:
    """x8 mosaic+mixup, x4 mosaic, x2 mixup, x1 none."""
    factor = 1
    if mosaic_prob > 0:
        factor *= 4
    if mixup_prob > 0:
        factor *= 2
    return factor


def augmentation_enabled(aug_cfg: Optional[Dict], train: bool) -> bool:
    """Whether the device stage would augment (the JAX package's rule: a
    train stage augments unless ``enabled`` is false)."""
    return bool(train and (aug_cfg or {}).get('enabled', True))


def pixels_to_f32(pixels) -> torch.Tensor:
    """Link-format pixels -> f32 RGB in [0, 255]: a bare u8 batch
    ``[B, H, W, 3]``, a 1-tuple of one, or planar yuv420
    ``(y [B, H, W], cb, cr [B, H/2, W/2])``."""
    if isinstance(pixels, (tuple, list)):
        if len(pixels) == 3:
            return yuv420_to_rgb(*pixels)
        pixels = pixels[0]
    return pixels.float()


def _device_stage(parts, boxes, generator, aug_cfg, anchors, num_classes,
                  input_hw, train, multi_anchor_assign=False):
    """pixels (see :func:`pixels_to_f32`) + boxes ``[B, N, 5]`` -> (images
    f32 [0, 1], y_true, boxes).  ``generator`` feeds the random
    augmentation, which is not ported yet."""
    if augmentation_enabled(aug_cfg, train):
        raise NotImplementedError(AUGMENT_NOT_PORTED)
    images = normalize_images(pixels_to_f32(parts))
    y_true = encode_targets(boxes, anchors, num_classes, input_hw,
                            multi_anchor_assign=multi_anchor_assign,
                            device=images.device)
    return images, y_true, boxes


def split_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator seeded from ``generator``'s stream (the counterpart
    of ``jax.random.split``)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed)


class MultiGridDataGenerator:
    """Batched data generator: iterate for ``(images, y_true, boxes)`` with
    images in [0, 1] on ``device`` and the 9-cell target grids, or use
    :meth:`iter_raw` to feed a fused train step."""

    def __init__(self,
                 annotation_lines: Sequence[str],
                 anchors: Sequence[np.ndarray],
                 num_classes: int,
                 input_shape: Tuple[int, int] = (608, 608),
                 batch_size: int = 8,
                 max_boxes: int = 100,
                 augment: Optional[Dict] = None,
                 train: bool = True,
                 rescale_interval: int = -1,
                 num_workers: int = 8,
                 seed: int = 0,
                 drop_remainder: bool = True,
                 multi_anchor_assign: bool = False,
                 cache_images: bool = False,
                 disk_cache_dir: Optional[str] = None,
                 cache_images_device: bool = False,
                 link_format: str = 'auto',
                 device=None):
        self.augment_cfg = dict(augment or {})
        if augmentation_enabled(self.augment_cfg, train):
            raise NotImplementedError(AUGMENT_NOT_PORTED)
        if cache_images_device:
            raise NotImplementedError(BANK_NOT_PORTED)
        self.device = resolve_device(device)
        self.lines = list(annotation_lines)
        self.anchors = [np.asarray(a, np.float32) for a in anchors]
        self.num_classes = num_classes
        self.input_shape = tuple(input_shape[:2])
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.train = train
        self.rescale_interval = rescale_interval
        self.rng = np.random.RandomState(seed)
        self.generator = torch.Generator().manual_seed(seed)
        # 'auto': the yuv420 link (half the bytes of rgb) for a train
        # generator on an even canvas; evaluation keeps the exact rgb canvas
        if link_format == 'auto':
            even = (self.input_shape[0] % 2 == 0
                    and self.input_shape[1] % 2 == 0)
            link_format = 'yuv420' if (train and even) else 'rgb'
        self.link_format = link_format
        self.loader = HostImageLoader(
            self.lines, self.input_shape, max_boxes, num_workers,
            cache_images=cache_images, disk_cache_dir=disk_cache_dir,
            link_format=link_format)
        self.drop_remainder = drop_remainder
        self.multi_anchor_assign = multi_anchor_assign
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == 'cuda' else None)

    def __len__(self):
        if self.drop_remainder:
            return len(self.lines) // self.batch_size
        return -(-len(self.lines) // self.batch_size)

    steps_per_epoch = property(__len__)

    def _pick_shape(self, step: int) -> Tuple[int, int]:
        if not self.train or self.rescale_interval <= 0:
            return self.input_shape
        if step % self.rescale_interval == 0 or not hasattr(self, '_cur_hw'):
            max_side = max(self.input_shape)
            options = [s for s in MULTISCALE_SHAPES if s[0] <= max_side]
            if not options:
                # below every bucket: /32 buckets under the nominal size
                sides = [s for s in range(max(32, max_side // 2 // 32 * 32),
                                          max_side + 1, 32)] or [max_side]
                options = [(s, s) for s in sides]
            self._cur_hw = options[self.rng.randint(len(options))]
        return self._cur_hw

    def _upload(self, pixels) -> Tuple[Tuple[torch.Tensor, ...], object]:
        """Start the host-to-device copy of a batch's parts; returns the
        parts and the event the consumer waits on (None on the CPU)."""
        if self._copy_stream is None:
            return tuple(torch.from_numpy(np.ascontiguousarray(p))
                         for p in pixels), None
        with torch.cuda.stream(self._copy_stream):
            parts = tuple(to_device(np.ascontiguousarray(p), self.device)
                          for p in pixels)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return parts, event

    @staticmethod
    def _ready(parts, event):
        """Order the consumer's stream after the copy of ``parts``."""
        if event is not None:
            stream = torch.cuda.current_stream(parts[0].device)
            stream.wait_event(event)
            for p in parts:
                p.record_stream(stream)
        return parts

    def process_batch(self, pixels, boxes: np.ndarray,
                      input_hw: Optional[Tuple[int, int]] = None):
        """Run the device stage on one batch: ``pixels`` is a u8 RGB batch
        or the loader's parts tuple, numpy or tensors on the device."""
        hw = tuple(input_hw or self.input_shape)
        if not isinstance(pixels, tuple):
            pixels = (pixels,)
        if not isinstance(pixels[0], torch.Tensor):
            pixels = self._ready(*self._upload(pixels))
        images, y_true, _ = _device_stage(
            pixels, boxes, split_generator(self.generator), self.augment_cfg,
            self.anchors, self.num_classes, hw, self.train,
            self.multi_anchor_assign)
        return images, y_true, to_device(boxes, self.device)

    def _prefetched(self):
        """A producer thread loads, letterboxes and starts the copy of the
        next batches while the device runs the current one.  Yields
        ``((parts, event), boxes, batch_lines, hw)``; an error in the
        producer is raised in the consumer."""
        order = np.arange(len(self.lines))
        if self.train:
            self.rng.shuffle(order)
        steps = len(self)
        q: 'queue.Queue' = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            try:
                for step in range(steps):
                    if stop.is_set():
                        return
                    start = step * self.batch_size
                    idx = order[start:start + self.batch_size]
                    if len(idx) < self.batch_size:
                        # wrap a last partial batch to the full batch size
                        idx = np.resize(idx, self.batch_size)
                    batch_lines = [self.lines[i] for i in idx]
                    hw = self._pick_shape(step)
                    pixels, boxes = self.loader.load_batch(batch_lines, hw)
                    if not isinstance(pixels, tuple):
                        pixels = (pixels,)
                    q.put((self._upload(pixels), boxes, batch_lines, hw))
                q.put(None)
            except BaseException as exc:    # re-raised by the consumer
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early (BN calibration) ends the producer
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()

    def __iter__(self):
        """Iterate processed batches ``(images, y_true, boxes)``."""
        for upload, boxes, _, hw in self._prefetched():
            yield self.process_batch(self._ready(*upload), boxes, hw)

    def iter_raw(self):
        """Iterate raw batches for a fused train step: yields
        ``('host', parts, boxes, hw, generator)`` with ``parts`` the
        link-format tuple on the device (copy ordered before the caller's
        work), ``boxes`` numpy ``[B, max_boxes, 5]`` and the batch's own
        ``torch.Generator``."""
        for upload, boxes, _, hw in self._prefetched():
            gen = split_generator(self.generator)
            yield ('host', self._ready(*upload), boxes, hw, gen)

    def close(self):
        self.loader.close()
