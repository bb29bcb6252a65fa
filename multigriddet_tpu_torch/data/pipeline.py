"""The input pipeline: host decode, then the device stage.

Counterpart of ``multigriddet_tpu/data/pipeline.py``:

  host thread:  read file -> decode -> letterbox -> u8 batch (rgb or the
                yuv420 link format) -> host-to-device copy started; on the
                card, nvJPEG decodes and a kernel letterboxes on the copy
                stream instead, and the batch is born on the device
  device:       u8 -> f32 [0, 255] -> photometric augs -> crop/pad zoom ->
                flips -> filters -> rotations -> gridmask -> capacity
                expand -> mosaic -> mixup -> copy-paste -> [0, 1] ->
                9-cell target encoding

Batch order, epoch shuffles and multi-scale canvases come from the same
``np.random.RandomState(seed)`` draws as the JAX generator, so the port sees
the same batches, in the same order and at the same canvases.  In place of
the JAX generator's PRNG key, each batch carries an explicit
``torch.Generator``; the augmentation draws come from it on the CPU (one
generator per op slot, see :func:`draw_chain`) and move to the device.

With ``cache_images_device`` the decoded u8 images also live in a bank on
the device (:class:`_DeviceImageCache`): from epoch 2 on, a batch whose
images are all banked is gathered there, and the host sends only its box
rows and row indices.

Capacity follows the JAX package: ``max_boxes`` is expanded x8/x4/x2/x1
for mosaic (x4) and mixup (x2), plus ``copypaste_max`` slots for
copy-paste, and never truncated afterwards.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device, to_device
from ..ops.encoding import encode_targets
from ..ops.yuv import yuv420_to_rgb
from . import augment as A
from .annotations import HostImageLoader

MULTISCALE_SHAPES = tuple((s, s) for s in range(320, 673, 32))

# the chain's op slots in the order of the JAX stage's keys: split(key,
# 12) gives the first twelve, fold_in(key, 101..104) the last four
SLOTS = ('resize', 'hflip', 'brightness', 'contrast', 'saturation', 'hue',
         'grayscale', 'rotate90', 'gridmask', 'mosaic', 'mixup', 'blur',
         'sharpness', 'motion_blur', 'rotate_any', 'copypaste')


def calculate_expansion_factor(mosaic_prob: float, mixup_prob: float) -> int:
    """x8 mosaic+mixup, x4 mosaic, x2 mixup, x1 none."""
    factor = 1
    if mosaic_prob > 0:
        factor *= 4
    if mixup_prob > 0:
        factor *= 2
    return factor


def augmentation_enabled(aug_cfg: Optional[Dict], train: bool) -> bool:
    """Whether the device stage augments (the JAX package's rule: a train
    stage augments unless ``enabled`` is false)."""
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


def split_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator seeded from ``generator``'s stream (the counterpart
    of ``jax.random.split``)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed)


def draw_chain(generator: torch.Generator, b: int, n: int,
               cfg: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every draw of the augmentation chain for a batch of ``b`` images
    with box capacity ``n``, on the CPU.  One generator per op slot is
    split from ``generator`` in a fixed order whether or not its op runs,
    so turning one optional op on never changes another op's draws (as
    the JAX stage's per-op keys).  Only the ops ``cfg`` runs are drawn."""
    gens = {name: split_generator(generator) for name in SLOTS}
    d = {'resize': A.draw_resize_crop_pad(
             gens['resize'], b, scale_range=tuple(cfg.get(
                 'scale_range', (0.7, 1.3)))),
         'hflip': A.draw_gate(gens['hflip'], b, cfg.get('hflip_prob', 0.5)),
         'brightness': A.draw_brightness(gens['brightness'], b),
         'contrast': A.draw_contrast(gens['contrast'], b),
         'saturation': A.draw_saturation(gens['saturation'], b),
         'hue': A.draw_hue(gens['hue'], b),
         'grayscale': A.draw_gate(gens['grayscale'], b,
                                  cfg.get('grayscale_prob', 0.1)),
         'rotate90': A.draw_rotate90(gens['rotate90'], b,
                                     cfg.get('rotate_prob', 0.05))}
    if cfg.get('blur_prob', 0.0) > 0:
        d['blur'] = A.draw_gate(gens['blur'], b, cfg['blur_prob'])
    if cfg.get('sharpness_prob', 0.0) > 0:
        d['sharpness'] = A.draw_sharpness(gens['sharpness'], b,
                                          cfg['sharpness_prob'])
    if cfg.get('motion_blur_prob', 0.0) > 0:
        d['motion_blur'] = A.draw_motion_blur(gens['motion_blur'], b,
                                              cfg['motion_blur_prob'])
    if cfg.get('rotate_any_prob', 0.0) > 0:
        d['rotate_any'] = A.draw_rotate_any(
            gens['rotate_any'], b, cfg['rotate_any_prob'],
            cfg.get('rotate_max_deg', 15.0))
    if cfg.get('enhance_type') == 'gridmask':
        d['gridmask'] = A.draw_gridmask(gens['gridmask'], b,
                                        cfg.get('gridmask_prob', 0.1))
    mosaic_prob = cfg.get('mosaic_prob', 0.0)
    mixup_prob = cfg.get('mixup_prob', 0.0)
    if mosaic_prob > 0:
        d['mosaic'] = A.draw_mosaic(gens['mosaic'], b, mosaic_prob)
    if mixup_prob > 0:
        d['mixup'] = A.draw_mixup(gens['mixup'], b, mixup_prob)
    if cfg.get('copypaste_prob', 0.0) > 0:
        cp_max = int(cfg.get('copypaste_max', 4))
        cap = n * calculate_expansion_factor(mosaic_prob, mixup_prob)
        d['copypaste'] = A.draw_copypaste(
            gens['copypaste'], b, cap + cp_max, cfg['copypaste_prob'],
            cp_max)
    return d


def apply_chain(images: torch.Tensor, boxes: torch.Tensor, draws: Dict,
                cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmentation chain of the JAX stage, in its order and with its
    gating, from ``draws`` (:func:`draw_chain`, on the images' device).
    Mosaic runs whenever ``mosaic_prob > 0``, whatever ``enhance_type``
    says, as in the JAX stage."""
    images, boxes = A.apply_resize_crop_pad(images, boxes, draws['resize'])
    images, boxes = A.apply_hflip(images, boxes, draws['hflip'])
    images, boxes = A.apply_brightness(images, boxes, draws['brightness'])
    images, boxes = A.apply_contrast(images, boxes, draws['contrast'])
    images, boxes = A.apply_saturation(images, boxes, draws['saturation'])
    images, boxes = A.apply_hue(images, boxes, draws['hue'])
    images, boxes = A.apply_grayscale(images, boxes, draws['grayscale'])
    if cfg.get('blur_prob', 0.0) > 0:
        images, boxes = A.apply_blur(images, boxes, draws['blur'])
    if cfg.get('sharpness_prob', 0.0) > 0:
        images, boxes = A.apply_sharpness(images, boxes, draws['sharpness'])
    if cfg.get('motion_blur_prob', 0.0) > 0:
        images, boxes = A.apply_motion_blur(images, boxes,
                                            draws['motion_blur'])
    if cfg.get('rotate_any_prob', 0.0) > 0:
        images, boxes = A.apply_rotate_any(images, boxes,
                                           draws['rotate_any'])
    images, boxes = A.apply_rotate90(images, boxes, draws['rotate90'])
    if cfg.get('enhance_type') == 'gridmask':
        images, boxes = A.apply_gridmask(images, boxes, draws['gridmask'])
    mosaic_prob = cfg.get('mosaic_prob', 0.0)
    mixup_prob = cfg.get('mixup_prob', 0.0)
    boxes = A.expand_box_capacity(
        boxes, calculate_expansion_factor(mosaic_prob, mixup_prob))
    if mosaic_prob > 0:
        images, boxes = A.apply_mosaic(images, boxes, draws['mosaic'])
    if mixup_prob > 0:
        images, boxes = A.apply_mixup(images, boxes, draws['mixup'])
    if cfg.get('copypaste_prob', 0.0) > 0:
        # +copypaste_max slots (additive) hold the pasted boxes
        cp_max = int(cfg.get('copypaste_max', 4))
        boxes = F.pad(boxes, (0, 0, 0, cp_max))
        images, boxes = A.apply_copypaste(images, boxes, draws['copypaste'],
                                          max_paste=cp_max)
    return images, boxes


def _device_stage(parts, boxes, generator, aug_cfg, anchors, num_classes,
                  input_hw, train, multi_anchor_assign=False, draws=None):
    """pixels (see :func:`pixels_to_f32`) + boxes ``[B, N, 5]`` -> (images
    f32 [0, 1], y_true, boxes after augmentation).

    A train stage with augmentation on draws from ``generator`` (or takes
    ``draws`` made by :func:`draw_chain`) and runs :func:`apply_chain` on
    the images' device; the boxes then live there too, and the encoder
    reads their valid count with one host sync."""
    images = pixels_to_f32(parts)
    cfg = dict(aug_cfg or {})
    if augmentation_enabled(cfg, train):
        if draws is None:
            if generator is None:
                raise ValueError('an augmenting stage needs a generator')
            draws = draw_chain(generator, images.shape[0], boxes.shape[1],
                               cfg)
        boxes = to_device(boxes, images.device, torch.float32)
        images, boxes = apply_chain(images, boxes,
                                    A.draws_to(draws, images.device), cfg)
    images = A.normalize_images(images)
    y_true = encode_targets(boxes, anchors, num_classes, input_hw,
                            multi_anchor_assign=multi_anchor_assign,
                            device=images.device)
    return images, y_true, boxes


def _device_stage_bank(banks, idx, boxes, generator, aug_cfg, anchors,
                       num_classes, input_hw, train,
                       multi_anchor_assign=False):
    """:func:`_device_stage` on pixels gathered from the device bank:
    ``banks`` is the per-part tuple (1 for rgb, 3 for yuv420), ``idx``
    the batch's rows; the gathered rows never leave the device."""
    if not isinstance(banks, (tuple, list)):
        banks = (banks,)
    idx = to_device(np.asarray(idx, np.int64), banks[0].device)
    parts = tuple(b[idx] for b in banks)
    return _device_stage(parts, boxes, generator, aug_cfg, anchors,
                         num_classes, input_hw, train, multi_anchor_assign)


def _bank_scatter(bank: torch.Tensor, rows: torch.Tensor,
                  images_u8: torch.Tensor) -> torch.Tensor:
    """Write a decoded batch into its bank rows, in place."""
    return bank.index_copy_(0, rows, images_u8)


class _DeviceImageCache:
    """Decoded u8 images in device memory.

    One bank per canvas, pre-sized to the dataset's rows (1 part for rgb
    ``[R, H, W, 3]``, 3 for yuv420: ``y [R, H, W]`` and ``cb``/``cr``
    ``[R, H/2, W/2]``, half the bytes).  A byte ledger, which several
    caches may share (the trainer's train and validation generators),
    bounds them all by one budget: a canvas whose bank does not fit warns
    and streams from the host instead.  An insert that cannot place every
    row rolls its rows back, so ``has()`` never reports a row whose
    pixels were not written.
    """

    def __init__(self, n_rows: int, budget_bytes: int,
                 ledger: Optional[Dict[str, int]] = None):
        self.n_rows = int(n_rows)
        self.budget = int(budget_bytes)
        self._ledger = ledger if ledger is not None else {'bytes': 0}
        self._row: Dict[Tuple[str, Tuple[int, int]], int] = {}
        self._next: Dict[Tuple[int, int], int] = {}
        self._banks: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}
        self._boxes: Dict[Tuple[str, Tuple[int, int]], np.ndarray] = {}
        self._uncacheable: set = set()

    @property
    def bytes(self) -> int:
        return self._ledger['bytes']

    def _ensure_bank(self, hw: Tuple[int, int], parts) -> bool:
        if hw in self._banks:
            return True
        if hw in self._uncacheable:
            return False
        shapes = [(self.n_rows, *p.shape[1:]) for p in parts]
        need = sum(int(np.prod(shp)) for shp in shapes)     # u8
        if self.bytes + need > self.budget:
            warnings.warn(
                f'device image cache: bank for canvas {hw} needs '
                f'{need / 1e9:.2f} GB but only '
                f'{(self.budget - self.bytes) / 1e9:.2f} GB of the budget '
                f'remains; this canvas streams from the host instead')
            self._uncacheable.add(hw)
            return False
        dev = parts[0].device
        self._banks[hw] = tuple(torch.zeros(shp, dtype=torch.uint8,
                                            device=dev) for shp in shapes)
        self._next[hw] = 0
        self._ledger['bytes'] += need
        return True

    def add_batch(self, hw: Tuple[int, int], lines: Sequence[str],
                  parts_dev, boxes_np: np.ndarray) -> None:
        """Write a batch already on the device into the bank (the epoch-1
        host path has it there anyway, so caching costs no transfer).
        Lines seen before rewrite their own row."""
        hw = tuple(hw)
        if not isinstance(parts_dev, (tuple, list)):
            parts_dev = (parts_dev,)
        if not self._ensure_bank(hw, parts_dev):
            return
        rows = np.empty(len(lines), np.int64)
        inserted = []
        for i, line in enumerate(lines):
            key = (line, hw)
            row = self._row.get(key)
            if row is None:
                row = self._next[hw]
                if row >= self.n_rows:
                    # roll back this call's inserts: a row whose pixels
                    # were never written would gather as a black image
                    for k in inserted:
                        del self._row[k]
                        del self._boxes[k]
                    self._uncacheable.add(hw)
                    return
                self._row[key] = row
                self._next[hw] = row + 1
                self._boxes[key] = np.array(boxes_np[i])
                inserted.append(key)
            rows[i] = row
        rows_dev = to_device(rows, parts_dev[0].device)
        for bank, part in zip(self._banks[hw], parts_dev):
            _bank_scatter(bank, rows_dev, part)

    def has(self, hw: Tuple[int, int], lines: Sequence[str]) -> bool:
        hw = tuple(hw)
        if hw not in self._banks or hw in self._uncacheable:
            return False
        return all((line, hw) in self._row for line in lines)

    def gather_args(self, hw: Tuple[int, int], lines: Sequence[str],
                    max_boxes: int):
        """(banks tuple, row idx ``[B]`` int64, boxes ``[B, max_boxes, 5]``
        float32), the last two numpy."""
        hw = tuple(hw)
        idx = np.asarray([self._row[(line, hw)] for line in lines],
                         np.int64)
        boxes = np.zeros((len(lines), max_boxes, 5), np.float32)
        for i, line in enumerate(lines):
            boxes[i] = self._boxes[(line, hw)]
        return self._banks[hw], idx, boxes


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
                 device_cache_budget: int = 4 << 30,
                 device_cache_ledger: Optional[Dict[str, int]] = None,
                 link_format: str = 'auto',
                 device=None):
        self.augment_cfg = dict(augment or {})
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
            link_format=link_format, device=self.device)
        self.drop_remainder = drop_remainder
        self.multi_anchor_assign = multi_anchor_assign
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == 'cuda' else None)
        # the device image bank: from epoch 2 on, batches gather on the
        # device; ``device_cache_ledger`` shares one byte budget between
        # generators (the trainer's train and validation ones)
        self._dcache = (_DeviceImageCache(len(self.lines),
                                          device_cache_budget,
                                          ledger=device_cache_ledger)
                        if cache_images_device else None)

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
        """Start the host-to-device copy of a batch's parts (parts already
        on the device pass through); returns the parts and the event the
        consumer waits on (None on the CPU).  The event follows everything
        queued on the copy stream so far: the producer decodes and
        letterboxes a JPEG batch there too."""
        def tensor(p):
            if isinstance(p, torch.Tensor):
                return p
            if self._copy_stream is None:
                return torch.from_numpy(np.ascontiguousarray(p))
            return to_device(np.ascontiguousarray(p), self.device)
        if self._copy_stream is None:
            return tuple(tensor(p) for p in pixels), None
        with torch.cuda.stream(self._copy_stream):
            parts = tuple(tensor(p) for p in pixels)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return parts, event

    def _load(self, batch_lines, hw):
        """The loader's batch and its upload: on the card the loader's
        decode, letterbox and copies run on the copy stream."""
        if self._copy_stream is None:
            pixels, boxes = self.loader.load_batch(batch_lines, hw)
        else:
            with torch.cuda.stream(self._copy_stream):
                pixels, boxes = self.loader.load_batch(batch_lines, hw)
        if not isinstance(pixels, tuple):
            pixels = (pixels,)
        return self._upload(pixels), boxes

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
        or the loader's parts tuple, numpy or tensors on the device.
        Returns ``(images, y_true, boxes)`` with the boxes after
        augmentation, on the device."""
        hw = tuple(input_hw or self.input_shape)
        if not isinstance(pixels, tuple):
            pixels = (pixels,)
        if not isinstance(pixels[0], torch.Tensor):
            pixels = self._ready(*self._upload(pixels))
        images, y_true, boxes = _device_stage(
            pixels, boxes, split_generator(self.generator), self.augment_cfg,
            self.anchors, self.num_classes, hw, self.train,
            self.multi_anchor_assign)
        return images, y_true, to_device(boxes, self.device)

    def _prefetched(self):
        """A producer thread loads, letterboxes and starts the copy of the
        next batches while the device runs the current one.  Yields
        ``((parts, event), boxes, batch_lines, hw)``, or ``(None, None,
        batch_lines, hw)`` when every image of the batch is in the device
        bank (no host load then); an error in the producer is raised in
        the consumer."""
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
                    if (self._dcache is not None
                            and self._dcache.has(hw, batch_lines)):
                        q.put((None, None, batch_lines, hw))
                        continue
                    upload, boxes = self._load(batch_lines, hw)
                    q.put((upload, boxes, batch_lines, hw))
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

    def _host_batch(self, upload, boxes, batch_lines, hw):
        """The streamed batch's parts, ordered after their copy, and
        written into the bank when there is one."""
        parts = self._ready(*upload)
        if self._dcache is not None:
            self._dcache.add_batch(hw, batch_lines, parts, boxes)
        return parts

    def __iter__(self):
        """Iterate processed batches ``(images, y_true, boxes)``."""
        for upload, boxes, batch_lines, hw in self._prefetched():
            if upload is None:
                yield self._process_batch_from_bank(batch_lines, hw)
                continue
            yield self.process_batch(
                self._host_batch(upload, boxes, batch_lines, hw), boxes, hw)

    def iter_raw(self):
        """Iterate raw batches for a fused train step: yields
        ``('host', parts, boxes, hw, generator)`` with ``parts`` the
        link-format tuple on the device (copy ordered before the caller's
        work), or ``('bank', banks, idx, boxes, hw, generator)`` when every
        image of the batch is in the device bank (``banks`` the per-part
        bank tuple, ``idx`` the numpy rows); ``boxes`` numpy ``[B,
        max_boxes, 5]`` and the batch's own ``torch.Generator``."""
        for upload, boxes, batch_lines, hw in self._prefetched():
            gen = split_generator(self.generator)
            if upload is None:
                banks, idx, boxes = self._dcache.gather_args(
                    hw, batch_lines, self.max_boxes)
                yield ('bank', banks, idx, boxes, hw, gen)
                continue
            yield ('host', self._host_batch(upload, boxes, batch_lines, hw),
                   boxes, hw, gen)

    def _process_batch_from_bank(self, batch_lines: Sequence[str],
                                 input_hw: Tuple[int, int]):
        """A banked batch: gather the rows on the device, augment, encode."""
        hw = tuple(input_hw)
        banks, idx, boxes = self._dcache.gather_args(hw, batch_lines,
                                                     self.max_boxes)
        images, y_true, boxes = _device_stage_bank(
            banks, idx, boxes, split_generator(self.generator),
            self.augment_cfg, self.anchors, self.num_classes, hw, self.train,
            self.multi_anchor_assign)
        return images, y_true, to_device(boxes, self.device)

    def close(self):
        self.loader.close()
