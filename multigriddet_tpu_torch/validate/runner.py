"""One training loop and one scoring loop for every learning validation.

Counterpart of the loops of ``tools/validate_{learning,flagship,presets,
anchor_prediction}.py``.  A :class:`Task` holds one tool's settings; the
loop is the tool's own:

* **Training:** the port's ``MultiGridDataGenerator`` (on the card it
  reads the JPEGs through nvJPEG and the ``csrc/jpeg.cu`` kernels), a
  model from ``create_model`` with flax's initializers (``init_flax_like``,
  seed 0) or given flax variables, ``create_train_state``,
  ``make_train_step`` and ``LossConfig``.  The optimizer is Adam (optax's
  defaults: betas 0.9 / 0.999, epsilon 1e-8) under
  ``warmup_cosine_decay_schedule(1e-5, 1e-3, 3 * spe, epochs * spe,
  1e-6)``, or at a constant rate where the tool uses one.  With
  ``ema_decay`` the step keeps EMA weights.
* **Scoring:** Pillow's ``letterbox_image`` on the host feeds
  ``make_infer_step`` with the tool's ``confidence``, ``max_boxes`` and
  ``pre_nms_top_k``, in chunks of the tool's size (the last one unpadded,
  or padded by repeating its final image, as the tool does), and
  ``calculate_map`` scores the detections against the annotation.  Like
  the tools, it scores the images it trained on, with no augmentation.

Every step's loss stays on the device until the end of training; the
loop fetches one loss every ``log_every`` epochs to print it, as the
tools do.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.builder import (create_optimizer_from_config, init_flax_like,
                              warmup_cosine_decay_schedule)
from ..data import (MultiGridDataGenerator, letterbox_image,
                    load_annotation_lines, parse_annotation_line)
from ..device import resolve_device
from ..evaluation import calculate_map, format_results
from ..losses import LossConfig
from ..models import create_model, load_flax_variables
from ..training import (TrainState, count_params, create_train_state,
                        fetch_detections, make_infer_step, make_train_step)
from . import datasets


def _anchor_set(base: float) -> np.ndarray:
    """Three anchors of aspect 0.5, 1 and 2 around ``base`` pixels."""
    return np.array([[base * 0.71, base * 1.41], [base, base],
                     [base * 1.41, base * 0.71]], np.float32)


SHAPES_ANCHORS = (np.array([[96, 96]], np.float32),
                  np.array([[56, 56]], np.float32),
                  np.array([[28, 28]], np.float32))
SHAPES_AUGMENT = {'enabled': True, 'mosaic_prob': 0.2, 'mixup_prob': 0.0,
                  'hflip_prob': 0.5, 'scale_range': (0.85, 1.15),
                  'rotate_prob': 0.0, 'grayscale_prob': 0.0}
SHAPES_LOSS = {'loss_option': 2, 'coord_scale': 5.0, 'no_object_scale': 0.5,
               'label_smoothing': 0.01}


@dataclasses.dataclass(frozen=True)
class Task:
    """One validation's settings (the names are the tools')."""

    name: str
    model: str                      # registry name
    dataset: str                    # a key of ``datasets.SETS``
    anchors: Tuple[np.ndarray, ...]
    num_classes: int
    epochs: int
    loss: Dict
    hw: Tuple[int, int] = (256, 256)
    batch_size: int = 16
    max_boxes: int = 8
    augment: Dict = dataclasses.field(
        default_factory=lambda: dict(SHAPES_AUGMENT))
    lr: Optional[float] = None      # constant Adam; None: warmup cosine
    dtype: torch.dtype = torch.bfloat16
    bn_momentum: Optional[float] = 0.9   # None: the model's default
    multi_anchor: bool = False
    cache_images: bool = False
    shuffle_lines: bool = True      # load_annotation_lines' default
    log_every: int = 10
    confidence: float = 0.25
    score_max_boxes: int = 12
    pre_nms_top_k: int = 128
    score_batch: int = 16
    pad_last: bool = False
    iou_thresholds: Optional[Tuple[float, ...]] = None   # None: COCO's
    pass_map50: Optional[float] = None
    results_table: bool = False     # print format_results' table

    @property
    def num_anchors(self) -> Tuple[int, ...]:
        return tuple(len(a) for a in self.anchors)


# tools/validate_learning.py
LEARNING = Task(
    name='learning', model='multigriddet_tiny', dataset='boxes',
    anchors=(np.array([[48, 48]], np.float32),
             np.array([[24, 24]], np.float32),
             np.array([[12, 12]], np.float32)),
    num_classes=2, epochs=600,
    loss={'loss_option': 2, 'coord_scale': 5.0, 'no_object_scale': 0.5},
    hw=(128, 128), batch_size=8, max_boxes=4, augment={'enabled': False},
    lr=2e-3, dtype=torch.float32, bn_momentum=None, shuffle_lines=False,
    log_every=100, confidence=0.15, score_max_boxes=10, pre_nms_top_k=64,
    score_batch=1, iou_thresholds=(0.5,), pass_map50=0.95)

# tools/validate_flagship.py
FLAGSHIP = Task(name='flagship', model='multigriddet_darknet',
                dataset='shapes', anchors=SHAPES_ANCHORS, num_classes=4,
                epochs=120, loss=SHAPES_LOSS, results_table=True)

# tools/validate_presets.py: multi_anchor is csp trained on multi-anchor
# assigned targets (an opt-in: it doubles the csp budget)
PRESET_MODELS = {'csp': 'multigriddet_csp_darknet',
                 'panet': 'multigriddet_darknet_panet',
                 'resnet': 'multigriddet_resnet',
                 'mobile': 'multigriddet_mobile',
                 'multi_anchor': 'multigriddet_csp_darknet'}
PRESETS = {key: dataclasses.replace(
    FLAGSHIP, name=key, model=model, epochs=60, log_every=20,
    multi_anchor=key == 'multi_anchor', pass_map50=0.7, results_table=False)
    for key, model in PRESET_MODELS.items()}
DEFAULT_PRESETS = ('csp', 'panet', 'resnet', 'mobile')

# tools/validate_anchor_prediction.py
ANCHORS = Task(
    name='anchors', model='multigriddet_darknet', dataset='anchor_bands',
    anchors=(_anchor_set(96), _anchor_set(56), _anchor_set(28)),
    num_classes=2, epochs=120,
    loss={'loss_option': 2, 'coord_scale': 5.0, 'no_object_scale': 0.5,
          'anchor_scale': 1.0},
    max_boxes=4,
    augment={'enabled': True, 'mosaic_prob': 0.0, 'mixup_prob': 0.0,
             'hflip_prob': 0.5, 'scale_range': (0.9, 1.1),
             'rotate_prob': 0.0, 'grayscale_prob': 0.0},
    cache_images=True, log_every=30, score_max_boxes=8, pad_last=True)

EMA_DECAY = 0.999       # tools/validate_flagship.py --ema
# the tools' warmup; the cosine after it needs at least one more epoch
WARMUP_EPOCHS = 3
MIN_SCHEDULED_EPOCHS = WARMUP_EPOCHS + 1


@dataclasses.dataclass
class Trained:
    """What :func:`train` leaves: the state (model, optimizer, EMA), every
    step's loss and anchor loss, every update's learning rate, the mean
    loss of each epoch, and the wall time of the loop."""

    task: Task
    state: TrainState
    losses: List[float]
    anchor_losses: List[float]
    lrs: List[float]
    epoch_losses: List[float]
    seconds: float
    images: int


def build_model(task: Task, device, variables=None, seed: int = 0):
    """The task's model on ``device`` in train mode: flax's initializers
    (seeded), or the given flax ``(params, batch_stats)``."""
    kw = {'num_anchors': task.num_anchors, 'num_classes': task.num_classes,
          'dtype': task.dtype}
    if task.bn_momentum is not None:
        kw['bn_momentum'] = task.bn_momentum
    model = create_model(task.model, **kw)
    if variables is None:
        init_flax_like(model, seed)
    else:
        load_flax_variables(model, *variables)
    return model.to(device).train()


def learning_rate(task: Task, steps_per_epoch: int):
    """The tool's schedule of the update count (a 3-epoch warmup, so a run
    needs at least ``MIN_SCHEDULED_EPOCHS``), or its constant rate."""
    if task.lr is not None:
        return float(task.lr)
    return warmup_cosine_decay_schedule(
        1e-5, 1e-3, WARMUP_EPOCHS * steps_per_epoch,
        task.epochs * steps_per_epoch, 1e-6)


def train(task: Task, lines: Sequence[str], device=None,
          ema_decay: Optional[float] = None, variables=None,
          log: Callable[[str], None] = print) -> Trained:
    """Train ``task``'s model on ``lines`` for ``task.epochs`` epochs."""
    dev = resolve_device(device)
    gen = MultiGridDataGenerator(
        lines, task.anchors, task.num_classes, task.hw,
        batch_size=task.batch_size, max_boxes=task.max_boxes,
        augment=task.augment, train=True, seed=0,
        multi_anchor_assign=task.multi_anchor,
        cache_images=task.cache_images, device=dev)
    model = build_model(task, dev, variables)
    opt = create_optimizer_from_config(
        {'optimizer': {'type': 'adam', 'epsilon': 1e-8}},
        model.parameters(), learning_rate(task, len(gen)))
    state = create_train_state(model, opt, ema=ema_decay is not None)
    step = make_train_step(task.anchors, task.num_classes, task.hw,
                           LossConfig(**task.loss), ema_decay=ema_decay)
    losses, anchor, lrs, per_epoch = [], [], [], []
    images = 0
    t0 = time.perf_counter()
    try:
        for epoch in range(task.epochs):
            first = len(losses)
            for batch, y_true, _ in gen:
                state, m = step(state, batch, y_true)
                losses.append(m['loss'])
                anchor.append(m['anchor'])
                lrs.append(opt.lr)
                images += batch.shape[0]
            per_epoch.append(torch.stack(losses[first:]).mean())
            if epoch % task.log_every == 0:
                extra = (f' anchor={float(anchor[-1]):.4f}'
                         if 'anchor_scale' in task.loss else '')
                log(f'  {task.name} epoch {epoch} loss '
                    f'{float(losses[-1]):.3f}{extra} '
                    f'({time.perf_counter() - t0:.0f}s)')
        losses = torch.stack(losses).float().cpu().tolist()
        seconds = time.perf_counter() - t0
    finally:
        gen.close()
    return Trained(task=task, state=state, losses=losses,
                   anchor_losses=torch.stack(anchor).float().cpu().tolist(),
                   lrs=lrs,
                   epoch_losses=torch.stack(per_epoch).float().cpu().tolist(),
                   seconds=seconds, images=images)


def ema_model(state):
    """A copy of the trained model holding the EMA weights (and the raw
    model's BatchNorm statistics, as the flagship tool scores them)."""
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return model


def ground_truth(boxes: np.ndarray) -> Dict[str, np.ndarray]:
    """Annotation boxes ``[M, 5]`` x1y1x2y2cls as ``calculate_map`` takes
    them: top-left ``(x, y, w, h)`` and classes."""
    return {'boxes': np.stack([boxes[:, 0], boxes[:, 1],
                               boxes[:, 2] - boxes[:, 0],
                               boxes[:, 3] - boxes[:, 1]], -1),
            'classes': boxes[:, 4].astype(np.int32)}


def scoring_batches(task: Task, lines: Sequence[str]):
    """Yield ``(start, canvases u8 [n, H, W, 3], annotation boxes)`` per
    chunk of ``task.score_batch`` lines, padded by repeating the last
    image where the tool pads."""
    from PIL import Image
    for start in range(0, len(lines), task.score_batch):
        arrs, metas = [], []
        for line in lines[start:start + task.score_batch]:
            path, boxes = parse_annotation_line(line)
            with Image.open(path) as im:
                arrs.append(letterbox_image(im.convert('RGB'), task.hw)[0])
            metas.append(boxes)
        if task.pad_last:
            arrs += [arrs[-1]] * (task.score_batch - len(arrs))
        yield start, np.stack(arrs), metas


def score(model, task: Task, lines: Sequence[str], device=None,
          nms_backend: str = 'xla'):
    """The tool's scoring loop.  Returns ``(calculate_map's results, the
    fetched detections of each chunk, padding included)``."""
    dev = resolve_device(device)
    model.eval()
    infer = make_infer_step(model, task.anchors, task.hw,
                            confidence=task.confidence,
                            max_boxes=task.score_max_boxes,
                            pre_nms_top_k=task.pre_nms_top_k,
                            nms_backend=nms_backend)
    preds, gts, chunks = {}, {}, []
    for start, batch, metas in scoring_batches(task, lines):
        bx, cl, sc, valid = fetch_detections(
            infer(torch.from_numpy(batch).to(dev)))
        chunks.append((bx, cl, sc, valid))
        for j, boxes in enumerate(metas):
            k = valid[j]
            preds[start + j] = {'boxes': bx[j][k],
                                'classes': cl[j][k].astype(np.int32),
                                'scores': sc[j][k]}
            gts[start + j] = ground_truth(boxes)
    kw = ({} if task.iou_thresholds is None
          else {'iou_thresholds': list(task.iou_thresholds)})
    return calculate_map(preds, gts, task.num_classes, **kw), chunks


@dataclasses.dataclass
class Run:
    """One validation run: the JSON-able ``result``, the trained state,
    and each scored backend's detections per chunk."""

    result: Dict
    trained: Trained
    detections: Dict[str, list]


def run(task: Task, ann: str, device=None, nms_backend: str = 'xla',
        ema: bool = False, log: Callable[[str], None] = print) -> Run:
    """Train and score one task on the set written at ``ann``.

    The weights are scored through ``nms_backend`` and, on the card, a
    second time through ``pallas_fused`` (the pop-max kernel); with
    ``ema`` the EMA weights are scored too."""
    dev = resolve_device(device)
    train_lines = load_annotation_lines(ann, shuffle=task.shuffle_lines)
    trained = train(task, train_lines, dev,
                    ema_decay=EMA_DECAY if ema else None, log=log)
    lines = load_annotation_lines(ann, shuffle=False)
    backends = [nms_backend]
    if dev.type == 'cuda' and nms_backend != 'pallas_fused':
        backends.append('pallas_fused')
    weights = [('raw', trained.state.model)]
    if ema:
        weights.append((f'ema@{EMA_DECAY}', ema_model(trained.state)))
    scores: Dict[str, Dict] = {}
    detections: Dict[str, list] = {}
    t0 = time.perf_counter()
    for tag, model in weights:
        for backend in backends:
            r, chunks = score(model, task, lines, dev, backend)
            key = backend if tag == 'raw' else f'{tag}/{backend}'
            scores[key] = {'mAP50': float(r['mAP50']),
                           'mAP': float(r['mAP'])}
            detections[key] = chunks
            if task.results_table and backend == nms_backend:
                log(format_results(r))
            log(f'{task.name.upper()}[{tag}] mAP50: {r["mAP50"]} mAP: '
                f'{r["mAP"]} (nms_backend {backend})')
    main = scores[nms_backend]
    result = {
        'task': task.name, 'model': task.model,
        'params': count_params(trained.state.model),
        'epochs': task.epochs,
        'steps': len(trained.losses), 'images': trained.images,
        'seconds': trained.seconds,
        'images_per_s': trained.images / trained.seconds,
        'score_seconds': time.perf_counter() - t0,
        'final_loss': trained.losses[-1],
        'final_anchor_loss': trained.anchor_losses[-1],
        'epoch_losses': trained.epoch_losses,
        'mAP50': main['mAP50'], 'mAP': main['mAP'], 'scores': scores,
        'nms_backend': nms_backend, 'device': str(dev)}
    anchor = (f', anchor loss {result["final_anchor_loss"]:.4f}'
              if 'anchor_scale' in task.loss else '')
    log(f'{task.name} ({task.model}): {result["params"] / 1e6:.1f}M '
        f'params, final loss {result["final_loss"]:.3f}{anchor}, '
        f'mAP50={main["mAP50"]:.3f}, mAP={main["mAP"]:.3f} '
        f'({nms_backend}); ' +
        ''.join(f'{k} mAP50={v["mAP50"]:.3f} mAP={v["mAP"]:.3f}; '
                for k, v in scores.items() if k != nms_backend) +
        f'{task.epochs} epochs, {trained.seconds:.1f} s, '
        f'{result["images_per_s"]:.1f} img/s')
    return Run(result=result, trained=trained, detections=detections)


def write_set(task: Task, root: str) -> str:
    """Write the task's dataset under ``root``; returns its annotation
    file."""
    return datasets.SETS[task.dataset](root)
