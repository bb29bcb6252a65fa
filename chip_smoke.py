#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py [--report PATH]

1. Card and build: prints the card's name and power limit, builds the CUDA
   kernels from ``multigriddet_tpu_torch/csrc`` with nvcc for sm_90a.
2. Kernels against their plain PyTorch versions at the serving shapes
   (B = 8, N = 7,581 candidates, 80 classes, exact-tie armies): pop-max NMS
   for (standard, IoU), (standard, IoL), (diou, IoL), all below confidence,
   pools of N = 63 and 65 (exhausted: more slots than survivors), N = 9,261
   (the @672 pool), an army of 1,000 identical boxes at the top of the
   order, 3,000 equal top scores, filtered scores in (NEG, NEG/2] that the
   tail repeats, and a pool above the kernel's capacity (must raise);
   pop-max at the evaluator's 500 keeps on the served-shape pool at
   confidence 0.1, 0 and 0.9 (exhausted) and on the @672 pool, for
   (diou, IoL) and (standard, IoU); greedy NMS at K = 64 (with valid
   holes), 1,024 and K = N, all invalid.  Equal valid masks, order and
   classes; boxes and scores bit-equal, tail slots included.
3. Serve: ``MultiGridInference`` from a config dict (multigriddet_darknet,
   608x608, 80 classes, COCO anchors, bfloat16, seeded random weights
   through the flax weight bridge, confidence 0 so the pool is full), four
   batches of eight letterboxed uint8 images for each NMS backend:
   ``pallas_fused`` (pop-max kernel), ``pallas`` (greedy kernel) and
   ``xla`` (PyTorch cluster NMS).  Launch counters are zeroed before each
   backend's run and read after it.
4. Float32 forward parity: one image through Darknet53 + head on the card
   (TF32 off) against the same weights on the CPU.
5. Times, with CUDA events after warm-up, of the serve step and of each
   kernel at the serving shapes (a kernel's ``ms`` with the stream held
   until all its calls are enqueued, so it is the card's time alone), and
   of the pop-max kernel on an army of 1,000 identical boxes at the top of
   the order and on a pool of identical boxes (its worst case: one sweep
   step per 64 candidates).
6. Evaluate: ``MultiGridEvaluator._evaluate_batches`` on the same model
   with the evaluator's settings (confidence 0.1, DIoU/IoL 0.45, 500
   detections, rgb link) over 8 batches of 8 letterboxed 640x480 frames,
   against ground truth made by the plain pop-max on the same pools:
   ``pallas_fused`` predictions bit-equal to it and mAP@[.5:.95] = 1 over
   boxes at least 0.1 px a side, one pop-max launch per batch; ``pallas``
   (one greedy call per batch), ``xla`` and a yuv420 run give in-range
   detections and their mAP; ``calculate_map`` equal through the native
   matcher and numpy; one ``detection.use_wbf`` serve batch equal to
   ``fuse_and_cap`` over its candidates; eval images/s and metrics seconds
   per backend, and the pop-max kernel timed at 500 keeps.
7. Train: (a) one fused train step of ``multigriddet_darknet`` at full
   width in float32 (TF32 off), b2 @416, on the card and on the CPU from
   the same seeded weights and batch, with the loss settings of
   ``configs/train_config.yaml``: the encoder's discrete fields equal and
   its offsets and the images within 1e-6; loss terms and running
   statistics within 1e-4 relative; the step in float64 from identical
   images and targets, every gradient within 1e-6 of its tensor's largest
   |grad| (in float32 the gradients are rounding noise at this init,
   reported beside it); (b) the augmented device stage (b8 @608, yuv420)
   on the card against the CPU from one seed, for the train config's
   augmentation block (mosaic 0.3, mixup 0.1) and for a block with every
   optional op on (gridmask, copy-paste, blur, sharpness, motion blur,
   free rotation): images within 1e-3 on the 0-255 scale, boxes within
   1e-3 px with the same slots zeroed, targets' offsets within 1e-4, and
   the chain's invariants on the card (capacity, boxes inside the canvas
   and at least 3 px a side, mixup keeping every valid box); (c)
   ``MultiGridTrainer(config).train()`` at 608, bfloat16, b8, Adam 1e-4
   with a 1-epoch cosine warmup, the train config's augmentation block,
   ``cache_images_device: true``, the yuv420 link, 2 epochs of 6 steps
   over 48 synthetic letterboxed frames with 1-30 boxes each (fed through
   the loader's ``.npy`` disk cache, so the phase needs no decoder) and
   validation on 16: epoch 1 streamed and epoch 2 from the device bank,
   a bank gather bit-equal to the host path, one byte ledger for the
   train and validation banks, finite history, no NMS launch, a
   checkpoint restored into a fresh state, and ``final_model.msgpack``
   served by ``MultiGridInference``; the same run without the bank for
   the streamed epoch-2 rate; (d) 40 fused steps on one batch must halve
   the loss; (e) the fused step's time, img/s and peak memory at b8 @608
   bf16 with augmentation off and on, the device stage alone (augment +
   encode) off and on, its parts alone (encode, forward + loss,
   backward, optimizer) with CUDA events, 20 steps after 3 warm-up, on a
   resident batch, and the ops the encoder launches, also at mosaic's
   box counts.
8. Overfit: the ``learning`` mode of ``multigriddet_tpu_torch.validate``
   (``tools/validate_learning.py`` on the card): the tool's 16 PIL-written
   128x128 JPEGs of two classes, read through nvJPEG; ``multigriddet_tiny``
   trains 600 epochs at b8, then the tool's scoring loop (the fused infer
   step, ``calculate_map``) scores it through ``xla`` and ``pallas_fused``:
   mAP50 must reach 0.9 on both.  The run must launch ``ycc_to_rgb`` and
   ``letterbox_yuv420`` (its input path, counted into the kernels line);
   both are then held bit-equal to their plain versions on a batch of the
   set's own files at 128.

9. Zoo: each preset beyond Darknet53 (``multigriddet_darknet_spp``,
   ``_darknet_lite``, ``_csp_darknet``, ``_darknet_panet``, ``_resnet``,
   ``_mobile``) and one ``model.type: custom`` composition (ResNet-101 +
   ``multigrid_fpn`` + ``multigrid_lite``), at full width (80 classes, COCO
   anchors, 608x608, bfloat16 convs, seeded random weights): (a) two
   batches of eight served through ``MultiGridInference`` with
   ``pallas_fused``, one pop-max launch a batch, batch 0 bit-equal to the
   plain pop-max on the same pool, the step timed; (b) the float32
   forward at b1 (TF32 off) within ``F32_PARITY_RTOL`` of the CPU's; (c)
   one fused train step (Adam, augmentation off) with a finite loss and
   every running variance moved, then its time and peak memory at b8;
   (d) float64 gradients at b2 @128 within ``GRAD64_RTOL`` of the CPU's.
   Then ``environment.remat`` on ``multigriddet_darknet``: ``True`` and
   ``'full'`` each give the plain step's loss, gradients, parameters and
   running statistics (float32, b2 @416, deterministic cuDNN, one SGD
   step), and the step's time and peak memory at b8 @608 bf16 for plain,
   ``True`` and ``'full'``.

10. Export: ``export_serving`` of ``multigriddet_darknet`` at 608 bf16 on
    the card (``xla`` NMS, programs for b1 and b8; export seconds and MB),
    ``ServingModel`` serving four batches of 8, one of 3 (padded), one of
    11 (chunked) and one image, each against the live step with
    ``cudnn.benchmark`` off (classes and valid masks equal, boxes and
    scores within 2e-5), the served b8 step (under ``inference_mode``, as
    ``ServingModel`` runs it, and under ``no_grad``) beside the live
    ``xla`` step, both profiled with the host ops the served one adds,
    and a ``multigriddet_tiny`` artifact traced on the CPU served on the
    card against the live step there.
11. Data parallel: (a) two ranks on the one card, gloo on CUDA tensors,
    ``multigriddet_darknet`` at 416 (TF32 off), global b4, two SGD steps,
    against one process on the concatenated batch: the float32 first
    step's loss terms within ``DP_RTOL``, and in float64 the steps' loss
    terms, running statistics and parameters within ``DP_RTOL64``; one
    process in float32 against one in float64 on the same steps, printed
    (float32's own rounding after an update at this init); the same two
    ranks on ``DP_TINY`` (``multigriddet_tiny`` @64, same LR) in float32,
    loss terms, statistics and parameters after the steps within
    ``DP_RTOL``; a rank's float32 step and its gradient all-reduce timed;
    (b) one NCCL process at world size 1, switched on by
    ``environment.distributed`` and named by torchrun's variables, one
    step; (c) ``MultiGridTrainer.train()`` on two gloo ranks for one epoch
    (8 frames, global b4): equal losses, one ``history.jsonl`` line and
    ``final_model.msgpack`` written by rank 0 alone.  The ranks are this
    script run with ``--dp-child``.
12. Spatial partition: two gloo ranks on the one card as a dp1 x sp2
    mesh (``parallel/spatial.py``: image rows banded, row exchanges with a
    backward, global BatchNorm and loss), ``multigriddet_darknet`` at 608
    (its stride-32 map's 19 rows band as 10 and 9), global b2, TF32 off,
    the train config's loss, against one process on the whole canvas:
    float64 loss terms, running statistics and parameters after two SGD
    steps within ``SP_RTOL64``; the float32 first step's loss terms and
    the infer step's gathered head maps within ``SP_RTOL``; the infer
    step's ``pallas_fused`` detections (pop-max kernel, launches counted
    on both ranks) from the float64 forward equal; a rank's step, the row
    exchanges' share of it (forward and backward) and each rank's peak
    memory against one process at the same global batch.  The ranks are
    this script run with ``--sp-child``.

13. JPEG files: (a) ``csrc/jpeg.cu`` built with the other sources (its
    ptxas lines), nvJPEG's version and the backends the card offers (the
    decode uses the default one: Huffman on the host, IDCT on the card;
    the hardware backend, the only one that scales in the DCT domain, is
    refused here); (b) every fixture of ``tests/fixtures/jpeg/`` and
    ``examples/images/dog.jpg`` decoded by nvJPEG and letterboxed by both
    kernels at 608, 416, 128 and 64: bit-equal to the plain versions on
    the same decoded pixels, metas and ok equal to fastloader's recorded
    ones (``letterbox_ref.npz``), rejected slots gray, the pad gray, and
    the mean |dRGB| at fastloader's recorded sample positions under
    ``JPEG_MEAN_BOUND`` per image (printed with p99, max, Y and CbCr, and
    the mean over every pixel of the content's border, where odd sizes
    and MCU overhang show);
    the decode's ms an image and each kernel's ms a b8 batch @608 beside
    its plain version, its bound and ``F.interpolate`` + pad; (c) 64
    annotation lines over the 640x480 fixtures: ``MultiGridTrainer`` for
    2 epochs (train config augmentation, yuv420 link) streamed from the
    files and then from the ``.npy`` disk cache that the card's loader
    fills (a cached batch bit-equal to a decoded one), the evaluator from
    the files (predictions equal to ``_evaluate_batches`` on the same
    canvases in memory) and ``detect_files`` in rgb and yuv420, each
    profiled: images/s and the device's busy share; then a batch of
    JPEGs and one PNG through the loader and ``detect_files``, whose
    JPEG slots must equal an all-JPEG batch's; the letterbox launch
    counts of (c) go into the kernels line.

14. Validate: ``python -m multigriddet_tpu_torch.validate`` at a cut
    budget: the ``flagship`` mode (``multigriddet_darknet``, bfloat16, the
    tools' 200-image shapes set through nvJPEG with mosaic, flips and
    zoom, Adam under the warmup cosine) for 6 epochs and ``presets
    mobile`` for 4 (the tools' 3-epoch warmup and one more), each scored
    by the tools' loop through ``xla`` and ``pallas_fused``: the loss
    falls, both mAPs are printed, and the ``pallas_fused`` detections of
    every scored chunk equal the plain pop-max on the trained weights'
    pool.  Each run must launch ``ycc_to_rgb`` and ``letterbox_yuv420``
    (counted into the kernels line); both are then held bit-equal to
    their plain versions on a batch of the set's own files at 256.  The
    full budgets (120 and 60 epochs) are the module's own commands.

``--step-times CHECKOUT ...`` only times the darknet serve and train
steps of the port in each checkout given, one process each, and exits:
the way to compare two commits on one card (parent, change, change,
parent).

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when there is no GPU or any phase fails.  Needs no YAML or msgpack;
phases 8 and 14 draw their sets and letterbox the scored images with
Pillow, as the JAX tools do.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
B, HW, NUM_CLASSES, MAX_BOXES = 8, (608, 608), 80, 100
N_POOL = sum((HW[0] // s) * (HW[1] // s) for s in (32, 16, 8))   # 7,581
SERVE_BATCHES = 4
CONF, THR = 0.05, 0.45
# H100 SXM data-sheet peaks (dense, 700 W): HBM rate, float32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per (box i, candidate j) pair of the overlap test in
# csrc/nms.cu (adds, multiplies, divides, min/max, the >= test); the
# pop-max pass adds 2 for its running argmax
PAIR_OPS = {('standard', False): 17, ('standard', True): 16,
            ('diou', False): 38, ('diou', True): 37}
# forward parity on the card, float32 with TF32 off, against the CPU:
# different conv algorithms sum in different orders (~1e-6 relative)
F32_PARITY_RTOL = 1e-4
# the evaluator's settings (configs/eval_config.yaml): confidence 0.1,
# 500 detections per image; 8 batches of 8 letterboxed 640x480 frames
EVAL_CONF, EVAL_MAX_BOXES, EVAL_BATCHES = 0.1, 500, 8
FRAME_HW = (480, 640)
KERNEL_SOURCES = ('nms.cu', 'jpeg.cu')


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean ms per call between CUDA events around ``reps`` calls.

    ``queued``: hold the stream behind a sleep kernel (~0.1 s) while the
    host enqueues the calls, so the events time the device's work alone,
    back to back, without the wrapper's host time between launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_pool(dev, seed, n=N_POOL):
    """Boxes on a 608 canvas, scores with exact-tie armies, 80 classes."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    m = max(n, 2200)                  # room for the armies, then cut to n
    xy = rng.rand(B, m, 2) * 560
    wh = rng.rand(B, m, 2) * 120 + 4
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    scores = rng.rand(B, m).astype(np.float32)
    scores[:, 500:600] = scores[:, 400:500]       # tie armies
    scores[:, 1000:1300] = scores[:, :1][:, [0] * 300]
    boxes[:, 2000:2100] = boxes[:, 2100:2200]     # duplicate boxes
    boxes, scores = boxes[:, :n], scores[:, :n]
    classes = rng.randint(0, NUM_CLASSES, (B, n)).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (boxes, scores, classes))


def tie_pool(pool, size):
    """``pool`` with one top score shared by its first ``size`` candidates:
    more ties than the pop-max kernel's selected head holds."""
    boxes, scores, classes = (t.clone() for t in pool)
    scores[:, :size] = 1.0
    return boxes, scores, classes


def army_pool(pool, size):
    """``pool`` with its first ``size`` candidates one identical box at the
    top score: the kept list removes them chunk after chunk."""
    boxes, scores, classes = (t.clone() for t in pool)
    boxes[:, :size] = boxes[:, :1]
    scores[:, :size] = 1.0
    return boxes, scores, classes


def letterboxed_batches(count, seed):
    """Synthetic letterboxed uint8 batches: a smooth 608x456 picture (a
    640x480 frame scaled down) on the gray canvas."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        batch = np.full((B, *HW, 3), 128, np.uint8)
        low = rng.randint(0, 256, (B, 29, 38, 3)).astype(np.uint8)
        pic = np.repeat(np.repeat(low, 16, axis=1), 16, axis=2)[:, :456, :608]
        batch[:, 76:76 + 456] = pic
        out.append(batch)
    return out


# ---------------------------------------------------------------------------
# exact comparison of a kernel with its plain version
# ---------------------------------------------------------------------------

def compare_popmax(got, want, method, use_iol, label):
    """Raise unless the two results are equal; returns max |diff| under
    valid.  On a differing keep decision, prints the pair's overlap."""
    import torch
    from multigriddet_tpu_torch.ops.cuda_nms import overlap_rows
    gb, gc, gs, gv = got
    wb, wc, ws, wv = want
    if not torch.equal(gv, wv):
        bad = torch.nonzero(gv != wv)[0].tolist()
        b_, i = bad
        log(f'[{label}] valid differs at image {b_} slot {i}')
        raise AssertionError(f'{label}: valid masks differ')
    v = wv
    if not torch.equal(gc[v], wc[v]) or not torch.equal(gb[v], wb[v]) \
            or not torch.equal(gs[v], ws[v]):
        diff = (gb != wb).any(-1) | (gs != ws) | (gc != wc)
        b_, i = torch.nonzero(diff & v)[0].tolist()
        for slot in range(i + 1):
            ov = overlap_rows(wb[b_, slot][None, None], gb[b_, i][None, None],
                              method, use_iol)[0, 0, 0].item()
            log(f'[{label}] image {b_}: plain slot {slot} vs kernel slot {i}'
                f' overlap {ov!r} (threshold {THR!r})')
        raise AssertionError(f'{label}: detections differ at image {b_} '
                             f'slot {i}')
    if not (torch.equal(gb, wb) and torch.equal(gc, wc)
            and torch.equal(gs, ws)):
        raise AssertionError(f'{label}: the invalid tail slots differ')
    err = max((gb[v] - wb[v]).abs().max().item() if v.any() else 0.0,
              (gs[v] - ws[v]).abs().max().item() if v.any() else 0.0)
    return err


def compare_greedy(got, want, boxes, method, use_iol, label):
    import torch
    from multigriddet_tpu_torch.ops.cuda_nms import overlap_rows
    if torch.equal(got, want):
        return 0.0
    b_, j = torch.nonzero(got != want)[0].tolist()
    kept = torch.nonzero(want[b_, :j])[:, 0]
    ov = overlap_rows(boxes[b_, kept][None], boxes[b_, j][None, None],
                      method, use_iol)[0, :, 0]
    worst = int(torch.argmax(ov))
    log(f'[{label}] image {b_} box {j}: kernel keep {bool(got[b_, j])}, '
        f'plain keep {bool(want[b_, j])}; largest overlap with an earlier '
        f'kept box {ov[worst].item()!r} (box {int(kept[worst])}, threshold '
        f'{THR!r})')
    raise AssertionError(f'{label}: keep masks differ')


# ---------------------------------------------------------------------------
# work the kernels' data needs (for the bound)
# ---------------------------------------------------------------------------

def popmax_pairs(boxes, scores, conf, thr, max_boxes, method, use_iol):
    """Pairs (winner, live candidate) the pop-max steps evaluate."""
    import torch
    from multigriddet_tpu_torch.ops.cuda_nms import NEG, overlap_rows
    b, n = scores.shape
    s = torch.where(scores >= conf, scores, torch.tensor(NEG,
                                                         device=scores.device))
    col = torch.arange(n, device=scores.device)
    rows = torch.arange(b, device=scores.device)
    pairs = 0
    for _ in range(max_boxes):
        alive = s > NEG / 2
        cur = s.amax(1)
        live = cur > NEG / 2
        if not bool(live.any()):
            break
        pairs += int(alive[live].sum())
        idx = torch.where(s == cur[:, None], col, n).amin(1)
        ov = overlap_rows(boxes[rows, idx][:, None], boxes, method,
                          use_iol)[:, 0]
        sup = ((ov >= thr) | (col == idx[:, None])) & live[:, None]
        s = torch.where(sup, torch.tensor(NEG, device=s.device), s)
    return pairs


def greedy_pairs(boxes, valid, keep, thr, method, use_iol):
    """Pairs (kept box i, later box j still kept at step i) the greedy
    sweep evaluates.  Box j is live at step i up to the first kept box
    that suppresses it."""
    import torch
    from multigriddet_tpu_torch.ops.cuda_nms import overlap_rows
    k = keep.shape[1]
    idx = torch.arange(k, device=keep.device)
    sup = ((overlap_rows(boxes, boxes, method, use_iol) >= thr)
           & keep[:, :, None] & (idx[:, None] < idx[None, :]))
    hit = sup.any(1)
    last = torch.where(hit, sup.int().argmax(1), idx - 1)   # last step
    kept_upto = torch.cumsum(keep.int(), 1)
    count = torch.where(last >= 0,
                        torch.gather(kept_upto, 1, last.clamp_min(0)), 0)
    return int(count[valid].sum())


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops
            else 'operations')


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Build every CUDA source at once (one nvcc each, started together);
    returns ``{source: build info}``."""
    from concurrent.futures import ThreadPoolExecutor
    from multigriddet_tpu_torch.ops import kernel_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        infos = dict(zip(KERNEL_SOURCES,
                         pool.map(kernel_build.build, KERNEL_SOURCES)))
    for source, info in infos.items():
        log(f'[build] {os.path.relpath(info["path"], REPO)}: nvcc '
            f'{info["seconds"]:.2f} s')
        for line in info['log'].splitlines():
            if 'registers' in line or 'Compiling entry' in line:
                log(f'[build] {line.strip()}')
    log(f'[build] {len(infos)} sources in {time.perf_counter() - t0:.2f} s')
    return infos


def phase_kernels(dev):
    import torch
    from multigriddet_tpu_torch.ops import cuda_nms
    errs = {'popmax_nms': 0.0, 'greedy_nms': 0.0}
    pool = make_pool(dev, SEED)
    for method, use_iol in (('standard', False), ('standard', True),
                            ('diou', True)):
        label = f'popmax {method} iol={use_iol}'
        got = cuda_nms.popmax_nms(*pool, CONF, THR, MAX_BOXES, method,
                                  use_iol)
        want = cuda_nms.popmax_nms_plain(*pool, CONF, THR, MAX_BOXES,
                                         method, use_iol)
        torch.cuda.synchronize()
        errs['popmax_nms'] = max(errs['popmax_nms'], compare_popmax(
            got, want, method, use_iol, label))
        log(f'[kernels] {label}: equal, {int(got[3].sum())} valid of '
            f'{got[3].numel()}')
    extra = [('n=63', make_pool(dev, SEED + 1, 63), CONF),
             ('n=65', make_pool(dev, SEED + 2, 65), CONF),
             ('n=9261 (@672)', make_pool(dev, SEED + 3, 9261), CONF),
             ('army of 1000', army_pool(pool, 1000), CONF),
             ('3000 equal top scores', tie_pool(pool, 3000), CONF)]
    bx, sc, cl = make_pool(dev, SEED + 4, 200)    # exhausted: ~80 live
    deep = torch.rand(sc.shape, generator=torch.Generator().manual_seed(4))
    sc = torch.where(deep.to(dev) < 0.6, -7e8 - sc * 1e8, sc)
    extra.append(('scores in (NEG, NEG/2]', (bx, sc, cl), -9e8))
    for name, p, conf in extra:
        label = f'popmax {name}'
        got = cuda_nms.popmax_nms(*p, conf, THR, MAX_BOXES)
        want = cuda_nms.popmax_nms_plain(*p, conf, THR, MAX_BOXES)
        torch.cuda.synchronize()
        errs['popmax_nms'] = max(errs['popmax_nms'], compare_popmax(
            got, want, 'diou', True, label))
        log(f'[kernels] {label}: equal, {int(got[3].sum())} valid of '
            f'{got[3].numel()}')
    # the evaluator's capacity: 500 keeps run the sweep past the selected
    # head into the full sort, on ordinary pools; at confidence 0.9 the
    # pool runs out before 500 keeps (the exhausted tail)
    at672 = make_pool(dev, SEED + 3, 9261)
    for name, p, conf in (('served pool, conf 0.1', pool, EVAL_CONF),
                          ('served pool, conf 0', pool, 0.0),
                          ('served pool, conf 0.9', pool, 0.9),
                          ('n=9261 (@672), conf 0.1', at672, EVAL_CONF)):
        for method, use_iol in (('diou', True), ('standard', False)):
            label = f'popmax max_boxes={EVAL_MAX_BOXES} {name} {method} ' \
                    f'iol={use_iol}'
            got = cuda_nms.popmax_nms(*p, conf, THR, EVAL_MAX_BOXES, method,
                                      use_iol)
            want = cuda_nms.popmax_nms_plain(*p, conf, THR, EVAL_MAX_BOXES,
                                             method, use_iol)
            torch.cuda.synchronize()
            errs['popmax_nms'] = max(errs['popmax_nms'], compare_popmax(
                got, want, method, use_iol, label))
            log(f'[kernels] {label}: equal, {int(got[3].sum())} valid of '
                f'{got[3].numel()}')
    boxes, scores, classes = pool
    low = torch.full_like(scores, 0.01)
    got = cuda_nms.popmax_nms(boxes, low, classes, 0.1, THR, MAX_BOXES)
    want = cuda_nms.popmax_nms_plain(boxes, low, classes, 0.1, THR,
                                     MAX_BOXES)
    torch.cuda.synchronize()
    if got[3].any() or not bool((got[2] == -1e9).all()):
        raise AssertionError('popmax: all-below-confidence pool gave output')
    compare_popmax(got, want, 'diou', True, 'popmax below-confidence')
    log('[kernels] popmax all below confidence: no valid output, equal')
    big = None
    try:
        cuda_nms.popmax_nms(*make_pool(dev, SEED, 16385), CONF, THR,
                            MAX_BOXES)
    except ValueError as e:
        big = str(e)
    if not big:
        raise AssertionError('popmax: a pool above capacity did not raise')
    log(f'[kernels] popmax above capacity raises: {big}')

    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sorted_valid = torch.gather(scores, 1, order) >= CONF
    holes = torch.rand(B, 64, generator=torch.Generator().manual_seed(5))
    for k in (64, 1024, N_POOL):
        bx, va = sorted_boxes[:, :k].contiguous(), sorted_valid[:, :k]
        if k == 64:     # valid holes inside the one chunk
            va = va & (holes.to(dev) > 0.25)
        va = va.contiguous()
        for method, use_iol in (('diou', True), ('standard', False)):
            label = f'greedy k={k} {method} iol={use_iol}'
            got = cuda_nms.greedy_nms(bx, va, THR, method, use_iol)
            want = cuda_nms.greedy_nms_plain(bx, va, THR, method, use_iol)
            torch.cuda.synchronize()
            compare_greedy(got, want, bx, method, use_iol, label)
            log(f'[kernels] {label}: equal, {int(got.sum())} kept of '
                f'{int(va.sum())} valid')
    none = torch.zeros(B, 256, dtype=torch.bool, device=dev)
    got = cuda_nms.greedy_nms(sorted_boxes[:, :256].contiguous(), none, THR)
    torch.cuda.synchronize()
    if got.any():
        raise AssertionError('greedy: all-invalid input kept a box')
    log('[kernels] greedy all invalid: nothing kept')
    return errs


def serve_config(backend):
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_darknet',
            'num_classes': NUM_CLASSES, 'input_shape': [*HW, 3],
            'anchors_path': os.path.join(REPO, 'configs',
                                         'yolov3_coco_anchor.txt')}},
        'environment': {'mixed_precision': True},
        'input': {'type': 'image', 'input_shape': [*HW, 3]},
        'detection': {'confidence_threshold': 0.0, 'nms_threshold': THR,
                      'nms_method': 'diou', 'use_iol': True,
                      'max_boxes': MAX_BOXES, 'nms_backend': backend},
    }


def build_engine(backend):
    from multigriddet_tpu_torch.inference import MultiGridInference
    from multigriddet_tpu_torch.models import (load_flax_variables,
                                               random_flax_variables)
    engine = MultiGridInference(serve_config(backend))
    load_flax_variables(engine.model,
                        *random_flax_variables(engine.model, seed=SEED))
    return engine


def phase_serve(batches):
    import numpy as np
    import torch
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.training.steps import (candidate_pool,
                                                       fetch_detections)
    engines, launches, results = {}, {}, {}
    for backend in ('pallas_fused', 'pallas', 'xla'):
        engine = engines[backend] = build_engine(backend)
        cuda_nms.popmax_nms.launches = 0
        cuda_nms.greedy_nms.launches = 0
        outs = [engine.infer_batch(b) for b in batches]
        torch.cuda.synchronize()
        launches[backend] = {'popmax_nms': cuda_nms.popmax_nms.launches,
                             'greedy_nms': cuda_nms.greedy_nms.launches}
        results[backend] = [fetch_detections(o) for o in outs]
        log(f'[serve] {backend}: {len(batches)} batches of {B}, launches '
            f'{launches[backend]}, valid per image '
            f'{[int(v.sum()) for v in results[backend][0][3]]}')
    want = {'pallas_fused': {'popmax_nms': len(batches), 'greedy_nms': 0},
            'pallas': {'popmax_nms': 0, 'greedy_nms': len(batches)},
            'xla': {'popmax_nms': 0, 'greedy_nms': 0}}
    if launches != want:
        raise AssertionError(f'kernel launches {launches}, expected {want}')
    for backend, res in results.items():
        for bx, cl, sc, va in res:
            if not (va.sum(1) >= 1).all():
                raise AssertionError(f'{backend}: an image has no detection')
            if not (np.isfinite(bx[va]).all() and np.isfinite(sc[va]).all()
                    and (sc[va] >= 0).all() and (sc[va] <= 1).all()):
                raise AssertionError(f'{backend}: detections out of range')
            if not ((cl[va] >= 0) & (cl[va] < NUM_CLASSES)).all():
                raise AssertionError(f'{backend}: class id out of range')

    # the served pop-max result equals the plain version on the same pool
    engine = engines['pallas_fused']
    with torch.inference_mode():
        x = torch.from_numpy(batches[0]).cuda().float() / 255.0
        pool = candidate_pool(engine.model, x, engine.spec['anchors'], HW)
        plain = cuda_nms.popmax_nms_plain(*pool, 0.0, THR, MAX_BOXES, 'diou',
                                          True)
    served = results['pallas_fused'][0]
    for name, a, b in zip(('boxes', 'classes', 'scores', 'valid'), served,
                          (t.cpu().numpy() for t in plain)):
        if not np.array_equal(a, b):
            raise AssertionError(f'served {name} differ from the plain '
                                 f'pop-max on the same pool')
    agree = float(np.mean(results['pallas'][0][3] == results['xla'][0][3]))
    log(f'[serve] pallas_fused == plain pop-max on batch 0; pallas vs xla '
        f'valid agreement {agree:.4f}')
    return engines, launches, pool


def phase_f32_parity(engine, batch):
    import numpy as np
    import torch
    from multigriddet_tpu_torch.models import create_model
    model = create_model('multigriddet_darknet', num_anchors=(3, 3, 3),
                         num_classes=NUM_CLASSES, dtype=torch.float32)
    model.load_state_dict(engine.model.state_dict())
    x = torch.from_numpy(batch[:1]).float() / 255.0
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = [t.numpy() for t in model(x)]
            got = [t.cpu().numpy() for t in model.cuda()(x.cuda())]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    worst = 0.0
    for r, g in zip(ref, got):
        if r.shape != g.shape or not np.isfinite(g).all():
            raise AssertionError('f32 forward: bad shape or non-finite')
        scale = max(1.0, float(np.abs(r).max()))
        err = float(np.abs(r - g).max())
        worst = max(worst, err / scale)
        if err > F32_PARITY_RTOL * scale:
            raise AssertionError(f'f32 forward differs from the CPU: max '
                                 f'|diff| {err} > {F32_PARITY_RTOL} x {scale}')
    log(f'[f32] card vs CPU logits: max |diff| / max(1, max |ref|) = '
        f'{worst:.3e} (limit {F32_PARITY_RTOL})')
    return worst


def phase_times(engines, batches, pool):
    import numpy as np
    import torch
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.ops.decode import decode_for_nms
    from multigriddet_tpu_torch.training.steps import fetch_detections
    engine = engines['pallas_fused']
    times = {}
    x_dev = torch.from_numpy(batches[0]).cuda()
    times['step_ms'] = cuda_ms(lambda: engine.infer_batch(x_dev), 20, 3)
    xf = x_dev.float() / 255.0
    with torch.inference_mode():
        times['forward_ms'] = cuda_ms(lambda: engine.model(xf), 20, 3)
        outs = engine.model(xf)
        times['decode_ms'] = cuda_ms(lambda: decode_for_nms(
            outs, engine.spec['anchors'], HW), 20, 3)
    lat = []
    for i in range(3 + 20):
        t0 = time.perf_counter()
        fetch_detections(engine.infer_batch(batches[i % len(batches)]))
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat[3:]) * 1e3
    times['latency_ms_mean'] = float(lat.mean())
    times['latency_ms_p50'] = float(np.percentile(lat, 50))
    times['latency_ms_p90'] = float(np.percentile(lat, 90))
    times['img_per_s'] = float(B / (lat.mean() / 1e3))
    times['device_img_per_s'] = B / (times['step_ms'] / 1e3)
    log(f'[times] b{B} @{HW[0]} bf16: fused step {times["step_ms"]:.3f} ms '
        f'on the card (forward {times["forward_ms"]:.3f}, decode '
        f'{times["decode_ms"]:.3f}); host-to-host latency mean '
        f'{times["latency_ms_mean"]:.3f} ms, p90 {times["latency_ms_p90"]:.3f}'
        f' ms; {times["img_per_s"]:.1f} img/s')

    kernels = []
    # pop-max on the served pool (confidence 0: the whole pool is live)
    boxes, scores, classes = pool
    args = (boxes, scores, classes, 0.0, THR, MAX_BOXES, 'diou', True)
    ms = cuda_ms(lambda: cuda_nms.popmax_nms(*args), 20, 3, queued=True)
    call_ms = cuda_ms(lambda: cuda_nms.popmax_nms(*args), 20, 3)
    plain_ms = cuda_ms(lambda: cuda_nms.popmax_nms_plain(*args), 3, 1)
    n = boxes.shape[1]
    moved = B * n * (16 + 4 + 4) + B * MAX_BOXES * (16 + 4 + 4 + 1)
    pairs = popmax_pairs(boxes, scores, 0.0, THR, MAX_BOXES, 'diou', True)
    ops = pairs * (PAIR_OPS[('diou', True)] + 2) + B * n * 3
    bms, by = bound(moved, ops)
    kernels.append({'name': 'popmax_nms', 'ms': ms, 'call_ms': call_ms,
                    'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
                    'pairs': pairs})
    # the sweep's hard cases: identical boxes at the top of the order
    for size, key in ((1000, 'army_1000_ms'), (n, 'army_all_ms')):
        army = army_pool(pool, size)
        times[f'popmax_{key}'] = cuda_ms(
            lambda: cuda_nms.popmax_nms(*army, 0.0, THR, MAX_BOXES), 20, 3,
            queued=True)
    log(f'[times] popmax_nms with an army of 1000 identical boxes at the '
        f'top: {times["popmax_army_1000_ms"]:.4f} ms; all {n} identical: '
        f'{times["popmax_army_all_ms"]:.4f} ms')
    # greedy on what the `pallas` backend hands it: the top 1,024 of the
    # same pool, sorted by score
    k = min(1024, n)
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    bx = bx.contiguous()
    va = torch.ones(B, k, dtype=torch.bool, device=bx.device)
    ms = cuda_ms(lambda: cuda_nms.greedy_nms(bx, va, THR, 'diou', True), 20, 3,
                 queued=True)
    call_ms = cuda_ms(lambda: cuda_nms.greedy_nms(bx, va, THR, 'diou', True),
                      20, 3)
    plain_ms = cuda_ms(lambda: cuda_nms.greedy_nms_plain(bx, va, THR, 'diou',
                                                         True), 3, 1)
    keep = cuda_nms.greedy_nms(bx, va, THR, 'diou', True)
    pairs = greedy_pairs(bx, va, keep, THR, 'diou', True)
    moved = B * k * (16 + 1 + 1)
    bms, by = bound(moved, pairs * (PAIR_OPS[('diou', True)]))
    kernels.append({'name': 'greedy_nms', 'ms': ms, 'call_ms': call_ms,
                    'plain_ms': plain_ms, 'bound_ms': bms, 'bound_by': by,
                    'pairs': pairs})
    for k in kernels:
        log(f'[times] {k["name"]}: {k["ms"]:.4f} ms on the card ('
            f'{k["call_ms"]:.4f} ms a call with the wrapper\'s host time), '
            f'plain {k["plain_ms"]:.3f} ms, bound {k["bound_ms"]:.5f} ms '
            f'({k["bound_by"]}, {k["pairs"]} pairs)')
    return times, kernels


def eval_config(backend):
    """The evaluator on the serve phase's model: 80 classes, COCO
    anchors, 608x608, bfloat16, b8, seeded random weights (seed 0, the
    seed build_model_for_inference uses without a weights file), with the
    settings of configs/eval_config.yaml."""
    cfg = serve_config(backend)
    del cfg['input'], cfg['detection']
    cfg['evaluation'] = {
        'batch_size': B, 'input_shape': [*HW, 3],
        'confidence_threshold': EVAL_CONF, 'nms_threshold': THR,
        'nms_method': 'diou', 'use_iol': True,
        'max_detections': EVAL_MAX_BOXES, 'nms_backend': backend,
        'link_format': 'rgb', 'save_results': False}
    return cfg


def evaluator_variant(ev, backend, link_format):
    """``ev`` with the fused step that ``evaluation.nms_backend`` =
    ``backend`` and ``evaluation.link_format`` = ``link_format`` give,
    over the same model (a new evaluator would only rebuild the same
    seeded weights)."""
    import copy
    out = copy.copy(ev)
    out.eval_cfg = dict(ev.eval_cfg, nms_backend=backend,
                        link_format=link_format)
    out.timing = {}
    out._build_step()
    return out


def in_range(boxes, classes, scores, image_hw, conf):
    import numpy as np
    h, w = image_hw
    return bool(np.isfinite(boxes).all() and np.isfinite(scores).all()
                and (scores >= conf).all() and (scores <= 1).all()
                and ((classes >= 0) & (classes < NUM_CLASSES)).all()
                and (boxes[:, :2] >= 0).all()
                and (boxes[:, 0] + boxes[:, 2] <= w + 1e-3).all()
                and (boxes[:, 1] + boxes[:, 3] <= h + 1e-3).all())


def phase_evaluate(serve_pool, smi):
    """``MultiGridEvaluator._evaluate_batches`` over in-memory batches for
    each NMS backend, against ground truth made by the plain pop-max;
    the matchers; one WBF serve batch; the pop-max kernel at 500 keeps."""
    import numpy as np
    import torch
    from multigriddet_tpu_torch.data import native
    from multigriddet_tpu_torch.evaluation import MultiGridEvaluator, metrics
    from multigriddet_tpu_torch.inference import MultiGridInference
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.ops.geometry import canvas_boxes_to_image
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.postprocess.wbf import fuse_and_cap
    from multigriddet_tpu_torch.training.steps import (candidate_pool,
                                                       fetch_detections)
    t0 = time.perf_counter()
    matcher = native.matcher_available()     # built here, not in metrics_s
    log(f'[evaluate] native matcher available: {matcher} '
        f'({time.perf_counter() - t0:.2f} s to build and load)')
    ev = MultiGridEvaluator(eval_config('pallas_fused'))
    batches = letterboxed_batches(EVAL_BATCHES, SEED + 1)
    # ground truth: the plain pop-max's detections on the same pools, in
    # image pixels, as x1y1x2y2cls
    items, plain = [], []
    for k, batch in enumerate(batches):
        with torch.inference_mode():
            pool = candidate_pool(
                ev.model, torch.from_numpy(batch).cuda().float() / 255.0,
                ev.spec['anchors'], HW)
            res = [t.cpu().numpy() for t in cuda_nms.popmax_nms_plain(
                *pool, EVAL_CONF, THR, EVAL_MAX_BOXES, 'diou', True)]
        metas = []
        for i in range(B):
            b, c, s, v = (a[i] for a in res)
            xywh = canvas_boxes_to_image(b[v], FRAME_HW, HW)
            plain.append((xywh, c[v], s[v]))
            gt = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:],
                                 c[v][:, None]], 1).astype(np.float32)
            metas.append((k * B + i, gt, *FRAME_HW, None, False))
        items.append(((batch,), metas))
    kept = [len(p[0]) for p in plain]
    log(f'[evaluate] ground truth: plain pop-max keeps per image min '
        f'{min(kept)} / mean {np.mean(kept):.1f} / max {max(kept)} '
        f'(capacity {EVAL_MAX_BOXES}, confidence {EVAL_CONF})')

    report = {'kept_per_image': kept, 'runs': {}}
    want = {'pallas_fused': (EVAL_BATCHES, 0), 'pallas': (0, EVAL_BATCHES),
            'xla': (0, 0)}
    runs = {}
    for backend, link in (('pallas_fused', 'rgb'), ('pallas', 'rgb'),
                          ('xla', 'rgb'), ('pallas_fused', 'yuv420')):
        e = ev if (backend, link) == ('pallas_fused', 'rgb') else \
            evaluator_variant(ev, backend, link)
        feed = items if link == 'rgb' else [
            (rgb_to_yuv420_np(parts[0]), metas) for parts, metas in items]
        cuda_nms.popmax_nms.launches = 0
        cuda_nms.greedy_nms.launches = 0
        res = e._evaluate_batches(feed)
        launches = (cuda_nms.popmax_nms.launches,
                    cuda_nms.greedy_nms.launches)
        if launches != want[backend]:
            raise AssertionError(f'evaluate {backend}/{link}: launches '
                                 f'(popmax, greedy) {launches}, expected '
                                 f'{want[backend]}')
        for img, p in e.predictions.items():
            if not in_range(p['boxes'], p['classes'], p['scores'],
                            FRAME_HW, EVAL_CONF):
                raise AssertionError(f'evaluate {backend}/{link}: image '
                                     f'{img} has detections out of range')
        runs[(backend, link)] = e
        report['runs'][f'{backend}/{link}'] = {
            'mAP': res['mAP'], 'mAP50': res['mAP50'],
            'images_per_sec': e.timing['images_per_sec'],
            'inference_s': e.timing['inference_s'],
            'metrics_s': e.timing['metrics_s'],
            'detections': int(sum(len(p['boxes'])
                                  for p in e.predictions.values())),
            'launches_popmax_greedy': list(launches)}
        log(f'[evaluate] {backend}/{link}: {res["num_images"]} images, '
            f'mAP {res["mAP"]:.6f}, mAP50 {res["mAP50"]:.6f}; inference '
            f'{e.timing["images_per_sec"]:.1f} img/s '
            f'({e.timing["inference_s"]:.3f} s), metrics '
            f'{e.timing["metrics_s"]:.3f} s; launches (popmax, greedy) '
            f'{launches}')

    fused = runs[('pallas_fused', 'rgb')]
    for img, (b, c, s) in enumerate(plain):
        p = fused.predictions[img]
        if not (np.array_equal(p['classes'], c)
                and np.array_equal(p['boxes'], b)
                and np.array_equal(p['scores'], s)):
            raise AssertionError(f'evaluate: pallas_fused predictions of '
                                 f'image {img} differ from the plain pop-max')
    # mAP against that ground truth is 1 over the boxes the letterbox
    # inverse leaves at least 0.1 px a side: a detection wholly in the
    # gray border or off the canvas is clipped to zero area, and a
    # zero-area box matches nothing (IoU 0), itself included
    def sized(d, keeps):
        return {img: {k: v[keeps[img]] for k, v in p.items()}
                for img, p in d.items()}
    keeps = {img: (p['boxes'][:, 2] >= 0.1) & (p['boxes'][:, 3] >= 0.1)
             for img, p in fused.predictions.items()}
    clipped = int(sum((~k).sum() for k in keeps.values()))
    m = metrics.calculate_map(sized(fused.predictions, keeps),
                              sized(fused.ground_truths, keeps),
                              NUM_CLASSES)['mAP']
    report.update(map_sized=m, clipped_to_zero=clipped)
    if abs(1.0 - m) > 1e-6:
        raise AssertionError(f'evaluate: mAP@[.5:.95] {m!r} against the '
                             f'plain pop-max ground truth, expected 1')
    log(f'[evaluate] pallas_fused predictions == plain pop-max (classes, '
        f'order, boxes and scores bit for bit); mAP@[.5:.95] = {m!r} over '
        f'the boxes at least 0.1 px a side ({clipped} of '
        f'{sum(kept)} clipped below that by the letterbox inverse)')

    # the native matcher and the numpy one give the same results
    args = (fused.predictions, fused.ground_truths, NUM_CLASSES)
    with_native = metrics.calculate_map(*args)
    available = native.matcher_available
    native.matcher_available = lambda: False
    try:
        with_numpy = metrics.calculate_map(*args)
    finally:
        native.matcher_available = available
    same = all(with_native[k] == with_numpy[k]
               for k in ('mAP', 'mAP50', 'mAP75'))
    same = same and with_native['per_class_ap'] == with_numpy['per_class_ap']
    if not same:
        raise AssertionError('evaluate: native and numpy matchers differ')
    report.update(matcher_native=matcher,
                  loader_native=native.native_available())
    log(f'[evaluate] calculate_map equal through the native matcher '
        f'(available: {matcher}) and numpy; native JPEG loader available: '
        f'{report["loader_native"]}')

    # one serve batch with detection.use_wbf (paper mode)
    cfg = serve_config('xla')
    cfg['detection'].update(use_wbf=True, wbf_mode='paper',
                            confidence_threshold=EVAL_CONF,
                            pre_nms_top_k=256)
    engine = MultiGridInference(cfg)
    outs = engine.infer_batch(batches[0])
    cands = fetch_detections(outs)
    got: list = []
    engine._postprocess_batch(outs, [FRAME_HW] * B, got)
    for i, (b, c, s) in enumerate(got):
        v = cands[3][i]
        fb, fc, fs = fuse_and_cap(cands[0][i][v], cands[1][i][v],
                                  cands[2][i][v], iou_thr=THR, mode='paper',
                                  max_out=MAX_BOXES)
        if len(fb):
            fb = canvas_boxes_to_image(fb, FRAME_HW, HW)
        if not (np.array_equal(b, fb) and np.array_equal(c, fc)
                and np.array_equal(s, fs)):
            raise AssertionError(f'wbf: image {i} differs from fuse_and_cap '
                                 f'over the fetched candidates')
        if not in_range(b, c, s, FRAME_HW, EVAL_CONF) or len(b) > MAX_BOXES:
            raise AssertionError(f'wbf: image {i} out of range')
    report['wbf_per_image'] = [len(r[0]) for r in got]
    log(f'[evaluate] use_wbf serve batch == fuse_and_cap over the fetched '
        f'candidates; fused detections per image {report["wbf_per_image"]}')

    # the pop-max kernel at the evaluator's 500 keeps on the served pool
    boxes, scores, classes = serve_pool
    n = boxes.shape[1]
    report['popmax_500'] = {}
    for conf in (EVAL_CONF, 0.0):
        args = (boxes, scores, classes, conf, THR, EVAL_MAX_BOXES, 'diou',
                True)
        ms = cuda_ms(lambda: cuda_nms.popmax_nms(*args), 20, 3, queued=True)
        plain_ms = cuda_ms(lambda: cuda_nms.popmax_nms_plain(*args), 3, 1)
        pairs = popmax_pairs(boxes, scores, conf, THR, EVAL_MAX_BOXES,
                             'diou', True)
        valid = int(cuda_nms.popmax_nms(*args)[3].sum())
        moved = B * n * (16 + 4 + 4) + B * EVAL_MAX_BOXES * (16 + 4 + 4 + 1)
        bms, by = bound(moved, pairs * (PAIR_OPS[('diou', True)] + 2)
                        + B * n * 3)
        report['popmax_500'][str(conf)] = {
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bms,
            'bound_by': by, 'pairs': pairs, 'valid': valid}
        log(f'[evaluate] popmax_nms max_boxes={EVAL_MAX_BOXES} on the '
            f'served pool, confidence {conf}: {ms:.4f} ms on the card, plain '
            f'{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}, {pairs} pairs), '
            f'{valid} valid of {B * EVAL_MAX_BOXES}')
    log(f'[evaluate] card: {smi}')
    return report


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

# the loss settings of configs/train_config.yaml (the card's host has no
# PyYAML): option 2, label smoothing 0.01, the consensus loss on
TRAIN_LOSS = {
    'coord_scale': 5.0, 'object_scale': 1.0, 'no_object_scale': 0.5,
    'class_scale': 1.0, 'anchor_scale': 1.0, 'ignore_thresh': 0.5,
    'use_iou_aware_objectness': False, 'iou_objectness_power': 1.5,
    'iou_objectness_ratio': 1.0, 'trainable_nms_weight': 0.0,
    'trainable_nms_power': 2.0, 'use_consensus_loss': True,
    'consensus_kernel_size': 3, 'consensus_iou_power': 1.5,
    'consensus_min_iou': 0.001, 'consensus_coord_scale': 0.5,
    'consensus_obj_scale': 0.5, 'consensus_class_scale': 0.3,
    'consensus_stop_gradient': True, 'consensus_center_tolerance': 0.0001}
TRAIN_MAX_BOXES = 100                 # augmentation.max_boxes_per_image
PARITY_B, PARITY_HW = 2, (416, 416)
# card vs CPU with TF32 off.  The device stage: the encoder's discrete
# fields exact, offsets and log-ratios, and the [0, 1] images, within 1e-6.
# The float32 fused step: loss terms relative, running statistics relative
# (of max(1, |v|)).  Gradients in float64 from identical images and
# targets, each of its tensor's largest |grad|: at this init a conv before
# train-mode BatchNorm gets the small remainder of a large common gradient
# (the no-object term pushes every cell's objectness down) once the
# backward subtracts the batch means, which multiplies any difference
# upstream by ~1e6: the CPU's own float32 gradients lie up to 1e-1 from
# float64 (reported), and images that differ in the last float32 bit (the
# yuv420 inverse on each device) move float64 gradients by ~1e-3
ENC_ATOL, LOSS_RTOL, STAT_RTOL, GRAD64_RTOL, GRAD_RTOL = (1e-6, 1e-4, 1e-4,
                                                          1e-6, 1e-3)
TRAIN_FRAMES, VAL_FRAMES, TRAIN_EPOCHS = 48, 16, 2
OVERFIT_STEPS, OVERFIT_LR = 40, 1e-3
TIMED_STEPS, WARMUP_STEPS = 20, 3
# configs/train_config.yaml's augmentation block
TRAIN_AUG = {'enabled': True, 'enhance_type': 'mosaic', 'mosaic_prob': 0.3,
             'mixup_prob': 0.1, 'rescale_interval': -1,
             'max_boxes_per_image': TRAIN_MAX_BOXES}
AUG_OFF = {'enabled': False, 'rescale_interval': -1,
           'max_boxes_per_image': TRAIN_MAX_BOXES}
# every optional op of the chain on, each likely to fire in a batch of 8
EVERY_OP_AUG = {'enabled': True, 'enhance_type': 'gridmask',
                'mosaic_prob': 0.5, 'mixup_prob': 0.5, 'gridmask_prob': 0.5,
                'copypaste_prob': 0.5, 'copypaste_max': 4, 'blur_prob': 0.3,
                'sharpness_prob': 0.3, 'motion_blur_prob': 0.3,
                'rotate_any_prob': 0.5, 'rotate_prob': 0.3,
                'grayscale_prob': 0.2}
# the augmented device stage, card vs CPU from one seed (the CPU tests'
# bounds, tests/test_torch_augment.py): images 1e-3 on the 0-255 scale,
# boxes 1e-3 px with the same slots zeroed, targets' offsets 1e-4
AUG_IMG_ATOL, AUG_BOX_ATOL, AUG_TARGET_ATOL = 1e-3 / 255.0, 1e-3, 1e-4
# item 11: tools/validate_learning.py on the card
MAP_HW, MAP_FRAMES, MAP_EPOCHS, MAP_LR, MAP50_MIN = (128, 128), 16, 600, \
    2e-3, 0.9


def train_config(root, hw=None, mixed=True, lr=1e-4, schedule=None,
                 aug=None, bank=False):
    """``configs/train_config.yaml`` on ``multigriddet_darknet`` (80
    classes, COCO anchors), b8, Adam, with the augmentation block ``aug``
    (default off), a 1-epoch warmup, the device image bank when ``bank``,
    and its files under ``root``; frames come from the loader's ``.npy``
    disk cache."""
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_darknet',
            'num_classes': NUM_CLASSES, 'input_shape': [*(hw or HW), 3],
            'anchors_path': os.path.join(REPO, 'configs',
                                         'yolov3_coco_anchor.txt')}},
        'data': {'train_annotation': os.path.join(root, 'train.txt'),
                 'val_annotation': os.path.join(root, 'val.txt')},
        'environment': {'mixed_precision': mixed},
        'data_loader': {'num_workers': 4, 'link_format': 'auto',
                        'disk_cache_dir': os.path.join(root, 'cache'),
                        'cache_images_device': bank},
        'training': {
            'batch_size': B, 'epochs': TRAIN_EPOCHS, 'learning_rate': lr,
            'transfer_epochs': 0, 'freeze_level': 1, 'loss_option': 2,
            'label_smoothing': 0.01, 'loss': dict(TRAIN_LOSS),
            'loss_normalization': ['batch'], 'class_weights': None,
            'augmentation': dict(aug or AUG_OFF)},
        'optimizer': {'type': 'adam', 'learning_rate': lr, 'beta_1': 0.9,
                      'beta_2': 0.999, 'epsilon': 1e-7},
        'lr_schedule': schedule or {
            'type': 'cosine_annealing', 'warmup_epochs': 1,
            'warmup_lr_factor': 0.01, 'min_lr': 1e-7},
        'callbacks': {
            'checkpoint': {'save_best_only': True, 'monitor': 'val_loss',
                           'save_dir': os.path.join(root, 'checkpoints')},
            'early_stopping': {'monitor': 'val_loss', 'patience': 10}},
        'resume': {'enabled': False},
        'output': {'log_dir': os.path.join(root, 'logs'),
                   'model_dir': os.path.join(root, 'models'),
                   'save_frequency': 1},
    }


def train_frames(count, seed, hw=None):
    """Synthetic 640x480 frames with 1-30 boxes each, letterboxed onto the
    gray ``hw`` canvas as the loader does: (annotation lines of the frames'
    own pixels, canvases u8, canvas boxes ``[count, 100, 5]``).  Each box
    is painted in its class's colour over a smooth random picture."""
    import numpy as np
    from multigriddet_tpu_torch.data.annotations import _letterbox_boxes
    rng = np.random.RandomState(seed)
    hw = hw or HW
    fh, fw = FRAME_HW
    scale = min(hw[1] / fw, hw[0] / fh)
    nw, nh = int(round(fw * scale)), int(round(fh * scale))
    pad_x, pad_y = (hw[1] - nw) // 2, (hw[0] - nh) // 2
    colours = rng.randint(0, 256, (NUM_CLASSES, 3))
    lines, canvases, boxes = [], [], []
    for i in range(count):
        n = rng.randint(1, 31)
        wh = rng.uniform(16, 320, (n, 2))
        x1 = rng.uniform(0, fw - wh[:, 0])
        y1 = rng.uniform(0, fh - wh[:, 1])
        cls = rng.randint(0, NUM_CLASSES, n)
        frame = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1], cls],
                         1).astype(np.float32)
        lines.append(f'frames/f{seed}_{i:03d}.jpg ' + ' '.join(
            f'{a:.1f},{b:.1f},{c:.1f},{d:.1f},{int(k)}'
            for a, b, c, d, k in frame))
        bx = _letterbox_boxes(frame.round(1), TRAIN_MAX_BOXES, scale, pad_x,
                              pad_y)
        low = rng.randint(0, 256, (nh // 16 + 1, nw // 16 + 1, 3))
        pic = np.repeat(np.repeat(low, 16, 0), 16, 1)[:nh, :nw]
        canvas = np.full((*hw, 3), 128, np.uint8)
        canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = pic
        for x1_, y1_, x2_, y2_, k in bx[:n]:
            canvas[int(y1_):int(y2_), int(x1_):int(x2_)] = colours[int(k)]
        canvases.append(canvas)
        boxes.append(bx)
    return lines, np.stack(canvases), np.stack(boxes)


def write_frames(root, name, lines, canvases, boxes, link_format, hw=None,
                 max_boxes=TRAIN_MAX_BOXES):
    """The annotation file, and each frame in ``HostImageLoader``'s own
    ``.npy`` disk cache, written by the loader's cache writer (so no
    image file is decoded)."""
    from multigriddet_tpu_torch.data.annotations import HostImageLoader
    hw = hw or HW
    lines = [os.path.join(root, ln) for ln in lines]
    with open(os.path.join(root, name), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    loader = HostImageLoader(lines, hw, max_boxes, num_workers=1,
                             use_native=False,
                             disk_cache_dir=os.path.join(root, 'cache'),
                             link_format=link_format)
    for line, canvas, bx in zip(lines, canvases, boxes):
        loader._disk_write(loader._disk_key(line, hw),
                           loader._to_parts(canvas), bx)
    loader.close()
    return lines


def train_step_parity(dev):
    """One train step of the full-width model (TF32 off) on the card and on
    the CPU from the same weights and batch: the device stage (encoder and
    images), the float32 fused step's loss terms and running statistics
    after it, and, in float64 from identical images and targets, every
    gradient (see ``GRAD64_RTOL``).  The float32 gradients' distance from
    the CPU's float64 step is reported for both devices.  Returns the
    report with the failed checks under ``failures``: the phase raises at
    its end, after the rest of it has run and printed."""
    import copy
    import torch
    from multigriddet_tpu_torch.config import (build_model_from_config,
                                               create_optimizer_from_config,
                                               loss_config_from_config)
    from multigriddet_tpu_torch.data.pipeline import _device_stage
    from multigriddet_tpu_torch.models import (load_flax_variables,
                                               random_flax_variables)
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.training import (apply_freeze,
                                                 create_train_state,
                                                 make_fused_train_step,
                                                 make_train_step)
    cfg = train_config('', PARITY_HW, mixed=False, schedule={
        'type': 'constant'})
    model, spec = build_model_from_config(cfg)
    load_flax_variables(model, *random_flax_variables(model, seed=SEED))
    model64, _ = build_model_from_config(cfg, dtype=torch.float64)
    model64.load_state_dict(model.state_dict())
    model64.double()
    _, canvases, boxes = train_frames(PARITY_B, SEED + 7, PARITY_HW)
    parts = rgb_to_yuv420_np(canvases)
    anchors, loss_cfg = spec['anchors'], loss_config_from_config(cfg)
    host_step, _ = make_fused_train_step(anchors, NUM_CLASSES, loss_cfg,
                                         aug_cfg={'enabled': False})
    step64 = make_train_step(anchors, NUM_CLASSES, PARITY_HW, loss_cfg)

    def run(base, d, batch=None):
        """One step on ``d``: the fused step from the u8 parts, or the
        train step from ``batch`` = (images, y_true)."""
        m = copy.deepcopy(base).to(d)
        state = create_train_state(m, create_optimizer_from_config(
            cfg, apply_freeze(m, 0)))
        t0 = time.perf_counter()
        if batch is None:
            _, metrics = host_step(
                state, tuple(torch.from_numpy(p).to(d) for p in parts),
                boxes, torch.Generator().manual_seed(SEED))
        else:
            _, metrics = step64(state, batch[0].to(d),
                                [y.to(d) for y in batch[1]])
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.detach().cpu().double()
                 for n, p in m.named_parameters()},
                {k: v.detach().cpu() for k, v in m.state_dict().items()
                 if 'running' in k},
                time.perf_counter() - t0)

    def stage(d):
        images, y_true, _ = _device_stage(
            tuple(torch.from_numpy(p).to(d) for p in parts), boxes, None,
            {'enabled': False}, anchors, NUM_CLASSES, PARITY_HW, True)
        return images.cpu(), [y.cpu() for y in y_true]

    failures = []
    (ci, cy), (gi, gy) = stage('cpu'), stage(dev)
    enc_err = max(float((g[..., :4] - c[..., :4]).abs().max())
                  for g, c in zip(gy, cy))
    if not (all(torch.equal(g[..., 4:], c[..., 4:]) for g, c in zip(gy, cy))
            and enc_err <= ENC_ATOL):
        failures.append(f'encoder: discrete fields differ or offsets '
                        f'{enc_err:.3e} > {ENC_ATOL}')
    img_err = float((gi - ci).abs().max())
    if not img_err <= ENC_ATOL:
        failures.append(f'device-stage images: {img_err:.3e} > {ENC_ATOL}')
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, rg, _, rt = run(model64, 'cpu', (ci, cy))
        _, g64, _, _ = run(model64, dev, (ci, cy))
        cm, cg, cs, ct = run(model, 'cpu')
        gm, gg, gs, _ = run(model, dev)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    if cm['num_positives'] != gm['num_positives']:
        failures.append(f'num_positives: card {gm["num_positives"]} vs CPU '
                        f'{cm["num_positives"]}')
    loss_err = 0.0
    for k in cm:
        err = abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6)
        loss_err = max(loss_err, err)
        if not err <= LOSS_RTOL:
            failures.append(f'loss term {k}: card {gm[k]!r} vs CPU {cm[k]!r}')
    stat_err = max(float(((gs[k] - want).abs()
                          / want.abs().clamp_min(1.0)).max())
                   for k, want in cs.items())
    if not stat_err <= STAT_RTOL:
        failures.append(f'running statistics after the step: {stat_err:.3e}'
                        f' relative > {STAT_RTOL}')

    # each gradient's distance from the CPU's float64 step, as a share of
    # its tensor's largest |grad|
    def dist(grads):
        return {n: float((grads[n] - ref).abs().max())
                / max(float(ref.abs().max()), 1e-300)
                for n, ref in rg.items()}
    e64, e_card, e_cpu = dist(g64), dist(gg), dist(cg)
    for n, err in e64.items():
        if not err <= GRAD64_RTOL:
            failures.append(f'float64 gradient of {n}: {err:.3e} of its '
                            f'largest from the CPU\'s')
    loose = sum(e > GRAD_RTOL for e in e_cpu.values())
    log(f'[train] step parity b{PARITY_B} @{PARITY_HW[0]} (TF32 off), card '
        f'vs CPU: encoder discrete fields equal, offsets {enc_err:.3e}, '
        f'images {img_err:.3e} (limit {ENC_ATOL}); float32 loss '
        f'{gm["loss"]:.6f} / {cm["loss"]:.6f}, worst loss term '
        f'{loss_err:.3e} relative (limit {LOSS_RTOL}), running statistics '
        f'{stat_err:.3e} (limit {STAT_RTOL}); float64 gradients '
        f'{max(e64.values()):.3e} of each tensor\'s largest (limit '
        f'{GRAD64_RTOL}, {len(rg)} tensors); {int(cm["num_positives"])} '
        f'positives; CPU step {ct:.1f} s, float64 {rt:.1f} s')
    log(f'[train] float32 gradients from the CPU\'s float64 step, worst: '
        f'card {max(e_card.values()):.3e}, CPU {max(e_cpu.values()):.3e}; '
        f'{loose} of {len(rg)} tensors beyond {GRAD_RTOL} on the CPU')
    return {'loss_cpu': cm['loss'], 'loss_card': gm['loss'],
            'encoder_offset_err': enc_err, 'image_err': img_err,
            'loss_rel_err': loss_err, 'stat_rel_err': stat_err,
            'grad64_rel_err': max(e64.values()),
            'grad32_err_card': max(e_card.values()),
            'grad32_err_cpu': max(e_cpu.values()), 'grad32_loose': loose,
            'cpu_step_s': ct, 'cpu_f64_step_s': rt, 'failures': failures}


def valid_rows(boxes):
    return ((boxes[..., 2] - boxes[..., 0]) > 0) & (
        (boxes[..., 3] - boxes[..., 1]) > 0)


def augment_checks(dev):
    """The augmented device stage on the card against the CPU from one
    seed, b8 @608 yuv420, for the train config's block and for one with
    every optional op on: images, boxes (the same slots zeroed) and
    targets within ``AUG_*_ATOL``; the chain's invariants on the card's
    output (capacity x8 plus the copy-paste slots, boxes inside the canvas
    and at least ``MIN_BOX_PX`` a side) and mixup keeping every valid box
    of a mosaic-spread batch.  Returns the report with the failed checks
    under ``failures``; the phase raises at its end."""
    import numpy as np
    import torch
    from multigriddet_tpu_torch.data import augment as A
    from multigriddet_tpu_torch.data.pipeline import (
        _device_stage, calculate_expansion_factor, draw_chain)
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.utils.anchors import load_anchors
    anchors = load_anchors(os.path.join(REPO, 'configs',
                                        'yolov3_coco_anchor.txt'))
    _, canvases, boxes = train_frames(B, SEED + 21)
    parts = rgb_to_yuv420_np(canvases)
    failures, report = [], {}
    for name, cfg in (('train_config', TRAIN_AUG),
                      ('every_op', EVERY_OP_AUG)):
        out = {}
        for tag, d in (('cpu', 'cpu'), ('card', dev)):
            images, y_true, bx = _device_stage(
                tuple(torch.from_numpy(p).to(d) for p in parts), boxes,
                torch.Generator().manual_seed(SEED), cfg, anchors,
                NUM_CLASSES, HW, True)
            out[tag] = (images.cpu(), [y.cpu() for y in y_true], bx.cpu())
        (ci, cy, cb), (gi, gy, gb) = out['cpu'], out['card']
        img_err = float((gi - ci).abs().max())
        box_err = float((gb - cb).abs().max())
        same_slots = bool(torch.equal(valid_rows(gb), valid_rows(cb)))
        tgt_err = max(float((g[..., :4] - c[..., :4]).abs().max())
                      for g, c in zip(gy, cy))
        discrete = all(torch.equal(g[..., 4:], c[..., 4:])
                       for g, c in zip(gy, cy))
        if not (img_err <= AUG_IMG_ATOL and box_err <= AUG_BOX_ATOL
                and same_slots and tgt_err <= AUG_TARGET_ATOL and discrete):
            failures.append(
                f'{name}: card vs CPU images {img_err:.3e} (limit '
                f'{AUG_IMG_ATOL:.3e}), boxes {box_err:.3e} (limit '
                f'{AUG_BOX_ATOL}), same slots {same_slots}, targets '
                f'{tgt_err:.3e} (limit {AUG_TARGET_ATOL}), discrete '
                f'fields equal {discrete}')
        cap = TRAIN_MAX_BOXES * calculate_expansion_factor(
            cfg.get('mosaic_prob', 0), cfg.get('mixup_prob', 0))
        if cfg.get('copypaste_prob', 0) > 0:
            cap += cfg['copypaste_max']
        live = gb[valid_rows(gb)]
        inside = bool((live[:, :4] >= 0).all()
                      and (live[:, [0, 2]] <= HW[1]).all()
                      and (live[:, [1, 3]] <= HW[0]).all())
        big = bool((live[:, 2] - live[:, 0] >= A.MIN_BOX_PX).all()
                   and (live[:, 3] - live[:, 1] >= A.MIN_BOX_PX).all())
        if tuple(gb.shape) != (B, cap, 5) or not (inside and big):
            failures.append(f'{name}: invariants: boxes {tuple(gb.shape)} '
                            f'(capacity {cap}), inside {inside}, at least '
                            f'{A.MIN_BOX_PX} px {big}')
        draws = draw_chain(torch.Generator().manual_seed(SEED), B,
                           TRAIN_MAX_BOXES, cfg)
        fired = {op: int(d['apply'].sum()) for op, d in draws.items()}
        report[name] = {'image_err': img_err, 'box_err': box_err,
                        'target_err': tgt_err, 'same_slots': same_slots,
                        'capacity': cap, 'valid_boxes': int(len(live)),
                        'fired': fired}
        log(f'[train] augmented stage {name}, card vs CPU b{B} @{HW[0]}: '
            f'images {img_err:.3e} (limit {AUG_IMG_ATOL:.3e}), boxes '
            f'{box_err:.3e} px (limit {AUG_BOX_ATOL}), same slots zeroed '
            f'{same_slots}, targets {tgt_err:.3e} (limit {AUG_TARGET_ATOL}), '
            f'capacity {cap}, {len(live)} valid boxes; images each op '
            f'fired on {fired}')
    # mixup after mosaic: every quarter of the x8 capacity holds boxes
    bx = torch.from_numpy(np.asarray(A.expand_box_capacity(boxes, 8))).to(
        dev)
    quarter = bx.shape[1] // 4
    for q in range(1, 4):
        bx[:, q * quarter:q * quarter + 25] = bx[:, :25]
    _, mixed = A.apply_mixup(
        torch.zeros((B, 8, 8, 3), device=dev), bx,
        {'apply': torch.ones(B, dtype=torch.bool, device=dev),
         'value': torch.full((B,), 0.5, device=dev)})
    nv = valid_rows(bx).sum(1)
    kept = bool(torch.equal(valid_rows(mixed).sum(1), nv + nv.roll(-1)))
    if not kept:
        failures.append('mixup lost valid boxes on the card')
    report['mixup_keeps_every_box'] = kept
    report['failures'] = failures
    return report


def train_through_trainer(dev, root, val_batch, bank=True):
    """``MultiGridTrainer(config).train()`` with the train config's
    augmentation block for 2 epochs of 6 steps with validation.  With
    ``bank``: epoch 2 must train from the device image bank (and epoch 1
    stream), a bank gather must equal the host path's parts bit for bit,
    then a checkpoint is restored into a fresh state and the exported
    ``final_model.msgpack`` served by ``MultiGridInference``.  Without:
    every batch streams (the rate epoch 2 is compared with)."""
    import math
    import numpy as np
    import torch
    from multigriddet_tpu_torch.config import (build_model_for_training,
                                               create_optimizer_from_config)
    from multigriddet_tpu_torch.data import MultiGridDataGenerator
    from multigriddet_tpu_torch.inference import MultiGridInference
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.training import (CheckpointManager,
                                                 MultiGridTrainer,
                                                 apply_freeze,
                                                 create_train_state,
                                                 fetch_detections)
    cfg = train_config(os.path.join(root, 'bank' if bank else 'stream'),
                       aug=TRAIN_AUG, bank=bank)
    cfg['data'] = {'train_annotation': os.path.join(root, 'train.txt'),
                   'val_annotation': os.path.join(root, 'val.txt')}
    cfg['data_loader']['disk_cache_dir'] = os.path.join(root, 'cache')
    cuda_nms.popmax_nms.launches = 0
    cuda_nms.greedy_nms.launches = 0
    kinds = []
    raw = MultiGridDataGenerator.iter_raw

    def counted(gen):
        for item in raw(gen):
            kinds.append(item[0])
            yield item
    t0 = time.perf_counter()
    trainer = MultiGridTrainer(cfg, device=dev)
    MultiGridDataGenerator.iter_raw = counted
    try:
        history = trainer.train()
    finally:
        MultiGridDataGenerator.iter_raw = raw
    seconds = time.perf_counter() - t0
    launches = (cuda_nms.popmax_nms.launches, cuda_nms.greedy_nms.launches)
    if launches != (0, 0):
        raise AssertionError(f'the training path launched NMS kernels '
                             f'{launches}')
    if len(history) != TRAIN_EPOCHS:
        raise AssertionError(f'history has {len(history)} records')
    for rec in history:
        bad = [k for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad or rec['steps'] != TRAIN_FRAMES // B or 'val_loss' not in rec:
            raise AssertionError(f'bad history record {rec}')
    with open(os.path.join(cfg['output']['log_dir'], 'history.jsonl')) as f:
        if len(f.read().splitlines()) != TRAIN_EPOCHS:
            raise AssertionError('history.jsonl does not hold 2 records')
    steps = TRAIN_FRAMES // B
    want = ['host'] * steps + ['bank' if bank else 'host'] * steps
    if kinds != want:
        raise AssertionError(f'batches by source {kinds}, want {want}')
    ips = [r['images_per_sec'] for r in history]
    if not bank:
        log(f'[train] trainer, augmentation on, streamed: losses '
            f'{[round(r["loss"], 4) for r in history]}, images/s '
            f'{[round(v, 1) for v in ips]}')
        return {'history': history, 'seconds': seconds,
                'epoch2_images_per_sec': ips[-1]}

    # a bank gather is the host path's parts, bit for bit
    cache = trainer.train_gen._dcache
    lines = trainer.train_lines[:B]
    banks, idx, bank_boxes = cache.gather_args(HW, lines, TRAIN_MAX_BOXES)
    pixels, host_boxes = trainer.train_gen.loader.load_batch(lines, HW)
    pixels = pixels if isinstance(pixels, tuple) else (pixels,)
    rows = torch.from_numpy(idx).to(dev)
    if not (len(banks) == len(pixels) == 3
            and all(torch.equal(bk[rows].cpu(), torch.as_tensor(p).cpu())
                    for bk, p in zip(banks, pixels))
            and np.array_equal(bank_boxes, host_boxes)):
        raise AssertionError('a bank gather differs from the host path')
    def held(c):
        return sum(b.numel() for bk in c._banks.values() for b in bk)
    bank_bytes = {'train': held(cache),
                  'val': held(trainer.val_gen._dcache),
                  'ledger': cache._ledger['bytes'],
                  'shared': cache._ledger is trainer.val_gen._dcache._ledger}
    if not (bank_bytes['shared'] and bank_bytes['ledger']
            == bank_bytes['train'] + bank_bytes['val']):
        raise AssertionError(f'the ledger does not count both banks: '
                             f'{bank_bytes}')

    # a checkpoint restores into a fresh state
    mgr = CheckpointManager(cfg['callbacks']['checkpoint']['save_dir'])
    step = mgr.latest_step()
    if step is None:
        raise AssertionError('no checkpoint was written')
    raw = mgr.restore_raw(step)
    fresh, _, _ = build_model_for_training(cfg, device=dev, seed=SEED + 1)
    state = create_train_state(fresh, create_optimizer_from_config(
        cfg, apply_freeze(fresh, 0)))
    mgr.restore(state, step)
    sd = fresh.state_dict()
    if not all(torch.equal(sd[k].cpu(), v) for k, v in raw['model'].items()):
        raise AssertionError('the restored model differs from its checkpoint')
    if state.step != raw['step'] or state.optimizer.count != \
            raw['optimizer']['count']:
        raise AssertionError('the restored step or optimizer count differs')

    # the export loads into the serving engine (the port's own msgpack
    # codec) and serves a batch
    final = os.path.join(cfg['output']['model_dir'], 'final_model.msgpack')
    scfg = serve_config('pallas_fused')
    scfg['weights_path'] = final
    engine = MultiGridInference(scfg, device=dev)
    served = engine.model.state_dict()
    exported = trainer.model.state_dict()
    if not all(torch.equal(served[k], exported[k].to(served[k].device))
               for k in served if not k.endswith('num_batches_tracked')):
        raise AssertionError('served weights differ from the trained model')
    bx, cl, sc, va = fetch_detections(engine.infer_batch(val_batch))
    if not (np.isfinite(bx[va]).all() and np.isfinite(sc[va]).all()):
        raise AssertionError('the exported model served non-finite output')
    log(f'[train] trainer, augmentation on, bank on: {TRAIN_EPOCHS} epochs '
        f'of {steps} steps in {seconds:.1f} s (epoch 1 streamed, epoch 2 '
        f'from the bank), losses {[round(r["loss"], 4) for r in history]}, '
        f'val {[round(r["val_loss"], 4) for r in history]}, images/s '
        f'{[round(v, 1) for v in ips]}; bank gather equal to the host path '
        f'bit for bit; bank bytes {bank_bytes}; checkpoint {step} '
        f'restored; {os.path.getsize(final) / 2 ** 20:.1f} MiB export '
        f'served ({int(va.sum())} detections); NMS launches while training '
        f'{launches}')
    return {'history': history, 'seconds': seconds, 'restored_step': step,
            'epoch2_images_per_sec': ips[-1], 'launches': list(launches),
            'bank_bytes': bank_bytes}


def count_ops(fn):
    """The ATen ops ``fn`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode
    count = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count[0] += 1
            return func(*args, **(kwargs or {}))
    with Counter():
        fn()
    return count[0]


def profile_calls(fn, calls, name='window'):
    """``calls`` calls of ``fn`` under ``torch.profiler`` (``utils.profiling
    .trace``, its Chrome trace written to ``build/traces/<name>``): CUDA
    kernels a call, device ms a call by kernel group (``profile_serve``'s
    groups), the device's busy share of the wall time, and the host side:
    top-level host ops a call, the host ms inside them, and the costliest
    of them by name (count and ms a call).  None where the profiler
    records no kernel (on the CPU, or if its tracing is unavailable)."""
    from collections import defaultdict
    import torch
    from multigriddet_tpu_torch.profile_serve import _group, _union_us
    from multigriddet_tpu_torch.utils.profiling import trace
    with trace(os.path.join(REPO, 'build', 'traces', name)) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    by_group, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        by_group[_group(e.name)] += e.time_range.end - e.time_range.start
        by_name[e.name[:60]] += e.time_range.end - e.time_range.start
    busy = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.cpu_parent is None]
    host_us, host_n = defaultdict(float), defaultdict(int)
    for e in host:
        host_us[e.name[:60]] += e.time_range.end - e.time_range.start
        host_n[e.name[:60]] += 1
    host_top = sorted(host_us, key=lambda k: -host_us[k])[:8]
    return {'kernels': len(kernels) / calls,
            'group_ms': {k: v / calls / 1e3
                         for k, v in sorted(by_group.items())},
            'top_ms': {k: round(v / calls / 1e3, 3) for k, v in top},
            'device_busy_share': busy / wall_us,
            'wall_ms': wall_us / calls / 1e3,
            'host_ops': len(host) / calls,
            'host_op_ms': sum(host_us.values()) / calls / 1e3,
            'host_top': {k: [host_n[k] / calls,
                             round(host_us[k] / calls / 1e3, 3)]
                         for k in host_top},
            'host_counts': {k: n / calls for k, n in host_n.items()}}


def overfit_and_times(dev, root, canvases, boxes):
    """40 fused steps on one fixed batch (the loss must halve), then the
    step and its parts timed on that resident batch."""
    import numpy as np
    import torch
    from multigriddet_tpu_torch.config import (build_model_for_training,
                                               create_optimizer_from_config)
    from multigriddet_tpu_torch.losses import multigrid_loss
    from multigriddet_tpu_torch.ops.encoding import encode_targets
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.training import (apply_freeze,
                                                 create_train_state,
                                                 make_fused_train_step)
    from multigriddet_tpu_torch.training.steps import train_forward
    cfg = train_config(root, lr=OVERFIT_LR, schedule={'type': 'constant'})
    model, spec, loss_cfg = build_model_for_training(cfg, device=dev,
                                                     seed=SEED)
    anchors = spec['anchors']
    opt = create_optimizer_from_config(cfg, apply_freeze(model, 0))
    state = create_train_state(model, opt)
    host_step, _ = make_fused_train_step(anchors, NUM_CLASSES, loss_cfg,
                                         aug_cfg={'enabled': False})
    parts = tuple(torch.from_numpy(p).to(dev)
                  for p in rgb_to_yuv420_np(canvases))
    gen = torch.Generator().manual_seed(SEED)
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, m = host_step(state, parts, boxes, gen)
        losses.append(m['loss'])
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or losses[-1] > 0.5 * losses[0]:
        raise AssertionError(f'overfit: loss {losses[0]!r} -> {losses[-1]!r}'
                             f' in {OVERFIT_STEPS} steps (must halve)')
    log(f'[train] overfit b{B} @{HW[0]} bf16, Adam {OVERFIT_LR}: loss '
        f'{losses[0]:.4f} -> {losses[-1]:.4f} ({losses[-1] / losses[0]:.3f}'
        f'x) in {OVERFIT_STEPS} steps; every 5th: '
        f'{[round(v, 3) for v in losses[::5]]}')

    times = {}
    torch.cuda.reset_peak_memory_stats()
    times['step_ms'] = cuda_ms(lambda: host_step(state, parts, boxes, gen),
                               TIMED_STEPS, WARMUP_STEPS)
    times['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    times['img_per_s'] = B / (times['step_ms'] / 1e3)
    # the same step with the train config's augmentation (new draws each
    # call), and the device stage alone (augment + encode), off and on
    aug_step, _ = make_fused_train_step(anchors, NUM_CLASSES, loss_cfg,
                                        aug_cfg=TRAIN_AUG)
    times['step_aug_ms'] = cuda_ms(
        lambda: aug_step(state, parts, boxes, gen), TIMED_STEPS, WARMUP_STEPS)
    times['img_per_s_aug'] = B / (times['step_aug_ms'] / 1e3)
    from multigriddet_tpu_torch.data.pipeline import _device_stage
    for key, cfg_ in (('stage_ms', AUG_OFF), ('stage_aug_ms', TRAIN_AUG)):
        times[key] = cuda_ms(lambda: _device_stage(
            parts, boxes, gen, cfg_, anchors, NUM_CLASSES, HW, True),
            TIMED_STEPS, WARMUP_STEPS)
    # the augmented stage's parts: the draws on the host, the chain on
    # the card (draws already there), and where its device time goes
    from multigriddet_tpu_torch.data import augment as A
    from multigriddet_tpu_torch.data.pipeline import (apply_chain,
                                                      draw_chain,
                                                      pixels_to_f32)
    t_draw = time.perf_counter()
    for _ in range(TIMED_STEPS):
        draws = draw_chain(gen, B, TRAIN_MAX_BOXES, TRAIN_AUG)
    times['aug_draw_host_ms'] = (time.perf_counter() - t_draw) * 1e3 / \
        TIMED_STEPS
    draws = A.draws_to(draws, dev)
    boxes_dev = torch.from_numpy(boxes).to(dev)
    images_f32 = pixels_to_f32(parts)
    times['aug_apply_ms'] = cuda_ms(lambda: apply_chain(
        images_f32, boxes_dev, draws, TRAIN_AUG), TIMED_STEPS, WARMUP_STEPS)
    times['stage_aug_profile'] = profile_calls(lambda: _device_stage(
        parts, boxes, gen, TRAIN_AUG, anchors, NUM_CLASSES, HW, True), 3,
        'stage_aug')
    times['aug_apply_profile'] = profile_calls(lambda: apply_chain(
        images_f32, boxes_dev, draws, TRAIN_AUG), 3, 'aug_apply')
    # the encoder at mosaic's box counts: mosaic on every image
    mosaic_boxes = _device_stage(
        parts, boxes, torch.Generator().manual_seed(SEED),
        dict(TRAIN_AUG, mosaic_prob=1.0), anchors, NUM_CLASSES, HW,
        True)[2]
    times['mosaic_max_valid_boxes'] = int(valid_rows(mosaic_boxes).sum(
        1).max())
    times['mosaic_capacity'] = int(mosaic_boxes.shape[1])
    times['encode_mosaic_ops'] = count_ops(lambda: encode_targets(
        mosaic_boxes, anchors, NUM_CLASSES, HW, device=dev))
    times['encode_mosaic_ms'] = cuda_ms(lambda: encode_targets(
        mosaic_boxes, anchors, NUM_CLASSES, HW, device=dev), TIMED_STEPS,
        WARMUP_STEPS)
    log(f'[train] augmentation (train config block) b{B} @{HW[0]} bf16: '
        f'fused step {times["step_aug_ms"]:.3f} ms '
        f'({times["img_per_s_aug"]:.1f} img/s) vs {times["step_ms"]:.3f} ms '
        f'off; device stage alone (u8 -> augment -> encode) '
        f'{times["stage_aug_ms"]:.3f} ms vs {times["stage_ms"]:.3f} ms off; '
        f'encoder at mosaic\'s box counts (mosaic on all {B}, '
        f'{times["mosaic_max_valid_boxes"]} valid boxes at most of '
        f'{times["mosaic_capacity"]} slots): {times["encode_mosaic_ops"]} '
        f'ops, {times["encode_mosaic_ms"]:.3f} ms; the chain alone on the '
        f'card (draws there) {times["aug_apply_ms"]:.3f} ms, the draws on '
        f'the host {times["aug_draw_host_ms"]:.3f} ms')
    for key in ('stage_aug_profile', 'aug_apply_profile'):
        prof = times[key]
        if prof:
            log(f'[train] profiled {key[:-8]}: {prof["wall_ms"]:.1f} ms '
                f'wall, {prof["kernels"]:.0f} CUDA kernels, device busy '
                f'{prof["device_busy_share"]:.1%}, device ms by group '
                f'{ {k: round(v, 2) for k, v in prof["group_ms"].items()} }'
                f', top kernels {prof["top_ms"]}')
    times['encode_ms'] = cuda_ms(lambda: encode_targets(
        boxes, anchors, NUM_CLASSES, HW, device=dev), TIMED_STEPS,
        WARMUP_STEPS)
    times['encode_ops'] = count_ops(lambda: encode_targets(
        boxes, anchors, NUM_CLASSES, HW, device=dev))
    y_true = encode_targets(boxes, anchors, NUM_CLASSES, HW, device=dev)
    prof = profile_calls(lambda: encode_targets(
        boxes, anchors, NUM_CLASSES, HW, device=dev), 1, 'encode')
    times['encode_cuda_kernels'] = prof and prof['kernels']
    times['max_valid_boxes'] = int(((boxes[..., 2] - boxes[..., 0])
                                    * (boxes[..., 3] - boxes[..., 1])
                                    > 0).sum(1).max())
    from multigriddet_tpu_torch.data.pipeline import pixels_to_f32
    from multigriddet_tpu_torch.data.augment import normalize_images
    images = normalize_images(pixels_to_f32(parts))
    anc = [torch.from_numpy(a).to(dev) for a in anchors]

    def forward_loss():
        outs = train_forward(model, images)
        return multigrid_loss(outs, list(y_true), anc, NUM_CLASSES, HW,
                              loss_cfg)[0]
    times['forward_loss_ms'] = cuda_ms(forward_loss, TIMED_STEPS,
                                       WARMUP_STEPS)
    # of which the loss: on the forward's outputs, its graph built
    outs = [o.detach().requires_grad_() for o in train_forward(model, images)]
    times['loss_ms'] = cuda_ms(lambda: multigrid_loss(
        outs, list(y_true), anc, NUM_CLASSES, HW, loss_cfg), TIMED_STEPS,
        WARMUP_STEPS)
    del outs
    total = forward_loss()
    opt.zero_grad()
    times['backward_ms'] = cuda_ms(
        lambda: total.backward(retain_graph=True), TIMED_STEPS, WARMUP_STEPS)
    del total
    times['optimizer_ms'] = cuda_ms(opt.step, TIMED_STEPS, WARMUP_STEPS)
    log(f'[train] fused train step b{B} @{HW[0]} bf16 (Adam): '
        f'{times["step_ms"]:.3f} ms, {times["img_per_s"]:.1f} img/s, peak '
        f'{times["peak_gib"]:.2f} GiB; parts alone: encode '
        f'{times["encode_ms"]:.3f} ms ({times["encode_ops"]} ops, '
        f'{times["encode_cuda_kernels"]} CUDA kernels, '
        f'{times["max_valid_boxes"]} boxes at most), forward + loss '
        f'{times["forward_loss_ms"]:.3f} ms (the loss '
        f'{times["loss_ms"]:.3f}), backward '
        f'{times["backward_ms"]:.3f} ms, optimizer '
        f'{times["optimizer_ms"]:.3f} ms')
    # where the step's device time goes, and how busy the device is
    times['profile'] = profile_calls(
        lambda: host_step(state, parts, boxes, gen), 5, 'train_step')
    if times['profile']:
        prof = times['profile']
        log(f'[train] profiled fused step: {prof["wall_ms"]:.1f} ms wall, '
            f'{prof["kernels"]:.0f} CUDA kernels, device busy '
            f'{prof["device_busy_share"]:.1%}; device ms by group '
            f'{ {k: round(v, 2) for k, v in prof["group_ms"].items()} }')
    return {'overfit_losses': losses, **times}


def phase_train(dev, smi):
    """Phase 7: step parity card vs CPU, the augmented device stage card vs
    CPU, the trainer through its entry point with augmentation and the
    device bank on (and streamed), an overfit run and the train step's
    times."""
    import shutil
    t0 = time.perf_counter()
    report = {'parity': train_step_parity(dev),
              'augment': augment_checks(dev)}
    root = os.path.join(REPO, 'build', 'chip_smoke_train')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lines, canvases, boxes = train_frames(TRAIN_FRAMES, SEED + 11)
    write_frames(root, 'train.txt', lines, canvases, boxes, 'yuv420')
    vlines, vcanvases, vboxes = train_frames(VAL_FRAMES, SEED + 12)
    write_frames(root, 'val.txt', vlines, vcanvases, vboxes, 'rgb')
    report['trainer'] = train_through_trainer(dev, root, vcanvases[:B])
    report['trainer_streamed'] = train_through_trainer(dev, root, None,
                                                       bank=False)
    report['step'] = overfit_and_times(dev, root, canvases[:B], boxes[:B])
    report['step']['epoch2_images_per_sec'] = \
        report['trainer']['epoch2_images_per_sec']
    report['step']['epoch2_images_per_sec_streamed'] = \
        report['trainer_streamed']['epoch2_images_per_sec']
    shutil.rmtree(root, ignore_errors=True)
    report['seconds'] = time.perf_counter() - t0
    log(f'[train] trainer epoch 2, augmentation on: '
        f'{report["step"]["epoch2_images_per_sec"]:.1f} img/s from the '
        f'bank, {report["step"]["epoch2_images_per_sec_streamed"]:.1f} '
        f'img/s streamed; card: {smi}')
    failures = report['parity']['failures'] + report['augment']['failures']
    if failures:
        raise AssertionError('train phase: ' + '; '.join(failures))
    return report


def phase_overfit_map(dev, smi):
    """Phase 8 (ROADMAP item 11): the ``learning`` mode of
    ``multigriddet_tpu_torch.validate`` (``tools/validate_learning.py``)
    on the card.  The tool's 16 PIL-written 128x128 JPEGs of two classes
    (a dark gray field, one red or green box) are read through nvJPEG and
    the ``csrc/jpeg.cu`` kernels; ``multigriddet_tiny`` (one anchor a
    level, flax's initializers) trains for ``MAP_EPOCHS`` epochs at b8
    with Adam 2e-3 and augmentation off, then the tool's scoring loop
    (Pillow's letterbox, the fused infer step at confidence 0.15 and 10
    boxes, one image at a time, ``calculate_map`` at IoU 0.5) scores it
    through ``xla`` and ``pallas_fused``.  Fails below mAP50
    ``MAP50_MIN`` on either, or where the run launched no pop-max,
    ``ycc_to_rgb`` or ``letterbox_yuv420``; the two JPEG kernels are then
    held against their plain versions on the set's own files
    (``validate_jpeg_check``).  Returns the report with the launches of
    the run."""
    import dataclasses
    import shutil
    import numpy as np
    from multigriddet_tpu_torch.data import load_annotation_lines
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.validate import LEARNING, run, write_set
    t0 = time.perf_counter()
    root = os.path.join(REPO, 'build', 'chip_smoke_overfit')
    shutil.rmtree(root, ignore_errors=True)
    task = dataclasses.replace(LEARNING, epochs=MAP_EPOCHS, lr=MAP_LR)
    ann = write_set(task, root)
    cuda_nms.popmax_nms.launches = 0
    reset_jpeg_launches()
    done = run(task, ann, dev, log=log)
    launches = cuda_nms.popmax_nms.launches
    jpeg_launches = read_jpeg_launches('overfit')
    check = validate_jpeg_check(
        dev, load_annotation_lines(ann, shuffle=False)[:task.batch_size],
        task.hw, 'overfit')
    shutil.rmtree(root, ignore_errors=True)
    res = done.result
    spe = res['steps'] // MAP_EPOCHS
    losses = [done.trained.losses[(e + 1) * spe - 1]
              for e in range(MAP_EPOCHS)
              if e % 100 == 0 or e == MAP_EPOCHS - 1]
    maps = {k: v['mAP50'] for k, v in res['scores'].items()}
    map50 = min(maps.values())
    seconds = time.perf_counter() - t0
    log(f'[overfit] multigriddet_tiny @{MAP_HW[0]}, {MAP_FRAMES} frames '
        f'(the tool\'s PIL JPEGs through nvJPEG), {MAP_EPOCHS} epochs at '
        f'b8 (Adam {MAP_LR}, float32): loss every 100 epochs '
        f'{[round(v, 4) for v in losses]}, final {losses[-1]:.4f}; mAP50 '
        f'{maps} (limit {MAP50_MIN}); pop-max launches {launches}, '
        f'jpeg.cu launches {jpeg_launches}; training '
        f'{res["seconds"]:.1f} s, phase {seconds:.1f} s; card: {smi}')
    if not (np.isfinite(losses).all() and map50 >= MAP50_MIN
            and launches > 0):
        raise AssertionError(f'overfit: mAP50 {maps} < {MAP50_MIN} or no '
                             f'pop-max launch ({launches}), losses '
                             f'{losses}')
    return {'map50': map50, 'map50_by_backend': maps,
            'final_loss': losses[-1], 'losses': losses,
            'popmax_launches': launches, 'jpeg_launches': jpeg_launches,
            'jpeg_check': check, 'train_seconds': res['seconds'],
            'images_per_s': res['images_per_s'], 'seconds': seconds}


# ---------------------------------------------------------------------------
# phase 9: the rest of the model zoo and activation checkpointing
# ---------------------------------------------------------------------------

ZOO_PRESETS = ('multigriddet_darknet_spp', 'multigriddet_darknet_lite',
               'multigriddet_csp_darknet', 'multigriddet_darknet_panet',
               'multigriddet_resnet', 'multigriddet_mobile')
# model.type: custom -- ResNet-101 + the FPN neck + the lite head
ZOO_CUSTOM = {'backbone': {'type': 'resnet101'},
              'neck': {'type': 'multigrid_fpn'},
              'head': {'type': 'multigrid_lite'}}
# the zoo's steps: the median of ZOO_WINDOWS windows of ZOO_TIMED calls
# each, after ZOO_WARMUP (one window's mean moved by up to 40% between
# models of the same size in one run: the host's hiccups)
ZOO_SERVE_BATCHES, ZOO_WINDOWS, ZOO_TIMED, ZOO_WARMUP = 2, 4, 5, 3
ZOO_GRAD_B, ZOO_GRAD_HW = 2, (128, 128)
REMAT_B, REMAT_HW, REMAT_LR = 2, (416, 416), 1e-2
# remat against the plain step, float32 on one card with deterministic
# cuDNN: the checkpointed backbone runs the same kernels on the same
# inputs, so only the loss's atomic accumulations may differ (a few ulps of
# a gradient element).  Loss and running statistics relative (of max(1,
# |v|)); gradients of each tensor's largest |grad|; parameters after one
# SGD step (lr 1e-2, no momentum: Adam's first update would turn a
# rounding-level gradient into a full learning-rate step) absolute
REMAT_LOSS_RTOL, REMAT_STAT_RTOL, REMAT_GRAD_RTOL, REMAT_PARAM_ATOL = (
    1e-6, 1e-6, 1e-5, 1e-6)


def windowed_ms(fn):
    """``cuda_ms`` over ``ZOO_WINDOWS`` windows of ``ZOO_TIMED`` calls after
    ``ZOO_WARMUP``: (median, min, max) of the windows' ms a call."""
    import numpy as np
    ms = [cuda_ms(fn, ZOO_TIMED, ZOO_WARMUP if i == 0 else 0)
          for i in range(ZOO_WINDOWS)]
    return float(np.median(ms)), float(min(ms)), float(max(ms))


def zoo_model_block(name):
    """The config's ``model`` block for a preset or ``'custom'``: 80
    classes, COCO anchors, 608x608."""
    preset = {'architecture': name if name != 'custom' else
              'multigriddet_darknet', 'num_classes': NUM_CLASSES,
              'input_shape': [*HW, 3],
              'anchors_path': os.path.join(REPO, 'configs',
                                           'yolov3_coco_anchor.txt')}
    if name == 'custom':
        return {'type': 'custom', 'preset': preset,
                'custom': dict(ZOO_CUSTOM)}
    return {'type': 'preset', 'preset': preset}


def zoo_serve(name, dev, batches):
    """(a) serve two batches through ``MultiGridInference`` with the
    pop-max kernel; (b) the float32 forward at b1 on the card against the
    CPU.  Returns the report."""
    import numpy as np
    import torch
    from multigriddet_tpu_torch.config import build_model_from_config
    from multigriddet_tpu_torch.inference import MultiGridInference
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.training.steps import (candidate_pool,
                                                       fetch_detections)
    cfg = serve_config('pallas_fused')
    cfg['model'] = zoo_model_block(name)
    engine = MultiGridInference(cfg, device=dev)    # seeded weights, seed 0
    params = sum(p.numel() for p in engine.model.parameters())
    cuda_nms.popmax_nms.launches = 0
    cuda_nms.greedy_nms.launches = 0
    outs = [engine.infer_batch(b) for b in batches]
    torch.cuda.synchronize()
    launches = {'popmax_nms': cuda_nms.popmax_nms.launches,
                'greedy_nms': cuda_nms.greedy_nms.launches}
    if launches != {'popmax_nms': len(batches), 'greedy_nms': 0}:
        raise AssertionError(f'{name}: kernel launches {launches}, expected '
                             f'{len(batches)} pop-max, 0 greedy')
    res = [fetch_detections(o) for o in outs]
    for bx, cl, sc, va in res:
        if not ((va.sum(1) >= 1).all() and np.isfinite(bx[va]).all()
                and ((sc[va] >= 0) & (sc[va] <= 1)).all()
                and ((cl[va] >= 0) & (cl[va] < NUM_CLASSES)).all()):
            raise AssertionError(f'{name}: detections out of range')
    with torch.inference_mode():
        x = torch.from_numpy(batches[0]).to(dev).float() / 255.0
        pool = candidate_pool(engine.model, x, engine.spec['anchors'], HW)
        plain = cuda_nms.popmax_nms_plain(*pool, 0.0, THR, MAX_BOXES, 'diou',
                                          True)
    for what, a, b in zip(('boxes', 'classes', 'scores', 'valid'), res[0],
                          (t.cpu().numpy() for t in plain)):
        if not np.array_equal(a, b):
            raise AssertionError(f'{name}: served {what} differ from the '
                                 f'plain pop-max on the same pool')
    x_dev = torch.from_numpy(batches[0]).to(dev)
    step_ms, step_min, step_max = windowed_ms(
        lambda: engine.infer_batch(x_dev))

    # (b) float32 forward, b1, TF32 off: the card against the CPU
    model, _ = build_model_from_config(cfg, dtype=torch.float32)
    model.load_state_dict(engine.model.state_dict())
    x1 = torch.from_numpy(batches[0][:1]).float() / 255.0
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = [t.numpy() for t in model(x1)]
            got = [t.cpu().numpy() for t in model.to(dev)(x1.to(dev))]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    f32_err = max(float(np.abs(r - g).max()) / max(1.0, float(np.abs(r)
                                                              .max()))
                  for r, g in zip(ref, got))
    if not (all(np.isfinite(g).all() and g.shape == r.shape
                for r, g in zip(ref, got)) and f32_err <= F32_PARITY_RTOL):
        raise AssertionError(f'{name}: float32 forward card vs CPU '
                             f'{f32_err:.3e} > {F32_PARITY_RTOL}')
    del model
    return {'params': params, 'popmax_launches': launches['popmax_nms'],
            'serve_step_ms': step_ms,
            'serve_step_ms_range': [step_min, step_max],
            'serve_img_per_s': B / (step_ms / 1e3),
            'valid_per_image': [int(v) for v in res[0][3].sum(1)],
            'f32_rel_err': f32_err}


def zoo_train_step(name, dev, canvases, boxes, remat=False):
    """(c) the fused train step (Adam, augmentation off) at b8 @608 bf16:
    one step must give a finite loss and move the running statistics;
    then its time (``windowed_ms``) and the peak memory."""
    import math
    import torch
    from multigriddet_tpu_torch.config import (build_model_for_training,
                                               create_optimizer_from_config)
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.training import (apply_freeze,
                                                 create_train_state,
                                                 make_fused_train_step)
    cfg = train_config('', schedule={'type': 'constant'})
    cfg['model'] = zoo_model_block(name)
    cfg['environment']['remat'] = remat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, spec, loss_cfg = build_model_for_training(cfg, device=dev,
                                                     seed=SEED)
    state = create_train_state(model, create_optimizer_from_config(
        cfg, apply_freeze(model, 0)))
    host_step, _ = make_fused_train_step(spec['anchors'], NUM_CLASSES,
                                         loss_cfg, aug_cfg={'enabled': False})
    parts = tuple(torch.from_numpy(p).to(dev)
                  for p in rgb_to_yuv420_np(canvases))
    gen = torch.Generator().manual_seed(SEED)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith('running_var')}
    _, metrics = host_step(state, parts, boxes, gen)
    loss = float(metrics['loss'])
    after = model.state_dict()
    moved = sum(not torch.equal(after[k], v) for k, v in before.items())
    if not (math.isfinite(loss) and moved == len(before)):
        raise AssertionError(f'{name}: train step loss {loss!r}, '
                             f'{moved} of {len(before)} running variances '
                             f'moved')
    step_ms, step_min, step_max = windowed_ms(
        lambda: host_step(state, parts, boxes, gen))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, model, host_step
    return {'train_loss': loss, 'train_step_ms': step_ms,
            'train_step_ms_range': [step_min, step_max],
            'train_img_per_s': B / (step_ms / 1e3), 'train_peak_gib': peak}


def zoo_grad64(name, dev):
    """(d) one train step in float64 at b2 @128 on the card and on the
    CPU from identical weights, images and targets: every gradient within
    ``GRAD64_RTOL`` of its tensor's largest |grad| on the CPU."""
    import copy
    import torch
    from multigriddet_tpu_torch.config import (build_model_from_config,
                                               create_optimizer_from_config,
                                               loss_config_from_config)
    from multigriddet_tpu_torch.data.pipeline import _device_stage
    from multigriddet_tpu_torch.models import (load_flax_variables,
                                               random_flax_variables)
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.training import (apply_freeze,
                                                 create_train_state,
                                                 make_train_step)
    cfg = train_config('', ZOO_GRAD_HW, mixed=False,
                       schedule={'type': 'constant'})
    cfg['model'] = zoo_model_block(name)
    model, spec = build_model_from_config(cfg, dtype=torch.float64)
    load_flax_variables(model, *random_flax_variables(model, seed=SEED))
    model.double()
    _, canvases, boxes = train_frames(ZOO_GRAD_B, SEED + 5, ZOO_GRAD_HW)
    anchors = spec['anchors']
    images, y_true, _ = _device_stage(
        tuple(torch.from_numpy(p) for p in rgb_to_yuv420_np(canvases)),
        boxes, None, {'enabled': False}, anchors, NUM_CLASSES, ZOO_GRAD_HW,
        True)
    step = make_train_step(anchors, NUM_CLASSES, ZOO_GRAD_HW,
                           loss_config_from_config(cfg))

    def grads(d):
        m = copy.deepcopy(model).to(d).train()
        state = create_train_state(m, create_optimizer_from_config(
            cfg, apply_freeze(m, 0)))
        step(state, images.to(d), [y.to(d) for y in y_true])
        return {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
    ref, got = grads('cpu'), grads(dev)
    err = max(float((got[n] - r).abs().max())
              / max(float(r.abs().max()), 1e-300) for n, r in ref.items())
    if not err <= GRAD64_RTOL:
        raise AssertionError(f'{name}: float64 gradients card vs CPU '
                             f'{err:.3e} > {GRAD64_RTOL}')
    return {'grad64_rel_err': err, 'grad_tensors': len(ref)}


def remat_checks(dev, canvases, boxes):
    """``environment.remat`` on ``multigriddet_darknet``: (1) float32 at
    b2 @416 with deterministic cuDNN, one SGD step of ``True`` and of
    ``'full'`` against the plain step from the same weights and batch --
    loss, gradients, parameters and running statistics; (2) the fused
    step's time and peak memory at b8 @608 bf16 for plain, ``True`` and
    ``'full'``."""
    import copy
    import torch
    from multigriddet_tpu_torch.config import (build_model_from_config,
                                               create_optimizer_from_config,
                                               loss_config_from_config)
    from multigriddet_tpu_torch.data.pipeline import _device_stage
    from multigriddet_tpu_torch.models import (load_flax_variables,
                                               random_flax_variables)
    from multigriddet_tpu_torch.models.detector import remat_mode
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.training import (apply_freeze,
                                                 create_train_state,
                                                 make_train_step)
    cfg = train_config('', REMAT_HW, mixed=False, lr=REMAT_LR,
                       schedule={'type': 'constant'})
    cfg['optimizer'] = {'type': 'sgd', 'momentum': 0.0}
    model, spec = build_model_from_config(cfg)
    load_flax_variables(model, *random_flax_variables(model, seed=SEED))
    _, frames, fboxes = train_frames(REMAT_B, SEED + 9, REMAT_HW)
    anchors = spec['anchors']
    images, y_true, _ = _device_stage(
        tuple(torch.from_numpy(p).to(dev)
              for p in rgb_to_yuv420_np(frames)), fboxes, None,
        {'enabled': False}, anchors, NUM_CLASSES, REMAT_HW, True)
    step = make_train_step(anchors, NUM_CLASSES, REMAT_HW,
                           loss_config_from_config(cfg))

    def one_step(remat):
        m = copy.deepcopy(model).to(dev).train()
        m.remat = remat_mode(remat)
        state = create_train_state(m, create_optimizer_from_config(
            cfg, apply_freeze(m, 0)))
        _, metrics = step(state, images, y_true)
        return (float(metrics['loss']),
                {n: p.grad.detach().clone() for n, p in m.named_parameters()},
                {k: v.detach().clone() for k, v in m.state_dict().items()})
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        plain = one_step(False)
        equal = {}
        for remat in (True, 'full'):
            loss, grads, sd = one_step(remat)
            stat = max(float(((sd[k] - v).abs() / v.abs().clamp_min(1.0))
                             .max()) for k, v in plain[2].items()
                       if 'running' in k)
            param = max(float((sd[k] - v).abs().max())
                        for k, v in plain[2].items() if 'running' not in k)
            grad = max(float((grads[n] - g).abs().max())
                       / max(float(g.abs().max()), 1e-30)
                       for n, g in plain[1].items())
            equal[str(remat)] = {
                'loss_rel': abs(loss - plain[0]) / max(1.0, abs(plain[0])),
                'stat_rel': stat, 'grad_rel': grad, 'param_abs': param}
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = flags
    for remat, e in equal.items():
        if not (e['loss_rel'] <= REMAT_LOSS_RTOL
                and e['stat_rel'] <= REMAT_STAT_RTOL
                and e['grad_rel'] <= REMAT_GRAD_RTOL
                and e['param_abs'] <= REMAT_PARAM_ATOL):
            raise AssertionError(f'remat {remat}: the step differs from the '
                                 f'plain step: {e}')
    del model
    times = {str(remat): zoo_train_step('multigriddet_darknet', dev,
                                        canvases, boxes, remat=remat)
             for remat in (False, True, 'full')}
    return {'equal': equal, 'times': times}


def phase_zoo(dev, smi):
    """Phase 9: each preset of the rest of the zoo and one custom
    composition -- (a) served with the pop-max kernel and bit-equal to
    the plain pop-max, (b) the float32 forward against the CPU, (c) a
    timed fused train step, (d) float64 gradients against the CPU -- then
    ``environment.remat`` on ``multigriddet_darknet``."""
    import torch

    def rng(lo_hi):
        return f'(windows {lo_hi[0]:.1f}-{lo_hi[1]:.1f})'
    t0 = time.perf_counter()
    batches = letterboxed_batches(ZOO_SERVE_BATCHES, SEED + 3)
    _, canvases, boxes = train_frames(B, SEED + 13)
    report = {}
    for name in ZOO_PRESETS + ('custom',):
        t1 = time.perf_counter()
        r = zoo_serve(name, dev, batches)
        r.update(zoo_train_step(name, dev, canvases, boxes))
        r.update(zoo_grad64(name, dev))
        r['seconds'] = time.perf_counter() - t1
        report[name] = r
        torch.cuda.empty_cache()
        log(f'[zoo] {name} ({r["params"] / 1e6:.2f}M params): serve b{B} '
            f'@{HW[0]} bf16 {r["serve_step_ms"]:.3f} ms '
            f'{rng(r["serve_step_ms_range"])} '
            f'({r["serve_img_per_s"]:.1f} img/s), {r["popmax_launches"]} '
            f'pop-max launches, equal to the plain pop-max; f32 forward '
            f'card vs CPU {r["f32_rel_err"]:.3e}; train step '
            f'{r["train_step_ms"]:.3f} ms {rng(r["train_step_ms_range"])} '
            f'({r["train_img_per_s"]:.1f} img/s), peak {r["train_peak_gib"]:.2f} GiB, loss '
            f'{r["train_loss"]:.3f}; float64 gradients @{ZOO_GRAD_HW[0]} '
            f'{r["grad64_rel_err"]:.3e}; {r["seconds"]:.1f} s')
    remat = remat_checks(dev, canvases, boxes)
    for mode, e in remat['equal'].items():
        log(f'[zoo] remat {mode} vs plain, f32 b{REMAT_B} @{REMAT_HW[0]}, '
            f'one SGD step: loss {e["loss_rel"]:.3e}, statistics '
            f'{e["stat_rel"]:.3e}, gradients {e["grad_rel"]:.3e}, '
            f'parameters {e["param_abs"]:.3e}')
    for mode, t in remat['times'].items():
        log(f'[zoo] remat {mode}: multigriddet_darknet train step b{B} '
            f'@{HW[0]} bf16 {t["train_step_ms"]:.3f} ms '
            f'{rng(t["train_step_ms_range"])} ({t["train_img_per_s"]:.1f} '
            f'img/s), peak {t["train_peak_gib"]:.2f} GiB')
    report['remat'] = remat
    report['popmax_launches'] = sum(r['popmax_launches'] for k, r in
                                    report.items()
                                    if k in ZOO_PRESETS + ('custom',))
    report['seconds'] = time.perf_counter() - t0
    log(f'[zoo] phase took {report["seconds"]:.1f} s; card: {smi}')
    return report


# ---------------------------------------------------------------------------
# phase 10: serving export
# ---------------------------------------------------------------------------

EXPORT_BATCHES = (1, 8)
# an exported program against the live step on the same card: the same
# ops on the same inputs; discrete outputs equal, boxes and scores within
# the JAX export test's 2e-5
EXPORT_ATOL = 2e-5
EXPORT_TINY_HW = (64, 64)


def compare_served(got, want, label):
    """Discrete outputs equal, boxes and scores within ``EXPORT_ATOL``;
    returns the largest float difference."""
    import numpy as np
    (gb, gc, gs, gv), (wb, wc, ws, wv) = got, want
    if not (np.array_equal(gv, wv) and np.array_equal(gc, wc)):
        raise AssertionError(f'{label}: classes or valid masks differ from '
                             f'the live step')
    err = max(float(np.abs(gb - wb).max()), float(np.abs(gs - ws).max()))
    if not err <= EXPORT_ATOL:
        raise AssertionError(f'{label}: boxes or scores {err:.3e} from the '
                             f'live step > {EXPORT_ATOL}')
    return err


def phase_export(dev, smi):
    """Phase 10: ``export_serving`` of ``multigriddet_darknet`` at 608 bf16
    on the card (``xla`` NMS, programs for b1 and b8), ``ServingModel``
    serving four batches of 8, one of 3 (padded) and one of 11 (chunked)
    against the live step, the served b8 step beside the live one, and a
    ``multigriddet_tiny`` artifact traced on the CPU served on the card."""
    import shutil
    import numpy as np
    import torch
    from multigriddet_tpu_torch.inference.export import (ServingModel,
                                                         export_serving)
    from multigriddet_tpu_torch.models import (create_model,
                                               load_flax_variables,
                                               random_flax_variables)
    from multigriddet_tpu_torch.training.steps import (fetch_detections,
                                                       make_infer_step)
    t0 = time.perf_counter()
    root = os.path.join(REPO, 'build', 'chip_smoke_export')
    shutil.rmtree(root, ignore_errors=True)
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    report = {}
    try:
        engine = build_engine('xla')
        kw = dict(confidence=engine.confidence,
                  nms_threshold=engine.nms_threshold,
                  nms_method=engine.nms_method, use_iol=engine.use_iol,
                  max_boxes=engine.max_boxes,
                  pre_nms_top_k=engine.pre_nms_top_k,
                  class_aware=engine.class_aware)
        art = os.path.join(root, 'darknet')
        t1 = time.perf_counter()
        meta = export_serving(engine.model, engine.spec['anchors'], HW, art,
                              batch_sizes=EXPORT_BATCHES,
                              class_names=engine.class_names, **kw)
        report['export_s'] = time.perf_counter() - t1
        report['artifact_mb'] = sum(
            os.path.getsize(os.path.join(art, n)) for n in os.listdir(art)
        ) / 2 ** 20
        t1 = time.perf_counter()
        serving = ServingModel(art)
        report['load_s'] = time.perf_counter() - t1
        live = make_infer_step(engine.model, engine.spec['anchors'], HW, **kw)

        top = max(EXPORT_BATCHES)

        def want(batch):
            """The live step on ``batch``, chunked by the largest program
            and each chunk padded to the smallest that fits, as the server
            does."""
            out = []
            for i in range(0, len(batch), top):
                part = batch[i:i + top]
                b = min(p for p in EXPORT_BATCHES if p >= len(part))
                pad = np.zeros((b - len(part), *HW, 3), np.uint8)
                res = fetch_detections(live(torch.from_numpy(
                    np.concatenate([part, pad])).to(dev)))
                out.append([r[:len(part)] for r in res])
            return [np.concatenate(p) for p in zip(*out)]
        batches = letterboxed_batches(SERVE_BATCHES + 2, SEED + 21)
        served = list(batches[:SERVE_BATCHES]) + [
            batches[-2][:3], np.concatenate([batches[-2], batches[-1][:3]]),
            batches[-1][:1]]
        errs = []
        for i, batch in enumerate(served):
            got = serving(batch)
            if got[0].shape[0] != len(batch):
                raise AssertionError('served batch of the wrong size')
            errs.append(compare_served(got, want(batch),
                                       f'export batch {i} (b{len(batch)})'))
        report['max_abs_diff'] = max(errs)
        report['served'] = [len(b) for b in served]
        report['valid_per_image'] = [int(v) for v in
                                     serving(served[0])[3].sum(1)]
        x = torch.from_numpy(np.concatenate(served[:SERVE_BATCHES])[:top]
                             ).to(dev)
        program = serving._fns[top]

        def served_step():
            with torch.inference_mode():
                return program(x)

        def served_step_no_grad():
            with torch.no_grad():
                return program(x)
        # in turns (A B C C B A, twice): steps of identical code drift
        # within one run
        steps = {'served_step_ms': served_step,
                 'served_no_grad_step_ms': served_step_no_grad,
                 'live_step_ms': lambda: live(x)}
        order = list(steps) + list(steps)[::-1]
        turns = {k: [] for k in steps}
        for k in order + order:
            turns[k].append(windowed_ms(steps[k])[0])
        report['step_turns_ms'] = turns
        report.update({k: float(np.median(v)) for k, v in turns.items()})
        # where the served program's time goes, beside the live step's
        report['served_profile'] = profile_calls(served_step, 3,
                                                 'export_served')
        report['live_profile'] = profile_calls(lambda: live(x), 3,
                                               'export_live')
        del serving, program, live, engine
        torch.cuda.empty_cache()

        # multigriddet_tiny traced on the CPU, served on the card
        tiny = create_model('multigriddet_tiny', num_classes=3)
        load_flax_variables(tiny, *random_flax_variables(tiny, seed=SEED))
        anchors = [np.array([[40, 40], [20, 20], [10, 10]], np.float32) / f
                   for f in (1, 2, 4)]
        tkw = dict(confidence=0.05, max_boxes=10, pre_nms_top_k=64)
        tart = os.path.join(root, 'tiny_cpu')
        export_serving(tiny, anchors, EXPORT_TINY_HW, tart, batch_sizes=[2],
                       device='cpu', **tkw)
        imgs = np.random.RandomState(SEED + 22).randint(
            0, 255, (2, *EXPORT_TINY_HW, 3)).astype(np.uint8)
        got = ServingModel(tart)(imgs)
        tiny.to(dev)
        tlive = make_infer_step(tiny, anchors, EXPORT_TINY_HW, **tkw)
        report['tiny_cpu_traced_max_abs_diff'] = compare_served(
            got, fetch_detections(tlive(torch.from_numpy(imgs).to(dev))),
            'tiny artifact traced on the CPU')
        report['tiny_valid'] = int(got[3].sum())
    finally:
        torch.backends.cudnn.benchmark = bench
        shutil.rmtree(root, ignore_errors=True)
    report['programs'] = meta['programs']
    report['seconds'] = time.perf_counter() - t0
    served_p, live_p = report['served_profile'], report['live_profile']
    if served_p and live_p:
        # the host ops a call that the served program runs more (or
        # fewer) of than the live step
        sc, lc = served_p['host_counts'], live_p['host_counts']
        report['host_ops_extra'] = {
            k: sc.get(k, 0) - lc.get(k, 0) for k in sorted(set(sc) | set(lc))
            if sc.get(k, 0) != lc.get(k, 0)}
        log(f'[export] host ops a call, served minus live: '
            f'{report["host_ops_extra"]}')
    for what in ('served', 'live'):
        prof = report[f'{what}_profile']
        if prof:
            log(f'[export] {what} b{B} step profiled: {prof["wall_ms"]:.1f} '
                f'ms wall, {prof["kernels"]:.0f} CUDA kernels, device '
                f'{sum(prof["group_ms"].values()):.2f} ms '
                f'({prof["group_ms"]}), busy '
                f'{prof["device_busy_share"]:.1%}; host '
                f'{prof["host_ops"]:.0f} top-level ops, '
                f'{prof["host_op_ms"]:.2f} ms inside them '
                f'({prof["host_top"]})')
    log(f'[export] multigriddet_darknet @{HW[0]} bf16, xla NMS: exported '
        f'b{EXPORT_BATCHES} in {report["export_s"]:.1f} s '
        f'({report["artifact_mb"]:.1f} MB), loaded in '
        f'{report["load_s"]:.1f} s; served batches of {report["served"]} '
        f'equal to the live step (largest float difference '
        f'{report["max_abs_diff"]:.3e}); b{B} step served '
        f'{report["served_step_ms"]:.3f} ms under inference_mode, '
        f'{report["served_no_grad_step_ms"]:.3f} ms under no_grad, vs live '
        f'{report["live_step_ms"]:.3f} ms (medians of 4 turns: '
        f'{report["step_turns_ms"]}); tiny artifact traced on the CPU '
        f'served on the card: {report["tiny_cpu_traced_max_abs_diff"]:.3e} '
        f'({report["tiny_valid"]} detections); {report["seconds"]:.1f} s; '
        f'card: {smi}')
    return report


# ---------------------------------------------------------------------------
# phase 11: data parallel
# ---------------------------------------------------------------------------

DP_HW, DP_GLOBAL_B, DP_STEPS, DP_LR = (416, 416), 4, 2, 1e-4
# two gloo ranks on the card against one process on the whole batch,
# relative to max(1, |v|).  Darknet in float32 (TF32 off): the first
# step's loss terms, from identical weights, within DP_RTOL; after an
# update its float32 gradients at this random init carry float32's own
# rounding (phase 7 holds float64 gradients for the same reason), which
# the phase shows by one process in float32 against one in float64 on the
# same steps.  So darknet's loss terms, running statistics and parameters
# after the steps are held in float64, within DP_RTOL64 (the CPU test's
# bound), and float32 after the steps is held within DP_RTOL on a
# well-conditioned configuration on the same CUDA tensors path (DP_TINY:
# multigriddet_tiny @64, same loss and LR; its loss falls 4928 -> 3480 over
# the two steps, where LR 1e-3 already raises it).
DP_RTOL, DP_RTOL64 = 1e-5, 1e-10
DP_TINY = dict(arch='multigriddet_tiny', hw=(64, 64))
DP_TIMEOUT = 600


def _dist_cfg(rank, world, port):
    return {'enabled': True, 'coordinator_address': f'localhost:{port}',
            'num_processes': world, 'process_id': rank}


def _init_gloo(rank, world, port):
    """Two ranks share the one card, which NCCL refuses: a gloo group on
    CUDA tensors, which ``maybe_initialize`` then finds and keeps."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            world_size=world, rank=rank)


def dp_steps(dev, dtype, steps=DP_STEPS, timed=False,
             arch='multigriddet_darknet', hw=DP_HW, lr=DP_LR, mesh=None,
             global_b=DP_GLOBAL_B, frames_seed=SEED + 31, probe=None):
    """``steps`` SGD steps (learning rate ``lr``) of ``arch`` at ``hw`` in
    ``dtype`` on this rank's share of each global batch of ``global_b``
    frames (all of it single-process; under a 2-D ``mesh`` the rank's
    batch share at the whole canvas, banded by the step), from seeded
    weights; ``timed``: then the step's time and the gradient all-reduce's
    time alone; ``probe(state, step, batch)``: more times, merged in.
    Returns the metrics, the final parameters and statistics on the CPU,
    and the times."""
    import torch
    from multigriddet_tpu_torch.config import (build_model_from_config,
                                               loss_config_from_config)
    from multigriddet_tpu_torch.data.pipeline import _device_stage
    from multigriddet_tpu_torch.models import (load_flax_variables,
                                               random_flax_variables)
    from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
    from multigriddet_tpu_torch.parallel import (all_reduce_grads,
                                                 make_mesh, replicate,
                                                 shard_batch)
    from multigriddet_tpu_torch.training import (TrainOptimizer,
                                                 create_train_state,
                                                 make_train_step)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config('', hw, mixed=False)
    cfg['model']['preset']['architecture'] = arch
    model, spec = build_model_from_config(cfg, dtype=dtype)
    load_flax_variables(model, *random_flax_variables(model, seed=SEED))
    model.to(dev, dtype).train()
    loss_cfg = loss_config_from_config(cfg)
    mesh = mesh or make_mesh()
    replicate(mesh, model)
    state = create_train_state(model, TrainOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr)))
    step = make_train_step(spec['anchors'], NUM_CLASSES, hw, loss_cfg,
                           mesh=mesh)
    _, canvases, boxes = train_frames(global_b * (steps + 1), frames_seed,
                                      hw)
    batches = []
    for i in range(steps + 1):
        sl = slice(i * global_b, (i + 1) * global_b)
        images, y_true, _ = _device_stage(
            tuple(torch.from_numpy(p) for p in rgb_to_yuv420_np(
                canvases[sl])), boxes[sl], None, {'enabled': False},
            spec['anchors'], NUM_CLASSES, hw, True)
        images, *y_true = shard_batch(mesh, images, *y_true)
        batches.append((images.to(dev, dtype),
                        [y.to(dev, dtype) for y in y_true]))
    metrics = []
    for images, y_true in batches[:steps]:
        state, m = step(state, images, y_true)
        metrics.append({k: float(v) for k, v in m.items()})
    final = {k: v.detach().cpu().double()
             for k, v in model.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    times = {}
    if timed:
        times['step_ms'] = cuda_ms(lambda: step(state, *batches[-1]), 3, 1)
        params = state.optimizer.params
        times['grad_allreduce_ms'] = cuda_ms(
            lambda: all_reduce_grads(params), 3, 1)
    if probe is not None:
        times.update(probe(state, step, batches[-1]))
    return {'metrics': metrics, 'final': final, 'times': times}


def dp_child(mode, rank, world, port, out, device, root=None):
    """A rank of phase 11, run as ``chip_smoke.py --dp-child``."""
    import torch
    import torch.distributed as dist
    from multigriddet_tpu_torch.parallel import (local_device,
                                                 maybe_initialize,
                                                 world_size)
    dev = torch.device(device)
    if mode == 'steps':
        _init_gloo(rank, world, port)
        maybe_initialize(_dist_cfg(rank, world, port), dev)
        dev = local_device(dev)
        res = {'f32': dp_steps(dev, torch.float32, timed=True),
               'f64': dp_steps(dev, torch.float64),
               'tiny_f32': dp_steps(dev, torch.float32, **DP_TINY),
               'world': world_size()}
        torch.save(res, os.path.join(out, f'steps_{rank}.pt'))
    elif mode == 'nccl':
        # torchrun's variables name the group; environment.distributed
        # only switches it on
        os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                          WORLD_SIZE='1', RANK='0', LOCAL_RANK='0')
        maybe_initialize({'enabled': 'auto'}, dev)
        res = dp_steps(local_device(dev), torch.float32, steps=1,
                       timed=True)
        res.update(world=world_size(), backend=dist.get_backend())
        torch.save(res, os.path.join(out, 'nccl.pt'))
    else:
        from multigriddet_tpu_torch.training import trainer as trainer_mod
        writes = []
        save = trainer_mod.save_params
        trainer_mod.save_params = lambda *a: (writes.append(a[0]), save(*a))
        cfg = train_config(os.path.join(root, 'out'), DP_HW)
        cfg['data'] = {'train_annotation': os.path.join(root, 'train.txt'),
                       'val_annotation': os.path.join(root, 'val.txt')}
        cfg['data_loader'].update(disk_cache_dir=os.path.join(root, 'cache'),
                                  num_workers=2)
        cfg['training'].update(batch_size=DP_GLOBAL_B, epochs=1)
        cfg['environment']['distributed'] = _dist_cfg(rank, world, port)
        _init_gloo(rank, world, port)
        history = trainer_mod.MultiGridTrainer(cfg, device=dev).train()
        with open(os.path.join(out, f'trainer_{rank}.json'), 'w') as f:
            json.dump({'history': history, 'writes': writes,
                       'world': world_size()}, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def launch_ranks(mode, out, dev, world=2, root=None, flag='--dp-child'):
    """``world`` ranks of ``mode`` on ``dev`` (``chip_smoke.py --dp-child``,
    or ``flag``), each awaited with ``DP_TIMEOUT``; any failure raises
    with its output."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, mode,
         str(rank), str(world), str(port), out, str(dev)]
        + ([root] if root else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f'{flag} {mode} rank failed:\n{o[-3000:]}')


def rel_err(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


def dp_errors(dp, one):
    """``dp``'s first-step loss terms, loss terms over the steps, running
    statistics and parameters against ``one``'s (``rel_err``)."""
    return {
        'first_loss_rel': max(rel_err(dp['metrics'][0][k], v)
                              for k, v in one['metrics'][0].items()),
        'loss_rel': max(rel_err(a[k], b[k]) for a, b in
                        zip(dp['metrics'], one['metrics']) for k in b),
        'stat_rel': max(rel_err(v, one['final'][k])
                        for k, v in dp['final'].items() if 'running' in k),
        'param_rel': max(rel_err(v, one['final'][k])
                         for k, v in dp['final'].items()
                         if 'running' not in k),
        'num_positives': dp['metrics'][0].get('num_positives'),
        'loss': [m['loss'] for m in dp['metrics']]}


def phase_data_parallel(dev, smi):
    """Phase 11: (1) two gloo ranks on the one card (CUDA tensors) against
    one process on the concatenated batch: ``multigriddet_darknet`` at 416,
    TF32 off, global b4, two SGD steps -- float32 first-step loss terms
    within ``DP_RTOL``, float64 loss terms, statistics and parameters
    within ``DP_RTOL64``, one process in float32 against one in float64
    printed; ``DP_TINY`` in float32, loss terms, statistics and parameters
    after the steps within ``DP_RTOL``; (2) one NCCL process at world size
    1 through ``environment.distributed`` and torchrun's variables; (3) a
    two-rank gloo ``MultiGridTrainer.train()`` for one epoch: one writer,
    equal losses."""
    import math
    import shutil
    import torch
    t0 = time.perf_counter()
    out = os.path.join(REPO, 'build', 'chip_smoke_dp')
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    report = {}
    try:
        launch_ranks('steps', out, dev)
        ranks = [torch.load(os.path.join(out, f'steps_{r}.pt'))
                 for r in range(2)]
        if not (ranks[0]['world'] == ranks[1]['world'] == 2 and all(
                ranks[0][p]['metrics'] == ranks[1][p]['metrics']
                and all(torch.equal(v, ranks[1][p]['final'][k])
                        for k, v in ranks[0][p]['final'].items())
                for p in ('f32', 'f64', 'tiny_f32'))):
            raise AssertionError('the two ranks disagree')
        errs, singles = {}, {}
        for p, dtype in (('f32', torch.float32), ('f64', torch.float64)):
            singles[p] = one = dp_steps(dev, dtype, timed=p == 'f32')
            errs[p] = dict(dp_errors(ranks[0][p], one),
                           rank_times=ranks[0][p]['times'],
                           single_times=one['times'])
            torch.cuda.empty_cache()
        # the witness: float32's own rounding on the same steps, one
        # process in float32 against one in float64
        errs['f32_vs_f64'] = dp_errors(singles['f32'], singles['f64'])
        del singles, one
        errs['tiny_f32'] = dp_errors(
            ranks[0]['tiny_f32'], dp_steps(dev, torch.float32, **DP_TINY))
        report['two_ranks'] = errs
        e32, e64, tiny = errs['f32'], errs['f64'], errs['tiny_f32']
        held64 = max(e64['loss_rel'], e64['stat_rel'], e64['param_rel'])
        held_tiny = max(tiny['loss_rel'], tiny['stat_rel'],
                        tiny['param_rel'])
        if not (e32['first_loss_rel'] <= DP_RTOL and held64 <= DP_RTOL64
                and held_tiny <= DP_RTOL and tiny['num_positives'] > 0):
            raise AssertionError(
                f'two gloo ranks vs one process: darknet float32 first-step '
                f'loss terms {e32["first_loss_rel"]:.3e} (bound {DP_RTOL}); '
                f'darknet float64 loss, statistics, parameters '
                f'{held64:.3e} (bound {DP_RTOL64}); tiny float32 after '
                f'{DP_STEPS} steps {held_tiny:.3e} (bound {DP_RTOL}, '
                f'{tiny["num_positives"]} positives)')

        launch_ranks('nccl', out, dev, world=1)
        nccl = torch.load(os.path.join(out, 'nccl.pt'))
        if not (nccl['backend'] == 'nccl' and nccl['world'] == 1
                and all(map(math.isfinite, nccl['metrics'][0].values()))):
            raise AssertionError(f'NCCL world-1 run: {nccl["backend"]}, '
                                 f'world {nccl["world"]}')
        report['nccl_world1'] = {'loss': nccl['metrics'][0]['loss'],
                                 'times': nccl['times']}

        root = os.path.join(out, 'data')
        os.makedirs(root)
        lines, canvases, boxes = train_frames(8, SEED + 32, DP_HW)
        write_frames(root, 'train.txt', lines, canvases, boxes, 'yuv420',
                     DP_HW)
        vlines, vcanvases, vboxes = train_frames(4, SEED + 33, DP_HW)
        write_frames(root, 'val.txt', vlines, vcanvases, vboxes, 'rgb',
                     DP_HW)
        launch_ranks('trainer', out, dev, root=root)
        r0, r1 = [json.load(open(os.path.join(out, f'trainer_{r}.json')))
                  for r in range(2)]
        final = os.path.join(root, 'out', 'models', 'final_model.msgpack')
        with open(os.path.join(root, 'out', 'logs', 'history.jsonl')) as f:
            hist = f.read().splitlines()
        l0 = [h['loss'] for h in r0['history']]
        if not (l0 == [h['loss'] for h in r1['history']]
                and [h['val_loss'] for h in r0['history']]
                == [h['val_loss'] for h in r1['history']]
                and all(map(math.isfinite, l0))
                and r0['history'][0]['steps'] == 2
                and (r0['writes'], r1['writes']) == ([final], [])
                and os.path.exists(final) and len(hist) == 1):
            raise AssertionError(f'two-rank trainer: {r0}, {r1}, history '
                                 f'{len(hist)} lines')
        report['trainer'] = {'loss': l0,
                             'val_loss': r0['history'][0]['val_loss'],
                             'images_per_sec':
                             r0['history'][0]['images_per_sec']}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    report['seconds'] = time.perf_counter() - t0
    t, t64 = report['two_ranks']['f32'], report['two_ranks']['f64']
    w, tiny = report['two_ranks']['f32_vs_f64'], report['two_ranks']['tiny_f32']
    log(f'[data parallel] two gloo ranks on one card vs one process, '
        f'multigriddet_darknet @{DP_HW[0]}, global b{DP_GLOBAL_B}, '
        f'{DP_STEPS} SGD steps: float64 loss {t64["loss_rel"]:.3e}, '
        f'statistics {t64["stat_rel"]:.3e}, parameters '
        f'{t64["param_rel"]:.3e}; float32 first-step loss '
        f'{t["first_loss_rel"]:.3e} (after the steps: loss '
        f'{t["loss_rel"]:.3e}, statistics {t["stat_rel"]:.3e}, parameters '
        f'{t["param_rel"]:.3e}, not held; one process float32 vs float64: '
        f'loss {w["loss_rel"]:.3e}, statistics {w["stat_rel"]:.3e}, '
        f'parameters {w["param_rel"]:.3e}); {DP_TINY["arch"]} '
        f'@{DP_TINY["hw"][0]} float32 after the steps: loss '
        f'{tiny["loss_rel"]:.3e}, statistics {tiny["stat_rel"]:.3e}, '
        f'parameters {tiny["param_rel"]:.3e}; a rank\'s f32 step '
        f'{t["rank_times"]["step_ms"]:.1f} ms (gradient all-reduce '
        f'{t["rank_times"]["grad_allreduce_ms"]:.1f} ms), one process on '
        f'b{DP_GLOBAL_B} {t["single_times"]["step_ms"]:.1f} ms; NCCL '
        f'world 1: loss {report["nccl_world1"]["loss"]:.3f}, step '
        f'{report["nccl_world1"]["times"]["step_ms"]:.1f} ms; two-rank '
        f'trainer epoch loss {report["trainer"]["loss"][0]:.4f} on both, '
        f'one writer; {report["seconds"]:.1f} s; card: {smi}')
    return report


# ---------------------------------------------------------------------------
# phase 12: spatial partition
# ---------------------------------------------------------------------------

# two gloo ranks on the card as one space group (dp 1 x sp 2) against one
# process on the whole canvas: darknet at 608, whose stride-32 map has 19
# rows (bands of 10 and 9), global b2, configs/train_config.yaml's loss
# (option 2, consensus on), SGD.  Relative to max(1, |v|): float64 loss
# terms, running statistics and parameters after SP_STEPS steps within
# SP_RTOL64; the float32 (TF32 off) first step's loss terms and the infer
# step's gathered float32 head maps within SP_RTOL; the infer step's
# pallas_fused detections from the float64 forward equal (float32
# forwards on bands and on the whole canvas may round differently, which
# can reorder near-ties: printed, not held)
SP_HW, SP_GLOBAL_B, SP_STEPS = (608, 608), 2, 2
SP_RTOL, SP_RTOL64 = 1e-5, 1e-10
SP_TIMED = 3
SP_ARGS = dict(hw=SP_HW, global_b=SP_GLOBAL_B, frames_seed=SEED + 41)


def sp_probe(state, step, batch):
    """A step's time (``SP_TIMED`` steps after one), the gradient
    all-reduce's alone, then the steps with the row exchanges timed (the
    device synchronised around each, so the exchanges' seconds hold no
    compute) and the step's peak memory."""
    import torch
    from multigriddet_tpu_torch.parallel import all_reduce_grads, spatial
    ms = cuda_ms(lambda: step(state, *batch), SP_TIMED, 1)
    params = state.optimizer.params
    grad_ms = cuda_ms(lambda: all_reduce_grads(params), SP_TIMED, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spatial.STATS.reset()
    spatial.STATS.timing = True
    try:
        timed_ms = cuda_ms(lambda: step(state, *batch), SP_TIMED, 0)
    finally:
        spatial.STATS.timing = False
    st = spatial.STATS
    return {'step_ms': ms, 'grad_allreduce_ms': grad_ms,
            'timed_step_ms': timed_ms,
            'exchange_fwd_ms': st.seconds['forward'] * 1e3 / SP_TIMED,
            'exchange_bwd_ms': st.seconds['backward'] * 1e3 / SP_TIMED,
            'exchanges': {k: v / SP_TIMED for k, v in st.calls.items()},
            'exchange_mb': sum(st.bytes.values()) / SP_TIMED / 1e6,
            'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}


def sp_infer(dev, mesh=None):
    """The infer step (``pallas_fused``: the pop-max kernel) of
    ``multigriddet_darknet`` at 608 on ``SP_GLOBAL_B`` letterboxed images,
    from the phase's seeded weights: the float32 head maps (gathered over
    the space group under a 2-D ``mesh``), and the detections of a float64
    and a float32 forward, with the pop-max launches of those two calls
    (the count zeroed just before and read just after)."""
    import torch
    from multigriddet_tpu_torch.config import build_model_from_config
    from multigriddet_tpu_torch.models import (load_flax_variables,
                                               random_flax_variables)
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.parallel.mesh import spatial_space
    from multigriddet_tpu_torch.training import make_infer_step
    from multigriddet_tpu_torch.training.steps import head_maps
    cfg = train_config('', SP_HW, mixed=False)
    images = torch.from_numpy(
        letterboxed_batches(1, SEED + 42)[0][:SP_GLOBAL_B]).to(dev)
    out, steps = {}, {}
    for name, dtype in (('f32', torch.float32), ('f64', torch.float64)):
        model, spec = build_model_from_config(cfg, dtype=dtype)
        load_flax_variables(model, *random_flax_variables(model, seed=SEED))
        model.to(dev, dtype).eval()
        steps[name] = make_infer_step(model, spec['anchors'], SP_HW,
                                      nms_backend='pallas_fused', mesh=mesh)
        if name == 'f32':
            with torch.no_grad():
                out['maps'] = [m.cpu() for m in head_maps(
                    model, images.float() / 255.0, spatial_space(mesh))]
    cuda_nms.popmax_nms.launches = 0
    for name in ('f64', 'f32'):
        out[f'dets_{name}'] = [t.cpu() for t in steps[name](images)]
    torch.cuda.synchronize()
    out['launches'] = cuda_nms.popmax_nms.launches
    return out


def sp_child(mode, rank, world, port, out, device):
    """A rank of phase 12, run as ``chip_smoke.py --sp-child``."""
    import torch
    import torch.distributed as dist
    from multigriddet_tpu_torch.parallel import (local_device,
                                                 maybe_initialize,
                                                 make_mesh_2d)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _init_gloo(rank, world, port)
    dev = torch.device(device)
    maybe_initialize(_dist_cfg(rank, world, port), dev)
    dev = local_device(dev)
    mesh = make_mesh_2d(1, world)
    res = {'mesh': mesh.shape,
           'f64': dp_steps(dev, torch.float64, steps=SP_STEPS, mesh=mesh,
                           **SP_ARGS)}
    torch.cuda.empty_cache()
    res['f32'] = dp_steps(dev, torch.float32, steps=1, mesh=mesh,
                          probe=sp_probe, **SP_ARGS)
    torch.cuda.empty_cache()
    res['infer'] = sp_infer(dev, mesh)
    torch.save(res, os.path.join(out, f'sp_{rank}.pt'))
    dist.destroy_process_group()


def phase_spatial(dev, smi):
    """Phase 12: two gloo ranks on the one card as a (1, 2) mesh against
    one process on the whole canvas (``multigriddet_darknet`` @608, TF32
    off, global b2): float64 loss terms, statistics and parameters after
    ``SP_STEPS`` SGD steps within ``SP_RTOL64``; the float32 first step's
    loss terms and the infer step's gathered head maps within ``SP_RTOL``;
    the infer step's float64 ``pallas_fused`` detections equal; a rank's
    step, the exchanges' share of it and each rank's peak memory against
    one process at the same global batch."""
    import shutil
    import torch
    from multigriddet_tpu_torch.parallel.spatial import bands
    t0 = time.perf_counter()
    deep = [hi - lo for lo, hi in bands(SP_HW[0] // 32, 2)]
    out = os.path.join(REPO, 'build', 'chip_smoke_sp')
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    try:
        launch_ranks('steps', out, dev, flag='--sp-child')
        ranks = [torch.load(os.path.join(out, f'sp_{r}.pt'))
                 for r in range(2)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    r0, r1 = ranks
    same = (r0['mesh'] == r1['mesh'] == {'batch': 1, 'space': 2}
            and all(r0[p]['metrics'] == r1[p]['metrics']
                    and all(torch.equal(v, r1[p]['final'][k])
                            for k, v in r0[p]['final'].items())
                    for p in ('f32', 'f64'))
            and all(torch.equal(a, b) for k in ('maps', 'dets_f64',
                                                'dets_f32')
                    for a, b in zip(r0['infer'][k], r1['infer'][k])))
    if not same:
        raise AssertionError('the two sp ranks disagree')
    one64 = dp_steps(dev, torch.float64, steps=SP_STEPS, **SP_ARGS)
    torch.cuda.empty_cache()
    one32 = dp_steps(dev, torch.float32, steps=1, probe=sp_probe, **SP_ARGS)
    torch.cuda.empty_cache()
    one_inf = sp_infer(dev)
    e64, e32 = dp_errors(r0['f64'], one64), dp_errors(r0['f32'], one32)
    map_rel = max(rel_err(a, b) for a, b in zip(r0['infer']['maps'],
                                                one_inf['maps']))
    dets = {k: all(torch.equal(a, b) for a, b in zip(r0['infer'][k],
                                                     one_inf[k]))
            for k in ('dets_f64', 'dets_f32')}
    held64 = max(e64['loss_rel'], e64['stat_rel'], e64['param_rel'])
    n_dets = int(one_inf['dets_f64'][3].sum())
    if not (held64 <= SP_RTOL64 and e32['first_loss_rel'] <= SP_RTOL
            and map_rel <= SP_RTOL and dets['dets_f64']
            and e64['num_positives'] > 0 and r0['infer']['launches'] > 0):
        raise AssertionError(
            f'sp=2 vs one process: float64 loss, statistics, parameters '
            f'{held64:.3e} (bound {SP_RTOL64}); float32 first-step loss '
            f'terms {e32["first_loss_rel"]:.3e} (bound {SP_RTOL}); head '
            f'maps {map_rel:.3e} (bound {SP_RTOL}); float64 detections '
            f'equal: {dets["dets_f64"]}; pop-max launches '
            f'{r0["infer"]["launches"]}')
    rt, ot = r0['f32']['times'], one32['times']
    report = {
        'float64': e64, 'float32': e32, 'head_map_rel': map_rel,
        'detections_equal': dets, 'detections': n_dets,
        'rank_times': [r['f32']['times'] for r in ranks],
        'single_times': ot,
        'exchange_share': (rt['exchange_fwd_ms'] + rt['exchange_bwd_ms'])
        / rt['timed_step_ms'],
        'popmax_launches': r0['infer']['launches']
        + r1['infer']['launches'],
        'seconds': time.perf_counter() - t0}
    log(f'[spatial partition] dp1 x sp2 gloo ranks on one card vs one '
        f'process, multigriddet_darknet @{SP_HW[0]} (stride-32 bands of '
        f'{deep[0]} and {deep[1]} rows), global b{SP_GLOBAL_B}: float64 '
        f'after {SP_STEPS} SGD '
        f'steps loss {e64["loss_rel"]:.3e}, statistics '
        f'{e64["stat_rel"]:.3e}, parameters {e64["param_rel"]:.3e}; '
        f'float32 first-step loss {e32["first_loss_rel"]:.3e}; infer head '
        f'maps {map_rel:.3e}, pallas_fused detections equal in float64 '
        f'{dets["dets_f64"]} ({n_dets} kept), in float32 '
        f'{dets["dets_f32"]}; a rank\'s f32 step (TF32 off) '
        f'{rt["step_ms"]:.1f} ms vs one process on b{SP_GLOBAL_B} '
        f'{ot["step_ms"]:.1f} ms (the rank\'s gradient all-reduce '
        f'{rt["grad_allreduce_ms"]:.1f} ms); row exchanges a step: '
        f'{rt["exchanges"]["forward"]:.0f} forward, '
        f'{rt["exchanges"]["backward"]:.0f} backward, '
        f'{rt["exchange_mb"]:.1f} MB sent, {rt["exchange_fwd_ms"]:.1f} + '
        f'{rt["exchange_bwd_ms"]:.1f} ms = {100 * report["exchange_share"]:.1f}'
        f'% of the step timed with them ({rt["timed_step_ms"]:.1f} ms); '
        f'peak memory a rank {ranks[0]["f32"]["times"]["peak_gib"]:.2f} / '
        f'{ranks[1]["f32"]["times"]["peak_gib"]:.2f} GiB vs one process '
        f'{ot["peak_gib"]:.2f} GiB; pop-max launches '
        f'{report["popmax_launches"]}; {report["seconds"]:.1f} s; card: '
        f'{smi}')
    return report


# ---------------------------------------------------------------------------
# phase 13: JPEG files on the card
# ---------------------------------------------------------------------------

JPEG_DIR = os.path.join(REPO, 'tests', 'fixtures', 'jpeg')
# mean |dRGB| per image between the JAX package's two decode paths
# (tests/test_native_loader.py), held between the card's canvases and
# fastloader's
JPEG_MEAN_BOUND = 6.0
JPEG_LINES = 64
JPEG_BASELINE_420 = ('photo_420_q90.jpg', 'photo_420_q75.jpg',
                     'photo_restart.jpg', 'odd_333x251.jpg', 'dog.jpg')
# float32 operations a canvas pixel costs the letterbox kernels (taps and
# the bilinear of three channels; 4:2:0 adds Y and a quarter of the chroma)
LETTERBOX_OPS = {'letterbox_rgb': 50, 'letterbox_yuv420': 59}
# integer operations a pixel costs ycc_to_rgb (two upsampled chroma values
# and the three table products, sums and clamps)
YCC_OPS = 40


def device_busy(fn):
    """``fn()`` with the card's kernels traced (CUDA activity alone, no
    trace file): (wall seconds, the share of them some kernel ran; NaN
    where the profiler records no kernel)."""
    import torch
    from multigriddet_tpu_torch.profile_serve import _union_us
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = (_union_us(kernels) / (seconds * 1e6) if kernels
            else float('nan'))
    return seconds, busy


def jpeg_fixture_checks(dev):
    """Part (b): every fixture decoded by nvJPEG and letterboxed by both
    kernels at the recorded canvases, against the plain versions on the
    same decoded pixels (bit for bit) and against fastloader's recorded
    canvases (metas and ok exact, pixels within ``JPEG_MEAN_BOUND``)."""
    import numpy as np
    import torch
    from multigriddet_tpu_torch.data import jpeg_cuda
    from multigriddet_tpu_torch.ops import cuda_jpeg
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from record_jpeg_fixtures import SAMPLES as ref_samples
    from record_jpeg_fixtures import positions as ref_positions
    ref = np.load(os.path.join(JPEG_DIR, 'letterbox_ref.npz'))
    names = [str(n) for n in ref['files']]
    paths = [os.path.join(REPO, n) for n in names]
    canvases = [tuple(hw) for hw in ref['canvases'].tolist()]
    # the planes nvJPEG decoded for Decoder.decode (the main path's call)
    # through the ycc_to_rgb kernel: the image decode returned, and every
    # canvas's divisor, against its plain version
    headers, max_err, converted = [], 0, []
    with cuda_jpeg.decoder(dev) as dec:
        for path in paths:
            with open(path, 'rb') as f:
                data = f.read()
            hd = dec.header(data)
            headers.append(hd)
            if isinstance(hd, int) or hd[3] not in cuda_jpeg.FACTORS:
                continue
            w, h, _, css, cw, ch = hd
            planes = []
            image, _, reason = dec.decode(data, None, planes)
            if image is None:
                raise AssertionError(f'jpeg: nvJPEG refused {path} '
                                     f'({reason})')
            factors = cuda_jpeg.FACTORS[css]
            host_planes = [p.cpu() for p in planes]
            want = cuda_jpeg.ycc_to_rgb_plain(*host_planes, factors, 1)
            max_err = max(max_err, int((image.cpu().int() - want.int())
                                       .abs().max()))
            for d in sorted({cuda_jpeg.divisor(w, h, hw) for hw in canvases}):
                got = cuda_jpeg.ycc_to_rgb(*planes, factors, d).cpu()
                want = cuda_jpeg.ycc_to_rgb_plain(*host_planes, factors, d)
                max_err = max(max_err,
                              int((got.int() - want.int()).abs().max()))
                converted.append((css, d))
    if max_err:
        raise AssertionError(f'jpeg: ycc_to_rgb differs from its plain '
                             f'version by {max_err}')
    log(f'[jpeg] ycc_to_rgb bit-equal to its plain version on the planes '
        f'of the colour files, {len(converted)} (layout, divisor) cases: '
        f'{sorted(set(converted))}')
    rows, failures = [], []
    for ci, (th, tw) in enumerate(canvases):
        hw = (th, tw)
        images, sizes = jpeg_cuda.decode_files(paths, dev, hw)
        host = [None if im is None else im.cpu() for im in images]
        canvas, metas, ok = cuda_jpeg.letterbox_rgb(images, hw, dev, sizes)
        y, cb, cr, metas2, ok2 = cuda_jpeg.letterbox_yuv420(images, hw, dev,
                                                            sizes)
        got = [t.cpu() for t in (canvas, y, cb, cr)]
        want, want_metas, want_ok = cuda_jpeg.letterbox_rgb(host, hw, 'cpu',
                                                            sizes)
        want = [want, *cuda_jpeg.rgb_to_yuv420_plain(want)]
        for g, w, part in zip(got, want, ('rgb', 'y', 'cb', 'cr')):
            err = int((g.int() - w.int()).abs().max()) if g.numel() else 0
            max_err = max(max_err, err)
            if err:
                i = int(torch.nonzero((g != w).flatten(1).any(1))[0])
                raise AssertionError(f'jpeg: the {part} kernel differs from '
                                     f'its plain version on {names[i]} at '
                                     f'{hw}')
        if not (np.array_equal(metas, want_metas) and np.array_equal(
                metas2, metas) and np.array_equal(ok, want_ok)
                and np.array_equal(ok2, ok)):
            raise AssertionError(f'jpeg: kernel metas differ at {hw}')
        for fi, name in enumerate(names):
            base = os.path.basename(name)
            if not (np.array_equal(metas[fi], ref['metas'][fi, ci])
                    and bool(ok[fi]) == bool(ref['ok'][fi, ci])):
                failures.append(f'{base} @{th}: metas {metas[fi].tolist()} '
                                f'ok {bool(ok[fi])}, fastloader '
                                f'{ref["metas"][fi, ci].tolist()} ok '
                                f'{bool(ref["ok"][fi, ci])}')
                continue
            if not ok[fi]:
                if not all(bool((p[fi] == 128).all()) for p in got) \
                        or metas[fi].any():
                    failures.append(f'{base} @{th}: a rejected slot is not '
                                    f'gray with zero metas')
                continue
            fw, fh = int(metas[fi, 3]), int(metas[fi, 4])
            _, nw, nh, px, py = cuda_jpeg.geometry(fw, fh, hw)
            pad = torch.ones(hw, dtype=torch.bool)
            pad[py:py + nh, px:px + nw] = False
            if not bool((got[0][fi][pad] == 128).all()):
                failures.append(f'{base} @{th}: the pad is not gray')
            # the recorded positions: seeded samples of the content (the
            # first SAMPLES), then the content's border
            (yy, xx), (cy, cx) = ref_positions(name, hw, ref['metas'][fi,
                                                                     ci])
            (at, cat), (n, cn) = ref['at'][fi, ci], ref['n'][fi, ci]
            if (len(yy), len(cy)) != (n, cn):
                raise AssertionError(f'jpeg: {base} @{th}: {len(yy)}/'
                                     f'{len(cy)} positions, {n}/{cn} '
                                     f'recorded')
            d_rgb = np.abs(got[0][fi].numpy()[yy, xx].astype(np.int32)
                           - ref['rgb'][at:at + n])
            d_y = np.abs(got[1][fi].numpy()[yy, xx].astype(np.int32)
                         - ref['y'][at:at + n])
            d_c = np.abs(np.stack([got[2][fi].numpy()[cy, cx],
                                   got[3][fi].numpy()[cy, cx]], -1)
                         .astype(np.int32) - ref['cbcr'][cat:cat + cn])
            k, kc = ref_samples, ref_samples // 4
            sample = d_rgb[:k]
            row = {'file': base, 'hw': th,
                   'divisor': cuda_jpeg.divisor(fw, fh, hw),
                   'css': headers[fi][3],
                   'content_mean': float(sample.mean()),
                   'canvas_mean': float(sample.mean()) * nw * nh / (th * tw),
                   'p99': float(np.percentile(sample, 99)),
                   'max': int(d_rgb.max()),
                   'border_mean': float(d_rgb[k:].mean()),
                   'border_max': int(d_rgb[k:].max()),
                   'border_pixels': int(n - k),
                   'y_mean': float(d_y[:k].mean()), 'y_max': int(d_y.max()),
                   'cbcr_mean': float(d_c[:kc].mean()),
                   'cbcr_max': int(d_c.max())}
            rows.append(row)
            if not row['canvas_mean'] < JPEG_MEAN_BOUND:
                failures.append(f'{base} @{th}: mean |dRGB| '
                                f'{row["canvas_mean"]:.3f} >= '
                                f'{JPEG_MEAN_BOUND}')
    for fi, name in enumerate(names):
        base = os.path.basename(name)
        mine = [r for r in rows if r['file'] == base]
        info = headers[fi]
        desc = (f'{info[0]}x{info[1]} {info[3]}' if not isinstance(info, int)
                else f'rejected by the header ({cuda_jpeg.status_name(info)})')
        log(f'[jpeg] {base} ({desc}): ' + ('; '.join(
            f'@{r["hw"]} d{r["divisor"]} |dRGB| mean {r["content_mean"]:.3f}'
            f' (canvas {r["canvas_mean"]:.3f}) p99 {r["p99"]:.0f}, border '
            f'mean {r["border_mean"]:.3f} over {r["border_pixels"]} px, max '
            f'{r["max"]}, Y {r["y_mean"]:.3f}/{r["y_max"]}, CbCr '
            f'{r["cbcr_mean"]:.3f}/{r["cbcr_max"]}' for r in mine)
            or 'gray, ok False, zero metas at every canvas'))
    base420 = [r for r in rows if r['file'] in JPEG_BASELINE_420
               and r['divisor'] == 1]
    worst = max(r['content_mean'] for r in base420)
    log(f'[jpeg] kernels bit-equal to their plain versions on nvJPEG\'s '
        f'pixels for {len(names)} files at {[hw[0] for hw in canvases]};'
        f' metas and ok equal to fastloader\'s; at divisor 1 on baseline '
        f'4:2:0 the largest mean |dRGB| is {worst:.3f} '
        f'({"under" if worst < 1.0 else "not under"} 1.0)')
    if failures:
        raise AssertionError('jpeg fixtures: ' + '; '.join(failures))
    return {'rows': rows, 'baseline_420_d1_worst_mean': worst,
            'max_abs_err': max_err}


def jpeg_lines(root, photos, seed):
    """``JPEG_LINES`` annotation lines over the 640x480 ``photos`` (files
    repeat), 1-10 seeded boxes each."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(JPEG_LINES):
        n = rng.randint(1, 11)
        wh = rng.uniform(16, 300, (n, 2))
        x1 = rng.uniform(0, 640 - wh[:, 0])
        y1 = rng.uniform(0, 480 - wh[:, 1])
        cls = rng.randint(0, NUM_CLASSES, n)
        lines.append(photos[i % len(photos)] + ' ' + ' '.join(
            f'{a:.1f},{b:.1f},{a + w:.1f},{b + h:.1f},{int(k)}'
            for a, b, (w, h), k in zip(x1, y1, wh, cls)))
    path = os.path.join(root, 'train.txt')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path, lines


def jpeg_rates(dev, photos):
    """Decode ms per image, and each letterbox kernel's ms per b8 batch @608
    with its plain version's, the bound and the bilinear
    ``F.interpolate`` + pad yardstick on the same images."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from multigriddet_tpu_torch.data import jpeg_cuda
    from multigriddet_tpu_torch.ops import cuda_jpeg
    paths = photos[:B]
    with open(paths[0], 'rb') as f:
        data = f.read()
    with cuda_jpeg.decoder(dev) as dec:
        w, h, _, css, _, _ = dec.header(data)
        planes = []
        if dec.decode(data, None, planes)[0] is None:
            raise AssertionError(f'jpeg: nvJPEG refused {paths[0]}')
    factors = cuda_jpeg.FACTORS[css]
    ycc_ms = cuda_ms(lambda: cuda_jpeg.ycc_to_rgb(*planes, factors), 50,
                     queued=True)
    host_planes = [p.cpu() for p in planes]
    t0 = time.perf_counter()
    cuda_jpeg.ycc_to_rgb_plain(*host_planes, factors)
    ycc_plain_ms = (time.perf_counter() - t0) * 1e3
    moved = sum(p.numel() for p in planes) + 3 * w * h
    ycc_bound, ycc_by = bound(moved, YCC_OPS * w * h)
    jpeg_cuda.decode_files(paths, dev, HW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        images, sizes = jpeg_cuda.decode_files(paths, dev, HW)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / reps / len(paths)
    host = [im.cpu() for im in images]
    src_bytes = sum(im.numel() for im in images)
    _, nw, nh, px, py = cuda_jpeg.geometry(640, 480, HW)
    x = torch.stack([im.expand(480, 640, 3).permute(2, 0, 1) for im in
                     jpeg_cuda.decode_files(paths, dev)[0]]).float()

    def yardstick():
        return F.pad(F.interpolate(x, size=(nh, nw), mode='bilinear',
                                   align_corners=False),
                     (px, HW[1] - nw - px, py, HW[0] - nh - py), value=128.0)
    library_ms = cuda_ms(yardstick, 20, queued=True)
    out = {'ycc_to_rgb': {'ms': ycc_ms, 'plain_ms': ycc_plain_ms,
                          'bound_ms': ycc_bound, 'bound_by': ycc_by,
                          'bytes': moved}}
    log(f'[jpeg] ycc_to_rgb {w}x{h} {css}: {ycc_ms:.4f} ms an image '
        f'({moved / 1e6:.2f} MB, bound {ycc_bound * 1e3:.2f} us by {ycc_by},'
        f' {ycc_bound / ycc_ms:.1%} of it); plain on the CPU '
        f'{ycc_plain_ms:.1f} ms')
    for name, fn, out_bytes in (
            ('letterbox_rgb', cuda_jpeg.letterbox_rgb, 3),
            ('letterbox_yuv420', cuda_jpeg.letterbox_yuv420, 1.5)):
        ms = cuda_ms(lambda: fn(images, HW, dev, sizes), 50, queued=True)
        t0 = time.perf_counter()
        fn(host, HW, 'cpu', sizes)
        plain_ms = (time.perf_counter() - t0) * 1e3
        moved = src_bytes + out_bytes * len(paths) * HW[0] * HW[1]
        bound_ms, bound_by = bound(moved, LETTERBOX_OPS[name] * len(paths)
                                   * nw * nh)
        out[name] = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                     'bound_by': bound_by, 'bytes': moved,
                     'interpolate_pad_ms': library_ms}
        log(f'[jpeg] {name} b{len(paths)} 640x480 -> {HW[0]}: {ms:.4f} ms '
            f'a batch ({moved / 1e6:.2f} MB, bound {bound_ms * 1e3:.2f} us '
            f'by {bound_by}, {bound_ms / ms:.1%} of it); plain on the CPU '
            f'{plain_ms:.1f} ms; F.interpolate bilinear + pad (not the same '
            f'function) {library_ms:.4f} ms')
    log(f'[jpeg] nvJPEG decode {decode_ms:.3f} ms an image (640x480, '
        f'{len(paths)} files, host read + Huffman + card IDCT, synchronized)')
    return decode_ms, out


def jpeg_producer(dev, root, photos, rates):
    """Part (c): the trainer, the evaluator and ``detect_files`` reading
    ``JPEG_LINES`` JPEG files on the card; the letterbox launch counts
    of these runs alone."""
    import numpy as np
    import torch
    from multigriddet_tpu_torch.data import jpeg_cuda
    from multigriddet_tpu_torch.data.annotations import (
        HostImageLoader, pad_batch, parse_annotation_line)
    from multigriddet_tpu_torch.evaluation import MultiGridEvaluator
    from multigriddet_tpu_torch.inference import MultiGridInference
    from multigriddet_tpu_torch.models import (load_flax_variables,
                                               random_flax_variables)
    from multigriddet_tpu_torch.ops import cuda_jpeg
    from multigriddet_tpu_torch.training import MultiGridTrainer
    ann, lines = jpeg_lines(root, photos, SEED + 51)
    decode_ms = rates[0]
    lb_ms = {k: v['ms'] for k, v in rates[1].items()}
    ycc_ms = rates[1]['ycc_to_rgb']['ms']
    kernels = (cuda_jpeg.ycc_to_rgb, cuda_jpeg.letterbox_rgb,
               cuda_jpeg.letterbox_yuv420)
    launches = {k.__name__: 0 for k in kernels}
    out = {}

    def run(label, n_images, fn, rate=None, extra=lambda: ''):
        """One main-path run, its kernels traced: the launches of the
        kernels of jpeg.cu (counted from zero just before it), images/s
        (``rate()``, or images over the wall) and the device's busy
        share."""
        for k in kernels:
            k.launches = 0
        seconds, busy = device_busy(fn)
        for k in kernels:
            launches[k.__name__] += k.launches
        ips = rate() if rate else n_images / seconds
        log(f'[jpeg] {label}: {ips:.1f} img/s ({n_images} images, '
            f'{seconds:.2f} s in all), decode {decode_ms:.3f} ms an image '
            f'(ycc_to_rgb {ycc_ms:.4f}), letterbox kernel '
            f'{lb_ms["letterbox_rgb"]:.4f} (rgb) / '
            f'{lb_ms["letterbox_yuv420"]:.4f} (yuv420) ms a batch, device '
            f'busy {busy:.1%}{extra()}')
        out[label] = {'images_per_sec': ips, 'seconds': seconds,
                      'device_busy_share': busy}
        return out[label]

    # the trainer: streamed from the files, then from the .npy disk cache
    # that the card's loader fills (one device-to-host copy a batch)
    cache = os.path.join(root, 'cache')
    filler = HostImageLoader(lines, HW, TRAIN_MAX_BOXES, num_workers=1,
                             disk_cache_dir=cache, link_format='yuv420',
                             device=dev)
    plain = HostImageLoader(lines, HW, TRAIN_MAX_BOXES, num_workers=1,
                            link_format='yuv420', device=dev)
    for start in range(0, len(lines), B):
        filler.load_batch(lines[start:start + B])
    cached, cached_boxes = filler.load_batch(lines[:B])
    fresh, fresh_boxes = plain.load_batch(lines[:B])
    if not (all(torch.equal(a, b) for a, b in zip(cached, fresh))
            and np.array_equal(cached_boxes, fresh_boxes)):
        raise AssertionError('jpeg: the disk cache differs from the decode')
    filler.close()
    plain.close()
    for label, tag, cache_dir in (
            ('trainer from JPEG files', 'files', None),
            ('trainer from the .npy disk cache', 'cached', cache)):
        cfg = train_config(os.path.join(root, tag), aug=TRAIN_AUG)
        cfg['data'] = {'train_annotation': ann}
        cfg['data_loader']['disk_cache_dir'] = cache_dir
        cfg['training']['epochs'] = 2
        trainer = MultiGridTrainer(cfg, device=dev)
        history = []
        res = run(label, 2 * JPEG_LINES,
                  lambda: history.extend(trainer.train()),
                  lambda: history[-1]['images_per_sec'],
                  lambda: f' (epoch 2); epoch images/s '
                          f'{[round(r["images_per_sec"], 1) for r in history]}'
                          f', losses {[round(r["loss"], 4) for r in history]}')
        if not all(np.isfinite(r['loss']) for r in history) or \
                len(history) != 2:
            raise AssertionError(f'jpeg: {label}: bad history {history}')
        res['epoch_images_per_sec'] = [r['images_per_sec'] for r in history]
        del trainer
        torch.cuda.empty_cache()

    # the evaluator from the files against the same canvases in memory,
    # with deterministic cuDNN (two forwards of one batch then agree)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ev = MultiGridEvaluator(eval_config('pallas_fused'), device=dev)
        run('evaluator from JPEG files', len(lines),
            lambda: ev.evaluate(ann),
            lambda: ev.timing['images_per_sec'], lambda: ' (inference)')
        from_files = ev.predictions
        ev.evaluate(ann)
        again = ev.predictions
        items, file_parts = [], [parts for parts, _ in
                                 ev._file_batches(lines)]
        for start in range(0, len(lines), B):
            chunk = lines[start:start + B]
            imgs, metas, ok = jpeg_cuda.load_letterbox_batch_cuda(
                [ln.split()[0] for ln in chunk], HW, dev)
            items.append(((pad_batch(imgs, B),), [
                (start + i, parse_annotation_line(ln)[1], int(m[4]),
                 int(m[3]), None, not good) for i, (ln, m, good) in
                enumerate(zip(chunk, metas, ok))]))
        if not all(torch.equal(fp[0], it[0][0])
                   for fp, it in zip(file_parts, items)):
            raise AssertionError('jpeg: the evaluator\'s file batches differ '
                                 'from the canvases decoded in memory')
        ev._evaluate_batches(iter(items))
        in_memory = ev.predictions
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for run_ in (from_files, again):
        differ = [k for k in sorted(run_) if k not in in_memory or any(
            not np.array_equal(run_[k][f], in_memory[k][f])
            for f in ('boxes', 'classes', 'scores'))]
        if differ or sorted(run_) != sorted(in_memory):
            raise AssertionError(
                f'jpeg: the evaluator\'s predictions from files differ from '
                f'the same canvases in memory on {len(differ)} images')
    n_det = sum(len(p['scores']) for p in from_files.values())
    log(f'[jpeg] evaluator: {n_det} detections from the files (two runs) '
        f'equal to the same canvases fed in memory, the file batches '
        f'bit-equal to them')
    del ev
    for link in ('rgb', 'yuv420'):
        cfg = serve_config('pallas_fused')
        cfg['detection']['link_format'] = link
        engine = MultiGridInference(cfg, device=dev)
        load_flax_variables(engine.model,
                            *random_flax_variables(engine.model, seed=SEED))
        paths = [ln.split()[0] for ln in lines]
        results = []
        run(f'detect_files {link}', len(paths),
            lambda: results.extend(engine.detect_files(paths, batch_size=B)),
            extra=lambda: f'; {sum(len(s) for _, _, s in results)} '
                          f'detections')
        if len(results) != len(paths) or not all(
                in_range(b, c, s, FRAME_HW, 0.0) for b, c, s in results):
            raise AssertionError(f'jpeg: detect_files ({link}) gave '
                                 f'results out of range')
        jpeg_mixed_batch(dev, engine, paths[:B], root, link)
        del engine
    if not all(launches.values()):
        raise AssertionError(f'jpeg: a kernel of jpeg.cu was not launched on '
                             f'the file paths: {launches}')
    out['launches'] = launches
    return out


def jpeg_mixed_batch(dev, engine, paths, root, link):
    """A batch of JPEGs and one PNG on the card, through the loader and
    ``detect_files``: every path goes to nvJPEG, which rejects the PNG (a
    gray slot, or Pillow's canvas where Pillow imports), and each JPEG
    comes out as it does in an all-JPEG batch."""
    import shutil
    import numpy as np
    import torch
    from multigriddet_tpu_torch.data.annotations import (HostImageLoader,
                                                         pil_available)
    png = os.path.join(root, 'not_a_jpeg.png')
    shutil.copy(os.path.join(JPEG_DIR, 'png_named.jpg'), png)
    mixed = paths[:-1] + [png]
    retried = pil_available()
    loader = HostImageLoader([], HW, 1, num_workers=1, link_format=link,
                             device=dev)
    try:
        want, _, _, want_ok = loader.load_batch(
            [f'{p} 2,2,30,30,1' for p in paths], return_metas=True)
        got, _, _, ok = loader.load_batch(
            [f'{p} 2,2,30,30,1' for p in mixed], return_metas=True)
    finally:
        loader.close()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    if not (want_ok.all() and ok[:-1].all() and bool(ok[-1]) == retried
            and all(torch.equal(g[:-1], w[:-1]) for g, w in zip(got, want))
            and (retried or all(bool((g[-1] == 128).all()) for g in got))):
        raise AssertionError(f'jpeg: the loader\'s mixed batch ({link}) '
                             f'differs from the all-JPEG one, ok {ok}')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = engine.detect_files(paths, batch_size=len(paths))
        got = engine.detect_files(mixed, batch_size=len(paths))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if not (all(np.array_equal(g, w) for gr, wr in zip(got[:-1], want)
                for g, w in zip(gr, wr))
            and (retried or len(got[-1][0]) == 0)):
        raise AssertionError(f'jpeg: detect_files on a mixed batch ({link}) '
                             f'differs from the all-JPEG one')
    log(f'[jpeg] mixed batch ({link}, {len(paths) - 1} JPEGs and a PNG): '
        f'every path through nvJPEG, the PNG rejected '
        f'({"retried by Pillow" if retried else "gray, no Pillow here"}), '
        f'the JPEG slots of the loader and of detect_files equal to an '
        f'all-JPEG batch\'s')


def phase_jpeg(dev, smi, build=None):
    """Phase 13: JPEG files on the card (nvJPEG decode, the letterbox
    kernels, the file producer of the trainer, the evaluator and
    ``detect_files``) at ``multigriddet_darknet`` full width, @608, b8."""
    import shutil
    import numpy as np
    from multigriddet_tpu_torch.ops import cuda_jpeg
    t0 = time.perf_counter()
    info = (build or {}).get('jpeg.cu')
    if info is not None:
        log(f'[jpeg] jpeg.cu built in {info["seconds"]:.2f} s: ' + '; '.join(
            ln.strip() for ln in info['log'].splitlines()
            if 'registers' in ln))
    from multigriddet_tpu_torch.data.annotations import pil_available
    from multigriddet_tpu_torch.inference.engine import _can_draw
    report = cuda_jpeg.decoder_report(dev)
    report['pillow'], report['can_draw'] = pil_available(), _can_draw()
    log(f'[jpeg] decoder: nvJPEG {report["nvjpeg"]}, backend '
        f'{report["backend_used"]}; backends here: {report["backends"]}; '
        f'Pillow imports here: {report["pillow"]} (it retries rejected '
        f'slots only), OpenCV or Pillow to draw: {report["can_draw"]}')
    fixtures = jpeg_fixture_checks(dev)
    ref = np.load(os.path.join(JPEG_DIR, 'letterbox_ref.npz'))
    photos = [os.path.join(REPO, str(n)) for n, m in zip(
        ref['files'], ref['metas'][:, 0]) if m[3] == 640 and m[4] == 480]
    rates = jpeg_rates(dev, photos)
    root = os.path.join(REPO, 'build', 'chip_smoke_jpeg')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        producer = jpeg_producer(dev, root, photos, rates)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f'[jpeg] phase took {seconds:.1f} s; card: {smi}')
    return {'decoder': report, 'fixtures': fixtures,
            'decode_ms_per_image': rates[0], 'kernels': rates[1],
            'producer': producer, 'launches': producer['launches'],
            'seconds': seconds}


# ---------------------------------------------------------------------------
# phase 14: the learning validations
# ---------------------------------------------------------------------------

# cut budgets of python -m multigriddet_tpu_torch.validate (the full runs,
# 120 and 60 epochs, are their own commands on the card)
# (4 epochs: the tools' 3-epoch warmup and one of cosine)
VALIDATE_FLAGSHIP_EPOCHS, VALIDATE_MOBILE_EPOCHS = 6, 4
# the jpeg.cu kernels of the learning validations' input path: the train
# generator's yuv420 link decodes with nvJPEG (ycc_to_rgb) and letterboxes
# with letterbox_yuv420 (letterbox_rgb is counted, never required)
JPEG_PATH_KERNELS = ('ycc_to_rgb', 'letterbox_yuv420')


def reset_jpeg_launches():
    from multigriddet_tpu_torch.ops import cuda_jpeg
    for name in ('ycc_to_rgb', 'letterbox_rgb', 'letterbox_yuv420'):
        getattr(cuda_jpeg, name).launches = 0


def read_jpeg_launches(label):
    """The jpeg.cu launches since ``reset_jpeg_launches``; fails where a
    kernel of the validations' input path was launched no time."""
    from multigriddet_tpu_torch.ops import cuda_jpeg
    got = {name: getattr(cuda_jpeg, name).launches
           for name in ('ycc_to_rgb', 'letterbox_rgb', 'letterbox_yuv420')}
    if not all(got[name] for name in JPEG_PATH_KERNELS):
        raise AssertionError(f'{label}: the run did not go through '
                             f'{JPEG_PATH_KERNELS}: launches {got}')
    return got


def validate_jpeg_check(dev, lines, hw, label):
    """Hold the jpeg.cu kernels of a learning validation's input path
    against their plain versions at that path's own shapes: one batch of
    the set's own JPEGs at the task's canvas, decoded as the train
    generator decodes them (``jpeg_cuda.decode_files``) and letterboxed to
    4:2:0 by ``letterbox_yuv420``.  Each image against ``ycc_to_rgb_plain``
    on nvJPEG's planes of the same file, and the planes against
    ``letterbox_rgb`` on the CPU then ``rgb_to_yuv420_plain``: bit for
    bit, with metas and ok equal.  Launches made here are not counted."""
    import numpy as np
    from multigriddet_tpu_torch.data import jpeg_cuda, parse_annotation_line
    from multigriddet_tpu_torch.ops import cuda_jpeg
    paths = [parse_annotation_line(line)[0] for line in lines]
    images, sizes = jpeg_cuda.decode_files(paths, dev, hw)
    max_err, layouts = 0, set()
    with cuda_jpeg.decoder(dev) as dec:
        for path, image, size in zip(paths, images, sizes):
            with open(path, 'rb') as f:
                data = f.read()
            hd = dec.header(data)
            if image is None or isinstance(hd, int) \
                    or hd[3] not in cuda_jpeg.FACTORS:
                raise AssertionError(f'{label}: {path} is not a colour JPEG '
                                     f'that nvJPEG decodes ({hd})')
            planes = []
            again, _, _ = dec.decode(data, hw, planes)
            d = cuda_jpeg.divisor(*size, hw)
            want = cuda_jpeg.ycc_to_rgb_plain(
                *(p.cpu() for p in planes), cuda_jpeg.FACTORS[hd[3]], d)
            for got in (image, again):
                max_err = max(max_err, int((got.cpu().int() - want.int())
                                           .abs().max()))
            layouts.add((hd[3], d))
    y, cb, cr, metas, ok = cuda_jpeg.letterbox_yuv420(images, hw, dev, sizes)
    rgb, want_metas, want_ok = cuda_jpeg.letterbox_rgb(
        [im.cpu() for im in images], hw, 'cpu', sizes)
    for got, want in zip((y, cb, cr), cuda_jpeg.rgb_to_yuv420_plain(rgb)):
        max_err = max(max_err, int((got.cpu().int() - want.int())
                                   .abs().max()))
    if max_err or not (np.array_equal(metas, want_metas) and np.array_equal(
            ok, want_ok) and ok.all()):
        raise AssertionError(f'{label}: the jpeg.cu kernels differ from '
                             f'their plain versions on the set\'s JPEGs at '
                             f'{hw} by {max_err} (ok {ok.tolist()})')
    log(f'[{label}] jpeg.cu on {len(paths)} of the set\'s own JPEGs at '
        f'{hw[0]}x{hw[1]}: ycc_to_rgb (layout, divisor) {sorted(layouts)} '
        f'and letterbox_yuv420 bit-equal to their plain versions')
    return {'images': len(paths), 'hw': list(hw),
            'layouts': sorted(layouts), 'max_abs_err': max_err}


def popmax_agreement(done, lines, dev) -> int:
    """Hold a validation run's ``pallas_fused`` detections, chunk by
    chunk, against ``popmax_nms_plain`` on the same trained weights' pool:
    keep set, order, classes, boxes and scores equal.  Returns the number
    of kept boxes checked."""
    import numpy as np
    import torch
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.training.steps import candidate_pool
    from multigriddet_tpu_torch.validate import scoring_batches
    task = done.trained.task
    model = done.trained.state.model.eval()
    chunks = done.detections['pallas_fused']
    kept = 0
    for (start, batch, _), got in zip(scoring_batches(task, lines), chunks):
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(dev).float() / 255.0
            pool = candidate_pool(model, x, task.anchors, task.hw)
            plain = cuda_nms.popmax_nms_plain(
                *pool, task.confidence, THR, task.score_max_boxes, 'diou',
                True)
        for what, a, b in zip(('boxes', 'classes', 'scores', 'valid'), got,
                              (t.cpu().numpy() for t in plain)):
            if not np.array_equal(a, b):
                raise AssertionError(
                    f'{task.name}: pallas_fused {what} of the chunk at '
                    f'{start} differ from the plain pop-max')
        kept += int(got[3].sum())
    if len(chunks) != -(-len(lines) // task.score_batch):
        raise AssertionError(f'{task.name}: {len(chunks)} chunks scored')
    return kept


def phase_validate(dev, smi):
    """Phase 14: ``python -m multigriddet_tpu_torch.validate`` at a cut
    budget.  The flagship mode (``multigriddet_darknet``, bfloat16,
    ``bn_momentum`` 0.9, the tools' 200-image shapes set written with
    Pillow and read through nvJPEG, mosaic + flips + zoom, Adam under the
    warmup cosine) for ``VALIDATE_FLAGSHIP_EPOCHS`` epochs and the
    ``presets mobile`` mode for ``VALIDATE_MOBILE_EPOCHS``, each scored by
    the tools' loop through ``xla`` and ``pallas_fused``: the mean loss of
    the last epoch must lie below epoch 0's, both mAPs are printed, and
    every chunk's ``pallas_fused`` detections must equal the plain pop-max
    on the trained weights' pool.  Each run must launch ``ycc_to_rgb`` and
    ``letterbox_yuv420`` (its input path), which are then held against
    their plain versions on the set's own 256x256 files
    (``validate_jpeg_check``).  Returns the report with the launches of
    the runs."""
    import dataclasses
    import shutil
    import numpy as np
    from multigriddet_tpu_torch.data import load_annotation_lines
    from multigriddet_tpu_torch.ops import cuda_nms
    from multigriddet_tpu_torch.validate import (FLAGSHIP, PRESETS, run,
                                                 write_set)
    t0 = time.perf_counter()
    root = os.path.join(REPO, 'build', 'chip_smoke_validate')
    shutil.rmtree(root, ignore_errors=True)
    ann = write_set(FLAGSHIP, root)
    lines = load_annotation_lines(ann, shuffle=False)
    report = {'popmax_launches': 0,
              'jpeg_launches': {'ycc_to_rgb': 0, 'letterbox_rgb': 0,
                                'letterbox_yuv420': 0}}
    for task in (dataclasses.replace(FLAGSHIP,
                                     epochs=VALIDATE_FLAGSHIP_EPOCHS),
                 dataclasses.replace(PRESETS['mobile'],
                                     epochs=VALIDATE_MOBILE_EPOCHS)):
        cuda_nms.popmax_nms.launches = 0
        reset_jpeg_launches()
        done = run(task, ann, dev, log=log)
        launches = cuda_nms.popmax_nms.launches
        jpeg_launches = read_jpeg_launches(task.name)
        report['popmax_launches'] += launches
        for name, n in jpeg_launches.items():
            report['jpeg_launches'][name] += n
        res = done.result
        kept = popmax_agreement(done, lines, dev)
        first, last = res['epoch_losses'][0], res['epoch_losses'][-1]
        scores = res['scores']
        log(f'[validate] {task.name} ({task.model}, '
            f'{res["params"] / 1e6:.1f}M) {task.epochs} epochs of '
            f'{res["steps"] // task.epochs} steps: epoch-mean loss '
            f'{first:.3f} -> {last:.3f}, final {res["final_loss"]:.3f}; '
            f'mAP50 / mAP xla {scores["xla"]["mAP50"]:.4f} / '
            f'{scores["xla"]["mAP"]:.4f}, pallas_fused '
            f'{scores["pallas_fused"]["mAP50"]:.4f} / '
            f'{scores["pallas_fused"]["mAP"]:.4f}; pallas_fused equal to '
            f'the plain pop-max on {kept} kept boxes; {launches} pop-max '
            f'launches, jpeg.cu {jpeg_launches}; training '
            f'{res["seconds"]:.1f} s '
            f'({res["images_per_s"]:.1f} img/s); card: {smi}')
        if not (np.isfinite(res['epoch_losses']).all() and last < first
                and launches > 0):
            raise AssertionError(f'{task.name}: loss {first} -> {last}, '
                                 f'{launches} pop-max launches')
        report[task.name] = {k: res[k] for k in (
            'epochs', 'steps', 'seconds', 'images_per_s', 'final_loss',
            'epoch_losses', 'scores')}
        report[task.name]['popmax_launches'] = launches
        report[task.name]['kept_checked'] = kept
        report[task.name]['jpeg_launches'] = jpeg_launches
        del done
    report['jpeg_check'] = validate_jpeg_check(
        dev, lines[:FLAGSHIP.batch_size], FLAGSHIP.hw, 'validate')
    shutil.rmtree(root, ignore_errors=True)
    report['seconds'] = time.perf_counter() - t0
    log(f'[validate] phase {report["seconds"]:.1f} s')
    return report


_STEP_TIMES_CHILD = """
import importlib.util, json, sys
sys.path.insert(0, {tree!r})
spec = importlib.util.spec_from_file_location('chip_smoke', {script!r})
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
print('STEPS ' + json.dumps(c.step_times()), flush=True)
"""


def step_times():
    """The serve step (phase 5's fused step on a resident batch, 20 calls
    after 3) and the fused train step (augmentation off, as phase 9 times
    it) of ``multigriddet_darknet`` at b8 @608 bf16, for the port that
    ``import multigriddet_tpu_torch`` finds."""
    import torch
    import multigriddet_tpu_torch
    phase_build()
    dev = torch.device('cuda')
    engine = build_engine('pallas_fused')
    x = torch.from_numpy(letterboxed_batches(1, SEED)[0]).to(dev)
    serve_ms = cuda_ms(lambda: engine.infer_batch(x), 20, 3)
    del engine
    _, canvases, boxes = train_frames(B, SEED + 13)
    train = zoo_train_step('multigriddet_darknet', dev, canvases, boxes)
    return {'package': os.path.dirname(multigriddet_tpu_torch.__file__),
            'serve_step_ms': serve_ms, 'train_step_ms': train['train_step_ms'],
            'train_peak_gib': train['train_peak_gib']}


def compare_step_times(trees):
    """``step_times`` of the port in each checkout of ``trees``, one fresh
    process each, in the order given (e.g. parent, change, change,
    parent): one line ``{"tree": ..., ...}`` each."""
    out = []
    for tree in trees:
        code = _STEP_TIMES_CHILD.format(tree=os.path.abspath(tree),
                                        script=os.path.abspath(__file__))
        proc = subprocess.run([sys.executable, '-c', code], text=True,
                              capture_output=True, check=True)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith('STEPS ')][-1]
        out.append({'tree': tree, **json.loads(line[len('STEPS '):])})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--report', default=None,
                   help='also write every measured number to this JSON file')
    p.add_argument('--step-times', nargs='+', metavar='CHECKOUT',
                   help='only time the darknet serve and train steps of the '
                        'port in each checkout, in turn (e.g. parent, change, '
                        'change, parent), and exit')
    p.add_argument('--dp-child', nargs='+', help=argparse.SUPPRESS)
    p.add_argument('--sp-child', nargs='+', help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dp_child:      # one rank of phase 11, started by the phase
        sys.path.insert(0, REPO)
        mode, rank, world, port, out, device, *root = args.dp_child
        dp_child(mode, int(rank), int(world), int(port), out, device,
                 *root)
        return 0
    if args.sp_child:      # one rank of phase 12, started by the phase
        sys.path.insert(0, REPO)
        mode, rank, world, port, out, device = args.sp_child
        sp_child(mode, int(rank), int(world), int(port), out, device)
        return 0

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import multigriddet_tpu_torch  # noqa: F401  (fails outside the repo)

    smi = smi_line()
    log(f'[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    if args.step_times:
        compare_step_times(args.step_times)
        return 0
    from multigriddet_tpu_torch.utils.profiling import PhaseTimer
    dev = torch.device('cuda')
    timer = PhaseTimer()
    t_start = time.perf_counter()
    with timer.phase('1 build'):
        build = phase_build()
    with timer.phase('2 kernels'):
        errs = phase_kernels(dev)
    batches = letterboxed_batches(SERVE_BATCHES, SEED)
    with timer.phase('3 serve'):
        engines, launches, pool = phase_serve(batches)
    with timer.phase('4 f32 parity'):
        f32_err = phase_f32_parity(engines['pallas_fused'], batches[0])
    with timer.phase('5 times'):
        times, ktimes = phase_times(engines, batches, pool)
    with timer.phase('6 evaluate'):
        evaluate = phase_evaluate(pool, smi)
    evaluate['seconds'] = timer.totals['6 evaluate']
    log(f'[evaluate] phase took {evaluate["seconds"]:.1f} s')
    with timer.phase('7 train'):
        train = phase_train(dev, smi)
    log(f'[train] phase took {train["seconds"]:.1f} s')
    with timer.phase('8 overfit'):
        overfit = phase_overfit_map(dev, smi)
    with timer.phase('9 zoo'):
        zoo = phase_zoo(dev, smi)
    del engines
    torch.cuda.empty_cache()
    with timer.phase('10 export'):
        export = phase_export(dev, smi)
    with timer.phase('11 data parallel'):
        data_parallel = phase_data_parallel(dev, smi)
    with timer.phase('12 spatial partition'):
        spatial = phase_spatial(dev, smi)
    with timer.phase('13 jpeg'):
        jpeg = phase_jpeg(dev, smi, build)
    with timer.phase('14 validate'):
        validate = phase_validate(dev, smi)
    log('[phases]\n' + timer.summary())

    src = 'multigriddet_tpu_torch/csrc/nms.cu'
    replaces = {'popmax_nms': 'multigriddet_tpu/ops/pallas_nms.py:115',
                'greedy_nms': 'multigriddet_tpu/ops/pallas_nms.py:34'}
    path_of = {'popmax_nms': 'pallas_fused', 'greedy_nms': 'pallas'}
    # the serve run's launches, the zoo's (one pop-max a served batch),
    # the sp infer path's (both ranks) and the learning validations'
    # pallas_fused scoring (phases 8 and 14)
    more = {'popmax_nms': zoo['popmax_launches']
            + spatial['popmax_launches'] + overfit['popmax_launches']
            + validate['popmax_launches'], 'greedy_nms': 0}
    kernels = [{'name': k['name'], 'route': 'cuda', 'source': src,
                'replaces': replaces[k['name']],
                'launches': (launches[path_of[k['name']]][k['name']]
                             + more[k['name']]),
                'max_abs_err': errs[k['name']], 'ms': k['ms'],
                'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
                'bound_by': k['bound_by'], 'library_ms': None}
               for k in ktimes]
    for name, replaces in (('ycc_to_rgb', 'native/fastloader.cpp:44'),
                           ('letterbox_rgb', 'native/fastloader.cpp:107'),
                           ('letterbox_yuv420', 'native/fastloader.cpp:209')):
        k = jpeg['kernels'][name]
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'multigriddet_tpu_torch/csrc/jpeg.cu',
            'replaces': replaces,
            'launches': (jpeg['launches'][name]
                         + overfit['jpeg_launches'][name]
                         + validate['jpeg_launches'][name]),
            'max_abs_err': max(jpeg['fixtures']['max_abs_err'],
                               overfit['jpeg_check']['max_abs_err'],
                               validate['jpeg_check']['max_abs_err']),
            'ms': k['ms'],
            'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
            'bound_by': k['bound_by'], 'library_ms': None})
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump({'card': smi, 'torch': torch.__version__,
                       'cuda': torch.version.cuda,
                       'build_seconds': {k: v['seconds']
                                         for k, v in build.items()},
                       'serve': times, 'launches': launches,
                       'f32_parity_rel_err': f32_err, 'kernels': kernels,
                       'evaluate': evaluate, 'train': train,
                       'overfit_map': overfit, 'zoo': zoo,
                       'export': export, 'data_parallel': data_parallel,
                       'spatial_partition': spatial, 'jpeg': jpeg,
                       'validate': validate,
                       'phase_seconds': timer.totals,
                       'kernel_pairs': {k['name']: k['pairs']
                                        for k in ktimes},
                       'kernel_call_ms': {k['name']: k['call_ms']
                                          for k in ktimes},
                       'seconds': time.perf_counter() - t_start}, f,
                      indent=1)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
