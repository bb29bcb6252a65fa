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

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when there is no GPU or any phase fails.  Needs no YAML, Pillow or
msgpack, and imports nothing of JAX.
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
    from multigriddet_tpu_torch.ops import kernel_build
    t0 = time.perf_counter()
    info = kernel_build.build('nms.cu')
    log(f'[build] {os.path.relpath(info["path"], REPO)} in '
        f'{time.perf_counter() - t0:.2f} s (nvcc {info["seconds"]:.2f} s)')
    for line in info['log'].splitlines():
        if 'registers' in line or 'Compiling entry' in line:
            log(f'[build] {line.strip()}')
    return info


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--report', default=None,
                   help='also write every measured number to this JSON file')
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import multigriddet_tpu_torch  # noqa: F401  (fails outside the repo)

    smi = smi_line()
    log(f'[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    t_start = time.perf_counter()
    build = phase_build()
    errs = phase_kernels(torch.device('cuda'))
    batches = letterboxed_batches(SERVE_BATCHES, SEED)
    engines, launches, pool = phase_serve(batches)
    f32_err = phase_f32_parity(engines['pallas_fused'], batches[0])
    times, ktimes = phase_times(engines, batches, pool)
    t_eval = time.perf_counter()
    evaluate = phase_evaluate(pool, smi)
    evaluate['seconds'] = time.perf_counter() - t_eval
    log(f'[evaluate] phase took {evaluate["seconds"]:.1f} s')

    src = 'multigriddet_tpu_torch/csrc/nms.cu'
    replaces = {'popmax_nms': 'multigriddet_tpu/ops/pallas_nms.py:115',
                'greedy_nms': 'multigriddet_tpu/ops/pallas_nms.py:34'}
    path_of = {'popmax_nms': 'pallas_fused', 'greedy_nms': 'pallas'}
    kernels = [{'name': k['name'], 'route': 'cuda', 'source': src,
                'replaces': replaces[k['name']],
                'launches': launches[path_of[k['name']]][k['name']],
                'max_abs_err': errs[k['name']], 'ms': k['ms'],
                'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
                'bound_by': k['bound_by'], 'library_ms': None}
               for k in ktimes]
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump({'card': smi, 'torch': torch.__version__,
                       'cuda': torch.version.cuda,
                       'build_seconds': build['seconds'],
                       'serve': times, 'launches': launches,
                       'f32_parity_rel_err': f32_err, 'kernels': kernels,
                       'evaluate': evaluate,
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
