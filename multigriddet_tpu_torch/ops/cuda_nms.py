"""The two NMS kernels of the main path, for Hopper, beside their plain
PyTorch versions.

``popmax_nms`` replaces ``pallas_popmax_nms`` / ``_popmax_kernel``
(``multigriddet_tpu/ops/pallas_nms.py:115-247``): confidence filter and
greedy NMS fused over the whole untruncated pool, one image per block.
  Bound on the card: latency.  At the serving shape (B = 8, N = 7,581,
  max_boxes = 100) the inputs are B*N*24 bytes (1.5 MB, under a
  microsecond at HBM rate) and the overlap tests a few million float32
  operations, but greedy NMS is a chain of dependent decisions, each
  paid for with a barrier.  The design takes the chain out of the pool's
  size: the live candidates' (score, index) keys are compacted into
  shared memory, a two-pass radix select picks the best ~512 of them, a
  bitonic sort (three stages per trip through shared memory) orders
  those, and the sorted list is swept 64 candidates at a step: each is
  tested against the boxes kept so far, the chunk's 64 x 64 suppression
  words are filled in parallel, and one warp resolves them with bit
  operations.  The sweep stops at ``max_boxes`` keeps; only if it runs
  past the selected head are all the keys sorted (an army of identical
  boxes at the top of the order does that, and costs one step per 64 of
  them).  Holds up to ``mgd_popmax_capacity(max_boxes)`` candidates
  (16,384 at 100 boxes).

``greedy_nms`` replaces ``pallas_greedy_nms`` / ``_nms_sweep_kernel``
(``multigriddet_tpu/ops/pallas_nms.py:34-112``): the keep mask of K boxes
already sorted by descending score.  Batched (the JAX wrapper handles one
image and is vmapped).
  Bound on the card: latency, K dependent decisions.  A first kernel fills
  the K x K suppression bitmask (upper-triangular 64 x 64 blocks, 256
  threads each, B * ceil(K/64)^2 / 2 blocks over the whole card) into a
  ``[B, K, ceil(K/64)]`` int64 scratch; a second, one block per image,
  scans it 64 rows at a step with one barrier a step: one warp resolves
  the chunk's rows from their diagonal words held in shared memory and
  carries its survivors into the next chunk, while the other warps OR the
  previous chunk's survivors into the chunks after that.  Holds up to
  ``mgd_greedy_capacity()`` boxes (about 14,000).

Each wrapper runs its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; it never falls back.  It counts
one launch per call in ``<wrapper>.launches`` (``greedy_nms`` launches two
CUDA kernels per call).  The plain versions repeat the kernels' float32
arithmetic operation by operation, so decisions agree bit for bit, ties
included.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernel_build

NEG = -1e9
_SOURCE = 'nms.cu'
_METHODS = ('standard', 'diou')


def _check_method(method: str):
    if method not in _METHODS:
        raise ValueError(f'NMS kernels take methods {_METHODS}, '
                         f'got {method!r}')


def overlap_rows(rows: torch.Tensor, boxes: torch.Tensor, method: str,
                 use_iol: bool) -> torch.Tensor:
    """Overlap of ``rows [B, R, 4]`` with ``boxes [B, N, 4]`` -> ``[B, R, N]``
    in the Pallas kernels' float32 order (``pallas_nms.py:57-72``)."""
    xi, yi, wi, hi = (rows[..., k, None] for k in range(4))
    xs, ys, ws, hs = (boxes[..., None, :, k] for k in range(4))
    iw = torch.clamp_min(torch.minimum(xi + wi, xs + ws)
                         - torch.maximum(xi, xs), 0.0)
    ih = torch.clamp_min(torch.minimum(yi + hi, ys + hs)
                         - torch.maximum(yi, ys), 0.0)
    inter = iw * ih
    area_i, areas = wi * hi, ws * hs
    if use_iol:
        ov = inter / (torch.maximum(area_i, areas) + 1e-8)
    else:
        ov = inter / (area_i + areas - inter + 1e-8)
    if method == 'diou':
        dx = xi + wi / 2.0 - xs - ws / 2.0
        dy = yi + hi / 2.0 - ys - hs / 2.0
        cdist = dx * dx + dy * dy
        ex = torch.maximum(xi + wi, xs + ws) - torch.minimum(xi, xs)
        ey = torch.maximum(yi + hi, ys + hs) - torch.minimum(yi, ys)
        ov = ov - cdist / (ex * ex + ey * ey + 1e-8)
    return ov


# ---------------------------------------------------------------------------
# pop-max NMS over the full pool
# ---------------------------------------------------------------------------

def popmax_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     classes: torch.Tensor, confidence: float,
                     threshold: float, max_boxes: int = 100,
                     method: str = 'diou', use_iol: bool = True):
    """Plain PyTorch version of the pop-max kernel (same contract)."""
    _check_method(method)
    b, n = scores.shape
    dev = scores.device
    boxes = boxes.float()
    s = torch.where(scores >= confidence, scores.float(),
                    torch.tensor(NEG, device=dev))
    col = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    out_b = torch.empty(b, max_boxes, 4, device=dev)
    out_c = torch.empty(b, max_boxes, dtype=torch.int32, device=dev)
    out_s = torch.empty(b, max_boxes, device=dev)
    out_v = torch.empty(b, max_boxes, dtype=torch.bool, device=dev)
    for i in range(max_boxes):
        cur = s.amax(dim=1)
        live = cur > NEG / 2
        # the lowest flat index among equal maxima, as the kernel pops
        idx = torch.where(s == cur[:, None], col, n).amin(dim=1)
        bi = boxes[rows, idx]
        ov = overlap_rows(bi[:, None], boxes, method, use_iol)[:, 0]
        sup = ((ov >= threshold) | (col == idx[:, None])) & live[:, None]
        s = torch.where(sup, torch.tensor(NEG, device=dev), s)
        out_b[:, i] = bi
        out_c[:, i] = classes[rows, idx].to(torch.int32)
        out_s[:, i] = cur
        out_v[:, i] = live
    return out_b, out_c, out_s, out_v


def popmax_nms(boxes: torch.Tensor, scores: torch.Tensor,
               classes: torch.Tensor, confidence: float, threshold: float,
               max_boxes: int = 100, method: str = 'diou',
               use_iol: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Fused confidence filter + greedy NMS over the whole pool, batched.

    Args:
      boxes: ``[B, N, 4]`` float32 top-left ``(x, y, w, h)`` pixels.
      scores: ``[B, N]`` float32.
      classes: ``[B, N]`` int32.
    Returns:
      ``(boxes [B, M, 4], classes [B, M] int32, scores [B, M],
      valid [B, M] bool)`` with ``M = max_boxes``; invalid slots carry
      score -1e9 and junk boxes.
    """
    _check_method(method)
    if boxes.device.type == 'cpu':
        return popmax_nms_plain(boxes, scores, classes, confidence,
                                threshold, max_boxes, method, use_iol)
    b, n = _check_cuda_inputs(boxes, scores=scores, classes=classes)
    lib = _library()
    capacity = lib.mgd_popmax_capacity(max_boxes)
    if n > capacity:
        raise ValueError(f'popmax_nms holds at most {capacity} candidates '
                         f'per image in shared memory beside {max_boxes} '
                         f'kept boxes, got {n}')
    dev = boxes.device
    out_b = torch.empty(b, max_boxes, 4, device=dev)
    out_c = torch.empty(b, max_boxes, dtype=torch.int32, device=dev)
    out_s = torch.empty(b, max_boxes, device=dev)
    out_v = torch.empty(b, max_boxes, dtype=torch.bool, device=dev)
    if b and max_boxes:
        err = lib.mgd_popmax_nms(
            boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(), b, n,
            float(confidence), float(threshold), max_boxes,
            int(method == 'diou'), int(use_iol), out_b.data_ptr(),
            out_c.data_ptr(), out_s.data_ptr(), out_v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, 'popmax_nms')
        popmax_nms.launches += 1
    return out_b, out_c, out_s, out_v


popmax_nms.launches = 0


# ---------------------------------------------------------------------------
# greedy sweep over score-sorted boxes
# ---------------------------------------------------------------------------

_PLAIN_ROW_BLOCK = 512


def greedy_nms_plain(boxes: torch.Tensor, valid: torch.Tensor,
                     threshold: float, method: str = 'diou',
                     use_iol: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the greedy kernel (same contract)."""
    _check_method(method)
    b, k, _ = boxes.shape
    boxes = boxes.float()
    keep = valid.clone()
    col = torch.arange(k, device=boxes.device)
    for start in range(0, k, _PLAIN_ROW_BLOCK):
        ov = overlap_rows(boxes[:, start:start + _PLAIN_ROW_BLOCK], boxes,
                          method, use_iol)
        for r in range(ov.shape[1]):
            i = start + r
            sup = (ov[:, r] >= threshold) & keep[:, i, None] & (col > i)
            keep &= ~sup
    return keep


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, threshold: float,
               method: str = 'diou', use_iol: bool = True) -> torch.Tensor:
    """Greedy keep mask, batched.

    Args:
      boxes: ``[B, K, 4]`` float32 top-left ``(x, y, w, h)``, each image
        sorted by descending score.
      valid: ``[B, K]`` bool.
    Returns:
      ``[B, K]`` bool keep mask: box i drops every later box j whose
      overlap with it is ``>= threshold``, if i itself is kept.
    """
    _check_method(method)
    if boxes.device.type == 'cpu':
        return greedy_nms_plain(boxes, valid, threshold, method, use_iol)
    b, k = _check_cuda_inputs(boxes, valid=valid)
    lib = _library()
    if k > lib.mgd_greedy_capacity():
        raise ValueError(f'greedy_nms holds at most '
                         f'{lib.mgd_greedy_capacity()} boxes per image in '
                         f'shared memory, got {k}')
    keep = torch.empty(b, k, dtype=torch.bool, device=boxes.device)
    # suppression words: row i, bit t of word w <=> box i drops box 64*w+t
    mask = torch.empty(b, k, -(-k // 64), dtype=torch.int64,
                       device=boxes.device)
    if b and k:
        err = lib.mgd_greedy_nms(
            boxes.data_ptr(), valid.data_ptr(), b, k, float(threshold),
            int(method == 'diou'), int(use_iol), mask.data_ptr(),
            keep.data_ptr(),
            torch.cuda.current_stream(boxes.device).cuda_stream)
        _raise_on(err, 'greedy_nms')
        greedy_nms.launches += 1
    return keep


greedy_nms.launches = 0


# ---------------------------------------------------------------------------
# binding
# ---------------------------------------------------------------------------

def _check_cuda_inputs(boxes: torch.Tensor, **others) -> Tuple[int, int]:
    if boxes.device.type != 'cuda':
        raise ValueError(f'the NMS kernels run on CUDA tensors, got '
                         f'{boxes.device}')
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f'boxes must be [B, N, 4], got {tuple(boxes.shape)}')
    b, n = boxes.shape[:2]
    want = {'scores': torch.float32, 'classes': torch.int32,
            'valid': torch.bool}
    for name, t in (('boxes', boxes), *others.items()):
        dtype = torch.float32 if name == 'boxes' else want[name]
        if t.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
        if t.device != boxes.device:
            raise ValueError(f'{name} is on {t.device}, boxes on '
                             f'{boxes.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if name != 'boxes' and tuple(t.shape) != (b, n):
            raise ValueError(f'{name} must be [{b}, {n}], got '
                             f'{tuple(t.shape)}')
    if n == 0:
        raise ValueError('the NMS kernels need at least one candidate')
    return b, n


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')


def _bind(lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mgd_popmax_capacity.argtypes = [i]
    lib.mgd_popmax_capacity.restype = i
    lib.mgd_greedy_capacity.argtypes = []
    lib.mgd_greedy_capacity.restype = i
    lib.mgd_popmax_nms.argtypes = [p, p, p, i, i, f, f, i, i, i,
                                   p, p, p, p, p]
    lib.mgd_popmax_nms.restype = i
    lib.mgd_greedy_nms.argtypes = [p, p, i, i, f, i, i, p, p, p]
    lib.mgd_greedy_nms.restype = i


def _library() -> ctypes.CDLL:
    return kernel_build.load(_SOURCE, _bind)
