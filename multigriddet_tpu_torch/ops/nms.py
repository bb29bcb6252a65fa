"""Fixed-shape batched NMS.

Counterpart of ``multigriddet_tpu/ops/nms.py`` with the same routing
(``nms.py:144-199``):

* ``backend='pallas_fused'`` with a class-agnostic standard/diou NMS runs
  the pop-max kernel over the whole pool (``cuda_nms.popmax_nms``;
  ``pre_nms_top_k`` is ignored there);
* otherwise the pool is confidence-filtered and cut to ``pre_nms_top_k``
  by score, then ``backend='pallas'`` runs the greedy kernel
  (``cuda_nms.greedy_nms``), ``'xla'`` the cluster-NMS matrix iteration,
  and the soft and cluster methods their sweeps, all in PyTorch;
* the kept boxes are cut to ``max_boxes`` by score.

Both cuts sort stably in descending order, so equal scores keep the lower
index first, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from . import cuda_nms
from .geometry import pairwise_diou_xywh_topleft, pairwise_iou_xywh_topleft

NEG_INF = -1e9


def _overlap_matrix(boxes, nms_method: str, use_iol: bool):
    if nms_method == 'diou':
        return pairwise_diou_xywh_topleft(boxes, boxes, use_iol=use_iol)
    return pairwise_iou_xywh_topleft(boxes, boxes, use_iol=use_iol)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x`` of shape ``[B, N, ...]``."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.gather(x, 1, idx)


def _soft_nms_sweep(overlap: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, sigma: float,
                    score_floor: float) -> torch.Tensor:
    """Gaussian soft-NMS in the original descending-score order; returns
    decayed scores with dropped entries at ``NEG_INF``.

    Eagerly the K steps run as a Python loop with a Python index (no host
    sync); under ``torch.export`` the same body runs in a
    ``while_loop`` with a tensor index (``lax.fori_loop`` in JAX), so the
    exported program does not unroll K steps."""
    k = overlap.shape[-1]
    iota = torch.arange(k, device=overlap.device)
    neg = torch.full((), NEG_INF, device=scores.device)

    def body(i, s, overlap, valid, iota):
        at = (i.reshape(1) if isinstance(i, torch.Tensor)
              else iota.narrow(0, i, 1))
        cur_ok = s.index_select(1, at) >= score_floor
        row = overlap.index_select(1, at)[:, 0]
        decayed = s * torch.exp(-(row ** 2) / sigma)
        s = torch.where(cur_ok & (iota > i) & valid, decayed, s)
        s = torch.where((iota == i) & ~cur_ok,
                        torch.full((), NEG_INF, device=s.device), s)
        return i + 1, s

    s = torch.where(valid, scores, neg)
    if torch.compiler.is_exporting():
        _, s = while_loop_op(
            lambda i, s, *_: i < k, body,
            (torch.zeros((), dtype=torch.int64, device=s.device), s),
            (overlap, valid, iota))
    else:
        for i in range(k):
            _, s = body(i, s, overlap, valid, iota)
    return torch.where(s >= score_floor, s, neg)


def _cluster_nms_sweep(overlap: torch.Tensor, valid: torch.Tensor,
                       nms_threshold: float) -> torch.Tensor:
    """Cluster-NMS matrix iteration (arXiv:2005.03572) to a fixed point,
    at most K rounds; the same keep set as the greedy sweep.

    A ``while_loop`` (``lax.while_loop`` in JAX): eagerly a Python loop
    that reads the condition on the host each round, under
    ``torch.export`` one loop node, so the live step and an exported
    program run this one function."""
    k = overlap.shape[-1]
    idx = torch.arange(k, device=overlap.device)
    upper = idx[:, None] < idx[None, :]
    x = torch.where(upper & valid[:, None, :] & valid[:, :, None], overlap,
                    torch.zeros((), device=overlap.device))

    def cond(keep, prev, it, x, valid):
        return torch.any(keep != prev) & (it < k)

    def body(keep, prev, it, x, valid):
        maxcol = torch.amax(x * keep[:, :, None].to(x.dtype), dim=1)
        return (maxcol < nms_threshold) & valid, keep.clone(), it + 1

    keep, _, _ = while_loop_op(
        cond, body,
        (valid, torch.zeros_like(valid),
         torch.zeros((), dtype=torch.int64, device=valid.device)),
        (x, valid))
    return keep


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, confidence: float,
                nms_threshold: float, max_boxes: int = 100,
                pre_nms_top_k: int = 512, nms_method: str = 'diou',
                use_iol: bool = True, class_aware: bool = False,
                soft_sigma: float = 0.5, soft_floor: float = 1e-3,
                backend: str = 'xla'
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Confidence filter + NMS, fixed shapes, batched.

    Args:
      boxes: ``[B, N, 4]`` top-left ``(x, y, w, h)`` pixels, float32.
      scores: ``[B, N]`` confidence.
      classes: ``[B, N]`` int class ids.
    Returns:
      ``(boxes [B, max_boxes, 4], classes [B, max_boxes] int32,
      scores [B, max_boxes], valid [B, max_boxes] bool)``.
    """
    if backend not in ('xla', 'pallas', 'pallas_fused'):
        raise ValueError(f'unknown nms backend {backend!r}')
    classes = classes.to(torch.int32)
    if (backend == 'pallas_fused' and not class_aware
            and nms_method in ('standard', 'diou')):
        return cuda_nms.popmax_nms(
            boxes.float().contiguous(), scores.float().contiguous(),
            classes.contiguous(), confidence, nms_threshold,
            max_boxes=max_boxes, method=nms_method, use_iol=use_iol)

    neg = torch.tensor(NEG_INF, device=scores.device)
    sc = torch.where(scores >= confidence, scores, neg)
    k = min(pre_nms_top_k, sc.shape[1])
    top_sc, idx = top_k(sc, k)
    top_bx = gather_rows(boxes, idx)
    top_cl = gather_rows(classes, idx)
    valid = top_sc > NEG_INF / 2

    nms_bx = top_bx
    if class_aware:
        # offset boxes per class so cross-class pairs never overlap
        span = (top_bx.amax(dim=(1, 2)) + 1.0) * 2.0
        nms_bx = top_bx.clone()
        nms_bx[..., 0] += top_cl.to(torch.float32) * span[:, None]

    if nms_method == 'soft':
        overlap = _overlap_matrix(nms_bx, 'standard', use_iol)
        keep_sc = _soft_nms_sweep(overlap, top_sc, valid, soft_sigma,
                                  soft_floor)
    else:
        if nms_method == 'cluster':
            overlap = _overlap_matrix(nms_bx, 'standard', use_iol)
            keep = _cluster_nms_sweep(overlap, valid, nms_threshold)
        elif backend == 'pallas':
            keep = cuda_nms.greedy_nms(nms_bx.contiguous(),
                                       valid.contiguous(), nms_threshold,
                                       nms_method, use_iol)
        else:
            overlap = _overlap_matrix(nms_bx, nms_method, use_iol)
            keep = _cluster_nms_sweep(overlap, valid, nms_threshold)
        keep_sc = torch.where(keep, top_sc, neg)

    m = min(max_boxes, k)
    out_sc, out_idx = top_k(keep_sc, m)
    out_valid = out_sc > NEG_INF / 2
    out_bx = gather_rows(top_bx, out_idx)
    out_cl = gather_rows(top_cl, out_idx)
    if m < max_boxes:
        pad = max_boxes - m
        out_bx = torch.nn.functional.pad(out_bx, (0, 0, 0, pad))
        out_cl = torch.nn.functional.pad(out_cl, (0, pad))
        out_sc = torch.nn.functional.pad(out_sc, (0, pad), value=NEG_INF)
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    return out_bx, out_cl, out_sc, out_valid
