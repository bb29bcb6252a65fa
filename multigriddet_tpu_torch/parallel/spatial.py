"""Spatial partitioning: the rows of every feature map banded over ranks.

Counterpart of what GSPMD does for the JAX package's 2-D ``('batch',
'space')`` mesh (``multigriddet_tpu/parallel/mesh.py``): images placed
``P('batch', 'space')`` split their rows over the ``sp`` devices of a
space group, and XLA writes a halo exchange into every convolution.  The
port makes the same function explicit with two pieces:

* a **band map**: a level of ``rows`` global rows splits as evenly as
  possible over the ``sp`` ranks of a space group, the first ``rows % sp``
  ranks holding one row more (:func:`band`).  Every level's split comes
  from its own row count, so uneven bands (19 rows at stride 32 of a 608
  canvas: 10 and 9) need no padding;
* :func:`gather_rows`, an autograd function over the space group: each
  rank receives the global rows it asks for, rows outside the level
  filled with a pad value (0 for convolutions, -inf for max-pools), and
  its backward returns each fetched row's gradient to the rank that owns
  the row, which adds it there.

A spatial op then gathers the input rows its output band needs and runs
VALID along the rows: :func:`pad` replaces ``F.pad`` ahead of a conv or a
pool, :func:`upsample2x` re-bands a 2x upsample onto the finer level's
band (with uneven bands the upsampled band is not the finer band), and
``models/layers.py`` ``batch_norm`` all-reduces the sums and counts of
``x`` and ``x^2`` (:func:`global_moments`), so its moments are the whole
global batch's at the whole canvas.

The ops find the global row count of a band in the active
:class:`Partition` (:func:`partitioned`), a table from this rank's band
height to the level's row count that starts at the canvas and grows as
ops produce new levels.  Two levels whose bands have the same height on
some rank cannot be told apart, and such a canvas raises with the shapes,
as does a level with fewer rows than ``sp``.  The partition is
thread-local; ``models/layers.py`` ``recompute_contexts`` carries it into
a checkpointed forward's recompute, which the autograd engine may run on
its own thread.

The exchange is one ``all_gather`` over the space group per call (gloo
on CPU tensors, NCCL on CUDA tensors; gloo's CUDA tensors are staged
through the host here).  Every rank computes every rank's request from the
band map, so no request is ever sent, and a call whose requests all lie
in the requesting rank's own band exchanges nothing.  :data:`STATS`
counts the exchanges and their bytes, forward and backward, and with
``STATS.timing`` on also the seconds spent in them (the device is
synchronised before and after each, so that its compute is not counted):
``chip_smoke.py`` phase 12 reads the exchanges' share of a step from it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

_LOCAL = threading.local()


def band(rows: int, sp: int, index: int) -> Tuple[int, int]:
    """Rank ``index``'s global row range ``[lo, hi)`` of a level of
    ``rows`` rows split over ``sp`` ranks: as even as possible, the first
    ``rows % sp`` ranks one row longer."""
    base, extra = divmod(rows, sp)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def bands(rows: int, sp: int) -> List[Tuple[int, int]]:
    return [band(rows, sp, r) for r in range(sp)]


@dataclasses.dataclass(frozen=True)
class SpaceGroup:
    """The ``size`` ranks that hold the same images, this process at
    ``index``; ``group`` is their process group (``None``: the default
    group, or no group at all when ``size`` is 1)."""

    size: int
    index: int
    group: Any = None


class ExchangeStats:
    """Row exchanges by direction (``'forward'``, ``'backward'``): calls,
    bytes this rank sent, and, while ``timing`` is on, seconds."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self):
        self.calls = {'forward': 0, 'backward': 0}
        self.bytes = {'forward': 0, 'backward': 0}
        self.seconds = {'forward': 0.0, 'backward': 0.0}


STATS = ExchangeStats()


def _backend(group) -> str:
    return dist.get_backend(group) if dist.is_initialized() else 'none'


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_gather(buf: torch.Tensor, space: SpaceGroup,
               direction: str = 'forward') -> List[torch.Tensor]:
    """``buf`` of every rank of the space group, in rank order (one
    collective; the shapes must agree).  A collective that fails raises."""
    buf = buf.contiguous()
    if STATS.timing:
        _sync(buf)
        t0 = time.perf_counter()
    staged = buf.is_cuda and _backend(space.group) == 'gloo'
    send = buf.cpu() if staged else buf
    outs = [torch.empty_like(send) for _ in range(space.size)]
    dist.all_gather(outs, send, group=space.group)
    if staged:
        outs = [o.to(buf.device) for o in outs]
    STATS.calls[direction] += 1
    STATS.bytes[direction] += buf.numel() * buf.element_size()
    if STATS.timing:
        _sync(buf)
        STATS.seconds[direction] += time.perf_counter() - t0
    return outs


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else (lo, lo)


class _Plan:
    """Who sends which rows to whom, the same on every rank: ``piece[r][q]``
    is the global row range rank ``q`` fetches from rank ``r``'s band."""

    def __init__(self, rows: int, sp: int, lo: Sequence[int],
                 hi: Sequence[int]):
        self.rows, self.sp = rows, sp
        self.bands = bands(rows, sp)
        self.req = list(zip(lo, hi))
        self.piece = [[_overlap(self.bands[r], self.req[q]) if q != r
                       else (0, 0) for q in range(sp)] for r in range(sp)]

    def size(self, span: Tuple[int, int]) -> int:
        return span[1] - span[0]

    def sent(self, r: int) -> int:
        """Rows rank ``r`` contributes in the forward exchange."""
        return sum(self.size(p) for p in self.piece[r])

    def returned(self, q: int) -> int:
        """Rows of gradient rank ``q`` sends back in the backward."""
        return sum(self.size(self.piece[r][q]) for r in range(self.sp))


def _rows(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    return x.narrow(dim, lo, hi - lo)


def _packed(x: torch.Tensor, dim: int, spans, length: int) -> torch.Tensor:
    """The rows ``spans`` (local ranges) of ``x`` one after the other
    along ``dim``, grown with zero rows to ``length``."""
    parts = [_rows(x, dim, lo, hi) for lo, hi in spans if hi > lo]
    used = sum(hi - lo for lo, hi in spans if hi > lo)
    if length > used:
        shape = list(x.shape)
        shape[dim] = length - used
        parts.append(x.new_zeros(shape))
    return torch.cat(parts, dim)


def _fill(x: torch.Tensor, dim: int, n: int, value: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_full(shape, value)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, space, plan, dim, pad_value):
        me, sp = space.index, space.size
        ctx.space, ctx.plan, ctx.dim = space, plan, dim
        ctx.band_rows = x.shape[dim]
        b_lo, _ = plan.bands[me]
        width = max(plan.sent(r) for r in range(sp))
        recv = None
        if width:
            recv = all_gather(_packed(x, dim, [
                (p[0] - b_lo, p[1] - b_lo) for p in plan.piece[me]], width),
                space)
        lo, hi = plan.req[me]
        segs = []
        if lo < 0:
            segs.append(_fill(x, dim, min(hi, 0) - lo, pad_value))
        for r, (r_lo, r_hi) in enumerate(plan.bands):
            s_lo, s_hi = _overlap((r_lo, r_hi), (lo, hi))
            if s_lo == s_hi:
                continue
            if r == me:
                segs.append(_rows(x, dim, s_lo - r_lo, s_hi - r_lo))
            else:
                off = sum(plan.size(p) for p in plan.piece[r][:me])
                segs.append(_rows(recv[r], dim, off, off + s_hi - s_lo))
        if hi > plan.rows:
            segs.append(_fill(x, dim, hi - max(lo, plan.rows), pad_value))
        return torch.cat(segs, dim) if len(segs) > 1 else segs[0].clone()

    @staticmethod
    def backward(ctx, g):
        space, plan, dim = ctx.space, ctx.plan, ctx.dim
        me, sp = space.index, space.size
        lo, _ = plan.req[me]
        b_lo, b_hi = plan.bands[me]
        width = max(plan.returned(q) for q in range(sp))
        recv = None
        if width:
            recv = all_gather(_packed(g, dim, [
                (plan.piece[r][me][0] - lo, plan.piece[r][me][1] - lo)
                for r in range(sp)], width), space, 'backward')
        shape = list(g.shape)
        shape[dim] = ctx.band_rows
        grad = g.new_zeros(shape)
        # every rank's gradient of this band's rows, added in rank order
        for q in range(sp):
            if q == me:
                p_lo, p_hi = _overlap((b_lo, b_hi), plan.req[me])
                src, off = g, p_lo - lo
            else:
                p_lo, p_hi = plan.piece[me][q]
                src = recv[q] if recv is not None else None
                off = sum(plan.size(plan.piece[r][q]) for r in range(me))
            if p_lo < p_hi:
                _rows(grad, dim, p_lo - b_lo, p_hi - b_lo).add_(
                    _rows(src, dim, off, off + p_hi - p_lo))
        return grad, None, None, None, None


def gather_rows(x_band: torch.Tensor, level_rows: int, lo: Sequence[int],
                hi: Sequence[int], pad_value: float = 0.0, dim: int = 2,
                space: Optional[SpaceGroup] = None) -> torch.Tensor:
    """Global rows ``[lo[me], hi[me])`` of a tensor of ``level_rows`` rows
    along ``dim``, banded over the space group (this rank holds
    ``x_band``, its :func:`band`).  ``lo`` and ``hi`` hold every rank's
    request, the same lists on every rank.  Rows outside ``[0,
    level_rows)`` are ``pad_value``; rows of other ranks are fetched, as
    many as asked.  The backward adds each row's gradient into the band of
    the rank that owns it.  ``space`` defaults to the active partition's."""
    space = space if space is not None else current().space
    plan = _Plan(level_rows, space.size, lo, hi)
    want = plan.bands[space.index][1] - plan.bands[space.index][0]
    if x_band.shape[dim] != want:
        raise ValueError(f'a band of {x_band.shape[dim]} rows along dim '
                         f'{dim}; rank {space.index} of {space.size} holds '
                         f'{want} of a level of {level_rows} rows')
    return _GatherRows.apply(x_band, space, plan, dim, float(pad_value))


class Partition:
    """The active spatial partition of one forward: the space group and
    the table of levels (this rank's band height -> the level's global
    rows), started at the canvas."""

    def __init__(self, space: SpaceGroup, rows: int):
        self.space = space
        self.canvas = rows
        self._levels: Dict[int, int] = {}
        self._heights: Dict[int, Tuple[int, ...]] = {}
        self.add(rows)

    def band(self, rows: int) -> Tuple[int, int]:
        return band(rows, self.space.size, self.space.index)

    def add(self, rows: int) -> int:
        """Register a level of ``rows`` rows (idempotent); raises if a rank
        would hold an empty band or two levels would share a band height
        on some rank.  Every rank checks every rank, so all raise alike."""
        if rows in self._heights:
            return rows
        sp = self.space.size
        heights = tuple(hi - lo for lo, hi in bands(rows, sp))
        if min(heights) < 1:
            raise ValueError(
                f'a level of {rows} rows (canvas {self.canvas}) cannot be '
                f'banded over spatial_partition={sp} ranks: each rank needs '
                f'at least one row')
        for other, oh in self._heights.items():
            for r in range(sp):
                if oh[r] == heights[r]:
                    raise ValueError(
                        f'canvas {self.canvas} over spatial_partition={sp}: '
                        f'levels of {other} and {rows} rows both give rank '
                        f'{r} a band of {heights[r]} rows, which the port '
                        f'cannot tell apart; choose another canvas or sp')
        self._heights[rows] = heights
        self._levels[heights[self.space.index]] = rows
        return rows

    def rows(self, x: torch.Tensor, dim: int = 2) -> int:
        """The global row count of the band ``x``."""
        h = x.shape[dim]
        if h not in self._levels:
            raise ValueError(
                f'a band of {h} rows matches no level of canvas '
                f'{self.canvas} on rank {self.space.index} of '
                f'{self.space.size} (known: {sorted(self._heights)})')
        return self._levels[h]


def current() -> Optional[Partition]:
    """The active :class:`Partition` of this thread, else ``None``."""
    return getattr(_LOCAL, 'part', None)


@contextlib.contextmanager
def active(part: Optional[Partition]):
    """Make ``part`` (may be ``None``) the active partition."""
    before = current()
    _LOCAL.part = part
    try:
        yield part
    finally:
        _LOCAL.part = before


def partitioned(space: Optional[SpaceGroup], rows: int):
    """A fresh :class:`Partition` of ``space`` over a canvas of ``rows``
    rows, made active; a no-op context when ``space`` is ``None`` or holds
    one rank."""
    if space is None or space.size <= 1:
        return contextlib.nullcontext()
    return active(Partition(space, rows))


def band_of(x: torch.Tensor, space: Optional[SpaceGroup],
            dim: int = 1) -> torch.Tensor:
    """This rank's band along ``dim`` of ``x`` (the whole canvas)."""
    if space is None or space.size <= 1:
        return x
    lo, hi = band(x.shape[dim], space.size, space.index)
    return _rows(x, dim, lo, hi)


def rows_of(x: torch.Tensor, dim: int = 2) -> int:
    """Global rows of ``x``: its own under no partition."""
    part = current()
    return x.shape[dim] if part is None else part.rows(x, dim)


def _gather_spans(part: Partition, x: torch.Tensor, rows: int,
                  spans: Sequence[Tuple[int, int]], value: float,
                  dim: int = 2) -> torch.Tensor:
    """Each rank's span of global rows; ``x`` itself when every span is
    its rank's own band."""
    if list(spans) == bands(rows, part.space.size):
        return x
    return gather_rows(x, rows, [s[0] for s in spans], [s[1] for s in spans],
                       value, dim, part.space)


def pad(x: torch.Tensor, pads: Sequence[int], kernel: int, stride: int,
        value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, pads, value=value)`` of an NCHW ``x`` ahead of an op
    that runs VALID with ``kernel`` and ``stride`` along the rows.  Under
    a partition the columns are padded and the rows are the input rows
    this rank's output band needs, the level's top and bottom pads
    included (``value`` outside the level)."""
    part = current()
    if part is None:
        return F.pad(x, tuple(pads), value=value)
    left, right, top, bottom = pads
    rows = part.rows(x)
    out_rows = part.add((rows + top + bottom - kernel) // stride + 1)
    spans = [(lo * stride - top, (hi - 1) * stride - top + kernel)
             for lo, hi in bands(out_rows, part.space.size)]
    y = _gather_spans(part, x, rows, spans, value)
    if left or right:
        y = F.pad(y, (left, right, 0, 0), value=value)
    return y


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of a band of NCHW ``x`` onto this rank's band
    of the level twice as tall: the coarse rows that band needs are
    gathered, upsampled, and trimmed to the band."""
    part = current()
    rows = part.rows(x)
    fine = part.add(2 * rows)
    fb = bands(fine, part.space.size)
    y = _gather_spans(part, x, rows, [(lo // 2, (hi + 1) // 2)
                                      for lo, hi in fb], 0.0)
    y = F.interpolate(y, scale_factor=2, mode='nearest')
    lo, hi = fb[part.space.index]
    return _rows(y, 2, lo - 2 * (lo // 2), lo - 2 * (lo // 2) + hi - lo)


def halo_rows(x: torch.Tensor, rows: int, halo: int, value: float = 0.0,
              dim: int = 1) -> torch.Tensor:
    """This rank's band of a level of ``rows`` rows grown by ``halo`` rows
    above and below (``value`` outside the level), along ``dim``."""
    part = current()
    spans = [(lo - halo, hi + halo)
             for lo, hi in bands(rows, part.space.size)]
    return _gather_spans(part, x, rows, spans, value, dim)


def gather_level(x: torch.Tensor, rows: int, dim: int = 1) -> torch.Tensor:
    """The whole level (``rows`` rows along ``dim``) on every rank of the
    space group, from the bands."""
    part = current()
    sp = part.space.size
    return gather_rows(x, rows, [0] * sp, [rows] * sp, 0.0, dim, part.space)


def global_moments(y: torch.Tensor):
    """Per-channel ``(E[y], E[y^2])`` of a band of an NCHW ``y`` over the
    batch, rows and columns of every rank: the sums all-reduced over the
    world (autograd aware) and divided by the global element count, so
    uneven bands weigh by their size."""
    from torch.distributed.nn.functional import all_reduce
    part = current()
    c = y.shape[1]
    dp = dist.get_world_size() // part.space.size
    count = float(y.shape[0] * dp * part.rows(y) * y.shape[3])
    tot = all_reduce(torch.cat([y.sum((0, 2, 3)), y.square().sum((0, 2, 3))]))
    return tot[:c] / count, tot[c:] / count
