"""JPEG decode (nvJPEG) and the three kernels of ``csrc/jpeg.cu``, beside
their plain PyTorch versions.

Counterpart of the decode and letterbox contract of
``native/fastloader.cpp``, the JAX package's host loader:

* **Decode.**  nvJPEG decodes the entropy-coded data and the IDCT to the
  file's YCbCr planes; :func:`ycc_to_rgb` upsamples the chroma and
  converts to RGB as libjpeg does (its fancy upsampling and fixed-point
  tables).  libjpeg scales in the DCT domain by the largest ``d`` in
  {8, 4, 2} with ``full_w // d >= tw`` and ``full_h // d >= th``
  (:func:`divisor`).  nvJPEG decodes at full size (its scaled decode needs
  the hardware backend, which the H100's driver does not offer), and the
  kernels take the rounded mean of each ``d x d`` block first, edge blocks
  cut at the image (:func:`reduce_plain`): ``ceil(w / d)`` samples, as
  libjpeg gives.
* **Geometry.**  ``scale = min(tw / full_w, th / full_h)`` in double,
  ``nw``, ``nh`` rounded half to even, ``pad = (t - n) // 2``; the metas
  are ``(scale, pad_x, pad_y, full_w, full_h)`` (:func:`geometry`).
* **Resize.**  Separable bilinear with half-pixel centres clamped to the
  source, ``int`` taps, ``u8(top + (bot - top) * wy + 0.5)``, onto a canvas
  filled with 128 (``bilinear_into``, ``native/fastloader.cpp:107-146``).
* **4:2:0.**  Y per pixel, Cb and Cr from the mean of each 2 x 2 block of
  the u8 canvas, in fastloader's order of float operations
  (``rgb_to_yuv420``, ``native/fastloader.cpp:209-238``).

``ycc_to_rgb_batch`` (libjpeg's chroma upsampling and YCbCr -> RGB after
nvJPEG's IDCT, for a batch of images of any sizes and layouts, gray ones
included; :func:`ycc_to_rgb` is its one-image case), ``letterbox_rgb``
and ``letterbox_yuv420`` take one launch a batch.  They run their plain
versions on CPU tensors and launch their kernel on CUDA ones, counted in
``<wrapper>.launches``, or raise; they never fall back.  The plain
versions repeat the kernels' integer and float32 operations one by one, so
the two agree bit for bit.

:func:`decoder` hands out nvJPEG contexts (handle and decode state), one
per device and concurrent caller, behind a lock; nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import kernel_build

_SOURCE = 'jpeg.cu'
_PARAMS = 9           # int64 per image in the letterbox kernels' table
_YCC_PARAMS = 14      # int64 per image in ycc_to_rgb_kernel's table
LETTERBOX_BAND = 8    # canvas rows a letterbox block writes
GRAY = 128

# nvjpegStatus_t
STATUS_NAMES = {
    0: 'SUCCESS', 1: 'NOT_INITIALIZED', 2: 'INVALID_PARAMETER',
    3: 'BAD_JPEG', 4: 'JPEG_NOT_SUPPORTED', 5: 'ALLOCATOR_FAILURE',
    6: 'EXECUTION_FAILED', 7: 'ARCH_MISMATCH', 8: 'INTERNAL_ERROR',
    9: 'IMPLEMENTATION_NOT_SUPPORTED', 10: 'INCOMPLETE_BITSTREAM'}
# statuses that say the library or the card failed, not the file: raised
_FATAL = (1, 5, 6, 7)
# nvjpegBackend_t
BACKENDS = {'DEFAULT': 0, 'HYBRID': 1, 'GPU_HYBRID': 2, 'HARDWARE': 3}
# nvjpegChromaSubsampling_t
SUBSAMPLING = {0: '444', 1: '422', 2: '420', 3: '440', 4: '411', 5: '410',
               6: 'gray', 7: '410V', -1: 'unknown'}
# chroma subsampling (horizontal, vertical) of the layouts that
# ycc_to_rgb upsamples as libjpeg does; a file in another layout (4:1:1,
# 4:1:0) is rejected
FACTORS = {'444': (1, 1), '422': (2, 1), '420': (2, 2), '440': (1, 2)}
Y, YUV = 0, 1     # mgd_jpeg_decode's output formats


def status_name(status: int) -> str:
    if status >= 100:
        return f'CUDA error {status - 100}'
    return STATUS_NAMES.get(status, f'status {status}')


# ---------------------------------------------------------------------------
# geometry (fastloader's, host side)
# ---------------------------------------------------------------------------

def divisor(full_w: int, full_h: int, hw: Tuple[int, int]) -> int:
    """libjpeg's ``scale_denom`` in fastloader: the largest of 8, 4, 2 whose
    output still covers the canvas, else 1."""
    th, tw = hw
    for d in (8, 4, 2):
        if full_w // d >= tw and full_h // d >= th:
            return d
    return 1


def geometry(full_w: int, full_h: int, hw: Tuple[int, int]
             ) -> Tuple[float, int, int, int, int]:
    """``(scale, nw, nh, pad_x, pad_y)`` of an image letterboxed onto
    ``hw``: ``scale`` in double, the content size rounded half to even (as
    ``std::nearbyint``), the content centred."""
    th, tw = hw
    scale = min(tw / full_w, th / full_h)
    nw, nh = round(full_w * scale), round(full_h * scale)
    return scale, nw, nh, (tw - nw) // 2, (th - nh) // 2


def metas_of(full_w: int, full_h: int, hw: Tuple[int, int]) -> np.ndarray:
    """fastloader's metas ``(scale, pad_x, pad_y, full_w, full_h)`` f32."""
    scale, _, _, px, py = geometry(full_w, full_h, hw)
    return np.asarray([scale, px, py, full_w, full_h], np.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _rgb(image: torch.Tensor) -> torch.Tensor:
    """``[H, W]``, ``[H, W, 1]`` or ``[H, W, 3]`` u8 -> ``[H, W, 3]``."""
    if image.dim() == 2:
        image = image[..., None]
    if image.shape[-1] == 1:
        image = image.expand(*image.shape[:2], 3)
    if image.dim() != 3 or image.shape[-1] != 3 or image.dtype != torch.uint8:
        raise ValueError(f'expected a u8 [H, W, 3] image, got '
                         f'{tuple(image.shape)} {image.dtype}')
    return image


def block_mean_plain(plane: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """The rounded mean of each ``bh x bw`` block of ``plane [H, W, ...]``
    u8, edge blocks cut at the plane: ``[ceil(H/bh), ceil(W/bw), ...]``."""
    if bh == bw == 1:
        return plane
    h, w = plane.shape[:2]
    rest = plane.shape[2:]
    sh, sw = -(-h // bh), -(-w // bw)
    total = torch.zeros(sh * bh, sw * bw, *rest, dtype=torch.int32)
    total[:h, :w] = plane.to(torch.int32)
    count = torch.zeros(sh * bh, sw * bw, dtype=torch.int32)
    count[:h, :w] = 1
    total = total.view(sh, bh, sw, bw, *rest).sum((1, 3))
    count = count.view(sh, bh, sw, bw).sum((1, 3)).view(
        sh, sw, *(1 for _ in rest))
    return torch.div(total + count // 2, count,
                     rounding_mode='floor').to(torch.uint8)


def _taps(n: int, s: int):
    """Per output index of ``n`` over ``s`` source samples: (i0, i1, frac),
    half-pixel centres clamped to the source, in float32."""
    scale = (torch.tensor(float(s), dtype=torch.float32)
             / torch.tensor(float(n), dtype=torch.float32))
    f = (torch.arange(n, dtype=torch.float32) + 0.5) * scale - 0.5
    f = torch.clamp(f, 0.0, float(s - 1))
    i0 = f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=s - 1)
    return i0, i1, f - i0.to(torch.float32)


def _bilinear(src: torch.Tensor, nw: int, nh: int) -> torch.Tensor:
    """fastloader's ``bilinear_into`` of ``src [h, w, 3]`` u8 to
    ``[nh, nw, 3]`` u8."""
    sh, sw = src.shape[:2]
    x0, x1, wx = _taps(nw, sw)
    y0, y1, wy = _taps(nh, sh)
    s = src.to(torch.int32)
    r0, r1 = s[y0], s[y1]
    a, b, c, e = r0[:, x0], r0[:, x1], r1[:, x0], r1[:, x1]
    wx, wy = wx[None, :, None], wy[:, None, None]
    top = a.to(torch.float32) + (b - a).to(torch.float32) * wx
    bot = c.to(torch.float32) + (e - c).to(torch.float32) * wx
    return (top + (bot - top) * wy + 0.5).to(torch.uint8)


def letterbox_rgb_plain(image: torch.Tensor, hw: Tuple[int, int],
                        full_size: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """Plain version of the RGB letterbox kernel for one image.

    ``image`` holds decoded pixels ``[H, W, 3]`` (or gray ``[H, W]``) u8 on
    the CPU.
    ``full_size`` is the file's ``(width, height)`` for the geometry: the
    image's own size by default, or the full size of pixels that a decoder
    already scaled (libjpeg's ``scale_denom``, PIL's ``draft``).  Returns
    the ``[th, tw, 3]`` u8 canvas."""
    image = _rgb(image)
    h, w = image.shape[:2]
    fw, fh = full_size or (w, h)
    _, nw, nh, px, py = geometry(fw, fh, hw)
    canvas = torch.full((*hw, 3), GRAY, dtype=torch.uint8)
    if nw > 0 and nh > 0:
        canvas[py:py + nh, px:px + nw] = _bilinear(image, nw, nh)
    return canvas


def rgb_to_yuv420_plain(canvas: torch.Tensor):
    """fastloader's ``rgb_to_yuv420`` of ``[..., H, W, 3]`` u8 (H, W even):
    Y per pixel, Cb and Cr from the 2 x 2 mean of the u8 RGB, in its order
    of float32 operations."""
    f = canvas.to(torch.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = torch.clamp(0.299 * r + 0.587 * g + 0.114 * b + 0.5, 0.0, 255.0)
    h, w = canvas.shape[-3:-1]
    q = canvas.to(torch.int32).reshape(*canvas.shape[:-3], h // 2, 2,
                                       w // 2, 2, 3).sum((-4, -2))
    q = 0.25 * q.to(torch.float32)
    rq, gq, bq = q[..., 0], q[..., 1], q[..., 2]
    cb = 128.0 - 0.168736 * rq - 0.331264 * gq + 0.5 * bq + 0.5
    cr = 128.0 + 0.5 * rq - 0.418688 * gq - 0.081312 * bq + 0.5
    return tuple(torch.clamp(p, 0.0, 255.0).to(torch.uint8)
                 for p in (y, cb, cr))


def letterbox_yuv420_plain(image: torch.Tensor, hw: Tuple[int, int],
                           full_size: Optional[Tuple[int, int]] = None):
    """Plain version of the 4:2:0 letterbox kernel for one image:
    :func:`letterbox_rgb_plain`, then :func:`rgb_to_yuv420_plain`.  Returns
    ``(y [th, tw], cb, cr [th/2, tw/2])`` u8."""
    return rgb_to_yuv420_plain(letterbox_rgb_plain(image, hw, full_size))


def scaled_chroma(hs: int, vs: int, d: int) -> Tuple[int, int, int, bool]:
    """How libjpeg decodes the chroma of a file subsampled by (hs, vs) at
    divisor ``d`` (``jdmaster.c``): it enlarges the chroma's IDCT from the
    luma's (``8 / d``) while that still leaves whole upsampling factors,
    so the plane comes reduced by ``r`` and is then upsampled by
    ``(uh, uv)``, with the fancy filters unless ``d`` = 8.  Returns
    ``(r, uh, uv, fancy)``."""
    m = 8 // d
    size = m
    while size < 8 and (hs * m) % (2 * size) == 0 \
            and (vs * m) % (2 * size) == 0:
        size *= 2
    return 8 // size, hs * m // size, vs * m // size, m > 1


def _upsample_plain(p: torch.Tensor, hs: int, vs: int, h: int,
                    w: int, fancy: bool = True) -> torch.Tensor:
    """libjpeg-turbo's upsampling (``jdsample.c``) of a chroma plane
    ``[ch, cw]`` by (hs, vs) to ``[h, w]`` int64: with ``fancy`` the h2v2,
    h2v1 and h1v2 triangles, the row outside the plane being its nearest
    row, and a plane two samples wide or less replicated (libjpeg's box
    upsampling for h2v1 and h2v2); without, replication."""
    p = p.to(torch.int64)
    ch, cw = p.shape
    ys, xs = torch.arange(h), torch.arange(w)
    if not fancy:
        return p[ys // vs][:, xs // hs]
    j = xs // 2
    even = (xs % 2 == 0)[None, :]
    if vs == 2:
        r = ys // 2
        far = torch.where(ys % 2 == 0, r - 1, r + 1).clamp(0, ch - 1)
        near, fr = p[r], p[far]
        if hs == 1:
            bias = torch.where(ys % 2 == 0, 1, 2)[:, None]
            return (3 * near + fr + bias) >> 2
        if cw <= 2:
            return near[:, j]
        t = 3 * near + fr
        this = t[:, j]
        prev = t[:, (j - 1).clamp(min=0)]
        nxt = t[:, (j + 1).clamp(max=cw - 1)]
        ev = torch.where((j == 0)[None, :], this * 4 + 8, this * 3 + prev + 8)
        od = torch.where((j == cw - 1)[None, :], this * 4 + 7,
                         this * 3 + nxt + 7)
        return torch.where(even, ev, od) >> 4
    if hs == 1:
        return p[:h, :w]
    if cw <= 2:
        return p[:, j]
    this = p[:, j]
    prev = p[:, (j - 1).clamp(min=0)]
    nxt = p[:, (j + 1).clamp(max=cw - 1)]
    ev = torch.where((j == 0)[None, :], this, (3 * this + prev + 1) >> 2)
    od = torch.where((j == cw - 1)[None, :], this, (3 * this + nxt + 2) >> 2)
    return torch.where(even, ev, od)


def ycc_to_rgb_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                     factors: Tuple[int, int], d: int = 1) -> torch.Tensor:
    """Plain version of ``ycc_to_rgb_kernel``: planar YCbCr u8 (``y [h,
    w]``, ``cb``/``cr [ch, cw]`` subsampled by ``factors`` = (horizontal,
    vertical)) -> ``[ceil(h/d), ceil(w/d), 3]`` RGB u8, with libjpeg's
    fixed-point YCbCr -> RGB tables (``jdcolor.c``).  The d x d block mean
    of luma stands in for libjpeg's DCT-domain scaling; the chroma is
    reduced by the r x r block mean of :func:`scaled_chroma` and upsampled
    as libjpeg does at that scale (at ``d`` = 1: not reduced, upsampled by
    the fancy filters)."""
    hs, vs = factors
    r, uh, uv, fancy = scaled_chroma(hs, vs, d)
    l = block_mean_plain(y, d, d).to(torch.int64)
    oh, ow = l.shape
    xb, xr = (_upsample_plain(block_mean_plain(p, r, r), uh, uv, oh, ow,
                              fancy) - 128 for p in (cb, cr))
    r = l + ((91881 * xr + 32768) >> 16)
    g = l + (((-22554 * xb + 32768) + (-46802 * xr)) >> 16)
    b = l + ((116130 * xb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def _ycc_slot(planes: Sequence[torch.Tensor], factors, d: int):
    """Check one slot of :func:`ycc_to_rgb_batch`; returns its output shape
    ``(ceil(h/d), ceil(w/d), channels)``."""
    if d not in (1, 2, 4, 8):
        raise ValueError(f'divisor must be 1, 2, 4 or 8, got {d}')
    y = planes[0]
    if y.dim() != 2:
        raise ValueError(f'luma must be [h, w], got {tuple(y.shape)}')
    h, w = y.shape
    shape = (-(-h // d), -(-w // d), 1 if factors is None else 3)
    if factors is None:
        if len(planes) != 1:
            raise ValueError('a gray slot has its luma plane alone')
        return shape
    hs, vs = factors
    cb, cr = planes[1:]
    ch, cw = cb.shape
    if (hs, vs) not in FACTORS.values() or tuple(cr.shape) != (ch, cw) \
            or cw != -(-w // hs) or ch != -(-h // vs):
        raise ValueError(f'planes {tuple(y.shape)}, {tuple(cb.shape)}, '
                         f'{tuple(cr.shape)} do not match subsampling '
                         f'{factors}')
    return shape


def ycc_to_rgb_batch_plain(slots) -> List[torch.Tensor]:
    """Plain version of :func:`ycc_to_rgb_batch`: each slot by
    :func:`ycc_to_rgb_plain`, a gray one by the d x d block mean of its
    luma (``[ceil(h/d), ceil(w/d), 1]``)."""
    return [block_mean_plain(planes[0], d, d)[..., None] if factors is None
            else ycc_to_rgb_plain(*planes, factors, d)
            for planes, factors, d in slots]


def _packed(shapes, device) -> List[torch.Tensor]:
    """Views of one u8 buffer on ``device``, one per shape, each starting
    at a 16-byte boundary."""
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = np.cumsum([0] + [-(-n // 16) * 16 for n in sizes])
    buf = torch.empty(max(int(offsets[-1]), 1), dtype=torch.uint8,
                      device=device)
    return [buf[int(o):int(o) + n].view(s)
            for o, n, s in zip(offsets, sizes, shapes)]


def _ycc_rows(slots, outs) -> np.ndarray:
    """``ycc_to_rgb_kernel``'s table: per slot its planes' and output's
    pointers, sizes, divisor and :func:`scaled_chroma`'s chroma scale."""
    rows = np.zeros((len(slots), _YCC_PARAMS), np.int64)
    for i, ((planes, factors, d), out) in enumerate(zip(slots, outs)):
        h, w = planes[0].shape
        if factors is None:
            rows[i] = (planes[0].data_ptr(), 0, 0, out.data_ptr(), w, h, 0,
                       0, d, 1, 1, 1, 0, 1)
            continue
        ch, cw = planes[1].shape
        r, uh, uv, fancy = scaled_chroma(*factors, d)
        rows[i] = (planes[0].data_ptr(), planes[1].data_ptr(),
                   planes[2].data_ptr(), out.data_ptr(), w, h, cw, ch, d, r,
                   uh, uv, int(fancy), 3)
    return rows


def ycc_to_rgb_batch(slots) -> List[torch.Tensor]:
    """Planar YCbCr -> interleaved RGB as libjpeg decodes it, for a batch.

    ``slots`` holds ``(planes, factors, d)`` per image: ``planes`` ``(y,
    cb, cr)`` u8 (``y [h, w]``, ``cb``/``cr`` subsampled by ``factors`` =
    (horizontal, vertical)), or ``(y,)`` with ``factors`` None for a gray
    image; ``d`` the divisor in {1, 2, 4, 8} (see :func:`ycc_to_rgb_plain`).
    Returns per slot ``[ceil(h/d), ceil(w/d), 3]`` RGB (gray: ``..., 1]``,
    its luma reduced by d) u8, views of one buffer: the plain version for
    CPU tensors, one kernel launch for CUDA ones."""
    shapes = [_ycc_slot(*slot) for slot in slots]
    if not slots:
        return []
    device = slots[0][0][0].device
    if device.type == 'cpu':
        outs = _packed(shapes, device)
        for out, got in zip(outs, ycc_to_rgb_batch_plain(slots)):
            out.copy_(got)
        return outs
    for planes, _, _ in slots:
        for t in planes:
            if t.device != device or t.dtype != torch.uint8 \
                    or not t.is_contiguous():
                raise ValueError(f'planes must be contiguous u8 on '
                                 f'{device}')
    outs = _packed(shapes, device)
    rows = _ycc_rows(slots, outs)
    table = torch.from_numpy(rows).pin_memory().to(device, non_blocking=True)
    err = _library().mgd_ycc_to_rgb(
        _index(device), table.data_ptr(), len(slots),
        max(s[1] for s in shapes), max(s[0] for s in shapes),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, 'ycc_to_rgb')
    ycc_to_rgb_batch.launches += 1
    return outs


ycc_to_rgb_batch.launches = 0


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               factors: Tuple[int, int], d: int = 1) -> torch.Tensor:
    """Planar YCbCr -> interleaved RGB as libjpeg decodes it, reduced by
    ``d`` (see :func:`ycc_to_rgb_plain`): :func:`ycc_to_rgb_batch` for
    one image."""
    return ycc_to_rgb_batch([((y, cb, cr), factors, d)])[0]


# ---------------------------------------------------------------------------
# the batched wrappers
# ---------------------------------------------------------------------------

def _check_hw(hw, even: bool) -> Tuple[int, int]:
    th, tw = (int(v) for v in hw)
    if th <= 0 or tw <= 0:
        raise ValueError(f'canvas must be positive, got {th}x{tw}')
    if even and (th % 2 or tw % 2):
        raise ValueError(f'canvas must be even for 4:2:0, got {th}x{tw}')
    return th, tw


def _batch_metas(sources, hw, full_sizes):
    """Per slot: the metas (zeros for a missing source, as fastloader
    leaves them), ok, and the kernel's table row without the pointer.  A
    source is its file reduced by the divisor for ``hw``
    (:func:`ycc_to_rgb_batch` reduces it), as fastloader's libjpeg
    decodes it."""
    n = len(sources)
    metas = np.zeros((n, 5), np.float32)
    ok = np.zeros((n,), bool)
    rows = np.zeros((n, _PARAMS), np.int64)
    for i, src in enumerate(sources):
        if src is None:
            continue
        h, w = src.shape[:2]
        fw, fh = full_sizes[i] if full_sizes else (w, h)
        d = divisor(fw, fh, hw)
        if (w, h) != (-(-fw // d), -(-fh // d)):
            raise ValueError(f'source {i} is {w}x{h}, not its file {fw}x{fh} '
                             f'reduced by {d} (ycc_to_rgb_batch reduces it)')
        c = 1 if src.dim() == 2 else src.shape[2]
        _, nw, nh, px, py = geometry(fw, fh, hw)
        metas[i] = metas_of(fw, fh, hw)
        ok[i] = True
        rows[i, 1:] = (w, h, c, nw, nh, px, py, 1)
    return metas, ok, rows


def _full(meta: np.ndarray) -> Tuple[int, int]:
    return int(meta[3]), int(meta[4])


def _stage_bytes(rows: np.ndarray, tw: int, yuv: bool) -> int:
    """Shared memory a letterbox block stages its source rows in: room for
    the most rows that a band of ``LETTERBOX_BAND`` canvas rows touches in
    any source of the batch, within the card's limit (a band that needs
    more reads its taps from device memory)."""
    lib = _library()
    room = lib.mgd_letterbox_smem_limit() - lib.mgd_letterbox_smem(
        int(yuv), LETTERBOX_BAND, tw, 0)
    if room < 0:
        raise ValueError(f'a canvas {tw} wide is too wide for the letterbox '
                         f'kernels')
    need = 0
    for _, w, h, c, _, nh, _, _, ok in rows.tolist():
        if ok and nh > 0:
            need = max(need, (-(-LETTERBOX_BAND * h // nh) + 3) * w * c + 32)
    return min(need, room)


def _table(sources, rows, device) -> torch.Tensor:
    for i, src in enumerate(sources):
        if src is None:
            continue
        if src.device != device or src.dtype != torch.uint8:
            raise ValueError(f'source {i} must be u8 on {device}, got '
                             f'{src.dtype} on {src.device}')
        if not src.is_contiguous():
            raise ValueError(f'source {i} must be contiguous')
        if src.dim() not in (2, 3) or (src.dim() == 3
                                       and src.shape[2] not in (1, 3)):
            raise ValueError(f'source {i} must be [H, W] or [H, W, 1|3], '
                             f'got {tuple(src.shape)}')
        rows[i, 0] = src.data_ptr()
    return torch.from_numpy(rows).pin_memory().to(device, non_blocking=True)


def letterbox_rgb(sources: Sequence[Optional[torch.Tensor]],
                  hw: Tuple[int, int], device,
                  full_sizes: Optional[Sequence] = None):
    """Letterbox a batch of decoded images onto ``hw`` in one launch.

    ``sources`` are decoded images (``[H, W, 3]`` RGB, or gray ``[H, W]`` /
    ``[H, W, 1]``) u8 on ``device``, or None for a slot that did not decode
    (a gray canvas), each its file reduced by the divisor for ``hw``
    (:func:`ycc_to_rgb_batch` gives it so); ``full_sizes`` their files'
    ``(width, height)`` (by default each source's own size).  Returns
    ``(canvas [N, th, tw, 3] u8 on device, metas [N, 5] f32 numpy, ok [N]
    bool numpy)``."""
    device = _device(device)
    th, tw = _check_hw(hw, even=False)
    metas, ok, rows = _batch_metas(sources, (th, tw), full_sizes)
    if device.type == 'cpu':
        out = torch.full((len(sources), th, tw, 3), GRAY, dtype=torch.uint8)
        for i, src in enumerate(sources):
            if src is not None:
                out[i] = letterbox_rgb_plain(src, (th, tw), _full(metas[i]))
        return out, metas, ok
    if device.type != 'cuda':
        raise ValueError(f'letterbox_rgb runs on the CPU or CUDA, got '
                         f'{device}')
    out = torch.empty((len(sources), th, tw, 3), dtype=torch.uint8,
                      device=device)
    if len(sources):
        table = _table(sources, rows, device)
        err = _library().mgd_letterbox_rgb(
            _index(device), table.data_ptr(), len(sources), th, tw,
            LETTERBOX_BAND, _stage_bytes(rows, tw, False), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        _raise_on(err, 'letterbox_rgb')
        letterbox_rgb.launches += 1
    return out, metas, ok


letterbox_rgb.launches = 0


def letterbox_yuv420(sources: Sequence[Optional[torch.Tensor]],
                     hw: Tuple[int, int], device,
                     full_sizes: Optional[Sequence] = None):
    """:func:`letterbox_rgb` fused with fastloader's 4:2:0 conversion, in
    one launch.  Returns ``(y [N, th, tw], cb [N, th/2, tw/2], cr, metas,
    ok)``; ``th`` and ``tw`` must be even."""
    device = _device(device)
    th, tw = _check_hw(hw, even=True)
    metas, ok, rows = _batch_metas(sources, (th, tw), full_sizes)
    n = len(sources)
    if device.type == 'cpu':
        planes = [torch.full((n, th, tw), GRAY, dtype=torch.uint8),
                  torch.full((n, th // 2, tw // 2), GRAY, dtype=torch.uint8),
                  torch.full((n, th // 2, tw // 2), GRAY, dtype=torch.uint8)]
        for i, src in enumerate(sources):
            if src is not None:
                for p, v in zip(planes, letterbox_yuv420_plain(
                        src, (th, tw), _full(metas[i]))):
                    p[i] = v
        return (*planes, metas, ok)
    if device.type != 'cuda':
        raise ValueError(f'letterbox_yuv420 runs on the CPU or CUDA, got '
                         f'{device}')
    y = torch.empty((n, th, tw), dtype=torch.uint8, device=device)
    cb = torch.empty((n, th // 2, tw // 2), dtype=torch.uint8, device=device)
    cr = torch.empty_like(cb)
    if n:
        table = _table(sources, rows, device)
        err = _library().mgd_letterbox_yuv420(
            _index(device), table.data_ptr(), n, th, tw, LETTERBOX_BAND,
            _stage_bytes(rows, tw, True), y.data_ptr(), cb.data_ptr(),
            cr.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        _raise_on(err, 'letterbox_yuv420')
        letterbox_yuv420.launches += 1
    return y, cb, cr, metas, ok


letterbox_yuv420.launches = 0


# ---------------------------------------------------------------------------
# nvJPEG
# ---------------------------------------------------------------------------

class Decoder:
    """One nvJPEG context (handle and decode state) on one device, with a
    CUDA stream of its own; use it from one thread at a time
    (:func:`decoder` hands them out).

    Decoded on the caller's stream while the card was busy with other
    work there (the evaluator's inference steps), images came out wrong:
    nvJPEG stages each file in the state's pinned buffer and copies it to
    the card on the stream it is given, so the copy queued behind that
    work while the next decode refilled the buffer.  So each decode runs
    on the decoder's own stream and waits for it (one image's IDCT, a
    fraction of a millisecond); its planes are allocated on that stream
    and handed to the caller's stream with ``record_stream``.  Decoders
    on several threads (``data/jpeg_cuda.py``'s pool) overlap their
    host-side Huffman decodes: the ctypes calls and the stream's
    synchronize release the GIL."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.lib = _library()
        ctx = ctypes.c_void_p()
        status = self.lib.mgd_jpeg_create(_index(device), ctypes.byref(ctx))
        if status:
            raise RuntimeError(f'nvJPEG context on {device}: '
                               f'{status_name(status)}')
        self._ctx = ctx

    def header(self, data: bytes):
        """``(width, height, components, subsampling, chroma width, chroma
        height)`` of a JPEG, or the nvJPEG status (an int) that rejected
        it."""
        vals = [ctypes.c_int() for _ in range(6)]
        status = self.lib.mgd_jpeg_info(self._ctx, data, len(data),
                                        *(ctypes.byref(v) for v in vals))
        if status:
            return status
        w, h, comps, css, cw, ch = (v.value for v in vals)
        return w, h, comps, SUBSAMPLING.get(css, 'unknown'), cw, ch

    def _decode(self, data: bytes, fmt: int, planes) -> int:
        ptrs = []
        for p in planes:
            ptrs += [p.data_ptr(), p.shape[1]]
        ptrs += [None, 0] * (3 - len(planes))
        status = self.lib.mgd_jpeg_decode(self._ctx, data, len(data), fmt,
                                          *ptrs, self.stream.cuda_stream)
        self.stream.synchronize()
        return status

    def _planes(self, stream, *shapes):
        """Planes allocated on the decoder's stream, handed to ``stream``
        (the caller's: captured on the calling thread, since a pool's
        worker has a current stream of its own)."""
        with torch.cuda.stream(self.stream):
            planes = [torch.empty(shape, dtype=torch.uint8,
                                  device=self.device) for shape in shapes]
        for p in planes:
            p.record_stream(stream)
        return planes

    def planes(self, data: bytes, stream=None):
        """Decode a JPEG at full size to its planes on the card, for
        ``stream`` (by default the current one).

        Returns ``(planes, factors, (width, height), None)``: ``planes``
        ``(y, cb, cr)`` u8 at their own resolution with their chroma
        ``factors`` (:data:`FACTORS`), or ``(y,)`` and None for a gray
        file; or ``(None, None, None, reason)`` for a file the decoder
        rejects (not a JPEG, corrupt, unsupported, neither one nor three
        components, a chroma layout other than 4:4:4, 4:2:2, 4:2:0 and
        4:4:0).  The decode is complete when this returns.  Raises when
        nvJPEG or the card fails."""
        if stream is None:
            stream = torch.cuda.current_stream(self.device)
        info = self.header(data)
        if isinstance(info, int):
            return None, None, None, self._rejected(info)
        w, h, comps, css, cw, ch = info
        if comps not in (1, 3) or w <= 0 or h <= 0:
            return None, None, None, f'{comps} components, {w}x{h}'
        if comps == 1:
            planes = self._planes(stream, (h, w))
            status = self._decode(data, Y, planes)
            if status:
                return None, None, None, self._rejected(status)
            return tuple(planes), None, (w, h), None
        if css not in FACTORS:
            return None, None, None, f'{css} chroma layout'
        hs, vs = FACTORS[css]
        if (cw, ch) != (-(-w // hs), -(-h // vs)):
            return (None, None, None,
                    f'{css} chroma planes {cw}x{ch} for {w}x{h}')
        planes = self._planes(stream, (h, w), (ch, cw), (ch, cw))
        status = self._decode(data, YUV, planes)
        if status:
            return None, None, None, self._rejected(status)
        return tuple(planes), (hs, vs), (w, h), None

    @staticmethod
    def _rejected(status: int) -> str:
        if status in _FATAL or status >= 100:
            raise RuntimeError(f'nvJPEG failed: {status_name(status)}')
        return status_name(status)

    def close(self):
        if self._ctx is not None:
            self.lib.mgd_jpeg_destroy(self._ctx)
            self._ctx = None


_free: Dict[torch.device, List[Decoder]] = {}
_free_lock = threading.Lock()


@contextlib.contextmanager
def decoder(device):
    """A :class:`Decoder` on ``device`` for the caller alone: taken from a
    free list (or created) and returned to it afterwards, so the trainer's
    producer thread and a loader's pool each decode on their own state."""
    device = _device(device)
    if device.type != 'cuda':
        raise ValueError(f'nvJPEG decodes on a CUDA device, got {device}')
    with _free_lock:
        pool = _free.setdefault(device, [])
        dec = pool.pop() if pool else None
    if dec is None:
        dec = Decoder(device)
    try:
        yield dec
    finally:
        with _free_lock:
            _free[device].append(dec)


def decoder_report(device) -> Dict[str, object]:
    """nvJPEG's version and which of its backends the card offers."""
    lib = _library()
    idx = _index(device)
    version = lib.mgd_jpeg_version()
    return {'nvjpeg': f'{version // 1000}.{version % 1000 // 10}.'
                      f'{version % 10}',
            'backend_used': 'DEFAULT (nvjpegDecode: Huffman on the host, '
                            'IDCT and colour conversion on the card)',
            'backends': {name: status_name(lib.mgd_jpeg_backend_status(idx,
                                                                      code))
                         for name, code in BACKENDS.items()}}


# ---------------------------------------------------------------------------
# binding
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    """``device`` resolved (raises for CUDA without a card), with its
    index: ``cuda`` is the current card."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def _index(device: torch.device) -> int:
    return _device(device).index


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')


def _bind(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    ip, sz = ctypes.POINTER(ctypes.c_int), ctypes.c_size_t
    lib.mgd_jpeg_version.argtypes = []
    lib.mgd_jpeg_version.restype = i
    lib.mgd_jpeg_backend_status.argtypes = [i, i]
    lib.mgd_jpeg_backend_status.restype = i
    lib.mgd_jpeg_create.argtypes = [i, ctypes.POINTER(ctypes.c_void_p)]
    lib.mgd_jpeg_create.restype = i
    lib.mgd_jpeg_destroy.argtypes = [p]
    lib.mgd_jpeg_destroy.restype = i
    lib.mgd_jpeg_info.argtypes = [p, ctypes.c_char_p, sz, ip, ip, ip, ip,
                                  ip, ip]
    lib.mgd_jpeg_info.restype = i
    lib.mgd_jpeg_decode.argtypes = [p, ctypes.c_char_p, sz, i, p, i, p, i,
                                    p, i, p]
    lib.mgd_jpeg_decode.restype = i
    lib.mgd_ycc_to_rgb.argtypes = [i, p, i, i, i, p]
    lib.mgd_ycc_to_rgb.restype = i
    lib.mgd_letterbox_smem_limit.argtypes = []
    lib.mgd_letterbox_smem_limit.restype = i
    lib.mgd_letterbox_smem.argtypes = [i, i, i, i]
    lib.mgd_letterbox_smem.restype = i
    lib.mgd_letterbox_rgb.argtypes = [i, p, i, i, i, i, i, p, p]
    lib.mgd_letterbox_rgb.restype = i
    lib.mgd_letterbox_yuv420.argtypes = [i, p, i, i, i, i, i, p, p, p,
                                         p]
    lib.mgd_letterbox_yuv420.restype = i


def _library() -> ctypes.CDLL:
    return kernel_build.load(_SOURCE, _bind)
