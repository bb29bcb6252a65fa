"""Frozen copy of ``multigriddet_tpu_torch/data/augment.py`` for the plain
reference (imports rewritten; nothing of the program is imported).

Batched image + box augmentation on tensors.

Counterpart of ``multigriddet_tpu/data/augment.py``.  Conventions as in the
JAX module: images ``[B, H, W, 3]`` float32 in [0, 255]; boxes ``[B, N, 5]``
``(x1, y1, x2, y2, class)`` canvas pixels, zero rows are padding.  Ops
never drop capacity: boxes that die are zeroed.

Every random op is split in two:

* ``draw_<op>(generator, b, ...)`` makes the op's random tensors on the
  CPU from a ``torch.Generator`` and returns them in a dict (the same
  values the JAX op draws from its key: gates, factors, offsets);
* ``apply_<op>(images, boxes, draws, ...)`` is deterministic given them,
  on whatever device the images are.

``random_<op>(generator, images, boxes, ...)`` composes the two, the
draws moved to the images' device.  So one seed gives one augmentation
on the CPU and on the card, and a test can feed the JAX op's own draws
to the port's apply.

Resampling ports ``jax.image.scale_and_translate(method='linear')`` with
its default ``antialias=True``: per-axis triangle-kernel weight matrices,
widened by 1/scale below scale 1, normalised by their in-range sum and
zeroed where the sample falls outside the input, applied as two float32
matmuls with TF32 off.  Free rotation ports ``map_coordinates(order=1,
mode='constant', cval=0)`` as an explicit bilinear gather with JAX's
weights, in pixel coordinates.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .util import to_device

GRAY_FILL = 128.0
MIN_BOX_PX = 3.0
_F32_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _valid(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]) > 0) & (
        (boxes[..., 3] - boxes[..., 1]) > 0)


def _zero_dead(boxes: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    return torch.where(alive[..., None], boxes, torch.zeros_like(boxes))


def _clip_filter(boxes: torch.Tensor, w: float, h: float,
                 min_px: float = MIN_BOX_PX) -> torch.Tensor:
    """Clip boxes to the canvas and kill those below the min pixel size."""
    was_valid = _valid(boxes)
    x1 = boxes[..., 0].clamp(0.0, w)
    y1 = boxes[..., 1].clamp(0.0, h)
    x2 = boxes[..., 2].clamp(0.0, w)
    y2 = boxes[..., 3].clamp(0.0, h)
    out = torch.stack([x1, y1, x2, y2, boxes[..., 4]], -1)
    alive = was_valid & ((x2 - x1) >= min_px) & ((y2 - y1) >= min_px)
    return _zero_dead(out, alive)


def _uniform(generator, shape, low=0.0, high=1.0) -> torch.Tensor:
    """Float32 uniform draws in [low, high) on the CPU."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (high - low) + low if (low, high) != (0.0, 1.0) else u


def _randint(generator, shape, low, high) -> torch.Tensor:
    return torch.randint(int(low), int(high), shape, generator=generator,
                         dtype=torch.int64)


def draws_to(draws, device):
    """A draws dict (nested) with every tensor on ``device``."""
    if isinstance(draws, dict):
        return {k: draws_to(v, device) for k, v in draws.items()}
    return to_device(draws, device)


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as IEEE division on every device: CUDA turns a
    division by a Python scalar into a multiplication by its reciprocal,
    one ulp off, which a rotation or a mosaic scale carries to ~0.01 of
    255 at a hard edge."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _bcast(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-image ``[B]`` tensor shaped to broadcast against ``like``."""
    return x.reshape(x.shape[0], *([1] * (like.dim() - 1)))


@contextlib.contextmanager
def _full_f32_matmul():
    """Float32 matmuls without TF32 (``precision=HIGHEST`` of the JAX
    resampler)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _edge_pad(images: torch.Tensor, r: int) -> torch.Tensor:
    """Pad H and W of ``[B, H, W, C]`` by ``r`` repeating the edge."""
    h, w = images.shape[1], images.shape[2]
    dev = images.device
    iy = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    ix = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    return images[:, iy][:, :, ix]


def _box_blur3(images: torch.Tensor) -> torch.Tensor:
    """3x3 mean over an edge-padded image, summed in the JAX op's order."""
    h, w = images.shape[1], images.shape[2]
    pad = _edge_pad(images, 1)
    acc = torch.zeros_like(images)
    for dy in range(3):
        for dx in range(3):
            acc = acc + pad[:, dy:dy + h, dx:dx + w, :]
    return acc / 9.0


# ---------------------------------------------------------------------------
# resampling: jax.image.scale_and_translate(method='linear')
# ---------------------------------------------------------------------------

def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """Per-image linear (triangle) resampling weights ``[B, in, out]`` with
    antialiasing, as ``jax/_src/image/scale.py`` ``compute_weight_mat``."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - translation[:, None] * inv_scale - 0.5)
    x = (sample_f[:, None, :] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[None, :, None]).abs() \
        / kernel_scale[:, :, None]
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def scale_and_translate(images: torch.Tensor, scale_yx: torch.Tensor,
                        translate_yx: torch.Tensor) -> torch.Tensor:
    """Resample each ``[H, W, C]`` image of the batch onto the same canvas:
    input point (y, x) lands at ``(y * sy + ty, x * sx + tx)``; samples
    outside the input are 0.  ``scale_yx`` and ``translate_yx`` are
    ``[B, 2]`` float32.  Two float32 matmuls, TF32 off."""
    b, h, w, c = images.shape
    wy = _weight_mat(h, h, scale_yx[:, 0], translate_yx[:, 0])  # [B,h,H]
    wx = _weight_mat(w, w, scale_yx[:, 1], translate_yx[:, 1])  # [B,w,W]
    with _full_f32_matmul():
        rows = torch.bmm(wy.transpose(1, 2),
                         images.reshape(b, h, w * c))         # [B,H,w*c]
        rows = rows.reshape(b, h, w, c).permute(0, 1, 3, 2).reshape(
            b, h * c, w)                                     # [B,H*c,w]
        out = torch.bmm(rows, wx)                            # [B,H*c,W]
    return out.reshape(b, h, c, w).permute(0, 1, 3, 2).contiguous()


# ---------------------------------------------------------------------------
# photometric ops (tf.image.adjust_* semantics, as the JAX module)
# ---------------------------------------------------------------------------

def _rgb_to_hsv(rgb: torch.Tensor):
    """RGB ``[..., 3]`` in [0, 1] -> (h, s, v) each ``[...]``."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = v - mn
    one = torch.ones_like(d)
    safe_d = torch.where(d > 0, d, one)
    h = torch.where(
        v == r, torch.remainder((g - b) / safe_d, 6.0),
        torch.where(v == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0))
    h = torch.where(d > 0, h / 6.0, torch.zeros_like(h))
    s = torch.where(v > 0, d / torch.where(v > 0, v, one),
                    torch.zeros_like(d))
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """(h, s, v) -> RGB ``[..., 3]`` in [0, 1]."""
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.to(torch.int32) % 6).long()[..., None]
    r = torch.stack([v, q, p, p, t, v], -1).gather(-1, i)
    g = torch.stack([t, v, v, q, p, p], -1).gather(-1, i)
    b = torch.stack([p, p, t, v, v, q], -1).gather(-1, i)
    return torch.cat([r, g, b], -1)


def adjust_brightness(images: torch.Tensor, delta) -> torch.Tensor:
    """Add ``delta`` (in [0, 1] units) and clip to [0, 255]."""
    return torch.clamp(images + delta * 255.0, 0.0, 255.0)


def adjust_contrast(images: torch.Tensor, factor) -> torch.Tensor:
    """Scale around the per-channel spatial mean."""
    mean = images.mean(dim=(-3, -2), keepdim=True)
    return torch.clamp((images - mean) * factor + mean, 0.0, 255.0)


def adjust_saturation(images: torch.Tensor, factor) -> torch.Tensor:
    h, s, v = _rgb_to_hsv(images / 255.0)
    s = torch.clamp(s * factor, 0.0, 1.0)
    return torch.clamp(_hsv_to_rgb(h, s, v) * 255.0, 0.0, 255.0)


def adjust_hue(images: torch.Tensor, delta) -> torch.Tensor:
    h, s, v = _rgb_to_hsv(images / 255.0)
    h = torch.remainder(h + delta, 1.0)
    return torch.clamp(_hsv_to_rgb(h, s, v) * 255.0, 0.0, 255.0)


def to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, repeated over the three channels."""
    gray = (0.2989 * images[..., 0:1] + 0.5870 * images[..., 1:2]
            + 0.1140 * images[..., 2:3])
    return gray.expand(images.shape)


def draw_gate_and_value(generator, b, prob, low, high) -> Dict:
    """A per-image gate ``u < prob`` and a value uniform in [low, high)."""
    return {'apply': _uniform(generator, (b,)) < prob,
            'value': _uniform(generator, (b,), low, high)}


def draw_brightness(generator, b, max_delta=0.2, prob=0.5):
    return draw_gate_and_value(generator, b, prob, -max_delta, max_delta)


def apply_brightness(images, boxes, draws):
    delta = torch.where(draws['apply'], draws['value'],
                        torch.zeros_like(draws['value']))
    return adjust_brightness(images, _bcast(delta, images)), boxes


def draw_contrast(generator, b, lower=0.8, upper=1.2, prob=0.5):
    return draw_gate_and_value(generator, b, prob, lower, upper)


def apply_contrast(images, boxes, draws):
    factor = torch.where(draws['apply'], draws['value'],
                         torch.ones_like(draws['value']))
    return adjust_contrast(images, _bcast(factor, images)), boxes


def draw_saturation(generator, b, lower=0.8, upper=1.2, prob=0.5):
    return draw_gate_and_value(generator, b, prob, lower, upper)


def apply_saturation(images, boxes, draws):
    factor = torch.where(draws['apply'], draws['value'],
                         torch.ones_like(draws['value']))
    return adjust_saturation(images, factor[:, None, None]), boxes


def draw_hue(generator, b, max_delta=0.1, prob=0.5):
    return draw_gate_and_value(generator, b, prob, -max_delta, max_delta)


def apply_hue(images, boxes, draws):
    delta = torch.where(draws['apply'], draws['value'],
                        torch.zeros_like(draws['value']))
    return adjust_hue(images, delta[:, None, None]), boxes


def draw_gate(generator, b, prob) -> Dict:
    """A per-image gate ``u < prob``."""
    return {'apply': _uniform(generator, (b,)) < prob}


def apply_grayscale(images, boxes, draws):
    return torch.where(_bcast(draws['apply'], images), to_grayscale(images),
                       images), boxes


# ---------------------------------------------------------------------------
# filters and free rotation
# ---------------------------------------------------------------------------

def apply_blur(images, boxes, draws):
    """Light 3x3 box blur where the gate is on."""
    return torch.where(_bcast(draws['apply'], images), _box_blur3(images),
                       images), boxes


def draw_sharpness(generator, b, prob=0.1, max_alpha=0.8):
    return draw_gate_and_value(generator, b, prob, 0.0, max_alpha)


def apply_sharpness(images, boxes, draws):
    """Unsharp mask ``x + alpha (x - blur3(x))``, clipped."""
    alpha = _bcast(draws['value'], images)
    sharp = images + alpha * (images - _box_blur3(images))
    return torch.where(_bcast(draws['apply'], images),
                       torch.clamp(sharp, 0.0, 255.0), images), boxes


def draw_motion_blur(generator, b, prob=0.05):
    return {'apply': _uniform(generator, (b,)) < prob,
            'direction': _randint(generator, (b,), 0, 4)}


def apply_motion_blur(images, boxes, draws, taps=5):
    """A 1-D mean of ``taps`` pixels along one of four directions
    (horizontal, vertical, diagonal, anti-diagonal)."""
    b, h, w, _ = images.shape
    r = taps // 2
    pad = _edge_pad(images, r)
    shifts = {0: [(0, d) for d in range(-r, r + 1)],
              1: [(d, 0) for d in range(-r, r + 1)],
              2: [(d, d) for d in range(-r, r + 1)],
              3: [(d, -d) for d in range(-r, r + 1)]}
    out = images
    for k in range(4):
        acc = torch.zeros_like(images)
        for dy, dx in shifts[k]:
            acc = acc + pad[:, r + dy:r + dy + h, r + dx:r + dx + w, :]
        pick = draws['apply'] & (draws['direction'] == k)
        out = torch.where(_bcast(pick, images), acc / taps, out)
    return out, boxes


def draw_rotate_any(generator, b, prob=0.05, max_deg=15.0):
    return draw_gate_and_value(generator, b, prob, -max_deg, max_deg)


def _bilinear_zero_fill(images: torch.Tensor, src_y: torch.Tensor,
                        src_x: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=1, mode='constant', cval=0)`` of every
    channel at pixel coordinates ``[B, H, W]``: the four neighbours with
    JAX's weights, a neighbour outside the image contributes 0."""
    b, h, w, c = images.shape
    flat = images.reshape(b, h * w, c)

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        return [(idx, 1 - upper_w), (idx + 1, upper_w)]

    out = None
    for iy, wy in nodes(src_y):
        for ix, wx in nodes(src_x):
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(
                b, h * w, 1).expand(b, h * w, c)
            val = flat.gather(1, lin).reshape(b, h, w, c)
            val = torch.where(ok[..., None], val, torch.zeros_like(val))
            term = (wy * wx)[..., None] * val
            out = term if out is None else out + term
    return out


def apply_rotate_any(images, boxes, draws):
    """Rotation by the drawn angle about the canvas centre with gray fill;
    boxes become the hull of their rotated corners, clip-filtered."""
    b, h, w, _ = images.shape
    dev = images.device
    theta = torch.where(draws['apply'],
                        _true_div(draws['value'] * math.pi, 180.0),
                        torch.zeros_like(draws['value']))
    # cos and sin in float64, rounded once: the same float32 on every
    # device (a one-ulp angle moves a hard edge by ~0.015 of 255)
    cos_t = torch.cos(theta.double()).float()
    sin_t = torch.sin(theta.double()).float()
    ys = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
          - (h - 1) / 2.0).expand(h, w)
    xs = (torch.arange(w, dtype=torch.float32, device=dev)[None, :]
          - (w - 1) / 2.0).expand(h, w)
    c3, s3 = cos_t[:, None, None], sin_t[:, None, None]
    src_x = c3 * xs + s3 * ys + (w - 1) / 2.0
    src_y = -s3 * xs + c3 * ys + (h - 1) / 2.0
    out = _bilinear_zero_fill(images - GRAY_FILL, src_y, src_x) + GRAY_FILL
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    corners_x = torch.stack([x1, x2, x1, x2], -1) - cx
    corners_y = torch.stack([y1, y1, y2, y2], -1) - cy
    c4, s4 = cos_t[:, None, None], sin_t[:, None, None]
    rx = c4 * corners_x - s4 * corners_y + cx
    ry = s4 * corners_x + c4 * corners_y + cy
    nb = torch.stack([rx.amin(-1), ry.amin(-1), rx.amax(-1), ry.amax(-1),
                      boxes[..., 4]], -1)
    nb = _zero_dead(nb, _valid(boxes))
    return out, _clip_filter(nb, w, h)


# ---------------------------------------------------------------------------
# geometric ops
# ---------------------------------------------------------------------------

def apply_hflip(images, boxes, draws):
    w = images.shape[2]
    a = draws['apply']
    out = torch.where(_bcast(a, images), images.flip(2), images)
    x1 = torch.where(a[:, None], w - boxes[..., 2], boxes[..., 0])
    x2 = torch.where(a[:, None], w - boxes[..., 0], boxes[..., 2])
    nb = torch.stack([x1, boxes[..., 1], x2, boxes[..., 3], boxes[..., 4]],
                     -1)
    return out, _zero_dead(nb, _valid(boxes))


def apply_vflip(images, boxes, draws):
    h = images.shape[1]
    a = draws['apply']
    out = torch.where(_bcast(a, images), images.flip(1), images)
    y1 = torch.where(a[:, None], h - boxes[..., 3], boxes[..., 1])
    y2 = torch.where(a[:, None], h - boxes[..., 1], boxes[..., 3])
    nb = torch.stack([boxes[..., 0], y1, boxes[..., 2], y2, boxes[..., 4]],
                     -1)
    return out, _zero_dead(nb, _valid(boxes))


def draw_rotate90(generator, b, prob=0.05):
    return {'apply': _uniform(generator, (b,)) < prob,
            'k': _randint(generator, (b,), 1, 4)}


def apply_rotate90(images, boxes, draws):
    """Counter-clockwise rotation by k quarter turns (square canvas)."""
    b, h, w, _ = images.shape
    rot = torch.where(draws['apply'], draws['k'], torch.zeros_like(
        draws['k']))
    x1, y1, x2, y2, cls = (boxes[..., i] for i in range(5))
    turned = {1: torch.stack([y1, w - x2, y2, w - x1, cls], -1),
              2: torch.stack([w - x2, h - y2, w - x1, h - y1, cls], -1),
              3: torch.stack([h - y2, x1, h - y1, x2, cls], -1)}
    out, nb = images, boxes
    for k in (1, 2, 3):
        pick = rot == k
        out = torch.where(_bcast(pick, images),
                          torch.rot90(images, k, dims=(1, 2)), out)
        nb = torch.where(pick[:, None, None], turned[k], nb)
    return out, _zero_dead(nb, _valid(boxes))


def draw_resize_crop_pad(generator, b, scale_range=(0.7, 1.3),
                         aspect_range=(0.75, 1.333), prob=1.0):
    return {'apply': _uniform(generator, (b,)) < prob,
            'scale': _uniform(generator, (b,), *scale_range),
            'aspect': _uniform(generator, (b,), *aspect_range),
            'u': _uniform(generator, (b, 2))}


def apply_resize_crop_pad(images, boxes, draws):
    """Zoom by (sx, sy), move to a drawn position, gray fill."""
    b, h, w, _ = images.shape
    a = draws['apply']
    one = torch.ones_like(draws['scale'])
    root = torch.sqrt(draws['aspect'])
    sx = torch.where(a, draws['scale'] * root, one)
    sy = torch.where(a, draws['scale'] / root, one)
    max_tx = torch.clamp(w - sx * w, min=0.0) + 0.25 * w
    max_ty = torch.clamp(h - sy * h, min=0.0) + 0.25 * h
    zero = torch.zeros_like(sx)
    tx = torch.where(a, draws['u'][:, 0] * max_tx - 0.125 * w, zero)
    ty = torch.where(a, draws['u'][:, 1] * max_ty - 0.125 * h, zero)
    out = scale_and_translate(images - GRAY_FILL, torch.stack([sy, sx], 1),
                              torch.stack([ty, tx], 1)) + GRAY_FILL
    out = torch.clamp(out, 0.0, 255.0)
    nb = torch.stack([boxes[..., 0] * sx[:, None] + tx[:, None],
                      boxes[..., 1] * sy[:, None] + ty[:, None],
                      boxes[..., 2] * sx[:, None] + tx[:, None],
                      boxes[..., 3] * sy[:, None] + ty[:, None],
                      boxes[..., 4]], -1)
    nb = _zero_dead(nb, _valid(boxes))
    return out, _clip_filter(nb, w, h)


# ---------------------------------------------------------------------------
# GridMask
# ---------------------------------------------------------------------------

def _integral_image(mask: torch.Tensor) -> torch.Tensor:
    """Summed-area table of ``[..., H, W]`` with a zero top/left border."""
    s = mask.cumsum(-2).cumsum(-1)
    return F.pad(s, (1, 0, 1, 0))


def draw_gridmask(generator, b, prob=0.1, d_range=(40, 120)):
    return {'apply': _uniform(generator, (b,)) < prob,
            'd': _randint(generator, (b,), d_range[0], d_range[1] + 1),
            'off': _randint(generator, (b, 2), 0, d_range[1])}


def apply_gridmask(images, boxes, draws, ratio=0.5, min_visible=0.3):
    """Gray out a grid of squares; keep boxes whose visible share stays at
    least ``min_visible``."""
    b, h, w, _ = images.shape
    dev = images.device
    d = draws['d'][:, None, None]
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    hole = d.float() * ratio
    in_hole = ((torch.remainder(ys + draws['off'][:, 0, None, None], d)
                < hole)
               & (torch.remainder(xs + draws['off'][:, 1, None, None], d)
                  < hole))
    keep = torch.where(draws['apply'][:, None, None],
                       1.0 - in_hole.float(),
                       torch.ones((b, h, w), device=dev))
    out = images * keep[..., None] + GRAY_FILL * (1.0 - keep[..., None])
    sat = _integral_image(keep)                          # [B, H+1, W+1]
    x1 = boxes[..., 0].to(torch.int64).clamp(0, w)
    y1 = boxes[..., 1].to(torch.int64).clamp(0, h)
    x2 = boxes[..., 2].to(torch.int64).clamp(0, w)
    y2 = boxes[..., 3].to(torch.int64).clamp(0, h)
    flat = sat.reshape(b, -1)

    def at(yy, xx):
        return flat.gather(1, yy * (w + 1) + xx)
    vis = at(y2, x2) - at(y1, x2) - at(y2, x1) + at(y1, x1)
    area = torch.clamp((x2 - x1) * (y2 - y1), min=1).float()
    alive = _valid(boxes) & ((vis / area) >= min_visible)
    return out, _zero_dead(boxes, alive)


# ---------------------------------------------------------------------------
# batch mixing: mosaic, mixup, copy-paste
# ---------------------------------------------------------------------------

def draw_mosaic(generator, b, prob=0.3, center_range=(0.3, 0.7)):
    return {'apply': _uniform(generator, (b,)) < prob,
            'center': _uniform(generator, (b, 2), *center_range)}


def apply_mosaic(images, boxes, draws):
    """4-image mosaic: image i takes its batch neighbours i..i+3 (mod B)
    into the quadrants split at the drawn centre, each rescaled to its
    quadrant; each quadrant's boxes are clipped to it, filtered at
    ``max(10, 0.03 * its short side)`` and placed in its own quarter of
    the (pre-expanded, x4) capacity."""
    b, h, w, _ = images.shape
    n = boxes.shape[1]
    cap = n // 4
    dev = images.device
    a = draws['apply']
    cx = draws['center'][:, 0] * w
    cy = draws['center'][:, 1] * h
    zero, fw, fh = (torch.zeros_like(cx), torch.full_like(cx, float(w)),
                    torch.full_like(cx, float(h)))
    quads = [(zero, zero, cx, cy), (cx, zero, fw, cy),
             (zero, cy, cx, fh), (cx, cy, fw, fh)]
    src = torch.stack([images.roll(-q, 0) for q in range(4)], 1)
    x0s, y0s, x1s, y1s = (torch.stack([qd[i] for qd in quads], 1)
                          for i in range(4))            # [B, 4]
    s_x = _true_div(x1s - x0s, w)
    s_y = _true_div(y1s - y0s, h)
    scaled = scale_and_translate(
        src.reshape(b * 4, h, w, 3) - GRAY_FILL,
        torch.stack([s_y, s_x], -1).reshape(b * 4, 2),
        torch.stack([y0s, x0s], -1).reshape(b * 4, 2)).reshape(
            b, 4, h, w, 3) + GRAY_FILL
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    out = torch.zeros_like(images)
    out_boxes = []
    for q in range(4):
        x0, y0, x1, y1 = (t[:, q, None, None] for t in (x0s, y0s, x1s, y1s))
        in_q = ((xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1))[..., None]
        out = torch.where(in_q, scaled[:, q], out)
        bq = boxes.roll(-q, 0)
        x0, y0, x1, y1 = (t[:, q, None] for t in (x0s, y0s, x1s, y1s))
        sxq, syq = s_x[:, q, None], s_y[:, q, None]
        nb = torch.stack([
            torch.minimum(torch.maximum(bq[..., 0] * sxq + x0, x0), x1),
            torch.minimum(torch.maximum(bq[..., 1] * syq + y0, y0), y1),
            torch.minimum(torch.maximum(bq[..., 2] * sxq + x0, x0), x1),
            torch.minimum(torch.maximum(bq[..., 3] * syq + y0, y0), y1),
            bq[..., 4]], -1)
        min_sz = torch.clamp(0.03 * torch.minimum(x1 - x0, y1 - y0),
                             min=10.0)
        alive = (_valid(bq) & ((nb[..., 2] - nb[..., 0]) >= min_sz)
                 & ((nb[..., 3] - nb[..., 1]) >= min_sz))
        out_boxes.append(_zero_dead(nb, alive)[:, :cap])
    m_box = F.pad(torch.cat(out_boxes, 1), (0, 0, 0, n - 4 * cap))
    return (torch.where(_bcast(a, images), out, images),
            torch.where(a[:, None, None], m_box, boxes))


def _pack_valid_front(boxes: torch.Tensor) -> torch.Tensor:
    """Stably move each image's valid rows to the front of the capacity
    axis (invalid rows sink, order kept)."""
    invalid = (~_valid(boxes)).to(torch.int32)
    order = torch.sort(invalid, dim=1, stable=True).indices
    return boxes.gather(1, order[..., None].expand_as(boxes))


def draw_mixup(generator, b, prob=0.1, alpha_range=(0.2, 0.8)):
    return draw_gate_and_value(generator, b, prob, *alpha_range)


def apply_mixup(images, boxes, draws):
    """Blend with the next image at the drawn lambda; both box lists,
    packed to the front, fill one half of the (pre-expanded, x2)
    capacity each, so no valid box is lost."""
    n = boxes.shape[1]
    half = n // 2
    a = draws['apply']
    lam = _bcast(draws['value'], images)
    packed = _pack_valid_front(boxes)
    other_boxes = packed.roll(-1, 0)
    mixed = images * lam + images.roll(-1, 0) * (1.0 - lam)
    merged = F.pad(torch.cat([packed[:, :half], other_boxes[:, :half]], 1),
                   (0, 0, 0, n - 2 * half))
    return (torch.where(_bcast(a, images), mixed, images),
            torch.where(a[:, None, None], merged, boxes))


def draw_copypaste(generator, b, n, prob=0.15, max_paste=4):
    """``n``: the capacity the op sees (the slots for the pastes
    included)."""
    return {'apply': _uniform(generator, (b,)) < prob,
            'noise': _uniform(generator, (b, n)),
            'u': _uniform(generator, (b, max_paste, 2))}


def apply_copypaste(images, boxes, draws, max_paste=4):
    """Paste up to ``max_paste`` ground-truth crops of the next image at
    the drawn positions (kept inside the canvas, no rescale).  Donors are
    picked by drawn noise + 2 * valid, lower index first on ties; the
    pasted boxes fill the last ``max_paste`` slots; a box whose centre a
    later paste covers is zeroed."""
    b, h, w, _ = images.shape
    n = boxes.shape[1]
    dev = images.device
    a = draws['apply']
    donor_img = images.roll(-1, 0)
    donor_box = boxes.roll(-1, 0)
    pri = draws['noise'] + _valid(donor_box).float() * 2.0
    sel = torch.sort(pri, dim=1, descending=True,
                     stable=True).indices[:, :max_paste]   # [B, P]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    picked = donor_box.gather(1, sel[..., None].expand(b, max_paste, 5))
    bw = picked[..., 2] - picked[..., 0]                    # [B, P]
    bh = picked[..., 3] - picked[..., 1]
    ok = a[:, None] & (bw >= MIN_BOX_PX) & (bh >= MIN_BOX_PX)
    tx = draws['u'][..., 0] * torch.clamp(w - bw, min=0.0)
    ty = draws['u'][..., 1] * torch.clamp(h - bh, min=0.0)
    shifted = scale_and_translate(
        donor_img.repeat_interleave(max_paste, 0),
        torch.ones((b * max_paste, 2), device=dev),
        torch.stack([ty - picked[..., 1], tx - picked[..., 0]],
                    -1).reshape(b * max_paste, 2)).reshape(
                        b, max_paste, h, w, 3)
    out = images
    for p in range(max_paste):
        t_x, t_y = tx[:, p, None, None], ty[:, p, None, None]
        m = ((xs >= t_x) & (xs < t_x + bw[:, p, None, None])
             & (ys >= t_y) & (ys < t_y + bh[:, p, None, None])
             & ok[:, p, None, None])[..., None]
        out = torch.where(m, shifted[:, p], out)
    rows = torch.stack([tx, ty, tx + bw, ty + bh, picked[..., 4]], -1)
    rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
    # originals whose centres a paste covers die
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    covered = torch.zeros_like(cx, dtype=torch.bool)
    x2s, y2s = tx + bw, ty + bh
    for p in range(max_paste):
        covered = covered | ((cx >= tx[:, p, None]) & (cx < x2s[:, p, None])
                             & (cy >= ty[:, p, None])
                             & (cy < y2s[:, p, None]) & ok[:, p, None])
    kept = _zero_dead(boxes, _valid(boxes) & ~covered)
    # an earlier paste whose centre a later one covers is occluded
    pcx = (rows[..., 0] + rows[..., 2]) / 2.0
    pcy = (rows[..., 1] + rows[..., 3]) / 2.0
    p_iota = torch.arange(max_paste, device=dev)[None, :]
    for q in range(max_paste):
        occl = ((p_iota < q) & (pcx >= tx[:, q, None])
                & (pcx < x2s[:, q, None]) & (pcy >= ty[:, q, None])
                & (pcy < y2s[:, q, None]) & ok[:, q, None])
        rows = torch.where(occl[..., None], torch.zeros_like(rows), rows)
    out_bx = torch.cat([kept[:, :n - max_paste], rows], 1)
    return (torch.where(_bcast(a, images), out, images),
            torch.where(a[:, None, None], out_bx, boxes))


# ---------------------------------------------------------------------------
# draw + apply on one generator
# ---------------------------------------------------------------------------

def _random(draw, apply, draw_kw=(), apply_kw=(), by_capacity=False):
    """``random_<op>(generator, images, boxes, **kw)``: draw on the CPU
    from ``generator`` (for the batch size, and the box capacity when
    ``by_capacity``), move the draws to the images' device, apply."""
    def op(generator, images, boxes, **kw):
        dk = {k: kw[k] for k in draw_kw if k in kw}
        ak = {k: kw[k] for k in apply_kw if k in kw}
        extra = set(kw) - set(dk) - set(ak)
        if extra:
            raise TypeError(f'unexpected arguments {sorted(extra)}')
        size = images.shape[:1] + (boxes.shape[1:2] if by_capacity else ())
        draws = draws_to(draw(generator, *size, **dk), images.device)
        return apply(images, boxes, draws, **ak)
    op.__name__ = 'random_' + apply.__name__[len('apply_'):]
    op.__doc__ = apply.__doc__
    return op


random_brightness = _random(draw_brightness, apply_brightness,
                            ('max_delta', 'prob'))
random_contrast = _random(draw_contrast, apply_contrast,
                          ('lower', 'upper', 'prob'))
random_saturation = _random(draw_saturation, apply_saturation,
                            ('lower', 'upper', 'prob'))
random_hue = _random(draw_hue, apply_hue, ('max_delta', 'prob'))
random_grayscale = _random(draw_gate, apply_grayscale, ('prob',))
random_blur = _random(draw_gate, apply_blur, ('prob',))
random_sharpness = _random(draw_sharpness, apply_sharpness,
                           ('prob', 'max_alpha'))
random_motion_blur = _random(draw_motion_blur, apply_motion_blur,
                             ('prob',), ('taps',))
random_rotate_any = _random(draw_rotate_any, apply_rotate_any,
                            ('prob', 'max_deg'))
random_hflip = _random(draw_gate, apply_hflip, ('prob',))
random_vflip = _random(draw_gate, apply_vflip, ('prob',))
random_rotate90 = _random(draw_rotate90, apply_rotate90, ('prob',))
random_resize_crop_pad = _random(draw_resize_crop_pad, apply_resize_crop_pad,
                                 ('scale_range', 'aspect_range', 'prob'))
random_gridmask = _random(draw_gridmask, apply_gridmask, ('prob', 'd_range'),
                          ('ratio', 'min_visible'))
random_mosaic = _random(draw_mosaic, apply_mosaic, ('prob', 'center_range'))
random_mixup = _random(draw_mixup, apply_mixup, ('prob', 'alpha_range'))
random_copypaste = _random(draw_copypaste, apply_copypaste,
                           ('prob', 'max_paste'), ('max_paste',),
                           by_capacity=True)


def expand_box_capacity(boxes, factor: int):
    """Pad the box axis to ``factor`` times its capacity (numpy or tensor)."""
    if factor <= 1:
        return boxes
    n = boxes.shape[1]
    if isinstance(boxes, torch.Tensor):
        return F.pad(boxes, (0, 0, 0, n * (factor - 1)))
    return np.pad(boxes, ((0, 0), (0, n * (factor - 1)), (0, 0)))


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [0, 1] at the end of the chain."""
    return images / 255.0
